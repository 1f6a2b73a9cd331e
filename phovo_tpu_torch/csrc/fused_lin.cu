// One linearization of B independent frame pairs: the 8x8 Gram of the
// per-pixel rows [J0..J5, r_w, valid] at each pair's state (K-LIN).
//
// Replaces the TPU kernel phovo_tpu/ops/fused.py::_fused_kernel (one
// linearization per call, behind make_fused_linearizer and
// fused_normal_equations_pallas), with _linearize_gram's per-pixel code:
// photometric, nearest or bilinear sampling, the target gradient at the
// warped point or averaged with the source gradient (ESM, six geometry
// rows), and any robust loss as IRLS weights at each pair's scale (the
// loss's delta, or the Student-t sigma the caller carries). Slot (6, 7)
// holds the pixels a banded sampling window dropped, as on the TPU: always
// 0 here, where the target is read by direct gather.
//
// What bounds it on an H100: one pass over the pair's packs (eight 4-byte
// loads a pixel, ten with ESM) and 35 block sums; at 480x640 a single pair
// streams 9.8 MB through one SM, so a B = 1 launch is bound by one SM's
// load bandwidth and the reduction, not by the card. The design is the
// level kernels' linearization (phovo_linearize.cuh linearize_block), one
// block per pair, without the solver loop: the same per-pixel arithmetic
// and the same fixed-order reduction, so a K-LIN Gram and a K-GN iteration
// at the same state sum the same bits.

#include "phovo_linearize.cuh"

namespace {

using namespace phovo;

// Index into the kGramSums sums of Gram entry (i, j), i <= j; -1 for the
// band-masked slot (6, 7).
__device__ __forceinline__ int gram_index(int i, int j) {
  if (j < 6) return 6 * i - i * (i - 1) / 2 + (j - i);  // JtJ, row-major upper
  if (i < 6) return j == 6 ? 21 + i : 29 + i;           // J^T r, J^T valid
  if (j == 6) return 27;                                // r^T r
  return i == 7 ? 28 : -1;                              // valid count; (6, 7)
}

template <bool kBilinear, int kLoss, bool kEsm>
__global__ void __launch_bounds__(kThreads)
fused_lin_kernel(const float* __restrict__ i0_all,     // (B, N)
                 const float* __restrict__ geom_all,   // (B, 4|6, N)
                 const float* __restrict__ t_all,      // (B, 3, H, W)
                 const float* __restrict__ states,     // (B, 6)
                 const float* __restrict__ scale_in,   // (B,) delta or sigma
                 float* __restrict__ gram_out,         // (B, 8, 8)
                 int H, int W, float fx, float fy, float cx, float cy) {
  constexpr int kRows = kEsm ? 6 : 4;
  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = H * W;

  __shared__ Terms terms;
  __shared__ float partial[kWarps][kGramSums];
  __shared__ float total[kGramSums];
  __shared__ float delta;

  if (tid == 0) {
    make_terms(states + pair * 6, &terms);
    delta = scale_in[pair];
  }
  __syncthreads();
  linearize_block<kBilinear, kLoss, kEsm, kGramSums>(
      terms, i0_all + static_cast<size_t>(pair) * N,
      geom_all + static_cast<size_t>(pair) * kRows * N,
      t_all + static_cast<size_t>(pair) * 3 * N, H, W, fx, fy, cx, cy, delta,
      partial, total);
  if (tid < 64) {
    const int i = tid / 8, j = tid % 8;
    const int k = i <= j ? gram_index(i, j) : gram_index(j, i);
    gram_out[pair * 64 + tid] = k < 0 ? 0.0f : total[k];
  }
}

}  // namespace

// Launches one linearization of B pairs on `stream` (a cudaStream_t); the
// caller owns every buffer. loss is a phovo::Loss, esm selects the six-row
// geometry, scale_in holds each pair's loss scale. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// variant that does not exist.
extern "C" int phovo_fused_lin(
    const float* i0, const float* geom, const float* t_all,
    const float* states, const float* scale_in, float* gram_out, int B, int H,
    int W, int bilinear, int loss, int esm, float fx, float fy, float cx,
    float cy, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch_variant<kTdist, true>(
      bilinear, loss, esm, [&](auto kb, auto kl, auto ke) {
        fused_lin_kernel<decltype(kb)::value, decltype(kl)::value,
                         decltype(ke)::value><<<B, kThreads, 0, s>>>(
            i0, geom, t_all, states, scale_in, gram_out, H, W, fx, fy, cx, cy);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
