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
// loads a pixel, ten with ESM) and 35 sums; at 480x640 one pair streams
// 9.8 MB, 0.0029 ms at the card's 3.35 TB/s. On one SM (one block a pair)
// the same pass took ~0.78 ms, bound by that SM's load latency.
//
// Design: there is no solver loop, so the blocks of a pair never have to
// agree on a state mid-kernel, and a pair can spread over more SMs than a
// thread-block cluster holds (16). A pair's pixels are split over G blocks
// (ops/fused_batch.py::lin_split(H, W), a function of the level's shape
// alone, never of B): block rank r sweeps pixels r * kThreads + tid in
// steps of G * kThreads and reduces its sums with block_sum into a (B, G,
// kGramSums) float32 scratch the caller allocates; a second launch of B
// blocks adds each pair's G partials in rank order, 0 to G - 1, and
// writes the 8x8. No atomics touch the sums, so a pair gives the same bits
// alone and in a batch. At G = 1 the block sweeps the pixels in
// linearize_block's order and writes the Gram itself, with no second
// launch. A K-LIN Gram and a K-GN iteration at the same state sum in
// different orders once either kernel splits a pair.

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

// G blocks a pair (blocks pair * G .. pair * G + G - 1, rank = blockIdx.x
// % G), each summing its strided share of the pixels. At G = 1 the block
// writes the pair's Gram; above, its kGramSums sums go to
// partials[blockIdx.x] for lin_gather_kernel.
template <bool kBilinear, int kLoss, bool kEsm>
__global__ void __launch_bounds__(kThreads)
fused_lin_kernel(const float* __restrict__ i0_all,    // (B, N)
                 const float* __restrict__ geom_all,  // (B, 4|6, N)
                 const float* __restrict__ t_all,     // (B, 3, H, W)
                 const float* __restrict__ states,    // (B, 6)
                 const float* __restrict__ scale_in,  // (B,) delta or sigma
                 float* __restrict__ partials,        // (B, G, kGramSums)
                 float* __restrict__ gram_out,        // (B, 8, 8)
                 int H, int W, int G, float fx, float fy, float cx, float cy) {
  constexpr int kRows = kEsm ? 6 : 4;
  const int pair = blockIdx.x / G;
  const int rank = blockIdx.x % G;
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
  const float* i0 = i0_all + static_cast<size_t>(pair) * N;
  const float* geom = geom_all + static_cast<size_t>(pair) * kRows * N;
  const float* tgt = t_all + static_cast<size_t>(pair) * 3 * N;
  float acc[kGramSums];
#pragma unroll
  for (int k = 0; k < kGramSums; ++k) acc[k] = 0.0f;
  for (int p = rank * kThreads + tid; p < N; p += G * kThreads) {
    float sgx = 0.0f, sgy = 0.0f;
    if constexpr (kEsm) {
      sgx = geom[4 * N + p];
      sgy = geom[5 * N + p];
    }
    accumulate_pixel<kBilinear, kLoss, kEsm, kGramSums, false>(
        terms, geom[p], geom[N + p], geom[2 * N + p], geom[3 * N + p], sgx, sgy,
        i0[p], tgt, H, W, fx, fy, cx, cy, delta, 0.0f, acc);
  }
  block_sum<kGramSums>(acc, partial, total);
  if (G == 1) {
    if (tid < 64) {
      const int i = tid / 8, j = tid % 8;
      const int k = i <= j ? gram_index(i, j) : gram_index(j, i);
      gram_out[pair * 64 + tid] = k < 0 ? 0.0f : total[k];
    }
  } else if (tid < kGramSums) {
    partials[static_cast<size_t>(blockIdx.x) * kGramSums + tid] = total[tid];
  }
}

// The fixed-order pass of the split layout: block `pair`, thread t < 64
// writes Gram entry t, the sum of the pair's G partials of that entry in
// rank order 0 to G - 1.
__global__ void __launch_bounds__(64)
lin_gather_kernel(const float* __restrict__ partials, float* __restrict__ gram_out, int G) {
  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / 8, j = tid % 8;
  const int k = i <= j ? gram_index(i, j) : gram_index(j, i);
  float a = 0.0f;
  if (k >= 0) {
    const float* p = partials + static_cast<size_t>(pair) * G * kGramSums + k;
    a = p[0];
    for (int r = 1; r < G; ++r) a += p[static_cast<size_t>(r) * kGramSums];
  }
  gram_out[pair * 64 + tid] = a;
}

}  // namespace

// Launches one linearization of B pairs on `stream` (a cudaStream_t); the
// caller owns every buffer. loss is a phovo::Loss, esm selects the six-row
// geometry, scale_in holds each pair's loss scale. split is G, the blocks a
// pair: at 1 each block writes its pair's Gram; above 1 the per-block sums
// go to partials (partials_len floats, at least B * G * 35), then
// lin_gather_kernel adds them. Returns the first CUDA error
// (cudaGetLastError() after each launch), or cudaErrorInvalidValue for a
// variant that does not exist, a split below 1 or a scratch too small;
// nothing is retried.
extern "C" int phovo_fused_lin(
    const float* i0, const float* geom, const float* t_all,
    const float* states, const float* scale_in, float* partials,
    int partials_len, float* gram_out, int B, int H, int W, int bilinear,
    int loss, int esm, int split, float fx, float fy, float cx, float cy,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool gather = split > 1;
  if (gather && static_cast<long long>(partials_len) <
                    static_cast<long long>(B) * split * kGramSums) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  const bool known = dispatch_variant<kTdist, true>(
      bilinear, loss, esm, [&](auto kb, auto kl, auto ke) {
        fused_lin_kernel<decltype(kb)::value, decltype(kl)::value,
                         decltype(ke)::value><<<B * split, kThreads, 0, s>>>(
            i0, geom, t_all, states, scale_in, partials, gram_out, H, W, split,
            fx, fy, cx, cy);
        err = cudaGetLastError();
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (err == cudaSuccess && gather) {
    lin_gather_kernel<<<B, 64, 0, s>>>(partials, gram_out, split);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
