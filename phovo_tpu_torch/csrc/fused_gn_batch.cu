// One whole Gauss-Newton pyramid level for B independent frame pairs (K-GN).
//
// Replaces these TPU kernels, which compute the same per-pair level:
//   phovo_tpu/ops/fused_batch.py::_fused_gn_batch_kernel (B pairs, the
//     level-major sequence; linearization _batch_linearize, solve
//     phovo_tpu/ops/fused.py::_chol_solve6), and
//   phovo_tpu/ops/fused.py::_fused_gn_kernel with _run_gn_loop (one pair,
//     the per-pair aligner): here that is this kernel launched with B = 1;
//   the same two in their bi-objective (intensity + depth) mode:
//     _fused_gn_batch_kernel with bi=True and
//     phovo_tpu/ops/fused.py::_fused_gn_bi_kernel (its 16x16 Gram's two
//     blocks summed into one set of normal equations), the kBi variant
//     here (K-GN-bi): a six-channel target [I, gx, gy, D, dgx, dgy] and a
//     per-pair depth gain; huber, cauchy and tukey, no ESM, no Student-t;
//   _fused_gn_batch_kernel with shared_src=True (keyframe tracking: one
//     source pack, the keyframe's, read by every pair), photometric, every
//     loss and ESM: here the shared_source flag, which points every block
//     at pair 0's source and changes nothing else, so a shared pack gives
//     the bits of the same pack repeated B times;
//   phovo_tpu/ops/fused.py::_fused_gn_multi_kernel (S independent streams
//     of one level, each freezing on its own): this kernel at B = S
//     (ops/fused.py::fused_gn_level_multi).
// Photometric, one source per pair, nearest or bilinear sampling, the
// target gradient at the warped point or averaged with the source gradient
// (ESM, six geometry rows), and any robust loss as IRLS weights. For the
// Student-t loss ('tdist') the scale sigma is per pair: it comes in, runs
// `tdist_burnin` scale-only passes at the initial state, is re-estimated
// after every linearization from its weighted cost and count
// (phovo_tpu/ops/fused.py:865-879), and goes out.
// It computes what the TPU kernel computes, not its block layout: the TPU
// stacks 8-32 pairs on the sublane axis and samples through one-hot MXU
// matmuls against a banded row window; here the target is read by direct
// gather, so nothing is masked and band_masked is always 0.
//
// What bounds it on an H100: a GN iteration is about a hundred flops and
// eight 4-byte loads a pixel (four geometry rows, the source intensity,
// three target samples, of which the target ones are scattered), then a
// 29-value block reduction and a serial 6x6 solve; the bi-objective
// variant reads three more target samples (44 B a pixel with its packs)
// and about 90 more flops for the depth row, into the same 29 sums. At 30x40 and 60x80
// (1,200 and 4,800 pixels a pair) the packs of a 256-pair chunk fit in the
// 50 MB L2, and gather latency plus the per-iteration reduction, barriers
// and solve bound it. At 120x160 the chunk's packs (32 bytes a pixel,
// 157 MB for 256 pairs) do not fit, and every iteration streams them from
// device memory: there bytes bound it (about half the 3.35 TB/s peak,
// measured on an H100 80GB HBM3 at its 700 W limit).
// With a shared source only the targets stream: the keyframe's intensity
// and geometry (20 B a pixel, 6.1 MB at 480x640) stay in L2 for every
// block.
// The design: one thread-block cluster per pair runs the level's whole
// iteration loop, so nothing but the final state and diagnostics goes back
// to device memory, and each pair freezes on its own. One block per pair
// left most of the 132 SMs idle at small B (a pair alone, the 16 targets
// of a tracked chunk, S = 8 streams) and swept a 480x640 level on one SM,
// so a pair's level is spread over `cluster` blocks, a function of the
// level's shape alone (ops/fused_batch.py::cluster_size: 1 at 30x40 and
// 60x80, where the serial tail of each iteration, not the sweep, sets the
// time). Each block sweeps every C-th run of 256 pixels; sums are
// per-thread in registers, then warp shuffles, then a fixed-order pass
// over the warps in shared memory, then the blocks' partial sums in rank
// order through distributed shared memory (linearize_cluster): no
// atomics, so every run gives the same bits, and every block of the
// cluster holds them, runs the same solve and stops at the same iteration.
// Block rank 0 writes the pair's results.
//
// The per-pixel code, the block reduction and the solve live in
// phovo_linearize.cuh, shared with the trust-region kernel
// (fused_tr_batch.cu) and the one-linearization kernel (fused_lin.cu);
// their arithmetic order follows phovo_tpu_torch/ops/fused_batch.py::
// _pixel_columns term by term.

#include "phovo_linearize.cuh"

namespace {

using namespace phovo;

// kCluster: a pair over a cluster of `cluster` blocks (linearize_cluster);
// without it, one block a pair.
template <bool kBilinear, int kLoss, bool kEsm, bool kBi, bool kCluster>
__global__ void __launch_bounds__(kThreads)
fused_gn_batch_kernel(const float* __restrict__ i0_all,     // (B|1, N)
                      const float* __restrict__ geom_all,   // (B|1, 4|6, N)
                      const float* __restrict__ t_all,      // (B, 3|6, H, W)
                      const float* __restrict__ init_states,  // (B, 6)
                      const float* __restrict__ scale_in,   // (B,) delta or sigma
                      const float* __restrict__ depth_gains,  // (B,) kBi only
                      float* __restrict__ states_out,       // (B, 6)
                      float* __restrict__ diag_out,         // (B, 6)
                      int H, int W, float fx, float fy, float cx, float cy,
                      int max_iterations, float min_gradient_norm,
                      float lambda_step, int tdist_burnin,
                      int shared_source, int cluster) {
  constexpr int kRows = kEsm ? 6 : 4;
  constexpr int kCh = kBi ? 6 : 3;
  // one cluster of `cluster` consecutive blocks per pair
  const int pair = kCluster ? blockIdx.x / cluster : blockIdx.x;
  const bool writer = !kCluster || blockIdx.x % cluster == 0;
  const int tid = threadIdx.x;
  const int N = H * W;
  // the source pack: the pair's own, or with shared_source pair 0's, read
  // by every block (a keyframe tracked against by a chunk of frames)
  const int src = shared_source ? 0 : pair;
  const float* i0 = i0_all + static_cast<size_t>(src) * N;
  const float* geom = geom_all + static_cast<size_t>(src) * kRows * N;
  const float* tgt = t_all + static_cast<size_t>(pair) * kCh * N;
  // the pair's depth gain, state-invariant (phovo_tpu's state slot 7)
  const float gain = kBi ? __ldg(depth_gains + pair) : 0.0f;

  __shared__ Terms terms;
  __shared__ float state[6];
  __shared__ float partial[kWarps][kSums];
  __shared__ float slots[2][kSums];
  __shared__ float total[kSums];
  // it, gnorm, cost, nvalid of the pair (fused_batch.py:659-686), and the
  // loss's scale (the Student-t sigma, carried; otherwise robust_delta)
  __shared__ float it, gnorm, cost, nvalid, delta;
  __shared__ int active;
  int parity = 0;

  if (tid == 0) {
    for (int k = 0; k < 6; ++k) state[k] = init_states[pair * 6 + k];
    it = 0.0f;
    gnorm = INFINITY;
    cost = 0.0f;
    nvalid = 0.0f;
    delta = scale_in[pair];
    active = (it < static_cast<float>(max_iterations)) & (gnorm >= min_gradient_norm);
    make_terms(state, &terms);
  }
  __syncthreads();

  if constexpr (kLoss == kTdist) {
    // scale-only passes at the initial state (the first active level)
    for (int b = 0; b < tdist_burnin && max_iterations > 0; ++b) {
      linearize_cluster<kCluster, kBilinear, kLoss, kEsm, kSums>(
          terms, i0, geom, tgt, H, W, fx, fy, cx, cy, delta, cluster, parity,
          partial, slots, total);
      if (tid == 0) delta = tdist_scale_update(total[27], total[28]);
      __syncthreads();
    }
  }

  while (active) {
    linearize_cluster<kCluster, kBilinear, kLoss, kEsm, kSums, kBi>(
        terms, i0, geom, tgt, H, W, fx, fy, cx, cy, delta, cluster, parity,
        partial, slots, total, gain);
    if (tid == 0) {
      float A[6][6], b[6], x[6];
      unpack_jtj(total, A);
      for (int i = 0; i < 6; ++i) b[i] = total[21 + i];
      chol_solve6(A, b, x);
      bool finite = true;
      for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
      if (finite) {
        for (int i = 0; i < 6; ++i) state[i] = state[i] - lambda_step * x[i];
      }
      float g2 = b[0] * b[0];
      for (int i = 1; i < 6; ++i) g2 = g2 + b[i] * b[i];
      it = it + 1.0f;
      gnorm = sqrtf(g2);
      cost = total[27];
      nvalid = total[28];
      if constexpr (kLoss == kTdist) delta = tdist_scale_update(cost, nvalid);
      active = (it < static_cast<float>(max_iterations)) & (gnorm >= min_gradient_norm);
      make_terms(state, &terms);
    }
    __syncthreads();
  }

  if (writer && tid == 0) {
    for (int k = 0; k < 6; ++k) states_out[pair * 6 + k] = state[k];
    diag_out[pair * 6 + 0] = it;
    diag_out[pair * 6 + 1] = isfinite(gnorm) ? gnorm : 0.0f;
    diag_out[pair * 6 + 2] = cost;
    diag_out[pair * 6 + 3] = nvalid;
    diag_out[pair * 6 + 4] = 0.0f;
    diag_out[pair * 6 + 5] = delta;
  }
  cluster_done<kCluster>();
}

}  // namespace

// Launches the level kernel for B pairs on `stream` (a cudaStream_t) as B
// clusters of `cluster` blocks (launch_clusters); the caller owns every
// buffer. loss is a phovo::Loss, esm selects the six-row
// geometry; scale_in holds each pair's loss scale (robust_delta, or the
// Student-t sigma). depth_gains (B,) selects the bi-objective variant with
// a six-channel t_all (nullptr: photometric, three channels); it exists
// for 'none', huber, cauchy and tukey without ESM. shared_source != 0: i0
// (1, N) and geom (1, 4|6, N) are one source read by every pair (the
// photometric level only). diag_out rows are [it,
// ||J^T r||, cost, nvalid, band_masked = 0, scale out]. Returns
// launch_clusters' error, or cudaErrorInvalidValue for a variant that does
// not exist.
extern "C" int phovo_fused_gn_level_batch(
    const float* i0, const float* geom, const float* t_all,
    const float* init_states, const float* scale_in, const float* depth_gains,
    float* states_out, float* diag_out, int B, int H, int W, int bilinear,
    int loss, int esm, int shared_source, int cluster, float fx, float fy,
    float cx, float cy, int max_iterations, float min_gradient_norm,
    float lambda_step, int tdist_burnin, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  auto launch = [&](auto kb, auto kl, auto ke, auto kbi) {
    constexpr bool b = decltype(kb)::value, e = decltype(ke)::value, bi = decltype(kbi)::value;
    constexpr int l = decltype(kl)::value;
    err = launch_clusters(
        fused_gn_batch_kernel<b, l, e, bi, false>, fused_gn_batch_kernel<b, l, e, bi, true>,
        B, cluster, 0, s, i0, geom, t_all, init_states, scale_in, depth_gains,
        states_out, diag_out, H, W, fx, fy, cx, cy, max_iterations,
        min_gradient_norm, lambda_step, tdist_burnin, shared_source, cluster);
  };
  if (depth_gains != nullptr) {
    dispatch_variant<kTukey, false>(
        bilinear, loss, esm,
        [&](auto kb, auto kl, auto ke) { launch(kb, kl, ke, std::true_type{}); });
  } else {
    dispatch_variant<kTdist, true>(
        bilinear, loss, esm,
        [&](auto kb, auto kl, auto ke) { launch(kb, kl, ke, std::false_type{}); });
  }
  return static_cast<int>(err);
}
