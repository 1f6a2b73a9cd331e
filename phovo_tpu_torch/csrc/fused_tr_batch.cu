// One whole trust-region Levenberg-Marquardt pyramid level for B
// independent frame pairs (K-TR).
//
// Replaces two TPU kernels, which compute the same per-pair level:
//   phovo_tpu/ops/fused_batch.py::_fused_tr_batch_kernel (B pairs, the
//     level-major sequence), and
//   phovo_tpu/ops/fused.py::_fused_tr_kernel with _run_tr_loop (one pair,
//     the per-pair aligner): here that is this kernel launched with B = 1;
//   _fused_tr_batch_kernel with shared_src=True (keyframe tracking: one
//     source pack, the keyframe's, read by every pair): here the
//     shared_source flag, which points every block at pair 0's source and
//     changes nothing else, so a shared pack gives the bits of the same
//     pack repeated B times.
// The loop is the reference Ceres backend's per-level solve
// (CPhotoconsistencyOdometryCeres.h:433-500) as phovo_tpu writes it: the
// Levenberg-Marquardt step (J^T J + diag(clip(diag J^T J)) / radius) dx =
// -J^T r, a trial linearization, acceptance when the actual over the
// predicted decrease exceeds min_relative_decrease, Ceres's radius rule,
// and the function, gradient, parameter and radius termination tests.
// Every option is a runtime float32 argument, as the TPU kernels bake them
// in as float32 constants; sampling is bilinear or nearest, photometric,
// with the robust losses huber, cauchy and tukey as IRLS weights at a fixed
// delta (phovo_tpu/ops/fused_batch.py:939-955): the cost is then the
// weighted sum w r^2, and rho is a ratio of such costs, as in phovo_tpu.
// The Student-t loss is refused: its scale changes the cost between
// iterations, which breaks the accept/reject comparison.
//
// What bounds it on an H100: each LM iteration is one linearization (the
// B1 per-pixel code, phovo_linearize.cuh) plus a serial 6x6 solve and a
// dozen scalar tests. At 30x40 to 120x160 it is bound as the GN kernel is
// (gather latency and the per-iteration reduction at the coarse levels,
// bytes at 120x160). The ceres schedules also iterate at 240x320 and
// 480x640, where one pair's packs are 2.4 and 9.8 MB and a 256-pair chunk
// streams 0.6 and 2.5 GB from device memory per iteration.
// The design: one thread-block cluster per pair keeps the level's whole
// loop on chip, and each pair freezes on its own. One block per pair left
// 116-131 of the 132 SMs idle at the small batches that keyframe tracking
// (16 targets), loop closures and the per-pair route (B = 1) launch, and
// swept a 480x640 level's 307,200 pixels on one SM. So a pair's level is
// spread over a cluster of `cluster` blocks (ops/fused_batch.py::
// cluster_size, a function of the level's shape alone: 1 at the coarse
// levels, whose time is the serial tail, more where the pixel sweep is
// long): each block sweeps every C-th run of 256 pixels, the partial sums
// meet through distributed shared memory in rank order
// (linearize_cluster), and every block then runs the same solve and tests
// on the same bits, so the blocks agree on the state and on every stop
// without a broadcast. Block rank 0 writes the pair's results.
//
// Arithmetic order follows phovo_tpu_torch/ops/fused_batch.py::
// fused_tr_level_batch_reference; the maxima propagate NaN as jnp.maximum
// does (fmaxf would drop it).

#include "phovo_linearize.cuh"

namespace {

using namespace phovo;

struct TROptions {
  int max_iterations;
  float function_tolerance;
  float gradient_tolerance;
  float parameter_tolerance;
  float initial_radius;
  float max_radius;
  float min_radius;
  float min_relative_decrease;
};

// max |g_k| over the six gradient entries (NaN if any is NaN)
__device__ __forceinline__ float max_abs6(const float* g) {
  float m = 0.0f;
  for (int k = 0; k < 6; ++k) m = nan_max(m, fabsf(g[k]));
  return m;
}

// kCluster: a pair over a cluster of `cluster` blocks (linearize_cluster);
// without it, one block a pair. The cluster instantiations ask for three
// blocks an SM (at most 80 registers a thread), which ran them 3-10%
// faster on an H100 (PERF.md); the one-block ones set no minimum (0), as
// the kernel had none before the cluster layout: a minimum of 1 already
// changes their machine code.
template <bool kBilinear, int kLoss, bool kCluster>
__global__ void __launch_bounds__(kThreads, kCluster ? 3 : 0)
fused_tr_batch_kernel(const float* __restrict__ i0_all,     // (B|1, N)
                      const float* __restrict__ geom_all,   // (B|1, 4, N)
                      const float* __restrict__ t_all,      // (B, 3, H, W)
                      const float* __restrict__ init_states,  // (B, 6)
                      float* __restrict__ states_out,       // (B, 6)
                      float* __restrict__ diag_out,         // (B, 6)
                      int H, int W, float fx, float fy, float cx, float cy,
                      float delta, TROptions opts, int shared_source,
                      int cluster) {
  // one cluster of `cluster` consecutive blocks per pair
  const int pair = kCluster ? blockIdx.x / cluster : blockIdx.x;
  const bool writer = !kCluster || blockIdx.x % cluster == 0;
  const int tid = threadIdx.x;
  const int N = H * W;
  // the pair's own source pack, or pair 0's read by every block
  const int src = shared_source ? 0 : pair;
  const float* i0 = i0_all + static_cast<size_t>(src) * N;
  const float* geom = geom_all + static_cast<size_t>(src) * 4 * N;
  const float* tgt = t_all + static_cast<size_t>(pair) * 3 * N;

  __shared__ Terms terms;
  __shared__ float state[6];
  __shared__ float trial[6];
  __shared__ float step[6];
  __shared__ float partial[kWarps][kSums];
  __shared__ float slots[2][kSums];
  __shared__ float total[kSums];
  // the last ACCEPTED linearization: 21 JtJ, 6 Jtr, cost, nvalid
  __shared__ float ne[kSums];
  __shared__ float it, radius;
  __shared__ int active;
  int parity = 0;

  if (tid == 0) {
    for (int k = 0; k < 6; ++k) state[k] = init_states[pair * 6 + k];
    make_terms(state, &terms);
  }
  __syncthreads();
  linearize_cluster<kCluster, kBilinear, kLoss, false, kSums>(
      terms, i0, geom, tgt, H, W, fx, fy, cx, cy, delta, cluster, parity,
      partial, slots, total);
  if (tid == 0) {
    for (int k = 0; k < kSums; ++k) ne[k] = total[k];
    it = 0.0f;
    radius = opts.initial_radius;
    const bool done = max_abs6(ne + 21) <= opts.gradient_tolerance;
    active = (it < static_cast<float>(opts.max_iterations)) & !done;
  }
  __syncthreads();

  while (active) {
    // 1-2. the LM step from the accepted normal equations; trial state
    if (tid == 0) {
      float A[6][6], neg_b[6], x[6];
      unpack_jtj(ne, A);
      const float inv_radius = 1.0f / radius;
      for (int i = 0; i < 6; ++i) {
        const float d = A[i][i];
        const float clipped = isnan(d) ? d : fminf(fmaxf(d, 1e-12f), 1e32f);
        A[i][i] = d + clipped * inv_radius;
        neg_b[i] = -ne[21 + i];
      }
      chol_solve6(A, neg_b, x);
      bool finite = true;
      for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
      for (int i = 0; i < 6; ++i) {
        step[i] = finite ? x[i] : 0.0f;
        trial[i] = state[i] + step[i];
      }
      make_terms(trial, &terms);
    }
    __syncthreads();
    // 3. linearize at the trial state
    linearize_cluster<kCluster, kBilinear, kLoss, false, kSums>(
        terms, i0, geom, tgt, H, W, fx, fy, cx, cy, delta, cluster, parity,
        partial, slots, total);
    // 4-6. ratio test, radius rule, keep or drop the trial, termination
    if (tid == 0) {
      float A[6][6];
      unpack_jtj(ne, A);
      const float cost = 0.5f * ne[27];
      const float new_cost = 0.5f * total[27];
      float sb = step[0] * ne[21];
      for (int i = 1; i < 6; ++i) sb = sb + step[i] * ne[21 + i];
      float sAs = 0.0f;
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j) sAs = sAs + step[i] * A[i][j] * step[j];
      }
      const float predicted = nan_max(-sb - 0.5f * sAs, 1e-30f);
      const float rho = (cost - new_cost) / predicted;
      const bool accept = rho > opts.min_relative_decrease;
      const float t = 2.0f * rho - 1.0f;
      const float grow =
          radius / nan_max(static_cast<float>(1.0 / 3.0), 1.0f - t * (t * t));
      const float new_radius =
          accept ? nan_min(grow, opts.max_radius) : radius * 0.5f;

      float x2 = state[0] * state[0];
      float s2 = step[0] * step[0];
      for (int k = 1; k < 6; ++k) {
        x2 = x2 + state[k] * state[k];
        s2 = s2 + step[k] * step[k];
      }
      if (accept) {
        for (int k = 0; k < 6; ++k) state[k] = trial[k];
        for (int k = 0; k < kSums; ++k) ne[k] = total[k];
      }
      const bool f_done =
          accept & (fabsf(cost - new_cost) <= opts.function_tolerance * cost);
      const bool g_done = max_abs6(ne + 21) <= opts.gradient_tolerance;
      const bool p_done =
          accept & (sqrtf(s2) <= opts.parameter_tolerance *
                                     (sqrtf(x2) + opts.parameter_tolerance));
      const bool r_done = new_radius < opts.min_radius;
      it = it + 1.0f;
      radius = new_radius;
      active = (it < static_cast<float>(opts.max_iterations)) &
               !(f_done | g_done | p_done | r_done);
    }
    __syncthreads();
  }

  if (writer && tid == 0) {
    for (int k = 0; k < 6; ++k) states_out[pair * 6 + k] = state[k];
    diag_out[pair * 6 + 0] = it;
    diag_out[pair * 6 + 1] = max_abs6(ne + 21);
    diag_out[pair * 6 + 2] = 0.5f * ne[27];
    diag_out[pair * 6 + 3] = ne[28];
    diag_out[pair * 6 + 4] = radius;
    diag_out[pair * 6 + 5] = 0.0f;
  }
  cluster_done<kCluster>();
}

}  // namespace

// Launches the trust-region level kernel for B pairs on `stream` (a
// cudaStream_t) as B clusters of `cluster` blocks (launch_clusters); the
// caller owns every buffer. loss is a phovo::Loss other than kTdist, at
// scale delta. shared_source != 0: i0 (1, N) and geom (1, 4, N) are one
// source read by every pair. diag_out rows are [it, max|J^T r|, 0.5 cost,
// nvalid, radius, band_masked = 0]. Returns launch_clusters' error, or
// cudaErrorInvalidValue for a variant that does not exist.
extern "C" int phovo_fused_tr_level_batch(
    const float* i0, const float* geom, const float* t_all,
    const float* init_states, float* states_out, float* diag_out, int B, int H,
    int W, int bilinear, int loss, int shared_source, int cluster, float delta,
    float fx, float fy, float cx, float cy, int max_iterations,
    float function_tolerance, float gradient_tolerance,
    float parameter_tolerance, float initial_radius, float max_radius,
    float min_radius, float min_relative_decrease, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TROptions opts{max_iterations,      function_tolerance,
                       gradient_tolerance,  parameter_tolerance,
                       initial_radius,      max_radius,
                       min_radius,          min_relative_decrease};
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_variant<kTukey, false>(bilinear, loss, 0, [&](auto kb, auto kl, auto) {
    constexpr bool b = decltype(kb)::value;
    constexpr int l = decltype(kl)::value;
    err = launch_clusters(fused_tr_batch_kernel<b, l, false>, fused_tr_batch_kernel<b, l, true>, B,
                          cluster, 0, s, i0, geom, t_all, init_states, states_out, diag_out, H, W,
                          fx, fy, cx, cy, delta, opts, shared_source, cluster);
  });
  return static_cast<int>(err);
}
