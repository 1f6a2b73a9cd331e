// One whole inverse-compositional Gauss-Newton level for B independent
// frame pairs (K-IC).
//
// Replaces two TPU kernels, which compute the same per-pair level:
//   phovo_tpu/ops/ic_batch.py::_ic_gn_batch_kernel (B pairs, the IC
//     level-major sequence), and
//   phovo_tpu/ops/ic.py::_ic_gn_kernel (one pair, the per-pair aligner):
//     here that is this kernel launched with B = 1.
// Per iteration and pixel: the hoisted source point goes through the pose
// R|t and is projected; ONE target channel (the intensity) is sampled,
// nearest or bilinear; r = (I1w - I0) valid; then g = J0^T r, the cost and
// the valid count. One thread solves against the frozen Cholesky factor
// (reciprocal pivots, phovo_tpu/ops/ic.py:134-152) and composes
// T <- T . T(lambda delta)^-1 in scalar matrix form (:99-131), keeping T
// when the step is not finite. A pair stops once ||g|| falls below the
// threshold or its budget is spent. The arithmetic follows the plain twin
// phovo_tpu_torch/ops/ic_batch.py::_level_pass term by term. It computes
// what the TPU kernel computes, not its layout: the TPU samples through
// one-hot MXU matmuls against a banded row window; here the target is read
// by direct gather, so nothing is masked and band_masked is always 0.
//
// What bounds it on an H100: per pixel and iteration it reads 48 bytes
// (three geometry rows, the eight J8 rows, one scattered target sample)
// and does about 45 flops (58 bilinear), so it is bound by bytes where the
// pairs' packs do not fit in the 50 MB L2: the bench chain's 256 pairs
// hold ~310 MB at its three active levels, and at 120x160 every iteration
// streamed them from device memory again; one pair alone ran its level on
// one SM of 132.
// The design: one thread-block cluster of `cluster` blocks per pair
// (ops/ic_batch.py::ic_cluster_size, a function of the level's shape
// alone) runs the level's whole iteration loop, so only the final pose and
// diagnostics go back to device memory, and each pair stops on its own.
// Block rank r sweeps pixels r * kThreads + tid in steps of cluster *
// kThreads; each block reduces its sums with block_sum, and
// cluster_block_sum adds the blocks' sums in rank order through
// distributed shared memory, so every block holds the same bits and runs
// the same solve, update and stop test: no broadcast, no atomics, the same
// bits every run. Where the block's share of the pack (geometry rows 0-2
// and J8 rows 0-7, 44 bytes a pixel) fits in dynamic shared memory
// (ops/ic_batch.py::ic_resident), the block copies it in once at the
// level's start and every iteration reads it there: only the target
// gather goes to device memory. A thread keeps its pixels and their order
// either way, so a resident level gives the bits of a streamed one at the
// same cluster size. One block a pair (kCluster false) streaming its pack
// is the pre-cluster kernel's per-pixel order.

#include "phovo_linearize.cuh"

namespace {

using namespace phovo;

constexpr int kIcSums = 8;  // g (6), cost, nvalid

// The target intensity at the warped point (u, v) of one pixel, from an
// (H, W) image; returns the in-bounds test. Nearest rounds half to even
// (rintf, as jnp.round and torch.round). Bilinear: in bounds means u in
// [0, W) and v in [0, H); the +1 taps clamp to the last column or row.
template <bool kBilinear>
static __device__ __forceinline__ bool sample_intensity(const float* __restrict__ t, int H, int W,
                                                        float u, float v, float* I) {
  if (!kBilinear) {
    const float c0 = rintf(u);
    const float r0 = rintf(v);
    *I = __ldg(t + clamp_index(r0, H) * W + clamp_index(c0, W));
    return (c0 >= 0.0f) & (c0 <= static_cast<float>(W - 1)) & (r0 >= 0.0f) &
           (r0 <= static_cast<float>(H - 1));
  }
  const float c0 = floorf(u);
  const float r0 = floorf(v);
  const float fc = u - c0;
  const float fr = v - r0;
  const int cl = clamp_index(c0, W), ch = clamp_index(c0 + 1.0f, W);
  const int rl = clamp_index(r0, H), rh = clamp_index(r0 + 1.0f, H);
  const float top = __ldg(t + rl * W + cl) * (1.0f - fc) + __ldg(t + rl * W + ch) * fc;
  const float bot = __ldg(t + rh * W + cl) * (1.0f - fc) + __ldg(t + rh * W + ch) * fc;
  *I = top * (1.0f - fr) + bot * fr;
  return (u >= 0.0f) & (u < static_cast<float>(W)) & (v >= 0.0f) &
         (v < static_cast<float>(H));
}

// T <- T . T(lam * delta)^-1 with a ZYX-Euler delta; pose = [R row-major
// (9), t (3)], updated in place (phovo_tpu/ops/ic.py:99-131, in its order).
static __device__ void compose_inverse_update(float* pose, const float* delta, float lam) {
  const float dx = lam * delta[0], dy = lam * delta[1], dz = lam * delta[2];
  const float dyaw = lam * delta[3], dpitch = lam * delta[4], droll = lam * delta[5];
  const float cy = cosf(dyaw), sy = sinf(dyaw);
  const float cp = cosf(dpitch), sp = sinf(dpitch);
  const float cr = cosf(droll), sr = sinf(droll);
  const float D00 = cy * cp, D01 = cy * sp * sr - sy * cr, D02 = cy * sp * cr + sy * sr;
  const float D10 = sy * cp, D11 = sy * sp * sr + cy * cr, D12 = sy * sp * cr - cy * sr;
  const float D20 = -sp, D21 = cp * sr, D22 = cp * cr;
  // T(d)^-1 = [D^T, -D^T t_d]
  const float I00 = D00, I01 = D10, I02 = D20;
  const float I10 = D01, I11 = D11, I12 = D21;
  const float I20 = D02, I21 = D12, I22 = D22;
  const float it0 = -(I00 * dx + I01 * dy + I02 * dz);
  const float it1 = -(I10 * dx + I11 * dy + I12 * dz);
  const float it2 = -(I20 * dx + I21 * dy + I22 * dz);
  const float R00 = pose[0], R01 = pose[1], R02 = pose[2];
  const float R10 = pose[3], R11 = pose[4], R12 = pose[5];
  const float R20 = pose[6], R21 = pose[7], R22 = pose[8];
  const float t0 = pose[9], t1 = pose[10], t2 = pose[11];
  pose[0] = R00 * I00 + R01 * I10 + R02 * I20;
  pose[1] = R00 * I01 + R01 * I11 + R02 * I21;
  pose[2] = R00 * I02 + R01 * I12 + R02 * I22;
  pose[3] = R10 * I00 + R11 * I10 + R12 * I20;
  pose[4] = R10 * I01 + R11 * I11 + R12 * I21;
  pose[5] = R10 * I02 + R11 * I12 + R12 * I22;
  pose[6] = R20 * I00 + R21 * I10 + R22 * I20;
  pose[7] = R20 * I01 + R21 * I11 + R22 * I21;
  pose[8] = R20 * I02 + R21 * I12 + R22 * I22;
  pose[9] = R00 * it0 + R01 * it1 + R02 * it2 + t0;
  pose[10] = R10 * it0 + R11 * it1 + R12 * it2 + t1;
  pose[11] = R20 * it0 + R21 * it1 + R22 * it2 + t2;
}

// The rows a block keeps of each of its pixels when its pack is resident:
// geometry rows 0-2, then J8 rows 0-7.
constexpr int kPackRows = 11;

// Floats of one resident row: the pixels of the cluster's block with the
// most, rounded up to whole sweeps of kThreads (the thread's j-th pixel
// sits at j * kThreads + tid). ops/ic_batch.py::ic_pack_bytes is
// kPackRows * 4 bytes of this.
static __host__ __device__ __forceinline__ int pack_slots(int N, int cluster) {
  const int sweep = cluster * kThreads;
  return (N + sweep - 1) / sweep * kThreads;
}

template <bool kBilinear, bool kCluster, bool kResident>
__global__ void __launch_bounds__(kThreads)
ic_gn_batch_kernel(const float* __restrict__ state_in,  // (B, 12) [R, t]
                   const float* __restrict__ geom_all,  // (B, 4, N); row 3 unread
                   const float* __restrict__ J8_all,    // (B, 8, N)
                   const float* __restrict__ L_all,     // (B, 36)
                   const float* __restrict__ t_all,     // (B, H, W)
                   float* __restrict__ state_out,       // (B, 12)
                   float* __restrict__ diag_out,        // (B, 4)
                   int H, int W, float fx, float fy, float cx, float cy,
                   int max_iterations, float min_gradient_norm,
                   float lambda_step, int cluster) {
  // one cluster is `cluster` consecutive blocks; one block a pair when
  // kCluster is false
  const int pair = kCluster ? static_cast<int>(blockIdx.x) / cluster : static_cast<int>(blockIdx.x);
  const int rank = kCluster ? static_cast<int>(blockIdx.x) % cluster : 0;
  const int step = kCluster ? cluster * kThreads : kThreads;
  const int tid = threadIdx.x;
  const int N = H * W;
  const float* geom = geom_all + static_cast<size_t>(pair) * 4 * N;
  const float* J8 = J8_all + static_cast<size_t>(pair) * 8 * N;
  const float* tgt = t_all + static_cast<size_t>(pair) * N;

  __shared__ float pose[12];
  __shared__ float L[36];
  __shared__ float inv_diag[6];
  __shared__ float partial[kWarps][kIcSums];
  __shared__ float slots[2][kIcSums];
  __shared__ float total[kIcSums];
  __shared__ float it, gnorm, cost, nvalid;
  __shared__ int active;
  // the resident pack: kPackRows rows of pack_slots(N, cluster) floats
  extern __shared__ float pack[];
  const int S = kResident ? pack_slots(N, cluster) : 0;
  int parity = 0;

  if constexpr (kResident) {
    // each thread copies, and later reads, only its own slots: no barrier
    for (int p = rank * kThreads + tid, q = tid; p < N; p += step, q += kThreads) {
      pack[q] = geom[p];
      pack[S + q] = geom[N + p];
      pack[2 * S + q] = geom[2 * N + p];
#pragma unroll
      for (int k = 0; k < 8; ++k) pack[(3 + k) * S + q] = J8[k * N + p];
    }
  }
  if (tid == 0) {
    for (int k = 0; k < 12; ++k) pose[k] = state_in[pair * 12 + k];
    for (int k = 0; k < 36; ++k) L[k] = L_all[pair * 36 + k];
    // the factor is frozen for the level: its reciprocal pivots once
    for (int i = 0; i < 6; ++i) inv_diag[i] = 1.0f / L[i * 6 + i];
    it = 0.0f;
    gnorm = INFINITY;
    cost = 0.0f;
    nvalid = 0.0f;
    active = (it < static_cast<float>(max_iterations)) & (gnorm >= min_gradient_norm);
  }
  __syncthreads();

  while (active) {
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
    float acc[kIcSums];
#pragma unroll
    for (int k = 0; k < kIcSums; ++k) acc[k] = 0.0f;
    for (int p = rank * kThreads + tid, q = tid; p < N; p += step, q += kThreads) {
      // the pixel's row k: J8 row k (k = 0..7), or geometry row k - 8
      auto row = [&](int k) {
        if constexpr (kResident) {
          return pack[(k < 8 ? 3 + k : k - 8) * S + q];
        } else {
          return k < 8 ? J8[k * N + p] : geom[(k - 8) * N + p];
        }
      };
      const float px = row(8), py = row(9), pz = row(10);
      const float tx = R[0] * px + R[1] * py + R[2] * pz + t[0];
      const float ty = R[3] * px + R[4] * py + R[5] * pz + t[1];
      const float tz = R[6] * px + R[7] * py + R[8] * pz + t[2];
      const float safe_z = fabsf(tz) > 1e-12f ? tz : 1e-12f;
      const float iz = 1.0f / safe_z;
      const float u = tx * fx * iz + cx;
      const float v = ty * fy * iz + cy;
      float i1w;
      const bool inb = sample_intensity<kBilinear>(tgt, H, W, u, v, &i1w);
      const bool valid = (row(7) > 0.5f) & (tz > 0.0f) & inb;
      const float validf = valid ? 1.0f : 0.0f;
      const float r = (i1w - row(6)) * validf;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc[k] += row(k) * r;
      acc[6] += r * r;
      acc[7] += validf;
    }
    if constexpr (kCluster) {
      cluster_block_sum<kIcSums>(acc, cluster, parity, partial, slots, total);
    } else {
      block_sum<kIcSums>(acc, partial, total);
    }
    // every block of the cluster holds the same total: each runs the same
    // solve, update and stop test
    if (tid == 0) {
      float ys[6], xs[6];
      for (int i = 0; i < 6; ++i) {
        float a = total[i];
        for (int k = 0; k < i; ++k) a = a - L[i * 6 + k] * ys[k];
        ys[i] = a * inv_diag[i];
      }
      for (int i = 5; i >= 0; --i) {
        float a = ys[i];
        for (int k = i + 1; k < 6; ++k) a = a - L[k * 6 + i] * xs[k];
        xs[i] = a * inv_diag[i];
      }
      bool finite = true;
      for (int i = 0; i < 6; ++i) finite = finite && isfinite(xs[i]);
      if (finite) compose_inverse_update(pose, xs, lambda_step);
      float g2 = total[0] * total[0];
      for (int i = 1; i < 6; ++i) g2 = g2 + total[i] * total[i];
      it = it + 1.0f;
      gnorm = sqrtf(g2);
      cost = total[6];
      nvalid = total[7];
      active = (it < static_cast<float>(max_iterations)) & (gnorm >= min_gradient_norm);
    }
    __syncthreads();
  }

  if (rank == 0 && tid == 0) {
    for (int k = 0; k < 12; ++k) state_out[pair * 12 + k] = pose[k];
    diag_out[pair * 4 + 0] = it;
    diag_out[pair * 4 + 1] = isfinite(gnorm) ? gnorm : 0.0f;
    diag_out[pair * 4 + 2] = cost;
    diag_out[pair * 4 + 3] = nvalid;
  }
  cluster_done<kCluster>();
}

}  // namespace

// Launches K-IC for B pairs on `stream` (a cudaStream_t) as B clusters of
// `cluster` blocks (launch_clusters), each block's share of the pack
// resident in shared memory when `resident` is not 0; the caller owns
// every buffer. state rows are [R row-major (9), t (3)]; diag_out rows are
// [it, ||J0^T r||, cost, nvalid]. Returns launch_clusters' error: a
// cluster or a resident pack the card cannot take is refused, and nothing
// runs.
extern "C" int phovo_ic_gn_level_batch(
    const float* state_in, const float* geom, const float* J8, const float* L,
    const float* t_i, float* state_out, float* diag_out, int B, int H, int W,
    int bilinear, int cluster, int resident, float fx, float fy, float cx,
    float cy, int max_iterations, float min_gradient_norm, float lambda_step,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      resident ? sizeof(float) * kPackRows * static_cast<size_t>(pack_slots(H * W, cluster)) : 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto launch = [&](auto kb, auto kr) {
    constexpr bool b = decltype(kb)::value, r = decltype(kr)::value;
    err = launch_clusters(ic_gn_batch_kernel<b, false, r>, ic_gn_batch_kernel<b, true, r>, B,
                          cluster, smem, s, state_in, geom, J8, L, t_i, state_out, diag_out, H,
                          W, fx, fy, cx, cy, max_iterations, min_gradient_norm, lambda_step,
                          cluster);
  };
  if (bilinear) {
    resident ? launch(std::true_type{}, std::true_type{}) : launch(std::true_type{}, std::false_type{});
  } else {
    resident ? launch(std::false_type{}, std::true_type{}) : launch(std::false_type{}, std::false_type{});
  }
  return static_cast<int>(err);
}
