// The inverse-compositional level constants of B frames (K-ICpre).
//
// Replaces the TPU kernel phovo_tpu/ops/ic.py::_ic_precompute_kernel
// (wrapper ic_precompute_pallas): at the identity warp, every source
// pixel's packed Jacobian rows J8 = [J0..J5; I0; valid] (the source
// gradient chained with the projection and the rigid columns at zero
// angles, times the depth-range mask), the Gram J0^T J0 + 1e-8 I, and its
// Cholesky factor. The arithmetic follows phovo_tpu/ops/ic.py:548-599 and
// its plain twin phovo_tpu_torch/ops/ic.py::ic_precompute_batch_reference
// term by term: pixel coordinates from the flat index, px = (col - cx) pz /
// fx a true division, pivots sqrt(max(acc, 1e-30)), then a reciprocal and
// products (not K-GN's rsqrt pivots).
//
// What bounds it on an H100: per pixel it reads 16 bytes (intensity, depth,
// two gradients), writes 32 (the eight rows) and does about 90 flops (the
// rows and the 21 Gram products). At under two flops a byte it is bound by
// bytes: the bench chain's three active levels of 257 VGA frames move
// ~311 MB, ~93 us at 3.35 TB/s. One block a frame put too few loads in
// flight for that (257 blocks of 8 warps on 132 SMs at 120x160; a lone
// 480x640 frame on one SM).
// The design: one thread-block cluster of `cluster` blocks per frame
// (ops/ic.py::ic_precompute_cluster_size, a function of the level's shape
// alone), one launch per level for all frames. Block rank r walks pixels
// r * kThreads + tid in steps of cluster * kThreads (neighbouring threads
// on neighbouring pixels, so the loads and the row stores coalesce),
// writes their rows and keeps the 21 Gram sums in registers; block_sum
// reduces them in a fixed order and cluster_block_sum adds the blocks'
// sums in rank order through distributed shared memory (no atomics, the
// same bits every run); the block of rank 0 factors the 6x6 system. Each
// pixel's rows are the same expressions whatever the cluster size, so the
// J8 bits do not depend on it. One block a frame (kCluster false) is the
// pre-cluster kernel.

#include "phovo_linearize.cuh"

namespace {

using namespace phovo;

constexpr int kGram = 21;  // upper triangle of the 6x6 Gram, row-major

template <bool kCluster>
__global__ void __launch_bounds__(kThreads)
ic_precompute_kernel(const float* __restrict__ i0_all,  // (B, N)
                     const float* __restrict__ d0_all,  // (B, N)
                     const float* __restrict__ gx_all,  // (B, N)
                     const float* __restrict__ gy_all,  // (B, N)
                     float* __restrict__ J8_all,        // (B, 8, N)
                     float* __restrict__ L_all,         // (B, 36)
                     int H, int W, float fx, float fy, float cx, float cy,
                     float min_depth, float max_depth, int cluster) {
  // one cluster is `cluster` consecutive blocks; one block a frame when
  // kCluster is false
  const int frame = kCluster ? static_cast<int>(blockIdx.x) / cluster : static_cast<int>(blockIdx.x);
  const int rank = kCluster ? static_cast<int>(blockIdx.x) % cluster : 0;
  const int step = kCluster ? cluster * kThreads : kThreads;
  const int tid = threadIdx.x;
  const int N = H * W;
  const size_t base = static_cast<size_t>(frame) * N;
  const float* i0 = i0_all + base;
  const float* d0 = d0_all + base;
  const float* gx = gx_all + base;
  const float* gy = gy_all + base;
  float* J8 = J8_all + 8 * base;

  __shared__ float partial[kWarps][kGram];
  __shared__ float slots[2][kGram];
  __shared__ float total[kGram];

  float acc[kGram];
#pragma unroll
  for (int k = 0; k < kGram; ++k) acc[k] = 0.0f;
  for (int p = rank * kThreads + tid; p < N; p += step) {
    const float row = static_cast<float>(p / W);
    const float col = static_cast<float>(p % W);
    const float pz = d0[p];
    const float px = (col - cx) * pz / fx;
    const float py = (row - cy) * pz / fy;
    const float validf = ((pz > min_depth) & (pz < max_depth)) ? 1.0f : 0.0f;
    const float safe_z = pz > 1e-12f ? pz : 1e-12f;
    const float iz = 1.0f / safe_z;
    const float a0 = fx * iz;
    const float a2 = -fx * px * iz * iz;
    const float b1 = fy * iz;
    const float b2 = -fy * py * iz * iz;
    const float g_x = gx[p];
    const float g_y = gy[p];
    // rigid columns at zero angles (ZYX): dR/dyaw|0 p = (-py, px, 0),
    // dR/dpitch|0 p = (pz, 0, -px), dR/droll|0 p = (0, -pz, py)
    float j[6];
    j[0] = g_x * a0 * validf;
    j[1] = g_y * b1 * validf;
    j[2] = (g_x * a2 + g_y * b2) * validf;
    j[3] = (g_x * (a0 * -py) + g_y * (b1 * px)) * validf;
    j[4] = (g_x * (a0 * pz + a2 * -px) + g_y * (b2 * -px)) * validf;
    j[5] = (g_x * (a2 * py) + g_y * (b1 * -pz + b2 * py)) * validf;
#pragma unroll
    for (int k = 0; k < 6; ++k) J8[k * N + p] = j[k];
    J8[6 * N + p] = i0[p];
    J8[7 * N + p] = validf;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += j[a] * j[b];
    }
  }
  if constexpr (kCluster) {
    int parity = 0;
    cluster_block_sum<kGram>(acc, cluster, parity, partial, slots, total);
  } else {
    block_sum<kGram>(acc, partial, total);
  }

  if (rank == 0 && tid == 0) {
    float A[6][6];
    int k = 0;
    for (int a = 0; a < 6; ++a) {
      for (int b = a; b < 6; ++b) {
        A[a][b] = total[k];
        A[b][a] = total[k];
        ++k;
      }
      A[a][a] = A[a][a] + 1e-8f;  // a Tikhonov floor keeps the factor finite
    }
    float L[6][6];
    for (int i = 0; i < 6; ++i) {
      float acc_d = A[i][i];
      for (int m = 0; m < i; ++m) acc_d = acc_d - L[i][m] * L[i][m];
      L[i][i] = sqrtf(nan_max(acc_d, 1e-30f));
      const float inv_d = 1.0f / L[i][i];
      for (int r = i + 1; r < 6; ++r) {
        float a = A[r][i];
        for (int m = 0; m < i; ++m) a = a - L[r][m] * L[i][m];
        L[r][i] = a * inv_d;
      }
    }
    float* out = L_all + static_cast<size_t>(frame) * 36;
    for (int i = 0; i < 6; ++i) {
      for (int c = 0; c < 6; ++c) out[i * 6 + c] = c <= i ? L[i][c] : 0.0f;
    }
  }
  cluster_done<kCluster>();
}

}  // namespace

// Launches K-ICpre for B frames on `stream` (a cudaStream_t) as B clusters
// of `cluster` blocks (launch_clusters); the caller owns every buffer: four
// (B, H, W) inputs, J8 (B, 8, H*W) and L (B, 36) row-major lower factors.
// Returns launch_clusters' error: a cluster the card cannot take is
// refused, and nothing runs.
extern "C" int phovo_ic_precompute(const float* i0, const float* d0,
                                   const float* gx, const float* gy,
                                   float* J8, float* L, int B, int H, int W,
                                   int cluster, float fx, float fy, float cx,
                                   float cy, float min_depth, float max_depth,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_clusters(ic_precompute_kernel<false>, ic_precompute_kernel<true>, B,
                                          cluster, 0, s, i0, d0, gx, gy, J8, L, H, W, fx, fy, cx,
                                          cy, min_depth, max_depth, cluster));
}
