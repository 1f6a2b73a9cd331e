// Per-pixel device code shared by the level kernels (fused_gn_batch.cu,
// fused_tr_batch.cu, fused_lin.cu): the state's rotation terms, target
// sampling, one pixel's residual and Jacobian row with its robust (IRLS)
// weight and ESM gradient (and, for the bi-objective level, its depth
// residual and row), the block reduction of the normal equations and its
// cluster form (one pair over a thread-block cluster, for K-GN and K-TR),
// the 6x6 Cholesky solve, and the host-side dispatch over the variants and
// the cluster launch. The inverse-compositional kernels (ic_precompute.cu,
// ic_gn_batch.cu) share its block size, block_sum, cluster_block_sum, the
// cluster launch, clamp_index and nan_max.
//
// Arithmetic order follows phovo_tpu_torch/ops/fused_batch.py::
// _pixel_columns and ops/robust.py term by term; build with -fmad=false and
// IEEE division and square root (nvcc's defaults, no --use_fast_math) so no
// multiply-add is contracted and the per-pixel values equal the plain torch
// version's. Every function has internal linkage, so each translation unit
// that includes this header gets its own copy.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>
#include <utility>

namespace phovo {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 21 JtJ entries (upper triangle, row-major), 6 Jtr, cost, nvalid
constexpr int kSums = 29;
// kSums and the 6 sums J_i * valid: the whole 8x8 Gram of [J0..J5, r, valid]
constexpr int kGramSums = 35;

// Robust losses (ops/robust.py LOSSES, in its order), template parameters of
// the per-pixel code: the loss-free kernels compile to the code they had
// before the losses existed.
enum Loss : int { kNone = 0, kHuber = 1, kCauchy = 2, kTukey = 3, kTdist = 4 };

// Floor of the Student-t scale (ops/robust.py TDIST_MIN_SCALE).
constexpr float kTdistMinScale = 1e-4f;

// jnp.maximum / jnp.minimum: a NaN operand wins (fmaxf would drop it).
static __device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

static __device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// One fixed-point step of the Student-t scale from a linearization's
// weighted cost sum w r^2 and valid count (ops/robust.py tdist_scale_update).
static __device__ __forceinline__ float tdist_scale_update(float cost, float nvalid) {
  return nan_max(sqrtf(cost / nan_max(nvalid, 1.0f)), kTdistMinScale);
}

// sqrt of the IRLS weight w(r) of one residual at scale delta (the loss's
// delta, or the Student-t sigma), in ops/robust.py's order of operations.
template <int kLoss>
static __device__ __forceinline__ float sqrt_weight(float r, float delta) {
  static_assert(kLoss != kNone, "loss 'none' has no weight");
  if constexpr (kLoss == kHuber) {
    return sqrtf(fminf(delta / fmaxf(fabsf(r), 1e-12f), 1.0f));
  } else {
    const float t = r / delta;
    const float q = t * t;
    if constexpr (kLoss == kCauchy) {
      return sqrtf(1.0f / (1.0f + q));
    } else if constexpr (kLoss == kTukey) {
      const float c = fmaxf(1.0f - q, 0.0f);
      return sqrtf(c * c);
    } else {
      // (nu + 1) / (nu + q), nu = 5, as torch evaluates a float over a
      // tensor: the reciprocal, then the product
      return sqrtf((1.0f / (5.0f + q)) * 6.0f);
    }
  }
}

// The state's ZYX rotation and the derivative rows of the Jacobian
// (fused_batch.py:269-283), computed once per linearization by thread 0.
struct Terms {
  float s0, s1, s2;
  float R[9];
  float dY[6];
  float dP[9];
  float dR[6];
};

static __device__ void make_terms(const float* s, Terms* t) {
  const float cyw = cosf(s[3]), syw = sinf(s[3]);
  const float cp = cosf(s[4]), sp = sinf(s[4]);
  const float cr = cosf(s[5]), sr = sinf(s[5]);
  t->s0 = s[0];
  t->s1 = s[1];
  t->s2 = s[2];
  t->R[0] = cyw * cp;
  t->R[1] = cyw * sp * sr - syw * cr;
  t->R[2] = cyw * sp * cr + syw * sr;
  t->R[3] = syw * cp;
  t->R[4] = syw * sp * sr + cyw * cr;
  t->R[5] = syw * sp * cr - cyw * sr;
  t->R[6] = -sp;
  t->R[7] = cp * sr;
  t->R[8] = cp * cr;
  t->dY[0] = -syw * cp;
  t->dY[1] = -syw * sp * sr - cyw * cr;
  t->dY[2] = -syw * sp * cr + cyw * sr;
  t->dY[3] = cyw * cp;
  t->dY[4] = cyw * sp * sr - syw * cr;
  t->dY[5] = cyw * sp * cr + syw * sr;
  t->dP[0] = -cyw * sp;
  t->dP[1] = cyw * cp * sr;
  t->dP[2] = cyw * cp * cr;
  t->dP[3] = -syw * sp;
  t->dP[4] = syw * cp * sr;
  t->dP[5] = syw * cp * cr;
  t->dP[6] = -cp;
  t->dP[7] = -sp * sr;
  t->dP[8] = -sp * cr;
  t->dR[0] = cyw * sp * cr + syw * sr;
  t->dR[1] = -cyw * sp * sr + syw * cr;
  t->dR[2] = syw * sp * cr - cyw * sr;
  t->dR[3] = -syw * sp * sr - cyw * cr;
  t->dR[4] = cp * cr;
  t->dR[5] = -cp * sr;
}

// Clamp to [0, n-1] in float, then convert. fmaxf/fminf return the non-NaN
// operand, so a NaN coordinate lands on index 0 and never reads out of range.
static __device__ __forceinline__ int clamp_index(float x, int n) {
  return static_cast<int>(fminf(fmaxf(x, 0.0f), static_cast<float>(n - 1)));
}

// Target samples (I, gx, gy) at the warped point (u, v) of one pixel, from a
// (3, H, W) stack; returns the in-bounds test. Nearest rounds half to even
// (rintf, as jnp.round and torch.round; never roundf). Bilinear: in bounds
// means u in [0, W) and v in [0, H); the +1 taps clamp to the last column
// or row; no zero padding. The bi-objective level samples its depth
// channels [D, dgx, dgy] with a second call on the stack's channels 3-5,
// at the same taps.
template <bool kBilinear>
static __device__ __forceinline__ bool sample_target(const float* __restrict__ t,
                                                     int H, int W, float u, float v,
                                                     float* I, float* gx, float* gy) {
  const int HW = H * W;
  if (!kBilinear) {
    const float c0 = rintf(u);
    const float r0 = rintf(v);
    const int off = clamp_index(r0, H) * W + clamp_index(c0, W);
    *I = __ldg(t + off);
    *gx = __ldg(t + HW + off);
    *gy = __ldg(t + 2 * HW + off);
    return (c0 >= 0.0f) & (c0 <= static_cast<float>(W - 1)) & (r0 >= 0.0f) &
           (r0 <= static_cast<float>(H - 1));
  }
  const float c0 = floorf(u);
  const float r0 = floorf(v);
  const float fc = u - c0;
  const float fr = v - r0;
  const int cl = clamp_index(c0, W), ch = clamp_index(c0 + 1.0f, W);
  const int rl = clamp_index(r0, H), rh = clamp_index(r0 + 1.0f, H);
  const int o00 = rl * W + cl, o01 = rl * W + ch;
  const int o10 = rh * W + cl, o11 = rh * W + ch;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* p = t + c * HW;
    const float top = __ldg(p + o00) * (1.0f - fc) + __ldg(p + o01) * fc;
    const float bot = __ldg(p + o10) * (1.0f - fc) + __ldg(p + o11) * fc;
    out[c] = top * (1.0f - fr) + bot * fr;
  }
  *I = out[0];
  *gx = out[1];
  *gy = out[2];
  return (u >= 0.0f) & (u < static_cast<float>(W)) & (v >= 0.0f) &
         (v < static_cast<float>(H));
}

// Residual and the six Jacobian columns of one source pixel at the state
// held in t, weighted by sqrt(w(r)) under kLoss (scale delta), added into
// acc[kN]. kEsm averages the sampled target gradient with the source
// gradient (sgx, sgy: geometry rows 4 and 5). kN == kGramSums also sums each
// column times the valid flag (the Gram's last row). kBi adds the
// bi-objective depth residual and row (six-channel target, depth gain
// `gain`) into the same sums, pixel by pixel; the valid count is the
// intensity's, counted once.
template <bool kBilinear, int kLoss, bool kEsm, int kN, bool kBi>
static __device__ __forceinline__ void accumulate_pixel(
    const Terms& t, float px, float py, float pz, float vd, float sgx,
    float sgy, float i0, const float* __restrict__ tgt, int H, int W,
    float fx, float fy, float cx, float cy, float delta, float gain,
    float* acc) {
  static_assert(!(kBi && (kEsm || kLoss == kTdist || kN != kSums)),
                "the bi-objective level is photometric GN only: no ESM, no Student-t, no Gram row");
  const float tx = t.R[0] * px + t.R[1] * py + t.R[2] * pz + t.s0;
  const float ty = t.R[3] * px + t.R[4] * py + t.R[5] * pz + t.s1;
  const float tz = t.R[6] * px + t.R[7] * py + t.R[8] * pz + t.s2;
  const float safe_z = fabsf(tz) > 1e-12f ? tz : 1e-12f;
  const float iz = 1.0f / safe_z;
  const float u = tx * fx * iz + cx;
  const float v = ty * fy * iz + cy;

  const float ry0 = t.dY[0] * px + t.dY[1] * py + t.dY[2] * pz;
  const float ry1 = t.dY[3] * px + t.dY[4] * py + t.dY[5] * pz;
  const float rp0 = t.dP[0] * px + t.dP[1] * py + t.dP[2] * pz;
  const float rp1 = t.dP[3] * px + t.dP[4] * py + t.dP[5] * pz;
  const float rp2 = t.dP[6] * px + t.dP[7] * py + t.dP[8] * pz;
  const float rr0 = t.dR[0] * py + t.dR[1] * pz;
  const float rr1 = t.dR[2] * py + t.dR[3] * pz;
  const float rr2 = t.dR[4] * py + t.dR[5] * pz;
  const float a0 = fx * iz;
  const float a2 = -fx * tx * iz * iz;
  const float b1 = fy * iz;
  const float b2 = -fy * ty * iz * iz;
  const float Ju3 = a0 * ry0;
  const float Ju4 = a0 * rp0 + a2 * rp2;
  const float Ju5 = a0 * rr0 + a2 * rr2;
  const float Jv3 = b1 * ry1;
  const float Jv4 = b1 * rp1 + b2 * rp2;
  const float Jv5 = b1 * rr1 + b2 * rr2;

  float i1w, gxw, gyw;
  const bool inb = sample_target<kBilinear>(tgt, H, W, u, v, &i1w, &gxw, &gyw);
  if constexpr (kEsm) {
    gxw = 0.5f * (gxw + sgx);
    gyw = 0.5f * (gyw + sgy);
  }
  const bool valid = (vd > 0.5f) & (tz > 0.0f) & inb;
  const float validf = valid ? 1.0f : 0.0f;
  const float resid = (i1w - i0) * validf;
  // row scale s and weighted residual r_w (s = valid, r_w = r without a loss)
  float s, rw;
  if constexpr (kLoss == kNone) {
    s = validf;
    rw = resid;
  } else {
    s = validf * sqrt_weight<kLoss>(resid, delta);
    rw = resid * s;
  }
  float col[6];
  col[0] = (gxw * a0) * s;
  col[1] = (gyw * b1) * s;
  col[2] = (gxw * a2 + gyw * b2) * s;
  col[3] = (gxw * Ju3 + gyw * Jv3) * s;
  col[4] = (gxw * Ju4 + gyw * Jv4) * s;
  col[5] = (gxw * Ju5 + gyw * Jv5) * s;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += col[i] * col[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += col[i] * rw;
  acc[27] += rw * rw;
  acc[28] += validf;
  if constexpr (kN == kGramSums) {
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[29 + i] += col[i] * validf;
  }
  if constexpr (kBi) {
    // The depth channel (phovo_tpu/ops/fused_batch.py:541-563): residual
    // gain (D1(warped) - tz) with the raw tz, its own IRLS weight at the
    // same delta, and row gain (grad D . J_pix - J_rt z-row), where the
    // z-row of J_rt is [0, 0, 1, 0, rp2, rr2].
    float d1w, dgx, dgy;
    sample_target<kBilinear>(tgt + 3 * H * W, H, W, u, v, &d1w, &dgx, &dgy);
    const float r_dep = gain * (d1w - tz) * validf;
    float sd, rdw;
    if constexpr (kLoss == kNone) {
      sd = validf;
      rdw = r_dep;
    } else {
      sd = validf * sqrt_weight<kLoss>(r_dep, delta);
      rdw = r_dep * sd;
    }
    float dcol[6];
    dcol[0] = gain * (dgx * a0) * sd;
    dcol[1] = gain * (dgy * b1) * sd;
    dcol[2] = gain * (dgx * a2 + dgy * b2 - 1.0f) * sd;
    dcol[3] = gain * (dgx * Ju3 + dgy * Jv3) * sd;
    dcol[4] = gain * (dgx * Ju4 + dgy * Jv4 - rp2) * sd;
    dcol[5] = gain * (dgx * Ju5 + dgy * Jv5 - rr2) * sd;
    k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[k++] += dcol[i] * dcol[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += dcol[i] * rdw;
    acc[27] += rdw * rdw;
  }
}

// Sum each thread's acc[kN] over the block into total[kN]: warp shuffles,
// then a fixed-order pass over the warps in shared memory; no atomics, so
// every run gives the same bits. Every thread of the block calls it; it
// ends with a barrier, so total is ready for every thread.
template <int kN>
static __device__ __forceinline__ void block_sum(const float (&acc)[kN],
                                                 float (*partial)[kN],
                                                 float* total) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float a = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) partial[warp][k] = a;
  }
  __syncthreads();
  if (tid < kN) {
    float a = partial[0][tid];
    for (int w = 1; w < kWarps; ++w) a += partial[w][tid];
    total[tid] = a;
  }
  __syncthreads();
}

// The normal equations of one pair at the state held in `terms`, summed
// over the block into total[kN] (block_sum). geom holds kEsm ? 6 : 4 rows
// of N pixels (ops/fused.py pack_geometry), tgt kBi ? 6 : 3 channels;
// per-thread sums are kept in registers. Every thread of the block calls
// it; it ends with a barrier, so total is ready for every thread.
template <bool kBilinear, int kLoss, bool kEsm, int kN, bool kBi = false>
static __device__ __forceinline__ void linearize_block(
    const Terms& terms, const float* __restrict__ i0,
    const float* __restrict__ geom, const float* __restrict__ tgt, int H,
    int W, float fx, float fy, float cx, float cy, float delta,
    float (*partial)[kN], float* total, float gain = 0.0f) {
  const int tid = threadIdx.x;
  const int N = H * W;
  float acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.0f;
  for (int p = tid; p < N; p += kThreads) {
    float sgx = 0.0f, sgy = 0.0f;
    if constexpr (kEsm) {
      sgx = geom[4 * N + p];
      sgy = geom[5 * N + p];
    }
    accumulate_pixel<kBilinear, kLoss, kEsm, kN, kBi>(
        terms, geom[p], geom[N + p], geom[2 * N + p], geom[3 * N + p], sgx,
        sgy, i0[p], tgt, H, W, fx, fy, cx, cy, delta, gain, acc);
  }
  block_sum<kN>(acc, partial, total);
}

// Sum each thread's acc[kN] over the `cluster` blocks of a thread-block
// cluster into total[kN], the same bits in every block: each block reduces
// its own with block_sum into slots[parity], and after one cluster barrier
// every block reads the C slots through distributed shared memory in rank
// order, 0 to C - 1, adding them in that order. No atomics. parity flips
// per call: a block writes slots[parity] again only two calls later, after
// the next barrier, which no block passes before every peer has read this
// call's slots, so one cluster barrier per call suffices. Every thread of
// every block of the cluster calls it; it ends with a block barrier, so
// total is ready for every thread. Call cluster_done before a block exits.
template <int kN>
static __device__ __forceinline__ void cluster_block_sum(const float (&acc)[kN], int cluster,
                                                         int& parity, float (*partial)[kN],
                                                         float (*slots)[kN], float* total) {
  const int tid = threadIdx.x;
  float* slot = slots[parity];
  block_sum<kN>(acc, partial, slot);
  const cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  cl.sync();
  if (tid < kN) {
    float a = *cl.map_shared_rank(slot + tid, 0);
    for (int r = 1; r < cluster; ++r) a += *cl.map_shared_rank(slot + tid, r);
    total[tid] = a;
  }
  __syncthreads();
  parity ^= 1;
}

// The cluster form of linearize_block, for the level kernels (K-GN, K-TR):
// one pair's level is spread over a thread-block cluster of `cluster`
// blocks. kCluster is false for a launch of one block a pair: then it is
// linearize_block itself, so those instantiations compile to the
// one-block kernels' code (slots, parity and cluster go unused). With
// kCluster, block rank r sweeps pixels r * kThreads + tid, stepping by
// cluster * kThreads, and cluster_block_sum adds the blocks' sums in rank
// order. So every block holds the same bits in total[kN], and the serial
// code after it (make_terms, the solve, the termination tests) runs alike
// in every block: state and control flow agree without a broadcast.
// (On an H100 this strided sweep timed faster than contiguous
// row bands a block on the 256-pair chains and for K-GN at B = 1:
// PERF.md.) Every thread of every block of the cluster calls it; it ends
// with a block barrier, so total is ready for every thread. Call
// cluster_done before a block exits.
template <bool kCluster, bool kBilinear, int kLoss, bool kEsm, int kN, bool kBi = false>
static __device__ __forceinline__ void linearize_cluster(
    const Terms& terms, const float* __restrict__ i0,
    const float* __restrict__ geom, const float* __restrict__ tgt, int H,
    int W, float fx, float fy, float cx, float cy, float delta, int cluster,
    int& parity, float (*partial)[kN], float (*slots)[kN], float* total,
    float gain = 0.0f) {
  if constexpr (!kCluster) {
    linearize_block<kBilinear, kLoss, kEsm, kN, kBi>(terms, i0, geom, tgt, H, W, fx, fy, cx, cy,
                                                     delta, partial, total, gain);
  } else {
    const int tid = threadIdx.x;
    const int N = H * W;
    // one cluster is `cluster` consecutive blocks, so this is the block's rank
    const int rank = static_cast<int>(blockIdx.x) % cluster;
    float acc[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] = 0.0f;
    for (int p = rank * kThreads + tid; p < N; p += cluster * kThreads) {
      float sgx = 0.0f, sgy = 0.0f;
      if constexpr (kEsm) {
        sgx = geom[4 * N + p];
        sgy = geom[5 * N + p];
      }
      accumulate_pixel<kBilinear, kLoss, kEsm, kN, kBi>(
          terms, geom[p], geom[N + p], geom[2 * N + p], geom[3 * N + p], sgx,
          sgy, i0[p], tgt, H, W, fx, fy, cx, cy, delta, gain, acc);
    }
    cluster_block_sum<kN>(acc, cluster, parity, partial, slots, total);
  }
}

// Before a block of a cluster launch exits: no block may leave while a
// peer can still read its slots.
template <bool kCluster>
static __device__ __forceinline__ void cluster_done() {
  if constexpr (kCluster) cooperative_groups::this_cluster().sync();
}

// Unpack the 21 upper-triangle sums into a full symmetric 6x6 matrix.
static __device__ __forceinline__ void unpack_jtj(const float* sums, float A[6][6]) {
  int k = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      A[i][j] = sums[k];
      A[j][i] = sums[k];
      ++k;
    }
  }
}

// Unrolled 6x6 Cholesky solve with rsqrt pivots floored at 1e-30 (a NaN
// pivot stays NaN, as jnp.maximum keeps it): phovo_tpu/ops/fused.py:771.
static __device__ void chol_solve6(const float A[6][6], const float b[6], float x[6]) {
  float L[6][6];
  float inv_diag[6];
  for (int i = 0; i < 6; ++i) {
    float acc = A[i][i];
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * L[i][k];
    if (!isnan(acc)) acc = fmaxf(acc, 1e-30f);
    const float inv_d = rsqrtf(acc);
    L[i][i] = acc * inv_d;
    inv_diag[i] = inv_d;
    for (int j = i + 1; j < 6; ++j) {
      float a = A[j][i];
      for (int k = 0; k < i; ++k) a = a - L[j][k] * L[i][k];
      L[j][i] = a * inv_d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float acc = b[i];
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * y[k];
    y[i] = acc * inv_diag[i];
  }
  for (int i = 5; i >= 0; --i) {
    float acc = y[i];
    for (int k = i + 1; k < 6; ++k) acc = acc - L[k][i] * x[k];
    x[i] = acc * inv_diag[i];
  }
}

// Host-side dispatch of a launch over the variants: f(bilinear, loss, esm)
// is called with std::integral_constant arguments, so one generic lambda
// instantiates each kernel variant. Losses above kMaxLoss and ESM where
// kAllowEsm is false are refused (returns false, nothing launched).
template <bool kB, bool kE, int kMaxLoss, typename F>
static bool dispatch_loss(int loss, F& f) {
  switch (loss) {
    case kNone:
      f(std::bool_constant<kB>{}, std::integral_constant<int, kNone>{}, std::bool_constant<kE>{});
      return true;
    case kHuber:
      f(std::bool_constant<kB>{}, std::integral_constant<int, kHuber>{}, std::bool_constant<kE>{});
      return true;
    case kCauchy:
      f(std::bool_constant<kB>{}, std::integral_constant<int, kCauchy>{}, std::bool_constant<kE>{});
      return true;
    case kTukey:
      f(std::bool_constant<kB>{}, std::integral_constant<int, kTukey>{}, std::bool_constant<kE>{});
      return true;
    case kTdist:
      if constexpr (kMaxLoss >= kTdist) {
        f(std::bool_constant<kB>{}, std::integral_constant<int, kTdist>{}, std::bool_constant<kE>{});
        return true;
      }
      return false;
    default:
      return false;
  }
}

template <int kMaxLoss, bool kAllowEsm, typename F>
static bool dispatch_variant(int bilinear, int loss, int esm, F&& f) {
  if (esm) {
    if constexpr (kAllowEsm) {
      return bilinear ? dispatch_loss<true, true, kMaxLoss>(loss, f)
                      : dispatch_loss<false, true, kMaxLoss>(loss, f);
    }
    return false;
  }
  return bilinear ? dispatch_loss<true, false, kMaxLoss>(loss, f)
                  : dispatch_loss<false, false, kMaxLoss>(loss, f);
}

// Launch a level kernel over B pairs as B clusters of `cluster` blocks of
// kThreads (grid B * cluster, cluster dimension {cluster, 1, 1}) with
// `smem` bytes of dynamic shared memory a block on stream s: `one` (the
// kernel's kCluster = false instantiation) when cluster is 1, else `many`
// (kCluster = true). Dynamic shared memory above 0 is allowed first
// (cudaFuncAttributeMaxDynamicSharedMemorySize; more than the card gives
// a block is refused there). A cluster above 8 blocks is non-portable: it is allowed first, and
// cudaOccupancyMaxActiveClusters must find room for one, else
// cudaErrorInvalidClusterSize and nothing is launched. Returns the first
// error, else cudaGetLastError() after the launch; the error of a refused
// launch is cleared, so it cannot surface at a later launch. There is no
// retry with smaller clusters or less shared memory.
template <typename... Params, typename... Args>
static cudaError_t launch_clusters(void (*one)(Params...), void (*many)(Params...), int B,
                                   int cluster, size_t smem, cudaStream_t s, Args&&... args) {
  if (cluster < 1) return cudaErrorInvalidValue;
  void (*const kernel)(Params...) = cluster > 1 ? many : one;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  // one block a pair launches as a plain grid, without a cluster dimension
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int clusters = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidClusterSize;
  }
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace phovo
