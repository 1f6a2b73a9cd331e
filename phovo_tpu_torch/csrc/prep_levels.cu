// Every active pyramid level's packs of F frames, from the frames in
// storage dtype, in one launch (K-PREP).
//
// Replaces no TPU kernel: phovo_tpu leaves this work (the storage-dtype
// conversion, the pyramids, the Scharr gradients and the packs the level
// kernels read) to XLA's fused elementwise code. The port ran it as a chain
// of plain torch ops (ops/prep.py::prep_levels_torch, kept as the plain
// version): some 260 launches of a 257-frame five-level chunk, 272 for one
// pair through the object API, each writing and re-reading float32
// intermediates. This kernel writes the same packs, bit for bit, in one.
//
// What bounds it on an H100: bytes. A VGA frame is 0.92 MB in storage dtype
// (uint8 intensity, uint16 depth counts); its packs at five levels are
// ~13 MB of float32 (i0, four geometry rows, three target rows, times 4/3
// for the coarser levels): ~4 us a frame at 3.35 TB/s. The work is a few
// adds and multiplies a byte.
//
// The design: the grid is a flat work list. Each frame owns tiles_per_frame
// consecutive blocks, one per kTile x kTile tile of each active level, so
// the levels of one frame run together and read its storage-dtype pixels
// from L2; then, for the chunked entry, the blocks of the new carry (the
// last frame's float32 intensity and depth at full resolution). A block
// builds its tile of the level intensity with a one-pixel reflect-101 halo
// in shared memory, each level pixel straight from the original frame (a
// level is an exact 1/2^k downscale: the mean of two rows, then of two
// columns, ops/pyramid.py::resize_bilinear's order), then writes the
// tile's packs row after row, neighbouring threads on neighbouring pixels.
// The arithmetic is float32 in the torch chain's order, one rounding an
// operation (the library is built with -fmad=false): the uint8 conversion
// multiplies by 1/255 rounded to float32; Scharr is _sep_filter's rows
// pass, columns pass, each a sum started from 0, then * scale; the
// geometry's divisions by fx and fy are multiplies by the float32
// reciprocals the caller passes, as torch's CUDA division by a CPU scalar
// is. So the packs equal the torch chain's on the card.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 32;  // a block's tile: kTile x kTile level pixels
constexpr int kHalo = kTile + 2;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTile;  // tile rows one pass of the block covers
// torch's uint8 conversion multiplies by the CPU scalar 1.0 / 255.0, which
// it rounds to float32
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

struct Level {
  int kr, kc;  // the level is the frame downscaled by 2^kr rows and 2^kc columns
  int H, W;
  int tiles_x;
  int first_tile;  // the frame's first block of this level
  float scale;     // the Scharr scale
  float cx, cy, inv_fx, inv_fy;
  float* i0;     // (S, H*W) or null
  float* geom;   // (S, 4 | 6, H*W) or null
  float* t_all;  // (T, 3, H, W) or null
};

// One plane of one frame: float32 as it is, uint8 * 1/255, or uint16 *
// scale.
struct Plane {
  const void* p;
  int kind;  // 0 float32, 1 uint8, 2 uint16
  float scale;
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  int tiles_per_frame;
  int frame_lo, frames;  // frames frame_lo .. frame_lo + frames - 1 get packs
  int src_lo, src_hi, tgt_lo, tgt_hi;
  int geom_rows;
  int F, H, W;
  float min_depth, max_depth;
  // frame 0 is the head when head_i is set, the body holds the others
  const void* head_i;
  const float* head_d;
  const void* body_i;
  const void* body_d;
  int head_u8, body_u8, body_u16;
  float body_scale;
  float* carry_i;  // (H, W) or null: the last frame at full resolution
  float* carry_d;
  int carry_tiles_x;
};

__device__ __forceinline__ float load(const Plane& pl, size_t idx) {
  if (pl.kind == 1) return static_cast<float>(__ldg(static_cast<const unsigned char*>(pl.p) + idx)) * kInv255;
  if (pl.kind == 2) return static_cast<float>(__ldg(static_cast<const unsigned short*>(pl.p) + idx)) * pl.scale;
  return __ldg(static_cast<const float*>(pl.p) + idx);
}

// Frame f's intensity and depth planes (the depth's pointer is null where
// the caller gave no depth).
__device__ __forceinline__ void frame_planes(const Params& P, int f, Plane& in, Plane& dp) {
  const size_t N = static_cast<size_t>(P.H) * P.W;
  if (P.head_i != nullptr) {
    if (f == 0) {
      in = {P.head_i, P.head_u8 ? 1 : 0, 1.0f};
      dp = {P.head_d, 0, 1.0f};
      return;
    }
    f -= 1;
  }
  const size_t at = static_cast<size_t>(f) * N;
  in = {static_cast<const char*>(P.body_i) + at * (P.body_u8 ? 1 : 4), P.body_u8 ? 1 : 0, 1.0f};
  dp = {P.body_d == nullptr ? nullptr : static_cast<const char*>(P.body_d) + at * (P.body_u16 ? 2 : 4),
        P.body_u16 ? 2 : 0, P.body_scale};
}

// Pixel (row, col) of the level 2^-kr x 2^-kc of a W-wide plane: the
// original at level 0; else resize_bilinear's exact downscale, rows
// 2^kr row + 2^(kr-1) - 1 and the next averaged, then the two columns.
__device__ __forceinline__ float level_pixel(const Plane& pl, int W, int kr, int kc, int row, int col) {
  if (kr == 0) return load(pl, static_cast<size_t>(row) * W + col);
  const int ra = (row << kr) + (1 << (kr - 1)) - 1;
  const int ca = (col << kc) + (1 << (kc - 1)) - 1;
  const size_t a = static_cast<size_t>(ra) * W + ca;
  const size_t b = a + W;
  const float left = 0.5f * (load(pl, a) + load(pl, b));
  const float right = 0.5f * (load(pl, a + 1) + load(pl, b + 1));
  return 0.5f * (left + right);
}

// Reflect-101 index of v into [0, n) for the one-pixel halo, clamped for
// the cells of a ragged tile that no output reads.
__device__ __forceinline__ int reflect(int v, int n) {
  v = v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// The two passes of _sep_filter over three taps, each sum from 0 as
// Python's sum() starts it.
__device__ __forceinline__ float taps(float k0, float k1, float k2, float a, float b, float c) {
  float s = 0.0f + k0 * a;
  s = s + k1 * b;
  return s + k2 * c;
}

__global__ void __launch_bounds__(kThreads) prep_levels_kernel(const __grid_constant__ Params P) {
  __shared__ float tile[kHalo][kHalo];
  const int tx = threadIdx.x % kTile;
  const int ty0 = threadIdx.x / kTile;
  const int packed = P.frames * P.tiles_per_frame;
  const int b = static_cast<int>(blockIdx.x);

  if (b >= packed) {  // the carry: the last frame's converted planes
    Plane in, dp;
    frame_planes(P, P.F - 1, in, dp);
    const int t = b - packed;
    const int y0 = (t / P.carry_tiles_x) * kTile;
    const int x = (t % P.carry_tiles_x) * kTile + tx;
    for (int ty = ty0; ty < kTile; ty += kRowStep) {
      const int y = y0 + ty;
      if (y >= P.H || x >= P.W) continue;
      const size_t p = static_cast<size_t>(y) * P.W + x;
      P.carry_i[p] = load(in, p);
      P.carry_d[p] = load(dp, p);
    }
    return;
  }

  const int f = P.frame_lo + b / P.tiles_per_frame;
  const int r = b % P.tiles_per_frame;
  int l = 0;
  while (l + 1 < P.n_levels && r >= P.lv[l + 1].first_tile) ++l;
  const Level& L = P.lv[l];
  const bool src = f >= P.src_lo && f < P.src_hi;
  const bool tgt = f >= P.tgt_lo && f < P.tgt_hi;
  const bool grads = tgt || (src && P.geom_rows == 6);
  const int t = r - L.first_tile;
  const int y0 = (t / L.tiles_x) * kTile;
  const int x0 = (t % L.tiles_x) * kTile;
  Plane in, dp;
  frame_planes(P, f, in, dp);

  for (int e = threadIdx.x; e < kHalo * kHalo; e += kThreads) {
    const int i = e / kHalo;
    const int j = e % kHalo;
    tile[i][j] = level_pixel(in, P.W, L.kr, L.kc, reflect(y0 - 1 + i, L.H), reflect(x0 - 1 + j, L.W));
  }
  __syncthreads();

  const size_t N = static_cast<size_t>(L.H) * L.W;
  const int x = x0 + tx;
  for (int ty = ty0; ty < kTile; ty += kRowStep) {
    const int y = y0 + ty;
    if (y >= L.H || x >= L.W) continue;
    const size_t p = static_cast<size_t>(y) * L.W + x;
    const float I = tile[ty + 1][tx + 1];
    float gx = 0.0f, gy = 0.0f;
    if (grads) {
      // Scharr d/dx: rows pass [3, 10, 3], columns pass [-1, 0, 1]; d/dy
      // the other way round
      float sx[3], sy[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sx[c] = taps(3.0f, 10.0f, 3.0f, tile[ty][tx + c], tile[ty + 1][tx + c], tile[ty + 2][tx + c]);
        sy[c] = taps(-1.0f, 0.0f, 1.0f, tile[ty][tx + c], tile[ty + 1][tx + c], tile[ty + 2][tx + c]);
      }
      gx = taps(-1.0f, 0.0f, 1.0f, sx[0], sx[1], sx[2]) * L.scale;
      gy = taps(3.0f, 10.0f, 3.0f, sy[0], sy[1], sy[2]) * L.scale;
    }
    if (tgt) {
      float* out = L.t_all + static_cast<size_t>(f - P.tgt_lo) * 3 * N + p;
      out[0] = I;
      out[N] = gx;
      out[2 * N] = gy;
    }
    if (src) {
      L.i0[static_cast<size_t>(f - P.src_lo) * N + p] = I;
      const float d = level_pixel(dp, P.W, L.kr, L.kc, y, x);
      float* g = L.geom + static_cast<size_t>(f - P.src_lo) * P.geom_rows * N + p;
      g[0] = ((static_cast<float>(x) - L.cx) * d) * L.inv_fx;
      g[N] = ((static_cast<float>(y) - L.cy) * d) * L.inv_fy;
      g[2 * N] = d;
      g[3 * N] = (d > P.min_depth && d < P.max_depth) ? 1.0f : 0.0f;
      if (P.geom_rows == 6) {
        g[4 * N] = gx;
        g[5 * N] = gy;
      }
    }
  }
}

}  // namespace

// Launches K-PREP on `stream` (a cudaStream_t). Frames 0 .. F-1 are the
// head (head_i (H, W) uint8 or float32 when head_u8 is 0, head_d (H, W)
// float32 metres; none when head_i is null) and then the body (body_i
// (n, H, W) uint8 or float32, body_d (n, H, W) uint16 counts times
// body_scale or float32 metres, or null). Frames src_lo .. src_hi-1 get
// source packs (i0, geom of 4 rows, 6 with esm), tgt_lo .. tgt_hi-1 target
// packs (t_all); the two ranges must meet or overlap. Per level, level_ints
// holds (kr, kc, H, W), level_floats (scale, cx, cy, 1/fx, 1/fy) and
// level_outs the pointers (i0, geom, t_all), null for a role no frame has.
// carry_i and carry_d (H, W) get the last frame at full resolution, unless
// null. Every buffer is the caller's. Returns cudaErrorInvalidValue for
// arguments it does not take (nothing runs), else the launch's error.
extern "C" int phovo_prep_levels(const void* head_i, const void* head_d, const void* body_i,
                                 const void* body_d, int head_u8, int body_u8, int body_u16,
                                 float body_scale, int F, int H, int W, int src_lo, int src_hi,
                                 int tgt_lo, int tgt_hi, int esm, float min_depth, float max_depth,
                                 int n_levels, const void* level_ints, const void* level_floats,
                                 const void* level_outs, void* carry_i, void* carry_d, void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || F < 1 || H < 2 || W < 2) return cudaErrorInvalidValue;
  if (src_lo < 0 || src_hi > F || src_lo > src_hi || tgt_lo < 0 || tgt_hi > F || tgt_lo > tgt_hi) {
    return cudaErrorInvalidValue;
  }
  const bool has_src = src_lo < src_hi;
  const bool has_tgt = tgt_lo < tgt_hi;
  if (has_src && has_tgt && (src_hi < tgt_lo || tgt_hi < src_lo)) return cudaErrorInvalidValue;
  Params P = {};
  const int* ints = static_cast<const int*>(level_ints);
  const float* floats = static_cast<const float*>(level_floats);
  float* const* outs = static_cast<float* const*>(level_outs);
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& L = P.lv[l];
    L.kr = ints[4 * l];
    L.kc = ints[4 * l + 1];
    L.H = ints[4 * l + 2];
    L.W = ints[4 * l + 3];
    const bool exact = L.kr >= 0 && L.kr < 16 && L.kc >= 0 && L.kc < 16 && (L.kr == 0) == (L.kc == 0) &&
                       L.H >= 2 && L.W >= 2 && (L.H << L.kr) == H && (L.W << L.kc) == W;
    if (!exact) return cudaErrorInvalidValue;
    L.tiles_x = (L.W + kTile - 1) / kTile;
    L.first_tile = tiles;
    tiles += L.tiles_x * ((L.H + kTile - 1) / kTile);
    L.scale = floats[5 * l];
    L.cx = floats[5 * l + 1];
    L.cy = floats[5 * l + 2];
    L.inv_fx = floats[5 * l + 3];
    L.inv_fy = floats[5 * l + 4];
    L.i0 = outs[3 * l];
    L.geom = outs[3 * l + 1];
    L.t_all = outs[3 * l + 2];
    if ((has_src && (L.i0 == nullptr || L.geom == nullptr)) || (has_tgt && L.t_all == nullptr)) {
      return cudaErrorInvalidValue;
    }
  }
  // the source frames and the carry's frame need their depth
  const int body_from = head_i != nullptr ? 1 : 0;
  if (has_src && ((src_hi > body_from && body_d == nullptr) || (src_lo < body_from && head_d == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if ((carry_i == nullptr) != (carry_d == nullptr)) return cudaErrorInvalidValue;
  if (carry_i != nullptr && (F - 1 >= body_from ? body_d == nullptr : head_d == nullptr)) return cudaErrorInvalidValue;
  P.n_levels = n_levels;
  P.tiles_per_frame = tiles;
  P.frame_lo = has_src && has_tgt ? (src_lo < tgt_lo ? src_lo : tgt_lo) : (has_src ? src_lo : tgt_lo);
  const int frame_hi = has_src && has_tgt ? (src_hi > tgt_hi ? src_hi : tgt_hi) : (has_src ? src_hi : tgt_hi);
  P.frames = frame_hi - P.frame_lo;
  P.src_lo = src_lo;
  P.src_hi = src_hi;
  P.tgt_lo = tgt_lo;
  P.tgt_hi = tgt_hi;
  P.geom_rows = esm ? 6 : 4;
  P.F = F;
  P.H = H;
  P.W = W;
  P.min_depth = min_depth;
  P.max_depth = max_depth;
  P.head_i = head_i;
  P.head_d = static_cast<const float*>(head_d);
  P.body_i = body_i;
  P.body_d = body_d;
  P.head_u8 = head_u8;
  P.body_u8 = body_u8;
  P.body_u16 = body_u16;
  P.body_scale = body_scale;
  P.carry_i = static_cast<float*>(carry_i);
  P.carry_d = static_cast<float*>(carry_d);
  P.carry_tiles_x = (W + kTile - 1) / kTile;
  const long long carry_blocks = carry_i != nullptr ? static_cast<long long>(P.carry_tiles_x) * ((H + kTile - 1) / kTile) : 0;
  const long long blocks = static_cast<long long>(P.frames) * tiles + carry_blocks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  prep_levels_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
