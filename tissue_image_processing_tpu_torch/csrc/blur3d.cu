// Separable edge-replicate Gaussian correlation along z, y, x in one pass.
//
// Replaces: tissue_image_processing_tpu/ops/blur_pallas.py:blur3d_pallas
//   (_blur3d_fn -> pallas_call -> _make_kernel), reached through
//   ops/filters.py:gaussian_blur for every blur with fewer than 31 taps on
//   an axis. On the main path: the watershed pre-blur (sigma 3, taps (1, 25,
//   25), a (2, 1024, 1024) batch) and the z axis of the projection's
//   small-score blur (taps (5, 1, 1), a (30, 256, 256) volume); on the
//   unfused projection (the projection driver, parallel/, and every movie
//   the fused kernels do not take): the pre-blur, taps (5, 9, 9), and the
//   one-hot z-mask blur, taps (9, 17, 17), of a whole (Z, Y, X) frame; and
//   band_pass_filter's low sigma, taps (1, 9, 9).
//
// Bound on an H100: memory for most tap sets. The function reads the (Z, Y,
// X) float32 volume once and writes it once (16.8 MB at (2, 1024, 1024),
// ~5.0 us at 3.35 TB/s; 1.0 GB at (30, 2048, 2048), ~0.30 ms); its
// arithmetic is 2 * (tz + ty + tx) flops per voxel (~0.21 GFLOP for the 25 x
// 25 blur, ~3.2 us at 67 TFLOP/s float32; 10.8 GFLOP for (9, 17, 17) at
// 2048^2 x 30, ~0.16 ms). Every multiply and add is issued on its own here
// (no FMA), so the arithmetic floor is about twice that operation bound:
// ~0.33 ms for (9, 17, 17), near its byte bound.
//
// Four kernels. blur3d_f32 picks among the first three by the taps (the
// forms of PRs 1-13); blur3d_walk_f32 launches the fourth, which the
// wrapper (ops/blur_cuda.py:blur3d_form) picks for the tap sets it
// compiles:
// - z only (ty == tx == 1): no shared memory. A thread owns four neighbouring
//   voxels of a plane (one 16-byte word) and a chunk of BZ_CHUNK output
//   planes; it asks for all BZ_CHUNK + tz - 1 planes of its window at once
//   (so the loads are in flight together), keeps them in registers, and sums
//   the taps from there.
// - tile: a block owns a BT_Y x BT_X output tile of one plane. It loads the
//   tile's halo with 16-byte loads, eight a thread in flight at once (the z
//   taps applied on the way), into shared memory; then the y pass,
//   register-tiled: a thread owns BT_RUN consecutive rows of one column and
//   streams their BT_RUN + ty - 1 inputs once, keeping the sums in
//   registers (one shared load serves up to ty taps); then the x pass the same way along a row, reading its window as
//   16-byte words, into the output. The 64 x 128 tile has a 88 x 152 halo
//   for the 25-tap blur (1.6x its area); its ~92 KB of dynamic shared memory
//   let two blocks share an SM. The main path's tap counts (25 in y and x;
//   5 in z alone) are compiled in; others take a generic form with one load
//   a tap. The tile form reads each input plane tz times (once for every
//   output plane whose window holds it).
// - walk (taps (1, 9, 9), (5, 9, 9), (9, 17, 17)): a block owns a BW_Y x BW_X
//   tile of y x x for a chunk of output planes and walks z through it. Each
//   thread owns a few 16-byte granules of the tile's halo and keeps, for
//   each, the last tz input planes (plus BW_AHEAD - 1 loading ahead) in a
//   register ring, so every input plane crosses memory once for each tile
//   (its halo's overlap with the neighbours' mostly from L2). A step of the
//   walk is one barrier: the x pass of output plane j, the y pass of plane
//   j + 1 and the z sums of plane j + 2 run side by side on double buffers
//   in shared memory, so no pass waits alone at a barrier. The y and x
//   passes have their tap counts compiled in: register runs of BW_RUN
//   outputs; the x window read as 16-byte words from a buffer whose row
//   pitch is 4 mod 32 words, a quarter warp on two rows x 32 columns (no
//   bank conflict), a warp storing four whole rows.
//   Why 32 x 64 and 512 threads an SM: the z window lives in registers,
//   tz float4 a granule. Sixteen warps an SM (one block of 512 threads, or
//   two of 256 where tz * n <= BW_TWO_BLOCKS: the pre-blur and the 2-D
//   blur) cap a thread at 128 registers; the 17-tap halo of a 32 x 64 tile
//   is 48 x 80 (960 granules, two a thread: 72 registers of window at tz =
//   9), the largest that fits. A 64-row or 128-column tile would cut the z
//   pass's halo share (1.9x the tile now) but needs twice the registers; a
//   z window in shared memory (cp.async / TMA, tz + 1 planes of halo) caps
//   the tile the same way (227 KB / 10 planes) and adds tz shared loads a
//   voxel. The z-mask blur at 2048^2 x 30 on an H100 SXM (700 W), by
//   utils/kernel_variants.py blur in one run: 256 threads an SM 0.93 ms
//   (247 registers), 384 0.97 (168 and a spill: three warps on a
//   scheduler cap a thread at 168), 512 0.83.
//   The y tasks (a column, 8 rows) go from the last thread down, so the
//   threads with a granule fewer take them first; the x pass has 256 tasks
//   (a row, 8 columns) on the first 256 threads. Along z a
//   block walks a chunk of the planes; the launcher picks the chunk so that
//   the card's last wave of blocks is full enough (a chunk reloads tz - 1
//   planes).
// The taps are kernel parameters (constant-bank operands): nothing is copied
// to the card for them.
//
// Taps accumulate from tap 0 upward, z then y then x, with separate
// round-to-nearest multiply and add (__fmul_rn/__fadd_rn: no contraction
// into FMA): the order and rounding of the plain PyTorch version
// (ops/blur_cuda.py:blur3d_plain). Clamped coordinates give exactly the
// edge-replicate padding. Every form computes the same function bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// The library serves every card of the process, from several host threads:
// what a launch learns from the calling thread's current card (occupancy, a
// shared memory size opted into) is cached by card, in atomics.
constexpr int MAX_CARDS = 64;

// the calling thread's current card, or -1
inline int current_card() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS)
    return -1;
  return dev;
}

constexpr int kMaxTaps = 33;
constexpr int BT_Y = 64;          // output rows of a tile
constexpr int BT_X = 128;         // output columns of a tile
constexpr int BT_RUN = 8;         // outputs a thread owns along a tap axis
constexpr int BT_THREADS = 256;
constexpr int BT_MIN_BLOCKS = 2;  // blocks an SM the registers must allow
constexpr int BT_BATCH = 8;       // halo granules a thread has in flight
constexpr int BZ_CHUNK = 8;       // output planes a thread of the z-only path owns
constexpr int BZ_THREADS = 256;
constexpr int BW_Y = 32;          // walk: output rows of a tile
constexpr int BW_X = 64;          // walk: output columns of a tile
constexpr int BW_RUN = 8;         // walk: outputs a task owns in the y and x passes
constexpr int BW_SM_THREADS = 512;  // walk: threads an SM, four warps a scheduler
constexpr int BW_AHEAD = 1;       // walk: planes a granule has loading ahead of its window
constexpr int BW_TWO_BLOCKS = 45; // walk: tz * n up to which two blocks share an SM
static_assert(BT_Y % BT_RUN == 0 && BT_X % BT_RUN == 0, "whole runs a tile");

struct BlurTaps {
  float z[kMaxTaps], y[kMaxTaps], x[kMaxTaps];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float mulv(float w, float v) { return __fmul_rn(w, v); }
__device__ __forceinline__ float addv(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 mulv(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
                     __fmul_rn(w, v.w));
}
__device__ __forceinline__ float4 addv(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// sums[o] = sum_t w[t] * in[o + t] over NT taps, every sum from tap 0
// upward, as input k arrives: it is tap k - o of output o.
template <int NT, int RUN>
__device__ __forceinline__ void taps_in_order(const float (&w)[kMaxTaps], int k,
                                              float v, float (&sums)[RUN]) {
#pragma unroll
  for (int o = 0; o < RUN; ++o) {
    const int t = k - o;
    if (t == 0)
      sums[o] = __fmul_rn(w[0], v);
    else if (t > 0 && t < NT)
      sums[o] = __fadd_rn(sums[o], __fmul_rn(w[t], v));
  }
}

// n taps at run time on in[0], in[stride], ...: one load a tap.
__device__ __forceinline__ float taps_any(const float (&w)[kMaxTaps], int n,
                                          const float* in, int stride) {
  float a = __fmul_rn(w[0], in[0]);
#pragma unroll
  for (int t = 1; t < kMaxTaps; ++t) {
    if (t >= n) break;
    a = __fadd_rn(a, __fmul_rn(w[t], in[t * stride]));
  }
  return a;
}

// ------------------------------------------------------------------ z only
// V: float4 (the plane's voxel count a multiple of 4, 16-byte aligned) or
// float. TZ > 0: the tap count, compiled in; 0: tz at run time.
template <int TZ, typename V>
__global__ void __launch_bounds__(BZ_THREADS)
blur_z_kernel(const V* __restrict__ x, V* __restrict__ out, const BlurTaps w,
              int Z, int n, int tz) {
  const int i = blockIdx.x * BZ_THREADS + threadIdx.x;
  if (i >= n) return;
  const int z0 = blockIdx.y * BZ_CHUNK;
  const int nz = min(BZ_CHUNK, Z - z0);
  if constexpr (TZ > 0) {
    constexpr int R = TZ / 2, W = BZ_CHUNK + TZ - 1;
    V win[W];  // every plane of the window asked for before any tap
#pragma unroll
    for (int k = 0; k < W; ++k)
      win[k] = __ldg(x + (size_t)clampi(z0 - R + k, 0, Z - 1) * n + i);
#pragma unroll
    for (int o = 0; o < BZ_CHUNK; ++o) {
      if (o >= nz) break;
      V a = mulv(w.z[0], win[o]);
#pragma unroll
      for (int t = 1; t < TZ; ++t) a = addv(a, mulv(w.z[t], win[o + t]));
      out[(size_t)(z0 + o) * n + i] = a;
    }
  } else {
    const int r = tz / 2;
    for (int o = 0; o < nz; ++o) {
      V a = mulv(w.z[0], __ldg(x + (size_t)clampi(z0 + o - r, 0, Z - 1) * n + i));
#pragma unroll
      for (int t = 1; t < kMaxTaps; ++t) {
        if (t >= tz) break;
        a = addv(a, mulv(w.z[t], __ldg(x + (size_t)clampi(z0 + o - r + t, 0, Z - 1) * n + i)));
      }
      out[(size_t)(z0 + o) * n + i] = a;
    }
  }
}

// -------------------------------------------------------------------- tile
// NY, NX > 0: the y and x tap counts, compiled in; 0: ty, tx at run time.
template <int NY, int NX>
__global__ void __launch_bounds__(BT_THREADS, BT_MIN_BLOCKS)
blur_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const BlurTaps w, int Z, int Y, int X, int tz, int ty, int tx,
                 int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ny = NY > 0 ? NY : ty, nx = NX > 0 ? NX : tx;
  const int ry = ny / 2, rx = nx / 2, rz = tz / 2;
  const int rxa = (rx + 3) & ~3;  // the x halo, whole 16-byte words
  const int hrows = BT_Y + 2 * ry, pitch = BT_X + 2 * rxa;
  float* zb = smem;                  // hrows x pitch: the z pass over the halo
  float* yb = smem + hrows * pitch;  // BT_Y x pitch: the y pass
  const int tid = threadIdx.x, z = blockIdx.z;
  const int y0 = blockIdx.y * BT_Y, x0 = blockIdx.x * BT_X;
  const size_t plane = (size_t)Y * X;

  // z pass over the halo, four columns a granule: 16-byte loads inside the
  // rows, BT_BATCH granules a thread in flight at once
  const int gran = pitch / 4, ngran = hrows * gran;
  for (int q0 = tid; q0 < ngran; q0 += BT_BATCH * BT_THREADS) {
    float4 a[BT_BATCH];
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t >= tz) break;
      const float* src = x + (size_t)clampi(z - rz + t, 0, Z - 1) * plane;
#pragma unroll
      for (int b = 0; b < BT_BATCH; ++b) {
        const int q = q0 + b * BT_THREADS;
        if (q >= ngran) break;
        const int r = q / gran, c = q % gran * 4;
        const float* row = src + (size_t)clampi(y0 - ry + r, 0, Y - 1) * X;
        const int xx = x0 - rxa + c;
        const float4 v =
            vec && xx >= 0 && xx + 3 < X
                ? __ldg(reinterpret_cast<const float4*>(row + xx))
                : make_float4(__ldg(row + clampi(xx, 0, X - 1)),
                              __ldg(row + clampi(xx + 1, 0, X - 1)),
                              __ldg(row + clampi(xx + 2, 0, X - 1)),
                              __ldg(row + clampi(xx + 3, 0, X - 1)));
        a[b] = t == 0 ? mulv(w.z[0], v) : addv(a[b], mulv(w.z[t], v));
      }
    }
#pragma unroll
    for (int b = 0; b < BT_BATCH; ++b) {
      const int q = q0 + b * BT_THREADS;
      if (q >= ngran) break;
      *reinterpret_cast<float4*>(zb + q / gran * pitch + q % gran * 4) = a[b];
    }
  }
  __syncthreads();

  // y pass: column c, rows r0 .. r0 + BT_RUN - 1 of the tile
  for (int q = tid; q < pitch * (BT_Y / BT_RUN); q += BT_THREADS) {
    const int c = q % pitch, r0 = q / pitch * BT_RUN;
    const float* in = zb + r0 * pitch + c;
    float s[BT_RUN];
    if constexpr (NY > 0) {
#pragma unroll
      for (int k = 0; k < BT_RUN + NY - 1; ++k)
        taps_in_order<NY>(w.y, k, in[k * pitch], s);
    } else {
#pragma unroll
      for (int o = 0; o < BT_RUN; ++o) s[o] = taps_any(w.y, ny, in + o * pitch, pitch);
    }
#pragma unroll
    for (int o = 0; o < BT_RUN; ++o) yb[(r0 + o) * pitch + c] = s[o];
  }
  __syncthreads();

  // x pass: row r, columns j .. j + BT_RUN - 1 of the tile, into the output
  const int xoff = rxa - rx;  // output column j's window starts at yb column xoff + j
  for (int q = tid; q < BT_Y * (BT_X / BT_RUN); q += BT_THREADS) {
    const int r = q / (BT_X / BT_RUN), j = q % (BT_X / BT_RUN) * BT_RUN;
    const int yy = y0 + r, xx = x0 + j;
    if (yy >= Y || xx >= X) continue;
    const float* in = yb + r * pitch + xoff + j;
    float s[BT_RUN];
    if constexpr (NX > 0) {  // xoff == 0: 16-byte words
      static_assert((NX / 2) % 4 == 0, "a compiled x radius of whole words");
      const float4* in4 = reinterpret_cast<const float4*>(in);
#pragma unroll
      for (int k4 = 0; k4 < (BT_RUN + NX - 1) / 4; ++k4) {
        const float4 v = in4[k4];
        taps_in_order<NX>(w.x, 4 * k4, v.x, s);
        taps_in_order<NX>(w.x, 4 * k4 + 1, v.y, s);
        taps_in_order<NX>(w.x, 4 * k4 + 2, v.z, s);
        taps_in_order<NX>(w.x, 4 * k4 + 3, v.w, s);
      }
    } else {
#pragma unroll
      for (int o = 0; o < BT_RUN; ++o) s[o] = taps_any(w.x, nx, in + o, 1);
    }
    float* dst = out + (size_t)z * plane + (size_t)yy * X + xx;
    if (vec && xx + BT_RUN <= X) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(s[0], s[1], s[2], s[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(s[4], s[5], s[6], s[7]);
    } else {
#pragma unroll
      for (int o = 0; o < BT_RUN; ++o)
        if (xx + o < X) dst[o] = s[o];
    }
  }
}

static_assert(BT_RUN == 8 && BW_RUN == 8, "the x pass stores two 16-byte words a run");

// ------------------------------------------------------------------- walk
// the walk form's shape for tz taps on z and n on y and x
template <int TZ, int N>
struct Walk {
  static constexpr int R = N / 2;
  static constexpr int HR = BW_Y + 2 * R;   // halo rows
  static constexpr int P = BW_X + 2 * R;    // halo columns: the z buffer's pitch
  static constexpr int GR = P / 4;          // 16-byte granules a halo row
  static constexpr int NG = HR * GR;        // granules of the halo
  static constexpr int MIN_BLOCKS = TZ * N <= BW_TWO_BLOCKS ? 2 : 1;
  static constexpr int NT = BW_SM_THREADS / MIN_BLOCKS;
  static constexpr int G = (NG + NT - 1) / NT;       // granules a thread
  static constexpr int YT = P * (BW_Y / BW_RUN);     // y tasks: a column, BW_RUN rows
  static constexpr int YK = (YT + NT - 1) / NT;      // y tasks a thread
  static constexpr int YP = P + (36 - P % 32) % 32;  // y buffer pitch, 4 mod 32
  static constexpr int RING = TZ + BW_AHEAD - 1;     // planes a granule holds
  static constexpr int ZB = HR * P, YB = BW_Y * YP;  // floats of a z / y buffer
  static constexpr int SMEM = (int)sizeof(float) * 2 * (ZB + YB);  // two of each
  static_assert(R % 4 == 0, "a halo of whole 16-byte words");
  static_assert(BW_RUN == 8 && BW_X == 8 * BW_RUN && BW_Y * 8 <= NT &&
                    NT % 32 == 0,
                "x tasks: a row of eight runs, one a thread, four rows a warp");
  static_assert(BW_Y % BW_RUN == 0, "whole y runs a tile");
  static_assert((BW_RUN + N - 1) % 4 == 0, "the x window in 16-byte words");
  static_assert(BW_AHEAD >= 1, "the next plane is asked for before it is summed");

  // granule i of thread tid: halo granule tid + i * NT, if there is one
  static __device__ __forceinline__ bool active(int i, int tid) {
    return (i + 1) * NT <= NG || tid + i * NT < NG;
  }
};

// four columns col .. col + 3 of a row, clamped to [0, X)
__device__ __forceinline__ float4 load_granule(const float* __restrict__ row,
                                               int col, bool whole, int X) {
  if (whole) return __ldg(reinterpret_cast<const float4*>(row + col));
  return make_float4(__ldg(row + clampi(col, 0, X - 1)),
                     __ldg(row + clampi(col + 1, 0, X - 1)),
                     __ldg(row + clampi(col + 2, 0, X - 1)),
                     __ldg(row + clampi(col + 3, 0, X - 1)));
}

// The thread's granules of a walk: their row offsets in a plane, first
// columns, whether one 16-byte load reads each, and the ring of planes.
template <int TZ, int N>
struct WalkGranules {
  using W = Walk<TZ, N>;
  int rowoff[W::G], col[W::G];
  bool whole[W::G];
  float4 win[W::G][W::RING];  // walk plane p in slot p % RING
};

// z sums of one output plane into zb, its window in ring slots s .. s + TZ
// - 1; then slot s asks for walk plane ``next`` (none if < 0). I: the slot
// s as a constant, found by one branch a slot.
template <int TZ, int N, int I>
__device__ __forceinline__ void walk_z(WalkGranules<TZ, N>& g, int s, int next,
                                       float* __restrict__ zb, const BlurTaps& w,
                                       const float* __restrict__ x, size_t plane,
                                       int zbase, int Z, int X, int tid) {
  using W = Walk<TZ, N>;
  if constexpr (I + 1 < W::RING) {
    if (s != I) {
      walk_z<TZ, N, I + 1>(g, s, next, zb, w, x, plane, zbase, Z, X, tid);
      return;
    }
  }
  const float* src = x + (size_t)clampi(zbase + next, 0, Z - 1) * plane;
#pragma unroll
  for (int i = 0; i < W::G; ++i) {
    if (!W::active(i, tid)) continue;
    float4 a = mulv(w.z[0], g.win[i][I]);
#pragma unroll
    for (int t = 1; t < TZ; ++t)
      a = addv(a, mulv(w.z[t], g.win[i][(I + t) % W::RING]));
    const int q = tid + i * W::NT;
    *reinterpret_cast<float4*>(zb + q / W::GR * W::P + q % W::GR * 4) = a;
    if (next >= 0) g.win[i][I] = load_granule(src + g.rowoff[i], g.col[i], g.whole[i], X);
  }
}

// y pass out of zb into yb: y task t is column t % P, rows r0 .. r0 +
// BW_RUN - 1 (r0 = t / P * BW_RUN); thread tid takes tasks NT - 1 - tid +
// k * NT, so that the threads with a granule fewer take the extra tasks
template <int TZ, int N>
__device__ __forceinline__ void walk_y(const float* __restrict__ zb,
                                       float* __restrict__ yb, const BlurTaps& w,
                                       int tid) {
  using W = Walk<TZ, N>;
#pragma unroll
  for (int k = 0; k < W::YK; ++k) {
    const int t = W::NT - 1 - tid + k * W::NT;
    if ((k + 1) * W::NT > W::YT && t >= W::YT) break;
    const int c = t % W::P, r0 = t / W::P * BW_RUN;
    const float* in = zb + r0 * W::P + c;
    float acc[BW_RUN];
#pragma unroll
    for (int i = 0; i < BW_RUN + N - 1; ++i)
      taps_in_order<N>(w.y, i, in[i * W::P], acc);
#pragma unroll
    for (int o = 0; o < BW_RUN; ++o) yb[(r0 + o) * W::YP + c] = acc[o];
  }
}

// x pass out of yb into output plane dst: row r, columns c0 .. c0 + BW_RUN
// - 1 of the tile (output column c0's window starts at y-buffer column c0)
template <int TZ, int N>
__device__ __forceinline__ void walk_x(const float* __restrict__ yb,
                                       float* __restrict__ dst, const BlurTaps& w,
                                       int Y, int X, int y0, int x0, int vec,
                                       int tid) {
  using W = Walk<TZ, N>;
  if (tid >= BW_Y * 8) return;
  // warp v: rows 4v .. 4v + 3; a quarter warp (lanes 8h .. 8h + 7): two
  // rows x four runs, 32 columns a row, which the y buffer's pitch (4 mod
  // 32) puts on distinct banks; a warp stores four whole rows
  const int lane = tid % 32, h = lane / 8, m = lane % 8;
  const int r = tid / 32 * 4 + h / 2 * 2 + m / 4;
  const int c0 = (h % 2 * 4 + m % 4) * BW_RUN;
  const int yy = y0 + r, xx = x0 + c0;
  if (yy >= Y || xx >= X) return;
  const float4* in4 = reinterpret_cast<const float4*>(yb + r * W::YP + c0);
  float acc[BW_RUN];
#pragma unroll
  for (int k4 = 0; k4 < (BW_RUN + N - 1) / 4; ++k4) {
    const float4 v = in4[k4];
    taps_in_order<N>(w.x, 4 * k4, v.x, acc);
    taps_in_order<N>(w.x, 4 * k4 + 1, v.y, acc);
    taps_in_order<N>(w.x, 4 * k4 + 2, v.z, acc);
    taps_in_order<N>(w.x, 4 * k4 + 3, v.w, acc);
  }
  dst += (size_t)yy * X + xx;
  if (vec && xx + BW_RUN <= X) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int o = 0; o < BW_RUN; ++o)
      if (xx + o < X) dst[o] = acc[o];
  }
}

// A block walks output planes z0 .. z0 + cz - 1 of one tile, three planes
// in flight a step: the x pass of plane j (y buffer j % 2), the y pass of
// plane j + 1 (z buffer (j + 1) % 2 into y buffer (j + 1) % 2) and the z
// sums of plane j + 2 (into z buffer j % 2), then one barrier.
template <int TZ, int N>
__global__ void __launch_bounds__(Walk<TZ, N>::NT, Walk<TZ, N>::MIN_BLOCKS)
blur_walk_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const BlurTaps w, int Z, int Y, int X, int cz, int vec) {
  using W = Walk<TZ, N>;
  extern __shared__ __align__(16) float smem[];
  float* zbuf = smem;              // two z buffers: z sums over the halo
  float* ybuf = smem + 2 * W::ZB;  // two y buffers: the y pass
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * BW_Y, x0 = blockIdx.x * BW_X;
  const int z0 = blockIdx.z * cz, nz = min(cz, Z - z0);
  const int zbase = z0 - TZ / 2;    // walk plane 0
  const int nplanes = nz + TZ - 1;  // walk planes
  const size_t plane = (size_t)Y * X;

  WalkGranules<TZ, N> g;
#pragma unroll
  for (int i = 0; i < W::G; ++i) {
    const int q = min(tid + i * W::NT, W::NG - 1);
    g.rowoff[i] = clampi(y0 - W::R + q / W::GR, 0, Y - 1) * X;
    g.col[i] = x0 - W::R + q % W::GR * 4;
    g.whole[i] = vec && g.col[i] >= 0 && g.col[i] + 3 < X;
  }
#pragma unroll
  for (int p = 0; p < W::RING; ++p) {
    const float* src = x + (size_t)clampi(zbase + p, 0, Z - 1) * plane;
#pragma unroll
    for (int i = 0; i < W::G; ++i)
      if (p < nplanes && W::active(i, tid))
        g.win[i][p] = load_granule(src + g.rowoff[i], g.col[i], g.whole[i], X);
  }

  for (int j = -2; j < nz; ++j) {
    if (j >= 0)
      walk_x<TZ, N>(ybuf + (j & 1) * W::YB, out + (size_t)(z0 + j) * plane, w, Y,
                    X, y0, x0, vec, tid);
    if (j + 1 >= 0 && j + 1 < nz)
      walk_y<TZ, N>(zbuf + ((j + 1) & 1) * W::ZB, ybuf + ((j + 1) & 1) * W::YB, w, tid);
    if (j + 2 < nz) {
      const int next = j + 2 + W::RING < nplanes ? j + 2 + W::RING : -1;
      walk_z<TZ, N, 0>(g, (j + 2) % W::RING, next, zbuf + (j & 1) * W::ZB, w, x,
                       plane, zbase, Z, X, tid);
    }
    __syncthreads();
  }
}

template <int NY, int NX>
cudaError_t launch_tile(const float* x, float* out, const BlurTaps& w, int Z,
                        int Y, int X, int tz, int ty, int tx, int vec,
                        cudaStream_t s) {
  const int ry = ty / 2, rxa = (tx / 2 + 3) & ~3;
  const size_t bytes = sizeof(float) * (size_t)(2 * BT_Y + 2 * ry) * (BT_X + 2 * rxa);
  // above 48 KB only after this; the largest tile (33 taps) needs 100 KB
  static std::atomic<bool> opted_in[MAX_CARDS];
  const int dev = current_card();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const int most = sizeof(float) * (2 * BT_Y + 2 * (kMaxTaps / 2)) *
                     (BT_X + 2 * ((kMaxTaps / 2 + 3) & ~3));
    const cudaError_t e = cudaFuncSetAttribute(
        blur_tile_kernel<NY, NX>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    opted_in[dev] = true;
  }
  dim3 grid((X + BT_X - 1) / BT_X, (Y + BT_Y - 1) / BT_Y, Z);
  blur_tile_kernel<NY, NX><<<grid, BT_THREADS, bytes, s>>>(x, out, w, Z, Y, X,
                                                          tz, ty, tx, vec);
  return cudaGetLastError();
}

template <int TZ, int N>
cudaError_t launch_walk(const float* x, float* out, const BlurTaps& w, int Z,
                        int Y, int X, int vec, cudaStream_t s) {
  using W = Walk<TZ, N>;
  static std::atomic<int> slot_cache[MAX_CARDS];  // blocks a card runs at once
  const int dev = current_card();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (slot_cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)  // above 48 KB only after this
      e = cudaFuncSetAttribute(blur_walk_kernel<TZ, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, blur_walk_kernel<TZ, N>, W::NT, W::SMEM);
    if (e != cudaSuccess) return e;
    slot_cache[dev] = max(1, sms * per_sm);
  }
  const int slots = slot_cache[dev];
  const int tiles_x = (X + BW_X - 1) / BW_X, tiles_y = (Y + BW_Y - 1) / BW_Y;
  // z chunks: a chunk reloads TZ - 1 planes; more chunks fill the last wave
  // of blocks. Cost: waves times a block's planes, a loaded-only plane
  // counted as a quarter of a summed one
  int cz = Z;
  long long best = -1;
  for (int n = 1; n <= min(Z, 16); ++n) {
    const int c = (Z + n - 1) / n, chunks = (Z + c - 1) / c;
    const long long waves =
        ((long long)tiles_x * tiles_y * chunks + slots - 1) / slots;
    const long long cost = waves * (4LL * c + TZ - 1);
    if (best < 0 || cost < best) {
      best = cost;
      cz = c;
    }
  }
  dim3 grid(tiles_x, tiles_y, (Z + cz - 1) / cz);
  blur_walk_kernel<TZ, N><<<grid, W::NT, W::SMEM, s>>>(x, out, w, Z, Y, X, cz,
                                                       vec);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_z(const float* x, float* out, const BlurTaps& w, int Z,
                     int n, int tz, cudaStream_t s) {
  dim3 grid((n + BZ_THREADS - 1) / BZ_THREADS, (Z + BZ_CHUNK - 1) / BZ_CHUNK);
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out);
  if (tz == 5)  // the small-score blur's z axis
    blur_z_kernel<5, V><<<grid, BZ_THREADS, 0, s>>>(xv, ov, w, Z, n, tz);
  else
    blur_z_kernel<0, V><<<grid, BZ_THREADS, 0, s>>>(xv, ov, w, Z, n, tz);
  return cudaGetLastError();
}

// the taps of a call, or false if blur3d takes no such call
bool pack_taps(const float* taps, int Z, int Y, int X, int tz, int ty, int tx,
               BlurTaps& w) {
  if (tz < 1 || ty < 1 || tx < 1 || tz > kMaxTaps || ty > kMaxTaps ||
      tx > kMaxTaps || tz % 2 == 0 || ty % 2 == 0 || tx % 2 == 0 || Z < 1 ||
      Y < 1 || X < 1 || Z > 65535 || (Y + BT_Y - 1) / BT_Y > 65535 ||
      (Y + BW_Y - 1) / BW_Y > 65535 || (size_t)Y * X > 0x7fffffff)
    return false;
  w = {};
  for (int i = 0; i < tz; ++i) w.z[i] = taps[i];
  for (int i = 0; i < ty; ++i) w.y[i] = taps[tz + i];
  for (int i = 0; i < tx; ++i) w.x[i] = taps[tz + ty + i];
  return true;
}

}  // namespace

extern "C" {

// taps: HOST array of tz + ty + tx floats (z taps, then y, then x), each
// count odd and <= 33, passed on as kernel parameters. Returns the
// cudaError_t of the launch. Picks the z-only, 25-tap tile or generic tile
// kernel by the taps.
int blur3d_f32(const float* x, float* out, const float* taps, int Z, int Y,
               int X, int tz, int ty, int tx, void* stream) {
  BlurTaps w;
  if (!pack_taps(taps, Z, Y, X, tz, ty, tx, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (ty == 1 && tx == 1) {
    const int n = Y * X;
    if (n % 4 == 0 && aligned)
      return (int)launch_z<float4>(x, out, w, Z, n / 4, tz, s);
    return (int)launch_z<float>(x, out, w, Z, n, tz, s);
  }
  // 16-byte loads and stores: rows keep the base pointers' alignment
  const int vec = X % 4 == 0 && aligned;
  if (ty == 25 && tx == 25)  // the watershed pre-blur
    return (int)launch_tile<25, 25>(x, out, w, Z, Y, X, tz, ty, tx, vec, s);
  return (int)launch_tile<0, 0>(x, out, w, Z, Y, X, tz, ty, tx, vec, s);
}

// The walk form, for taps (1, 9, 9), (5, 9, 9) and (9, 17, 17); the same
// arguments as blur3d_f32. Any other tap set is refused
// (cudaErrorInvalidValue).
int blur3d_walk_f32(const float* x, float* out, const float* taps, int Z,
                    int Y, int X, int tz, int ty, int tx, void* stream) {
  BlurTaps w;
  if (!pack_taps(taps, Z, Y, X, tz, ty, tx, w) || ty != tx)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = X % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  switch (tz * 100 + ty) {
    case 109: return (int)launch_walk<1, 9>(x, out, w, Z, Y, X, vec, s);
    case 509: return (int)launch_walk<5, 9>(x, out, w, Z, Y, X, vec, s);
    case 917: return (int)launch_walk<9, 17>(x, out, w, Z, Y, X, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
