// The two passes of the fused surface projection.
//
// proj_score
//   Replaces: tissue_image_processing_tpu/projection/fused.py:_score_pass
//   (pallas_call -> _make_score_kernel). Computes, from the uint16 reference
//   channel (Z, Y, X), block_reduce(gaussian_blur(min(max(v - off, 0), p95),
//   (0.5, 1, 1)), (1, 4, 4), "mean") with edge-replicate padding: a (Z, Y/4,
//   X/4) float32 score volume.
//   Bound on an H100: memory. At Z = 30, 1024^2 the function reads 62.9 MB
//   and writes 7.9 MB (~21 us at 3.35 TB/s). Its arithmetic in the plain
//   order, with every multiply and add issued on its own, is ~40 instructions
//   an input voxel (~1.3 G, ~40-45 us of the SMs' float32 issue), so the
//   floor of this bit-exact form sits near twice the byte bound. What holds
//   this kernel is instruction issue, not memory: staging 1 to 6 planes
//   ahead runs equally fast, and clock counters put ~55% of a thread's
//   cycles in the z sums, ~40% in the y pass and under 2% at the barrier.
//   Design: a block owns one 4 x 32 output tile (a 24 x 136 input halo) and
//   walks the planes of a z chunk of 16 (two chunks at Z = 30, each
//   re-reading its four halo planes: 1024 blocks, about four waves of two
//   blocks on each of the 132 SMs, which measured faster than one chunk).
//   - Each input plane comes in once: a thread owns four-pixel granules of
//     the halo, copies them with 8-byte cp.async into a shared staging ring
//     SC_STAGES planes ahead of the one it works on (no registers held by
//     loads in flight), and converts each pixel once (offset, clip, float)
//     into a ring of the last five converted planes in its registers. The ring is indexed by plane modulo 5, which the z loop
//     (unrolled five times) makes a compile-time index; planes beyond the
//     edges are the clamped edge plane, so the first and last two output
//     planes see it more than once.
//   - The z taps read the ring in the order t = 0..4 and store the tile's
//     z-summed plane in shared memory.
//   - Register-tiled y pass: a thread owns two columns of one output row,
//     streams the 12 rows of their window once (one 8-byte shared load
//     serves up to 9 taps of 4 sub-rows each) and keeps the sums in
//     registers, then the 4-row mean. The x pass the same way on the 12
//     columns of an output's window, three 16-byte shared loads.
//   - The taps are kernel parameters (constant-bank operands); nothing is
//     copied to the card for them.
//   - One barrier a plane: between two barriers the block makes the z sums
//     of plane k, the y pass of plane k - 1 and the x pass of plane k - 2
//     (the z-summed and y-summed tiles are double-buffered), the y and x
//     passes on threads of their own, so no pass waits for another's
//     stragglers and their latencies overlap.
//   The full-resolution blurred volume never reaches device memory.
//
// proj_project
//   Replaces: tissue_image_processing_tpu/projection/fused.py:_project_pass
//   (pallas_call -> _make_project_kernel). Computes out[c, y, x] =
//   max_z v[c, z, y, x] * M[z, y, x] with M the edge-replicate (1, 2, 2)
//   Gaussian blur of the one-hot mask of the z-map (the atoh_shift-ed z-map
//   for channels other than the reference), v the uint16 channel after the
//   optional airyscan offset.
//   Bound on an H100: memory. Reading every plane of C = 2, Z = 30, 1024^2
//   costs 126 MB plus the 4 MB z-map and the 8 MB output (~41 us); the gate
//   below admits only planes within 4 of the z-map near each tile, so the
//   bytes this input needs are far fewer (chip_smoke.py counts them from the
//   run's z-map). Its arithmetic is ~90 flops per admitted pixel-plane.
//   Design: one block of 320 threads per 32 x 64 output tile and channel
//   group (two channels together when C is even, else one). The block stages
//   its z-map tile with an 8-pixel halo in shared memory, one byte a pixel,
//   and reduces its min and max; only planes in [min - 4, max + 4] can have
//   a nonzero mask, and every product is >= 0, so the running max starts at
//   0 and the other planes are skipped exactly. What bounded the first form
//   was not bytes but shared-memory traffic (one load a multiply-add), four
//   barriers a plane, a read-modify-write of the running maxima in shared
//   memory and the image loads sitting behind the taps. Here:
//   - the z blur of the one-hot mask is a table G[r] = sum_t kz[t]
//     [clip(z + t - 4) == r] (the mask volume never exists), built for plane
//     z + 1 while plane z is worked on (double-buffered, no barrier of its
//     own), one table for the reference channel and one for the atoh_shift-ed
//     others;
//   - the y taps read the table through the z-map directly (no staged
//     plane): a thread owns 8 rows of one column, streams the 24 inputs once
//     and keeps the 8 sums in registers, each sum still adding its taps from
//     0 upward;
//   - the x taps the same way: a thread owns 8 consecutive outputs of a row,
//     reads its 24 inputs as six 16-byte words, and multiplies the result
//     straight into the running maxima, which live in registers (a thread
//     always owns the same pixels);
//   - the y sums are double-buffered, so a plane costs one barrier;
//   - a thread loads its 8 pixels of each channel of a plane as one 16-byte
//     word before the plane's taps, so the load's latency hides behind them;
//   - the taps are kernel parameters: operands from the constant bank, no
//     load and no register.
//
// Both kernels sum every axis from tap 0 upward with separate round-to-nearest
// multiplies and adds (__fmul_rn/__fadd_rn: no contraction into FMA), in the
// order z, y, x of their plain PyTorch versions (projection/fused.py), so the
// two agree bit for bit.

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------- score pass
constexpr int SC_RZ = 2, SC_RY = 4, SC_RX = 4;
constexpr int SC_TZ = 2 * SC_RZ + 1, SC_TY = 2 * SC_RY + 1, SC_TX = 2 * SC_RX + 1;
constexpr int DEC = 4;
constexpr int SC_OY = 4;           // output rows of a tile
constexpr int SC_OX = 32;          // output columns of a tile
constexpr int SC_THREADS = 416;
constexpr int SC_MIN_BLOCKS = 2;   // blocks an SM the registers must allow
constexpr int SC_ZCHUNK = 16;      // output planes a block walks
constexpr int SC_STAGES = 4;       // input planes in flight (cp.async)
constexpr int SC_ROWS = SC_OY * DEC + 2 * SC_RY;  // 24 input rows with halo
constexpr int SC_COLS = SC_OX * DEC + 2 * SC_RX;  // 136 input columns with halo
constexpr int SC_PITCH = SC_COLS + 4;             // z-summed row, padded
constexpr int SC_GRAN = SC_COLS / 4;              // four-pixel granules a row
constexpr int SC_GROUPS = SC_ROWS * SC_GRAN;
constexpr int SC_G = (SC_GROUPS + SC_THREADS - 1) / SC_THREADS;  // granules a thread owns
constexpr int SC_Y_TASKS = SC_OY * SC_COLS / 2;   // (output row, column pair)
constexpr int SC_X_TASKS = SC_OY * SC_OX;         // outputs
static_assert(SC_RX % 4 == 0, "granules start on 4-pixel boundaries");
static_assert(SC_TZ == 5, "the ring holds five planes");

struct ScoreTaps {
  float z[SC_TZ], y[SC_TY], x[SC_TX];
};

template <int V>
struct Int {
  static constexpr int value = V;
};

// sums[o] = sum_t w[t] * in[o + t], every sum from tap 0 upward, as input k
// arrives: it is tap k - o of output o.
template <int RUN, int NT>
__device__ __forceinline__ void taps_in_order(const float (&w)[NT], int k,
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

// The mean of 4 sub-row (or sub-column) sums, added in order, times 0.25.
__device__ __forceinline__ float mean4(const float (&s)[DEC]) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(s[0], s[1]), s[2]), s[3]),
                   0.25f);
}

// Four pixels of one row from column x on: one 8-byte load inside the row,
// else four loads at clamped columns.
__device__ __forceinline__ uint2 load4(const uint16_t* __restrict__ row,
                                       int x, int X, int vec) {
  if (vec && x >= 0 && x + 3 < X) return __ldg(reinterpret_cast<const uint2*>(row + x));
  unsigned p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __ldg(row + clampi(x + i, 0, X - 1));
  return make_uint2(p[0] | p[1] << 16, p[2] | p[3] << 16);
}

// An 8-byte copy from device to shared memory that does not hold the
// thread: cp.async, completed by groups.
__device__ __forceinline__ void cp_async8(unsigned smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // at most N groups pending
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float clip(unsigned raw, float off, float p95) {
  float v = (float)raw;
  if (off != 0.f) v = fmaxf(__fsub_rn(v, off), 0.f);
  return fminf(v, p95);
}

__global__ void __launch_bounds__(SC_THREADS, SC_MIN_BLOCKS)
score_kernel(const uint16_t* __restrict__ vol, const float* __restrict__ p95p,
             const ScoreTaps w, float* __restrict__ out, int Z, int Y, int X,
             float off, int vec) {
  __shared__ __align__(16) float zb[2][SC_ROWS][SC_PITCH];
  __shared__ __align__(16) float yb[2][SC_OY][SC_COLS];
  extern __shared__ __align__(16) uint2 stage[];  // [SC_STAGES][SC_G][SC_THREADS]

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * SC_OX, oy0 = blockIdx.y * SC_OY;
  const int xh = ox0 * DEC - SC_RX, yh = oy0 * DEC - SC_RY;  // halo origin
  const int z0 = blockIdx.z * SC_ZCHUNK, n = min(Z - z0, SC_ZCHUNK);
  const int OY = Y / DEC, OX = X / DEC;
  const float p95 = __ldg(p95p);
  const size_t plane = (size_t)Y * X;

  // this thread's granules: halo row r, columns 4g .. 4g + 3
  int rowoff[SC_G], gr[SC_G], gc[SC_G];
  bool live[SC_G];
#pragma unroll
  for (int i = 0; i < SC_G; ++i) {
    const int q = tid + i * SC_THREADS;
    live[i] = q < SC_GROUPS;
    gr[i] = live[i] ? q / SC_GRAN : 0;
    gc[i] = live[i] ? q % SC_GRAN * 4 : 0;
    rowoff[i] = clampi(yh + gr[i], 0, Y - 1) * X;
  }
  // plane j of the walk is virtual plane z0 - SC_RZ + j (clamped to the
  // stack); it is staged in slot j % SC_STAGES, SC_STAGES planes in flight.
  // A thread stages and later reads only its own granules, so the staging
  // needs no barrier: its own cp.async groups tell it what has arrived
  auto fetch = [&](int j) {
    if (j < n + 2 * SC_RZ) {
      const uint16_t* base =
          vol + (size_t)clampi(z0 - SC_RZ + j, 0, Z - 1) * plane;
#pragma unroll
      for (int i = 0; i < SC_G; ++i) {
        if (!live[i]) continue;
        uint2* dst = stage + ((j % SC_STAGES) * SC_G + i) * SC_THREADS + tid;
        const int x = xh + gc[i];
        if (vec && x >= 0 && x + 3 < X)
          cp_async8((unsigned)__cvta_generic_to_shared(dst), base + rowoff[i] + x);
        else  // a granule over the image's edge: clamped columns, loaded now
          *dst = load4(base + rowoff[i], x, X, vec);
      }
    }
    cp_async_commit();  // an empty group past the last plane keeps the count
  };
  float4 ring[5][SC_G];  // converted planes, slot = j mod 5
  // plane j, once it has arrived, converted into dst; then plane
  // j + SC_STAGES into the staging slot it leaves
  auto take = [&](int j, float4 (&dst)[SC_G]) {
    cp_async_wait<SC_STAGES - 1>();
#pragma unroll
    for (int i = 0; i < SC_G; ++i) {
      if (!live[i]) continue;
      const uint2 r = stage[(j % SC_STAGES * SC_G + i) * SC_THREADS + tid];
      dst[i] = make_float4(clip(r.x & 0xffffu, off, p95), clip(r.x >> 16, off, p95),
                           clip(r.y & 0xffffu, off, p95), clip(r.y >> 16, off, p95));
    }
    fetch(j + SC_STAGES);
  };
#pragma unroll
  for (int j = 0; j < SC_STAGES; ++j) fetch(j);
#pragma unroll
  for (int j = 0; j < 2 * SC_RZ; ++j) take(j, ring[j]);

  // the y pass (threads below SC_Y_TASKS): output row yr, halo columns yc,
  // yc + 1
  const int yc = tid % (SC_COLS / 2) * 2, yr = tid / (SC_COLS / 2);
  // the x pass (the last SC_X_TASKS threads): output row xr, column xc
  const int xt = tid - (SC_THREADS - SC_X_TASKS);
  const bool x_thread = xt >= 0;
  const int xr = x_thread ? xt / SC_OX : 0, xc = x_thread ? xt % SC_OX : 0;
  const int oy = oy0 + xr, ox = ox0 + xc;
  static_assert(SC_Y_TASKS + SC_X_TASKS <= SC_THREADS,
                "the y and x passes on threads of their own");

  // step k: the z sums of plane k, the y pass of plane k - 1 and the x pass
  // of plane k - 2 between the same two barriers (zb and yb are
  // double-buffered); S = k mod 5 names the ring slots at compile time
  auto step = [&](int k, auto S_) {
    constexpr int S = decltype(S_)::value;
    if (k < n) {
      take(k + 2 * SC_RZ, ring[(S + 4) % 5]);
#pragma unroll
      for (int i = 0; i < SC_G; ++i) {
        if (!live[i]) continue;
        float4 a;
#pragma unroll
        for (int t = 0; t < SC_TZ; ++t) {
          const float4 v = ring[(S + t) % 5][i];
          if (t == 0) {
            a = make_float4(__fmul_rn(w.z[0], v.x), __fmul_rn(w.z[0], v.y),
                            __fmul_rn(w.z[0], v.z), __fmul_rn(w.z[0], v.w));
          } else {
            a.x = __fadd_rn(a.x, __fmul_rn(w.z[t], v.x));
            a.y = __fadd_rn(a.y, __fmul_rn(w.z[t], v.y));
            a.z = __fadd_rn(a.z, __fmul_rn(w.z[t], v.z));
            a.w = __fadd_rn(a.w, __fmul_rn(w.z[t], v.w));
          }
        }
        *reinterpret_cast<float4*>(&zb[k & 1][gr[i]][gc[i]]) = a;
      }
    }
    if (k >= 1 && k <= n && tid < SC_Y_TASKS) {
      const int kb = (k - 1) & 1;
      float s0[DEC], s1[DEC];
#pragma unroll
      for (int kk = 0; kk < DEC + SC_TY - 1; ++kk) {
        const float2 v = *reinterpret_cast<const float2*>(&zb[kb][yr * DEC + kk][yc]);
        taps_in_order(w.y, kk, v.x, s0);
        taps_in_order(w.y, kk, v.y, s1);
      }
      yb[kb][yr][yc] = mean4(s0);
      yb[kb][yr][yc + 1] = mean4(s1);
    }
    if (k >= 2 && x_thread) {
      const float4* in = reinterpret_cast<const float4*>(&yb[k & 1][xr][xc * DEC]);
      float s[DEC];
#pragma unroll
      for (int k4 = 0; k4 < (DEC + SC_TX - 1) / 4; ++k4) {
        const float4 v = in[k4];
        taps_in_order(w.x, 4 * k4, v.x, s);
        taps_in_order(w.x, 4 * k4 + 1, v.y, s);
        taps_in_order(w.x, 4 * k4 + 2, v.z, s);
        taps_in_order(w.x, 4 * k4 + 3, v.w, s);
      }
      if (oy < OY && ox < OX)
        out[(size_t)(z0 + k - 2) * OY * OX + (size_t)oy * OX + ox] = mean4(s);
    }
    // what this step wrote is read, and what it read is overwritten, only
    // after this barrier
    __syncthreads();
  };
  for (int k = 0; k < n + 2; k += 5) {
    step(k, Int<0>{});
    if (k + 1 < n + 2) step(k + 1, Int<1>{});
    if (k + 2 < n + 2) step(k + 2, Int<2>{});
    if (k + 3 < n + 2) step(k + 3, Int<3>{});
    if (k + 4 < n + 2) step(k + 4, Int<4>{});
  }
}

// -------------------------------------------------------------- project pass
constexpr int PR_RZ = 4, PR_RY = 8, PR_RX = 8;
constexpr int PR_TZ = 2 * PR_RZ + 1, PR_TY = 2 * PR_RY + 1, PR_TX = 2 * PR_RX + 1;
constexpr int PR_Y = 32, PR_X = 64;  // output tile
constexpr int PR_ROWS = PR_Y + 2 * PR_RY;  // 48
constexpr int PR_COLS = PR_X + 2 * PR_RX;  // 80
constexpr int PR_RUN = 8;                  // outputs a thread owns along a tap axis
constexpr int PR_WIN = PR_RUN + 2 * PR_RY; // inputs such a run reads: 24
constexpr int PR_THREADS = PR_COLS * (PR_Y / PR_RUN);       // 320: the y pass
constexpr int PR_X_THREADS = PR_Y * (PR_X / PR_RUN);        // 256: the x pass
constexpr int PR_MAX_Z = 256;
constexpr int PR_MIN_BLOCKS = 3;  // blocks an SM the registers must allow
static_assert(PR_RY == PR_RX && PR_X_THREADS <= PR_THREADS, "one run length");

struct ProjectTaps {
  float z[PR_TZ], y[PR_TY], x[PR_TX];
};

// Pixel o of the 8 that a uint4 holds, two a word, the first in the low half.
__device__ __forceinline__ unsigned pixel(const uint4& p, int o) {
  const unsigned word = o < 2 ? p.x : o < 4 ? p.y : o < 6 ? p.z : p.w;
  return (word >> (16 * (o & 1))) & 0xffffu;
}

// One block: an output tile and the CB channels from blockIdx.z * CB.
template <int CB>
__global__ void __launch_bounds__(PR_THREADS, PR_MIN_BLOCKS)
project_kernel(const uint16_t* __restrict__ img, const int* __restrict__ relz,
               const ProjectTaps w, float* __restrict__ out, int Z, int Y,
               int X, float off, int ref_channel, int atoh_shift, int vec) {
  __shared__ uint8_t zm[PR_ROWS][PR_COLS];
  __shared__ __align__(16) float yb[2][PR_Y][PR_COLS];
  __shared__ float g[2][2][PR_MAX_Z];  // [plane parity][mask variant][z-map value]
  __shared__ int lo_s, hi_s;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * PR_X, y0 = blockIdx.y * PR_Y;
  const int c0 = blockIdx.z * CB;
  if (tid == 0) {
    lo_s = Z;
    hi_s = -1;
  }
  __syncthreads();

  // z-map tile with its edge-replicated halo, and its range
  int lo = Z, hi = -1;
  for (int i = tid; i < PR_ROWS * PR_COLS; i += PR_THREADS) {
    const int r = i / PR_COLS, c = i % PR_COLS;
    const int yy = clampi(y0 - PR_RY + r, 0, Y - 1);
    const int xx = clampi(x0 - PR_RX + c, 0, X - 1);
    const int v = relz[(size_t)yy * X + xx];
    zm[r][c] = (uint8_t)v;
    lo = min(lo, v);
    hi = max(hi, v);
  }
  atomicMin(&lo_s, lo);
  atomicMax(&hi_s, hi);
  __syncthreads();
  lo = lo_s;
  hi = hi_s;
  if (atoh_shift != 0) {  // the union with the shifted range (clip is monotone)
    lo = min(lo, clampi(lo + atoh_shift, 0, Z - 1));
    hi = max(hi, clampi(hi + atoh_shift, 0, Z - 1));
  }
  const int zlo = max(lo - PR_RZ, 0), zhi = min(hi + PR_RZ, Z - 1);
  const size_t plane = (size_t)Y * X;

  // mask variant 0 (no shift) serves every channel without atoh_shift, else
  // only the reference channel; variant 1 (shifted) the others
  bool use0 = false, use1 = false;
#pragma unroll
  for (int ch = 0; ch < CB; ++ch) {
    const bool shifted = atoh_shift != 0 && c0 + ch != ref_channel;
    use0 = use0 || !shifted;
    use1 = use1 || shifted;
  }

  // G for plane z: the z pass of the one-hot mask for every z-map value
  auto build_table = [&](int z) {
    for (int i = tid; i < 2 * Z; i += PR_THREADS) {
      const int var = i >= Z ? 1 : 0, r = i - var * Z;
      if (!(var ? use1 : use0)) continue;
      const int rr = var ? clampi(r + atoh_shift, 0, Z - 1) : r;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < PR_TZ; ++t) {
        const float term =
            __fmul_rn(w.z[t], clampi(z - PR_RZ + t, 0, Z - 1) == rr ? 1.f : 0.f);
        s = t == 0 ? term : __fadd_rn(s, term);
      }
      g[z & 1][var][r] = s;
    }
  };

  // the y pass: column yc, output rows yr .. yr + 7 (input rows yr .. yr + 23)
  const int yc = tid % PR_COLS, yr = (tid / PR_COLS) * PR_RUN;
  // the x pass and the maxima: row xr, output columns xc .. xc + 7
  const bool x_thread = tid < PR_X_THREADS;
  const int xr = tid / (PR_X / PR_RUN), xc = (tid % (PR_X / PR_RUN)) * PR_RUN;
  const int gy = y0 + xr, gx = x0 + xc;
  const bool row_in = x_thread && gy < Y;
  float acc[CB][PR_RUN];
#pragma unroll
  for (int ch = 0; ch < CB; ++ch)
#pragma unroll
    for (int o = 0; o < PR_RUN; ++o) acc[ch][o] = 0.f;

  build_table(zlo);
  __syncthreads();
  int pass = 0;
  for (int z = zlo; z <= zhi; ++z) {
    // this plane's pixels, asked for before the taps that hide their latency
    uint4 px[CB];  // 8 pixels a channel, two a word
#pragma unroll
    for (int ch = 0; ch < CB; ++ch) {
      const uint16_t* src =
          img + ((size_t)(c0 + ch) * Z + z) * plane + (size_t)gy * X + gx;
      if (row_in && vec && gx + PR_RUN <= X) {
        px[ch] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        unsigned p[PR_RUN];
#pragma unroll
        for (int o = 0; o < PR_RUN; ++o)
          p[o] = row_in && gx + o < X ? __ldg(src + o) : 0;
        px[ch] = make_uint4(p[0] | p[1] << 16, p[2] | p[3] << 16,
                            p[4] | p[5] << 16, p[6] | p[7] << 16);
      }
    }
    if (z < zhi) build_table(z + 1);

#pragma unroll
    for (int var = 0; var < 2; ++var) {
      if (!(var ? use1 : use0)) continue;
      const float* gz = g[z & 1][var];
      float sums[PR_RUN];
#pragma unroll
      for (int k = 0; k < PR_WIN; ++k)
        taps_in_order(w.y, k, gz[zm[yr + k][yc]], sums);
#pragma unroll
      for (int o = 0; o < PR_RUN; ++o) yb[pass & 1][yr + o][yc] = sums[o];
      __syncthreads();
      if (x_thread) {
        const float4* in = reinterpret_cast<const float4*>(&yb[pass & 1][xr][xc]);
#pragma unroll
        for (int k4 = 0; k4 < PR_WIN / 4; ++k4) {
          const float4 v = in[k4];
          taps_in_order(w.x, 4 * k4, v.x, sums);
          taps_in_order(w.x, 4 * k4 + 1, v.y, sums);
          taps_in_order(w.x, 4 * k4 + 2, v.z, sums);
          taps_in_order(w.x, 4 * k4 + 3, v.w, sums);
        }
#pragma unroll
        for (int ch = 0; ch < CB; ++ch) {
          if ((atoh_shift != 0 && c0 + ch != ref_channel ? 1 : 0) != var)
            continue;
#pragma unroll
          for (int o = 0; o < PR_RUN; ++o) {
            float v = (float)pixel(px[ch], o);
            if (off != 0.f) v = fmaxf(__fsub_rn(v, off), 0.f);
            acc[ch][o] = fmaxf(acc[ch][o], __fmul_rn(v, sums[o]));
          }
        }
      }
      // the next pass writes the other y buffer, and this one again only
      // after the barrier in between: one barrier a pass
      ++pass;
    }
  }

  if (!row_in) return;
#pragma unroll
  for (int ch = 0; ch < CB; ++ch) {
    float* dst = out + (size_t)(c0 + ch) * plane + (size_t)gy * X + gx;
    if (vec && gx + PR_RUN <= X) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      d4[0] = make_float4(acc[ch][0], acc[ch][1], acc[ch][2], acc[ch][3]);
      d4[1] = make_float4(acc[ch][4], acc[ch][5], acc[ch][6], acc[ch][7]);
    } else {
#pragma unroll
      for (int o = 0; o < PR_RUN; ++o)
        if (gx + o < X) dst[o] = acc[ch][o];
    }
  }
}

}  // namespace

extern "C" {

// taps: HOST array of 5 + 9 + 9 floats (z, y, x), passed on as kernel
// parameters; p95: device scalar. Y and X multiples of 4. Returns the
// cudaError_t of the launch.
int proj_score(const uint16_t* vol, const float* p95, const float* taps,
               float* out, int Z, int Y, int X, int tz, int ty, int tx,
               float off, void* stream) {
  if (tz != SC_TZ || ty != SC_TY || tx != SC_TX || Z < 1 || Y < DEC ||
      X < DEC || Y % DEC || X % DEC ||
      (Y / DEC + SC_OY - 1) / SC_OY > 65535)
    return (int)cudaErrorInvalidValue;
  ScoreTaps w;
  for (int i = 0; i < SC_TZ; ++i) w.z[i] = taps[i];
  for (int i = 0; i < SC_TY; ++i) w.y[i] = taps[SC_TZ + i];
  for (int i = 0; i < SC_TX; ++i) w.x[i] = taps[SC_TZ + SC_TY + i];
  // 8-byte loads of 4 pixels: X % 4 == 0 keeps every row on the base's
  // alignment
  const int vec = (uintptr_t)vol % 8 == 0;
  dim3 grid((X / DEC + SC_OX - 1) / SC_OX, (Y / DEC + SC_OY - 1) / SC_OY,
            (Z + SC_ZCHUNK - 1) / SC_ZCHUNK);
  // the staging ring is dynamic shared memory: with the static tiles it
  // passes 48 KB, which a kernel may use only after this
  const int staged = SC_STAGES * SC_G * SC_THREADS * (int)sizeof(uint2);
  static std::atomic<bool> opted_in[MAX_CARDS];
  const int dev = current_card();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, staged);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  score_kernel<<<grid, SC_THREADS, staged, (cudaStream_t)stream>>>(
      vol, p95, w, out, Z, Y, X, off, vec);
  return (int)cudaGetLastError();
}

// img: (C, Z, Y, X) uint16; relz: (Y, X) int32 in [0, Z); taps: HOST array
// of 9 + 17 + 17 floats (z, y, x), passed on as kernel parameters. Returns
// the cudaError_t of the launch.
int proj_project(const uint16_t* img, const int* relz, const float* taps,
                 float* out, int C, int Z, int Y, int X, int tz, int ty,
                 int tx, float off, int ref_channel, int atoh_shift,
                 void* stream) {
  if (tz != PR_TZ || ty != PR_TY || tx != PR_TX || C < 1 || Z < 1 ||
      Z > PR_MAX_Z || Y < 1 || X < 1 || ref_channel < 0 || ref_channel >= C ||
      C > 65535)
    return (int)cudaErrorInvalidValue;
  ProjectTaps w;
  for (int i = 0; i < PR_TZ; ++i) w.z[i] = taps[i];
  for (int i = 0; i < PR_TY; ++i) w.y[i] = taps[PR_TZ + i];
  for (int i = 0; i < PR_TX; ++i) w.x[i] = taps[PR_TZ + PR_TY + i];
  // 16-byte loads of 8 pixels and stores of 4 results: rows and planes must
  // keep the alignment of the base pointers
  const int vec = X % 8 == 0 && (uintptr_t)img % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const int cb = C % 2 == 0 ? 2 : 1;
  dim3 grid((X + PR_X - 1) / PR_X, (Y + PR_Y - 1) / PR_Y, C / cb);
  cudaStream_t s = (cudaStream_t)stream;
  if (cb == 2)
    project_kernel<2><<<grid, PR_THREADS, 0, s>>>(
        img, relz, w, out, Z, Y, X, off, ref_channel, atoh_shift, vec);
  else
    project_kernel<1><<<grid, PR_THREADS, 0, s>>>(
        img, relz, w, out, Z, Y, X, off, ref_channel, atoh_shift, vec);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
