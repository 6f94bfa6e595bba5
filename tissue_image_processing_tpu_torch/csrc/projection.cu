// The two passes of the fused surface projection.
//
// proj_score
//   Replaces: tissue_image_processing_tpu/projection/fused.py:_score_pass
//   (pallas_call -> _make_score_kernel). Computes, from the uint16 reference
//   channel (Z, Y, X), block_reduce(gaussian_blur(min(max(v - off, 0), p95),
//   (0.5, 1, 1)), (1, 4, 4), "mean") with edge-replicate padding: a (Z, Y/4,
//   X/4) float32 score volume.
//   Bound on an H100: memory. At Z = 30, 1024^2 the function reads 62.9 MB
//   and writes 7.9 MB (~21 us at 3.35 TB/s); its arithmetic is ~40 flops per
//   input voxel (~1.3 GFLOP, ~19 us at 67 TFLOP/s float32).
//   Design: one block per (output plane z, 8 x 32 output tile). The block
//   converts its 40 x 136 input halo (y/x radius 4) of the five planes z-2..z+2
//   (clamped) to float32 after the offset and the clip and sums the z taps
//   straight into shared memory, then runs the 9 y taps with the 4-row mean
//   into a second buffer, then the 9 x taps with the 4-column mean into the
//   output. The full-resolution blurred volume never reaches device memory.
//   z is the fastest grid index, so the blocks that share input planes run
//   together and the five-fold plane reads mostly hit L2. No TPU band-matrix
//   folds: the decimation is a plain sum in shared memory.
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

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------- score pass
constexpr int SC_RZ = 2, SC_RY = 4, SC_RX = 4;
constexpr int SC_TZ = 2 * SC_RZ + 1, SC_TY = 2 * SC_RY + 1, SC_TX = 2 * SC_RX + 1;
constexpr int DEC = 4;
constexpr int SC_OY = 8;    // output rows per block
constexpr int SC_OX = 32;   // output columns per block
constexpr int SC_ROWS = SC_OY * DEC + 2 * SC_RY;  // 40 input rows with halo
constexpr int SC_COLS = SC_OX * DEC + 2 * SC_RX;  // 136 input columns with halo
constexpr int SC_THREADS = 256;

__global__ void __launch_bounds__(SC_THREADS)
score_kernel(const uint16_t* __restrict__ vol, const float* __restrict__ p95p,
             const float* __restrict__ taps, float* __restrict__ out, int Z,
             int Y, int X, float off) {
  __shared__ float zb[SC_ROWS][SC_COLS];
  __shared__ float yb[SC_OY][SC_COLS];
  __shared__ float w[SC_TZ + SC_TY + SC_TX];

  const int tid = threadIdx.x;
  const int z = blockIdx.x;
  const int ox0 = blockIdx.y * SC_OX, oy0 = blockIdx.z * SC_OY;
  const int x0 = ox0 * DEC, y0 = oy0 * DEC;
  const int OY = Y / DEC, OX = X / DEC;
  if (tid < SC_TZ + SC_TY + SC_TX) w[tid] = taps[tid];
  __syncthreads();
  const float* wz = w;
  const float* wy = w + SC_TZ;
  const float* wx = w + SC_TZ + SC_TY;
  const float p95 = *p95p;
  const size_t plane = (size_t)Y * X;

  // offset, clip and z taps over the halo tile
  for (int i = tid; i < SC_ROWS * SC_COLS; i += SC_THREADS) {
    const int r = i / SC_COLS, c = i % SC_COLS;
    const int yy = clampi(y0 - SC_RY + r, 0, Y - 1);
    const int xx = clampi(x0 - SC_RX + c, 0, X - 1);
    const uint16_t* col = vol + (size_t)yy * X + xx;
    float acc = 0.f;
    for (int t = 0; t < SC_TZ; ++t) {
      float v = (float)col[(size_t)clampi(z - SC_RZ + t, 0, Z - 1) * plane];
      if (off != 0.f) v = fmaxf(__fsub_rn(v, off), 0.f);
      v = fminf(v, p95);
      const float term = __fmul_rn(wz[t], v);
      acc = t == 0 ? term : __fadd_rn(acc, term);
    }
    zb[r][c] = acc;
  }
  __syncthreads();

  // y taps, then the mean of each 4 rows
  for (int i = tid; i < SC_OY * SC_COLS; i += SC_THREADS) {
    const int orow = i / SC_COLS, c = i % SC_COLS;
    float s = 0.f;
    for (int d = 0; d < DEC; ++d) {
      const int r0 = orow * DEC + d;
      float acc = __fmul_rn(wy[0], zb[r0][c]);
      for (int t = 1; t < SC_TY; ++t)
        acc = __fadd_rn(acc, __fmul_rn(wy[t], zb[r0 + t][c]));
      s = d == 0 ? acc : __fadd_rn(s, acc);
    }
    yb[orow][c] = __fmul_rn(s, 0.25f);
  }
  __syncthreads();

  // x taps, then the mean of each 4 columns
  for (int i = tid; i < SC_OY * SC_OX; i += SC_THREADS) {
    const int orow = i / SC_OX, ocol = i % SC_OX;
    const int oy = oy0 + orow, ox = ox0 + ocol;
    if (oy >= OY || ox >= OX) continue;
    float s = 0.f;
    for (int d = 0; d < DEC; ++d) {
      const int c0 = ocol * DEC + d;
      float acc = __fmul_rn(wx[0], yb[orow][c0]);
      for (int t = 1; t < SC_TX; ++t)
        acc = __fadd_rn(acc, __fmul_rn(wx[t], yb[orow][c0 + t]));
      s = d == 0 ? acc : __fadd_rn(s, acc);
    }
    out[(size_t)z * OY * OX + (size_t)oy * OX + ox] = __fmul_rn(s, 0.25f);
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

// sums[o] = sum_t w[t] * in[o + t], every sum from tap 0 upward, as input k
// arrives: it is tap k - o of output o.
template <int NT>
__device__ __forceinline__ void run_taps(const float (&w)[NT], int k, float v,
                                         float (&sums)[PR_RUN]) {
#pragma unroll
  for (int o = 0; o < PR_RUN; ++o) {
    const int t = k - o;
    if (t == 0)
      sums[o] = __fmul_rn(w[0], v);
    else if (t > 0 && t < NT)
      sums[o] = __fadd_rn(sums[o], __fmul_rn(w[t], v));
  }
}

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
        run_taps(w.y, k, gz[zm[yr + k][yc]], sums);
#pragma unroll
      for (int o = 0; o < PR_RUN; ++o) yb[pass & 1][yr + o][yc] = sums[o];
      __syncthreads();
      if (x_thread) {
        const float4* in = reinterpret_cast<const float4*>(&yb[pass & 1][xr][xc]);
#pragma unroll
        for (int k4 = 0; k4 < PR_WIN / 4; ++k4) {
          const float4 v = in[k4];
          run_taps(w.x, 4 * k4, v.x, sums);
          run_taps(w.x, 4 * k4 + 1, v.y, sums);
          run_taps(w.x, 4 * k4 + 2, v.z, sums);
          run_taps(w.x, 4 * k4 + 3, v.w, sums);
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

// taps: device array of 5 + 9 + 9 floats (z, y, x); p95: device scalar.
// Y and X multiples of 4. Returns the cudaError_t of the launch.
int proj_score(const uint16_t* vol, const float* p95, const float* taps,
               float* out, int Z, int Y, int X, int tz, int ty, int tx,
               float off, void* stream) {
  if (tz != SC_TZ || ty != SC_TY || tx != SC_TX || Z < 1 || Y < DEC ||
      X < DEC || Y % DEC || X % DEC || Z > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Z, (X / DEC + SC_OX - 1) / SC_OX, (Y / DEC + SC_OY - 1) / SC_OY);
  score_kernel<<<grid, SC_THREADS, 0, (cudaStream_t)stream>>>(
      vol, p95, taps, out, Z, Y, X, off);
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
