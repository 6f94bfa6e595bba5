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
//   Design: one block per 32 x 64 output tile, all channels together. The
//   block stages its z-map tile with an 8-pixel halo in shared memory and
//   reduces its min and max; only planes in [min - 4, max + 4] can have a
//   nonzero mask, and every product is >= 0, so the running max starts at 0
//   and the other planes are skipped exactly. Per admitted plane the z blur
//   of the one-hot mask is a table G[r] = sum_t kz[t] [clip(z + t - 4) == r]
//   looked up per pixel (the mask volume never exists), then the 17 y taps
//   and the 17 x taps run in shared memory, and each channel's uint16 plane
//   is read coalesced and max-accumulated in shared memory.
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
constexpr int PR_THREADS = 256;
constexpr int PR_MAX_Z = 256;

// dynamic shared memory: the running max of every channel, C * PR_Y * PR_X
__global__ void __launch_bounds__(PR_THREADS)
project_kernel(const uint16_t* __restrict__ img, const int* __restrict__ relz,
               const float* __restrict__ taps, float* __restrict__ out, int C,
               int Z, int Y, int X, float off, int ref_channel,
               int atoh_shift) {
  extern __shared__ float acc[];
  __shared__ int zm[PR_ROWS][PR_COLS];
  __shared__ float zb[PR_ROWS][PR_COLS];
  __shared__ float yb[PR_Y][PR_COLS];
  __shared__ float w[PR_TZ + PR_TY + PR_TX];
  __shared__ float g[PR_MAX_Z];
  __shared__ int lo_s, hi_s;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * PR_X, y0 = blockIdx.y * PR_Y;
  if (tid < PR_TZ + PR_TY + PR_TX) w[tid] = taps[tid];
  if (tid == 0) {
    lo_s = Z;
    hi_s = -1;
  }
  for (int i = tid; i < C * PR_Y * PR_X; i += PR_THREADS) acc[i] = 0.f;
  __syncthreads();
  const float* wz = w;
  const float* wy = w + PR_TZ;
  const float* wx = w + PR_TZ + PR_TY;

  // z-map tile with its edge-replicated halo, and its range
  int lo = Z, hi = -1;
  for (int i = tid; i < PR_ROWS * PR_COLS; i += PR_THREADS) {
    const int r = i / PR_COLS, c = i % PR_COLS;
    const int yy = clampi(y0 - PR_RY + r, 0, Y - 1);
    const int xx = clampi(x0 - PR_RX + c, 0, X - 1);
    const int v = relz[(size_t)yy * X + xx];
    zm[r][c] = v;
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
  const int variants = atoh_shift != 0 ? 2 : 1;
  const size_t plane = (size_t)Y * X;

  for (int z = zlo; z <= zhi; ++z) {
    // G[r]: the z pass of the one-hot mask at plane z for z-map value r
    for (int r = tid; r < Z; r += PR_THREADS) {
      float s = 0.f;
      for (int t = 0; t < PR_TZ; ++t) {
        const float term =
            __fmul_rn(wz[t], clampi(z - PR_RZ + t, 0, Z - 1) == r ? 1.f : 0.f);
        s = t == 0 ? term : __fadd_rn(s, term);
      }
      g[r] = s;
    }
    __syncthreads();
    for (int var = 0; var < variants; ++var) {
      const int shift = var == 0 ? 0 : atoh_shift;
      for (int i = tid; i < PR_ROWS * PR_COLS; i += PR_THREADS) {
        const int r = i / PR_COLS, c = i % PR_COLS;
        zb[r][c] = g[clampi(zm[r][c] + shift, 0, Z - 1)];
      }
      __syncthreads();
      for (int i = tid; i < PR_Y * PR_COLS; i += PR_THREADS) {
        const int r = i / PR_COLS, c = i % PR_COLS;
        float s = __fmul_rn(wy[0], zb[r][c]);
        for (int t = 1; t < PR_TY; ++t)
          s = __fadd_rn(s, __fmul_rn(wy[t], zb[r + t][c]));
        yb[r][c] = s;
      }
      __syncthreads();
      for (int i = tid; i < PR_Y * PR_X; i += PR_THREADS) {
        const int r = i / PR_X, c = i % PR_X;
        const int yy = y0 + r, xx = x0 + c;
        if (yy >= Y || xx >= X) continue;
        float m = __fmul_rn(wx[0], yb[r][c]);
        for (int t = 1; t < PR_TX; ++t)
          m = __fadd_rn(m, __fmul_rn(wx[t], yb[r][c + t]));
        for (int ch = 0; ch < C; ++ch) {
          // variant 0 serves every channel without a shift, else only the
          // reference channel; variant 1 the others
          const bool mine = variants == 1 || ((ch == ref_channel) == (var == 0));
          if (!mine) continue;
          float v = (float)img[((size_t)ch * Z + z) * plane + (size_t)yy * X + xx];
          if (off != 0.f) v = fmaxf(__fsub_rn(v, off), 0.f);
          float* a = acc + (size_t)ch * PR_Y * PR_X + i;
          *a = fmaxf(*a, __fmul_rn(v, m));
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < C * PR_Y * PR_X; i += PR_THREADS) {
    const int ch = i / (PR_Y * PR_X), p = i % (PR_Y * PR_X);
    const int yy = y0 + p / PR_X, xx = x0 + p % PR_X;
    if (yy < Y && xx < X) out[(size_t)ch * plane + (size_t)yy * X + xx] = acc[i];
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

// img: (C, Z, Y, X) uint16; relz: (Y, X) int32 in [0, Z); taps: device array
// of 9 + 17 + 17 floats (z, y, x). Returns the cudaError_t of the launch.
int proj_project(const uint16_t* img, const int* relz, const float* taps,
                 float* out, int C, int Z, int Y, int X, int tz, int ty,
                 int tx, float off, int ref_channel, int atoh_shift,
                 void* stream) {
  if (tz != PR_TZ || ty != PR_TY || tx != PR_TX || C < 1 || Z < 1 ||
      Z > PR_MAX_Z || Y < 1 || X < 1 || ref_channel < 0 || ref_channel >= C)
    return (int)cudaErrorInvalidValue;
  // static shared memory is ~42 KB; the running maxima take 8 KB a channel,
  // so one channel already passes the 48 KB a block gets without opting in
  const size_t smem = (size_t)C * PR_Y * PR_X * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((X + PR_X - 1) / PR_X, (Y + PR_Y - 1) / PR_Y);
  project_kernel<<<grid, PR_THREADS, smem, (cudaStream_t)stream>>>(
      img, relz, taps, out, C, Z, Y, X, off, ref_channel, atoh_shift);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
