// Separable edge-replicate Gaussian correlation along z, y, x in one pass.
//
// Replaces: tissue_image_processing_tpu/ops/blur_pallas.py:blur3d_pallas
//   (_blur3d_fn -> pallas_call -> _make_kernel), the watershed pre-blur
//   (sigma 3: 25 taps per axis) reached through ops/filters.py.
//
// Bound on an H100: memory. The function reads the (Z, Y, X) float32 volume
// once and writes it once (8 MB at 1024^2, ~2.5 us at 3.35 TB/s); its
// arithmetic is 2 * (tz + ty + tx) flops per voxel (~0.1 GFLOP at 1024^2,
// ~1.5 us at 67 TFLOP/s float32).
//
// Design: one block per (TY x TX) output tile of one z-plane. The block
// computes the z pass for its tile plus a y/x halo of the tap radius straight
// from device memory into shared memory, then the y pass into a second shared
// buffer, then the x pass into the output — the volume is read once (plus the
// halo) and the intermediates never touch device memory. Clamped coordinates
// give exactly the edge-replicate padding of the JAX version. Taps accumulate
// from tap 0 upward with separate round-to-nearest multiply and add
// (__fmul_rn/__fadd_rn: no contraction into FMA), the order and rounding of the
// plain PyTorch version, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 33;
constexpr int kMaxR = kMaxTaps / 2;
constexpr int TY = 32;
constexpr int TX = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
blur3d_kernel(const float* __restrict__ x, float* __restrict__ out,
              const float* __restrict__ taps, int Z, int Y, int X, int tz,
              int ty, int tx) {
  __shared__ float zb[TY + 2 * kMaxR][TX + 2 * kMaxR];
  __shared__ float yb[TY][TX + 2 * kMaxR];
  __shared__ float w[3 * kMaxTaps];

  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int rz = tz / 2, ry = ty / 2, rx = tx / 2;
  const float* wz = w;
  const float* wy = w + kMaxTaps;
  const float* wx = w + 2 * kMaxTaps;

  for (int i = tid; i < tz + ty + tx; i += kThreads) {
    int slot = i < tz ? i : (i < tz + ty ? kMaxTaps + i - tz
                                         : 2 * kMaxTaps + i - tz - ty);
    w[slot] = taps[i];
  }
  __syncthreads();

  // z pass over the tile plus its y/x halo
  const int rows = TY + 2 * ry;
  const int cols = TX + 2 * rx;
  const size_t plane = (size_t)Y * X;
  for (int i = tid; i < rows * cols; i += kThreads) {
    int r = i / cols, c = i % cols;
    int yy = clampi(y0 - ry + r, 0, Y - 1);
    int xx = clampi(x0 - rx + c, 0, X - 1);
    const float* col = x + (size_t)yy * X + xx;
    float acc = __fmul_rn(wz[0], col[(size_t)clampi(z - rz, 0, Z - 1) * plane]);
    for (int t = 1; t < tz; ++t)
      acc = __fadd_rn(acc, __fmul_rn(
          wz[t], col[(size_t)clampi(z - rz + t, 0, Z - 1) * plane]));
    zb[r][c] = acc;
  }
  __syncthreads();

  // y pass: TY rows, still with the x halo
  for (int i = tid; i < TY * cols; i += kThreads) {
    int r = i / cols, c = i % cols;
    float acc = __fmul_rn(wy[0], zb[r][c]);
    for (int t = 1; t < ty; ++t) acc = __fadd_rn(acc, __fmul_rn(wy[t], zb[r + t][c]));
    yb[r][c] = acc;
  }
  __syncthreads();

  // x pass into the output tile
  for (int i = tid; i < TY * TX; i += kThreads) {
    int r = i / TX, c = i % TX;
    int yy = y0 + r, xx = x0 + c;
    if (yy >= Y || xx >= X) continue;
    float acc = __fmul_rn(wx[0], yb[r][c]);
    for (int t = 1; t < tx; ++t) acc = __fadd_rn(acc, __fmul_rn(wx[t], yb[r][c + t]));
    out[(size_t)z * plane + (size_t)yy * X + xx] = acc;
  }
}

}  // namespace

extern "C" {

// taps: device array of tz + ty + tx floats (z taps, then y, then x), each
// count odd and <= 33. Returns the cudaError_t of the launch.
int blur3d_f32(const float* x, float* out, const float* taps, int Z, int Y,
               int X, int tz, int ty, int tx, void* stream) {
  if (tz < 1 || ty < 1 || tx < 1 || tz > kMaxTaps || ty > kMaxTaps ||
      tx > kMaxTaps || Z < 1 || Y < 1 || X < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, Z);
  blur3d_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, taps, Z, Y, X, tz, ty, tx);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
