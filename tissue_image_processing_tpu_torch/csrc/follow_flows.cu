// Cellpose's flow following: every pixel whose y-flow is not ~0 takes
// `niter` Euler steps along the bilinearly interpolated flow field.
//
// Replaces no TPU kernel: the JAX package has no Cellpose. The function is
// Cellpose v2's CPU path (dynamics.py steps2D_interp with map_coordinates)
// in pixel coordinates, every operation rounded to float32:
//
//   yc = int(y), xc = int(x)          (y, x >= 0, so truncation is floor)
//   fy = y - yc, fx = x - xc
//   yf = clamp(yc, 0, Y-1), xf = clamp(xc, 0, X-1)
//   yf1 = min(Y-1, yf+1), xf1 = min(X-1, xf+1)
//   v = ((I[yf,xf](1-fy))(1-fx) + (I[yf,xf1](1-fy))fx)
//       + (I[yf1,xf]fy)(1-fx) + (I[yf1,xf1]fy)fx      (left to right)
//   y = min(Y-1, max(0, y + v_y)), x likewise
//
// Each product and sum is written with __fmul_rn / __fadd_rn, so nvcc
// cannot contract them into fused multiply-adds: the kernel equals the
// plain PyTorch version (ops/flows.py:follow_plain) bit for bit.
//
// Bound on an H100: a followed pixel makes 200 steps of 8 dependent loads
// (two channels x four taps) and 32 float32 operations; the (2, Y, X)
// field of a 2000^2 frame is 32 MB and stays in the 50 MB L2, so the
// steps are bound by load latency, not by HBM. The least work is the
// field read once and the positions written once (16 B a pixel) and the
// operations at the float32 rate (benchmark/costs/follow.py).
//
// Design: one thread a pixel of (B, Y, X), its position in registers for
// all the steps, no shared memory and no synchronisation. A thread whose
// pixel is not followed writes its own coordinates. Neighbouring threads
// start at neighbouring pixels and converge on the same sinks, so their
// taps hit the same cache lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float tap_sum(const float* __restrict__ I, int X,
                                         int yf, int xf, int yf1, int xf1,
                                         float fy, float fx, float gy,
                                         float gx) {
  const float a = __fmul_rn(__fmul_rn(__ldg(I + (int64_t)yf * X + xf), gy), gx);
  const float b = __fmul_rn(__fmul_rn(__ldg(I + (int64_t)yf * X + xf1), gy), fx);
  const float c = __fmul_rn(__fmul_rn(__ldg(I + (int64_t)yf1 * X + xf), fy), gx);
  const float d = __fmul_rn(__fmul_rn(__ldg(I + (int64_t)yf1 * X + xf1), fy), fx);
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__global__ void __launch_bounds__(THREADS)
follow_kernel(const float* __restrict__ d, float* __restrict__ p, int B,
              int Y, int X, int niter) {
  const int64_t plane = (int64_t)Y * X;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)B * plane) return;
  const int64_t b = i / plane;
  const int64_t at = i - b * plane;
  const float* dy = d + b * 2 * plane;
  const float* dx = dy + plane;
  float y = (float)(at / X);
  float x = (float)(at - (at / X) * X);
  if (fabsf(dy[at]) > 1e-3f) {
    const float ymax = (float)(Y - 1), xmax = (float)(X - 1);
    for (int t = 0; t < niter; ++t) {
      const int yc = (int)y, xc = (int)x;
      const float fy = __fsub_rn(y, (float)yc);
      const float fx = __fsub_rn(x, (float)xc);
      const int yf = min(Y - 1, max(0, yc));
      const int xf = min(X - 1, max(0, xc));
      const int yf1 = min(Y - 1, yf + 1);
      const int xf1 = min(X - 1, xf + 1);
      const float gy = __fsub_rn(1.f, fy);
      const float gx = __fsub_rn(1.f, fx);
      const float vy = tap_sum(dy, X, yf, xf, yf1, xf1, fy, fx, gy, gx);
      const float vx = tap_sum(dx, X, yf, xf, yf1, xf1, fy, fx, gy, gx);
      y = fminf(ymax, fmaxf(0.f, __fadd_rn(y, vy)));
      x = fminf(xmax, fmaxf(0.f, __fadd_rn(x, vx)));
    }
  }
  float* out = p + b * 2 * plane;
  out[at] = y;
  out[plane + at] = x;
}

}  // namespace

extern "C" {

// d: (B, 2, Y, X) float32 flows (dY, dX), already masked and divided by 5;
// p: (B, 2, Y, X) float32 final positions (y, x).
int follow_flows(const float* d, float* p, int B, int Y, int X, int niter,
                 void* stream) {
  if (B <= 0 || Y <= 0 || X <= 0 || niter < 0 ||
      (int64_t)Y * X >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * Y * X;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  follow_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      d, p, B, Y, X, niter);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
