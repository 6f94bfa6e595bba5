// Watershed flood kernels: the 4-neighbour monotone diffusion (Bellman-Ford
// flood levels and connected-component minimum) and the Meyer settle.
//
// Replaces, in tissue_image_processing_tpu/ops/flood_pallas.py:
//   diffusion  <- _diffusion_bulk_kernel, _diffusion_unrolled_kernel and
//                 _diffusion_loop_kernel (three schedules of one function),
//                 reached through bf_flood_pallas (combine = min-max) and
//                 cc_diffusion_pallas (combine = masked min);
//   settle     <- _settle_bulk_kernel, _settle_loop_kernel, their packed
//                 variants and _settle_loop2d_kernel (schedules and encodings
//                 of one function), reached through settle_pallas_loop;
//   settle_mask<- _settle_mask (plain XLA on the TPU, a kernel here).
//
// Bound on an H100: memory, sweep after sweep. One Jacobi sweep reads the
// state (4 B/px, neighbours mostly from cache) and the auxiliary plane
// (4 B/px) and writes the new state (4 B/px); the settle also writes the
// arrival stamp of the pixels that settle. At the stacked 2112 x 1024 shape a
// sweep moves ~26 MB, which fits the 50 MB L2, and the flood needs on the order
// of a hundred to two hundred sweeps. Arithmetic is ~6 (diffusion) to ~40
// (settle) integer or float operations per pixel and sweep.
//
// Design: one thread per pixel and one launch per sweep, with ping-pong
// state buffers, so every sweep is an exact Jacobi step. The TPU kept the
// whole state in VMEM across sweeps; here a launch is cheap (~2-3 us) and the
// state stays in L2 between sweeps. The host launches sweeps in batches of
// eight (the TPU's _SWEEP_BATCH) and only the last sweep of a batch records
// "changed" in a device flag, which the host reads once per batch: these are
// monotone fixpoint iterations, so a last sweep that changed nothing proves
// convergence, and the extra sweeps of the final batch are no-ops.
//
// The settle must stay Jacobi: its arrival stamp t is the sweep index, and
// the watershed-line pass orders line pixels by (lam, t, index). An in-place
// or Gauss-Seidel update would change t and hence the lines. Label domain as
// in _settle_math: > 0 label, 0 unsettled, -1 line, -2 void.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__global__ void bf_sweep_kernel(const float* __restrict__ img,
                                const float* __restrict__ a,
                                float* __restrict__ b, int* flag, int H,
                                int W) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t p = (size_t)y * W + x;
  const float inf = INFINITY;
  float st = a[p];
  float up = y > 0 ? a[p - W] : inf;
  float dn = y < H - 1 ? a[p + W] : inf;
  float lf = x > 0 ? a[p - 1] : inf;
  float rt = x < W - 1 ? a[p + 1] : inf;
  float cand = fminf(fminf(up, dn), fminf(lf, rt));
  float nv = fminf(st, fmaxf(cand, img[p]));
  b[p] = nv;
  if (flag != nullptr && nv != st) *flag = 1;
}

__global__ void cc_sweep_kernel(const int* __restrict__ mask,
                                const int* __restrict__ a, int* __restrict__ b,
                                int* flag, int H, int W, int fill) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t p = (size_t)y * W + x;
  int st = a[p];
  int up = y > 0 ? a[p - W] : fill;
  int dn = y < H - 1 ? a[p + W] : fill;
  int lf = x > 0 ? a[p - 1] : fill;
  int rt = x < W - 1 ? a[p + 1] : fill;
  int cand = min(min(up, dn), min(lf, rt));
  int nv = mask[p] > 0 ? min(st, cand) : fill;
  b[p] = nv;
  if (flag != nullptr && nv != st) *flag = 1;
}

// bits 0-3: (lam_q < lam), bits 4-7: (lam_q <= lam) for q = N, S, W, E;
// +inf outside the image.
__global__ void settle_mask_kernel(const float* __restrict__ lam,
                                   int* __restrict__ mask, int H, int W) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t p = (size_t)y * W + x;
  const float inf = INFINITY;
  float v = lam[p];
  float q[4] = {y > 0 ? lam[p - W] : inf, y < H - 1 ? lam[p + W] : inf,
                x > 0 ? lam[p - 1] : inf, x < W - 1 ? lam[p + 1] : inf};
  int m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m |= (q[k] < v ? 1 : 0) << k;
    m |= (q[k] <= v ? 1 : 0) << (4 + k);
  }
  mask[p] = m;
}

__global__ void settle_sweep_kernel(const int* __restrict__ mask,
                                    const int* __restrict__ a,
                                    int* __restrict__ b, int* __restrict__ t,
                                    int* flag, int H, int W, int it) {
  int x = blockIdx.x * BX + threadIdx.x;
  int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t p = (size_t)y * W + x;
  int l = a[p];
  if (l != 0) {  // settled pixels never change
    b[p] = l;
    return;
  }
  int m = mask[p];
  int q[4] = {y > 0 ? a[p - W] : 0, y < H - 1 ? a[p + W] : 0,
              x > 0 ? a[p - 1] : 0, x < W - 1 ? a[p + 1] : 0};
  bool ready = true, all_eq = true;
  int minl = 1 << 30, maxl = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool qs = q[k] != 0;
    bool lt = (m >> k) & 1;
    bool le = (m >> (4 + k)) & 1;
    ready = ready && (!lt || qs);
    all_eq = all_eq && (!le || qs);
    if (q[k] > 0 && le) {
      minl = min(minl, q[k]);
      maxl = max(maxl, q[k]);
    }
  }
  bool has_donor = maxl > 0;
  int nl = 0;
  bool can = false;
  if (ready) {
    if (has_donor) {
      nl = minl != maxl ? -1 : maxl;  // conflict -> line
      can = true;
    } else if (all_eq) {
      nl = -2;  // void: nothing can ever donate
      can = true;
    }
  }
  b[p] = nl;
  if (can) {
    t[p] = it;
    if (flag != nullptr) *flag = 1;
  }
}

dim3 grid_for(int H, int W) { return dim3((W + BX - 1) / BX, (H + BY - 1) / BY); }

}  // namespace

extern "C" {

// Each *_sweeps entry point runs n_sweeps (even, >= 2) Jacobi sweeps
// a -> b -> a -> ... so the result lands back in `a`; `flag` is zeroed first
// and set by the LAST sweep iff it changed any pixel. Returns the
// cudaError_t of the launches.

int bf_sweeps(const float* img, float* a, float* b, int* flag, int H, int W,
              int n_sweeps, void* stream) {
  if (n_sweeps < 2 || n_sweeps % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flag, 0, sizeof(int), s);
  dim3 block(BX, BY), grid = grid_for(H, W);
  for (int i = 0; i < n_sweeps; ++i) {
    const float* src = i % 2 ? b : a;
    float* dst = i % 2 ? a : b;
    bf_sweep_kernel<<<grid, block, 0, s>>>(img, src, dst,
                                           i == n_sweeps - 1 ? flag : nullptr,
                                           H, W);
  }
  return (int)cudaGetLastError();
}

int cc_sweeps(const int* mask, int* a, int* b, int* flag, int H, int W,
              int fill, int n_sweeps, void* stream) {
  if (n_sweeps < 2 || n_sweeps % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flag, 0, sizeof(int), s);
  dim3 block(BX, BY), grid = grid_for(H, W);
  for (int i = 0; i < n_sweeps; ++i) {
    const int* src = i % 2 ? b : a;
    int* dst = i % 2 ? a : b;
    cc_sweep_kernel<<<grid, block, 0, s>>>(mask, src, dst,
                                           i == n_sweeps - 1 ? flag : nullptr,
                                           H, W, fill);
  }
  return (int)cudaGetLastError();
}

int settle_mask(const float* lam, int* mask, int H, int W, void* stream) {
  settle_mask_kernel<<<grid_for(H, W), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      lam, mask, H, W);
  return (int)cudaGetLastError();
}

// Sweep k of the batch stamps t = it0 + k on the pixels it settles.
int settle_sweeps(const int* mask, int* a, int* b, int* t, int* flag, int H,
                  int W, int it0, int n_sweeps, void* stream) {
  if (n_sweeps < 2 || n_sweeps % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flag, 0, sizeof(int), s);
  dim3 block(BX, BY), grid = grid_for(H, W);
  for (int i = 0; i < n_sweeps; ++i) {
    const int* src = i % 2 ? b : a;
    int* dst = i % 2 ? a : b;
    settle_sweep_kernel<<<grid, block, 0, s>>>(
        mask, src, dst, t, i == n_sweeps - 1 ? flag : nullptr, H, W, it0 + i);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
