// Cellpose's flow check: the heat diffusion of masks_to_flows_gpu, every
// mask inside its own bounding box, in float64.
//
// Replaces no TPU kernel: the JAX package has no Cellpose. The function is
// Cellpose v2's masks_to_flows_gpu diffusion. T is the (Y + 2, X + 2)
// float64 frame padded by one pixel, zero at the start; each of n_iter
// iterations
//
//   1. adds 1.0 at every mask's centre (index_add_ in the plain version);
//   2. sets every mask pixel p to
//        ((T[p] + T[n_1]) + ... + T[n_8]) / 9
//      over the neighbours n_i in ops/flows.py NEIGHBOURS[1:] order (up,
//      down, left, right, then the diagonals) that lie in p's own mask.
//
// The plain version (ops/flows.py:diffuse_plain) adds T[n_i] * w_i with a
// 0.0 / 1.0 weight for every neighbour; T is finite and >= 0, so a zero
// weight adds +0.0 and leaves the sum as it was. Each sum here is rounded
// on its own (__dadd_rn, no contraction), and the division is correctly
// rounded: q = RN(acc * z) with z = RN(1 / 9) is within one ulp of
// acc / 9, the remainder acc - 9 q is exact in one fused multiply-add, and
// RN(q + remainder * z) is then RN(acc / 9) (Markstein's theorem; 9 is no
// power of two and acc / 9 is never a tie). So the kernel equals the plain
// loop run on the CPU bit for bit. (PyTorch's CUDA division by a host
// scalar multiplies by the reciprocal, so the plain loop run on the card
// can differ from both in the last bit.) Pixels off the masks stay 0.
//
// Bound on an H100: float64 arithmetic. A 2000^2 frame of the benchmark's
// traffic holds ~3.4 M mask pixels and n_iter ~410: ~1.4 G pixel updates of
// 8 sums and a division, ~13 G operations counted one apiece, 0.75 ms at
// the 17 T/s unfused float64 rate; the int32 labels read once and T written
// once are 48 MB, 0.014 ms of HBM (benchmark/costs/flow_qc.py).
//
// Design. Heat never crosses a mask's border, so each mask diffuses alone
// inside its box; the largest box of the traffic (long side + short side
// <= n_iter / 2) is ~105 x 105 px, which fits one SM's shared memory.
//   Shared form (flow_diffuse_boxes): one block a mask, one launch a size
//   class (the wrapper groups masks by the longer box side rounded up to a
//   power of two and sizes threads and dynamic shared memory to the class).
//   The block reads its box of the label map once, into a byte a pixel
//   that says whether the pixel lies in the mask. Two float64 copies of the
//   box with a one-pixel zero ring hold T for all n_iter iterations: each
//   iteration reads one and writes the other, with one barrier. The block
//   writes only its mask's pixels, so every other pixel of its copies,
//   another mask's, the background's and the ring's, stays +0.0: a pixel's
//   eight neighbours are summed whatever they are, which is the masked sum
//   exactly, and the loop reads no neighbour bits. A strip is a column of
//   the box over R rows (R from the block's threads and the box's width); a
//   thread walks a strip with a three-row window of three columns in
//   registers, so a pixel costs three shared reads, not nine. Strips that
//   hold no pixel of the mask are dropped once, at set-up: the rest are
//   listed in shared memory and dealt out to the threads. The centre's
//   thread adds 1.0 to its own output for the next iteration (the first
//   iteration's 0 + 1 is set before the loop). At the end the block writes
//   its own mask's pixels of T, nothing else.
//   Global form (flow_diffuse_global): a mask whose padded box is over the
//   shared-memory limit (one up to 40% of the frame may occur; none in the
//   traffic) runs the same arithmetic on two device-memory frames, one
//   launch an iteration, one thread a pixel. Its frames hold other masks'
//   values, so it sums only the neighbours whose bit is set in the
//   precomputed neighbour bits (ops/flow_diffuse_cuda.py:neighbour_bits),
//   and reads its centre's step on the fly as __dadd_rn(T[c], 1.0).
// No host read inside.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_THREADS = 512;     // a shared-form block
constexpr int GLOBAL_THREADS = 256;  // a global-form block
constexpr int ROW = 7;               // table row: label, y0, x0, h, w, cy, cx
constexpr int MAX_CARDS = 64;

int current_card() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS)
    return -1;
  return dev;
}

// RN(acc / 9), see the head of the file
__device__ __forceinline__ double div9(double acc) {
  constexpr double z = 1.0 / 9.0;
  const double q = __dmul_rn(acc, z);
  return __fma_rn(__fma_rn(-q, 9.0, acc), z, q);
}

// ((((((((c + up) + down) + left) + right) + ul) + ur) + dl) + dr) / 9
__device__ __forceinline__ double stencil(double c, double u, double d,
                                          double l, double r, double ul,
                                          double ur, double dl, double dr) {
  double acc = __dadd_rn(c, u);
  acc = __dadd_rn(acc, d);
  acc = __dadd_rn(acc, l);
  acc = __dadd_rn(acc, r);
  acc = __dadd_rn(acc, ul);
  acc = __dadd_rn(acc, ur);
  acc = __dadd_rn(acc, dl);
  acc = __dadd_rn(acc, dr);
  return div9(acc);
}

// Dynamic shared memory of a block (all of its shared memory): the two
// copies of the padded box (A pixels), a byte a pixel (in the mask or
// not), padded to 4 bytes, the strip count, then the strip list (one
// uint32 a strip: the padded index of its first pixel | its rows << 16; at
// most max(threads, w) strips). ops/flow_diffuse_cuda.py:_smem_bytes.
__global__ void __launch_bounds__(MAX_THREADS)
flow_diffuse_kernel(const int* __restrict__ labels,
                    const int* __restrict__ table, int Y, int X, int n_iter,
                    double* __restrict__ T) {
  extern __shared__ double smem[];
  const int* row = table + (int64_t)blockIdx.x * ROW;
  const int L = row[0], y0 = row[1], x0 = row[2], h = row[3], w = row[4];
  const int P = w + 2, A = (h + 2) * P;  // the padded box, row-major
  double* a = smem;
  double* b = smem + A;
  uint8_t* own = reinterpret_cast<uint8_t*>(smem + 2 * A);
  int* n_strips = reinterpret_cast<int*>(own + ((A + 3) & ~3));
  uint32_t* strips = reinterpret_cast<uint32_t*>(n_strips + 1);
  const int ci = (row[5] - y0 + 1) * P + (row[6] - x0 + 1);
  if (threadIdx.x == 0) *n_strips = 0;
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    a[i] = 0.0;
    b[i] = 0.0;
    const int r = i / P - 1, c = i - (i / P) * P - 1;
    own[i] = r >= 0 && r < h && c >= 0 && c < w &&
             __ldg(labels + (int64_t)(y0 + r) * X + (x0 + c)) == L;
  }
  __syncthreads();
  // strip s: column s % w over rows [s / w * R, s / w * R + R)
  const int bands = max(1, (int)blockDim.x / w);
  const int R = (h + bands - 1) / bands;
  const int S = w * ((h + R - 1) / R);
  const unsigned lane = threadIdx.x & 31;
  for (int base = 0; base < S; base += blockDim.x) {
    const int s = base + threadIdx.x;
    int first = 0, rows = 0;
    bool keep = false;
    if (s < S) {
      const int band = s / w, c = s - band * w;
      const int r0 = band * R;
      rows = min(h, r0 + R) - r0;
      first = (r0 + 1) * P + c + 1;
      for (int k = 0; k < rows; ++k) keep |= own[first + k * P] != 0;
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    int at = 0;
    if (lane == 0 && kept) at = atomicAdd(n_strips, __popc(kept));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (keep)
      strips[at + __popc(kept & ((1u << lane) - 1))] =
          (uint32_t)first | ((uint32_t)rows << 16);
  }
  if (threadIdx.x == 0) a[ci] = 1.0;  // the first iteration's 0 + 1
  __syncthreads();
  const int n = *n_strips;
  for (int it = 0; it < n_iter; ++it) {
    const double* __restrict__ src = (it & 1) ? b : a;
    double* __restrict__ dst = (it & 1) ? a : b;
    const bool last = it == n_iter - 1;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      int i = (int)(strips[k] & 0xFFFFu);
      const int rows = (int)(strips[k] >> 16);
      double ul = src[i - P - 1], u = src[i - P], ur = src[i - P + 1];
      double l = src[i - 1], m = src[i], r = src[i + 1];
      for (int y = 0; y < rows; ++y, i += P) {
        const double dl = src[i + P - 1], d = src[i + P], dr = src[i + P + 1];
        double v = stencil(m, u, d, l, r, ul, ur, dl, dr);
        if (i == ci && !last) v = __dadd_rn(v, 1.0);  // next centre step
        if (own[i]) dst[i] = v;
        ul = l; u = m; ur = r;
        l = dl; m = d; r = dr;
      }
    }
    __syncthreads();
  }
  const double* out = (n_iter & 1) ? b : a;
  const int64_t stride = X + 2;
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    if (own[i]) {
      const int r = i / P - 1, c = i - (i / P) * P - 1;
      T[(int64_t)(y0 + r + 1) * stride + (x0 + c + 1)] = out[i];
    }
  }
}

// One iteration of the masks flagged in is_global, src -> dst ((Y + 2) x
// (X + 2) each); centre[L] is mask L's padded flat index
__global__ void __launch_bounds__(GLOBAL_THREADS)
flow_diffuse_global_kernel(const int* __restrict__ labels,
                           const uint8_t* __restrict__ bits,
                           const uint8_t* __restrict__ is_global,
                           const int* __restrict__ centre,
                           const double* __restrict__ src,
                           double* __restrict__ dst, int Y, int X) {
  const int64_t i = (int64_t)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  if (i >= (int64_t)Y * X) return;
  const int L = labels[i];
  if (L <= 0 || !is_global[L]) return;
  const int y = (int)(i / X), x = (int)(i - (int64_t)y * X);
  const int P = X + 2;
  const int p = (y + 1) * P + x + 1, cp = centre[L];
  const uint32_t f = bits[i];
  // neighbour k of NEIGHBOURS[1:] if its bit is set, else +0.0
  auto at = [&](int k, int q) {
    if (!((f >> k) & 1u)) return 0.0;
    const double v = src[q];
    return q == cp ? __dadd_rn(v, 1.0) : v;  // this iteration's centre step
  };
  const double c = src[p];
  dst[p] = stencil(p == cp ? __dadd_rn(c, 1.0) : c, at(0, p - P),
                   at(1, p + P), at(2, p - 1), at(3, p + 1), at(4, p - P - 1),
                   at(5, p - P + 1), at(6, p + P - 1), at(7, p + P + 1));
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of the current card may take.
int flow_diffuse_shared_limit() {
  const int dev = current_card();
  int most = 0;
  if (dev < 0 ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return most;
}

// Shared form: the n_masks rows of `table` (int32, ROW a mask), one block
// of `threads` and smem_bytes of dynamic shared memory each (see
// flow_diffuse_kernel; every padded box under 65,536 pixels), into T
// ((Y + 2) x (X + 2) float64, zeroed by the caller; only the masks' pixels
// are written).
int flow_diffuse_boxes(const int* labels, const int* table, int n_masks,
                       int Y, int X, int n_iter, int threads, int smem_bytes,
                       double* T, void* stream) {
  if (n_masks < 0 || Y <= 0 || X <= 0 || n_iter < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || smem_bytes <= 0 ||
      (int64_t)(Y + 2) * (X + 2) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (n_masks == 0 || n_iter == 0) return 0;
  static std::atomic<int> opted_in[MAX_CARDS];  // bytes allowed, a card
  const int dev = current_card();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (opted_in[dev] == 0) {  // above 48 KB only after this
    const int most = flow_diffuse_shared_limit();
    const cudaError_t e = cudaFuncSetAttribute(
        flow_diffuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = most;
  }
  if (smem_bytes > opted_in[dev]) return (int)cudaErrorInvalidValue;
  flow_diffuse_kernel<<<n_masks, threads, smem_bytes, (cudaStream_t)stream>>>(
      labels, table, Y, X, n_iter, T);
  return (int)cudaGetLastError();
}

// Global form: n_iter launches over the frame for the masks flagged in
// is_global (uint8 by label), bits the (Y, X) neighbour bits, centre the
// padded flat index by label; T and scratch are zeroed (Y + 2) x (X + 2)
// float64 frames, and the last iteration writes T.
int flow_diffuse_global(const int* labels, const uint8_t* bits,
                        const uint8_t* is_global, const int* centre, double* T,
                        double* scratch, int Y, int X, int n_iter,
                        void* stream) {
  if (Y <= 0 || X <= 0 || n_iter < 0 ||
      (int64_t)(Y + 2) * (X + 2) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)Y * X + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  for (int it = 0; it < n_iter; ++it) {
    const bool to_t = (n_iter - 1 - it) % 2 == 0;
    flow_diffuse_global_kernel<<<(unsigned)blocks, GLOBAL_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        labels, bits, is_global, centre, to_t ? scratch : T,
        to_t ? T : scratch, Y, X);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
