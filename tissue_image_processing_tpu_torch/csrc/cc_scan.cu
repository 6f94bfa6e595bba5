// Connected-component minimum by iterated segmented row / column min-scans.
//
// Replaces, in tissue_image_processing_tpu/ops/flood_pallas.py:
//   cc_scan <- _cc_scan_kernel through _cc_scan_call, reached by
//              cc_diffusion_pallas(scan=True): the zero-set seeds of the
//              binary watershed behind the U-Net post-process.
//
// Function: for every pixel the minimum of `lbl` over its 4-connected
// component, where connectivity is given per pixel by `conn` (bit 0: joined
// to the left neighbour, bit 1: joined to the row above). Pixels outside the
// mask carry no link and keep their value. A value only ever moves along a
// link, so the state is bounded below by the component minimum, falls
// monotonically and is constant per component at any fixpoint: the limit is
// the component minimum whatever the order of the updates, and equals the
// Jacobi sweep kernels' result (flood.cu, cc_sweeps) bit for bit.
//
// Bound on an H100: memory. One call reads conn (1 B/px) and lbl (4 B/px)
// and writes lbl (4 B/px); arithmetic is one min per pixel and pass. The
// sweep kernels need one pass per step of a component's diameter (the
// background sea of a boundary map spans the image); a scan carries a
// value across a whole row or column in one pass, so a convex component
// converges in one iteration and the sea around the cells in a few.
//
// Design: one iteration = a row pass and a column pass, both in place.
//   rows:    one warp per row. The row is walked in 32-pixel tiles, forwards
//            then backwards; within a tile the segmented min-scan is five
//            shuffle steps (the gap flag doubles alongside the value), and
//            the running minimum is carried from tile to tile while the
//            links are unbroken (a ballot of the tile's links tells each
//            lane whether its run reaches the tile's edge). Loads and stores
//            are 128-byte lines.
//   columns: one thread per column, neighbouring threads on neighbouring
//            columns so every load is coalesced; each thread walks its
//            column down and then up with a running minimum that a gap
//            resets. Rows are fetched eight at a time so the loads of a
//            chunk are in flight together.
// Every store compares with the old value and raises the device flag; the
// host reads the flag once an iteration and stops at the first iteration
// that changed nothing. That iteration relaxed every link in both
// directions, so the state is the fixpoint. Nothing of the TPU kernel's
// log-doubling over whole-image VMEM arrays, 32-row blocks or in-place
// Gauss-Seidel column blocks is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_THREADS = 256;  // 8 rows a block
constexpr int COL_THREADS = 32;
constexpr int COL_CHUNK = 8;

// Segmented inclusive min-scan across the lanes of a warp, towards higher
// lanes. `g` says "joined to the previous lane"; lane 0 must pass false.
__device__ __forceinline__ int scan_up(int v, bool g) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int vu = __shfl_up_sync(FULL, v, d);
    int gu = __shfl_up_sync(FULL, (int)g, d);
    if (g) v = min(v, vu);
    g = g && gu;
  }
  return v;
}

// The mirror image: towards lower lanes; lane 31 must pass false.
__device__ __forceinline__ int scan_down(int v, bool g) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int vd = __shfl_down_sync(FULL, v, d);
    int gd = __shfl_down_sync(FULL, (int)g, d);
    if (g) v = min(v, vd);
    g = g && gd;
  }
  return v;
}

__global__ void cc_scan_rows_kernel(const uint8_t* __restrict__ conn,
                                    int* __restrict__ lbl, int* flag, int H,
                                    int W) {
  int row = (blockIdx.x * ROW_THREADS + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= H) return;  // a whole warp leaves together
  const uint8_t* c = conn + (size_t)row * W;
  int* v = lbl + (size_t)row * W;
  bool changed = false;

  // forwards: link[x] joins x - 1 and x
  int carry = BIG;
  for (int x0 = 0; x0 < W; x0 += 32) {
    int x = x0 + lane;
    bool in = x < W;
    int old = in ? v[x] : BIG;
    bool link = in && (c[x] & 1);
    unsigned links = __ballot_sync(FULL, link);
    int val = scan_up(old, link && lane > 0);
    // lanes 0..lane all linked: the run reaches into the previous tile
    unsigned need = lane == 31 ? FULL : ((2u << lane) - 1u);
    if ((links & need) == need) val = min(val, carry);
    carry = __shfl_sync(FULL, val, 31);
    if (in && val != old) {
      v[x] = val;
      changed = true;
    }
  }

  // backwards: link[x] joins x and x + 1 (bit 0 of pixel x + 1)
  carry = BIG;
  for (int x0 = ((W - 1) / 32) * 32; x0 >= 0; x0 -= 32) {
    int x = x0 + lane;
    bool in = x < W;
    int old = in ? v[x] : BIG;
    bool link = x + 1 < W && (c[x + 1] & 1);
    unsigned links = __ballot_sync(FULL, link);
    int val = scan_down(old, link && lane < 31);
    // lanes lane..31 all linked: the run reaches into the next tile
    unsigned need = FULL << lane;
    if ((links & need) == need) val = min(val, carry);
    carry = __shfl_sync(FULL, val, 0);
    if (in && val != old) {
      v[x] = val;
      changed = true;
    }
  }
  if (changed) *flag = 1;
}

__global__ void cc_scan_cols_kernel(const uint8_t* __restrict__ conn,
                                    int* __restrict__ lbl, int* flag, int H,
                                    int W) {
  int x = blockIdx.x * COL_THREADS + threadIdx.x;
  if (x >= W) return;
  bool changed = false;
  int vals[COL_CHUNK];
  uint8_t cs[COL_CHUNK];

  // down: bit 1 of row y joins y - 1 and y
  int run = BIG;
  for (int y0 = 0; y0 < H; y0 += COL_CHUNK) {
#pragma unroll
    for (int u = 0; u < COL_CHUNK; ++u) {
      int y = y0 + u;
      if (y < H) {
        vals[u] = lbl[(size_t)y * W + x];
        cs[u] = conn[(size_t)y * W + x];
      }
    }
#pragma unroll
    for (int u = 0; u < COL_CHUNK; ++u) {
      int y = y0 + u;
      if (y < H) {
        int nv = (cs[u] & 2) ? min(vals[u], run) : vals[u];
        if (nv != vals[u]) {
          lbl[(size_t)y * W + x] = nv;
          changed = true;
        }
        run = nv;
      }
    }
  }

  // up: the link between y and y + 1 is bit 1 of row y + 1, the row this
  // thread handled just before
  run = BIG;
  bool joined = false;
  for (int y0 = H - 1; y0 >= 0; y0 -= COL_CHUNK) {
#pragma unroll
    for (int u = 0; u < COL_CHUNK; ++u) {
      int y = y0 - u;
      if (y >= 0) {
        vals[u] = lbl[(size_t)y * W + x];
        cs[u] = conn[(size_t)y * W + x];
      }
    }
#pragma unroll
    for (int u = 0; u < COL_CHUNK; ++u) {
      int y = y0 - u;
      if (y >= 0) {
        int nv = joined ? min(vals[u], run) : vals[u];
        if (nv != vals[u]) {
          lbl[(size_t)y * W + x] = nv;
          changed = true;
        }
        run = nv;
        joined = (cs[u] & 2) != 0;
      }
    }
  }
  if (changed) *flag = 1;
}

}  // namespace

extern "C" {

// One iteration in place on `lbl`: `flag` is zeroed first and set iff the
// row pass or the column pass lowered any pixel. Returns the cudaError_t of
// the launches.
int cc_scan_iteration(const uint8_t* conn, int* lbl, int* flag, int H, int W,
                      void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flag, 0, sizeof(int), s);
  int row_blocks = (int)(((size_t)H * 32 + ROW_THREADS - 1) / ROW_THREADS);
  cc_scan_rows_kernel<<<row_blocks, ROW_THREADS, 0, s>>>(conn, lbl, flag, H, W);
  cc_scan_cols_kernel<<<(W + COL_THREADS - 1) / COL_THREADS, COL_THREADS, 0,
                        s>>>(conn, lbl, flag, H, W);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
