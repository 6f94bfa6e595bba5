// Connected-component minimum by label equivalence (union-find).
//
// Replaces, in tissue_image_processing_tpu/ops/flood_pallas.py:
//   cc_scan <- _cc_scan_kernel through _cc_scan_call, reached by
//              cc_diffusion_pallas(scan=True): the zero-set seeds of the
//              binary watershed behind the U-Net post-process.
//
// Function: for a mask (H, W) and an int32 `init`, every mask pixel gets the
// minimum of `init` (the flat pixel index where `init` is null) over its
// 4-connected component; pixels outside the mask get -1. The result is a
// minimum over a set, so it equals the relaxation kernel's fixpoint
// (flood.cu, cc_diffusion) bit for bit and is the same in every run, although
// the unions below race.
//
// Bound on an H100: memory. The function reads the mask (1 B/px) and `init`
// (4 B/px) and writes the result (4 B/px); arithmetic is a few compares a
// pixel. Any schedule that moves a value one link, one run or one tile at a
// time takes as many passes as the component is long or winding (the
// background sea of a boundary map spans the image), and an iterated
// schedule needs a host read to know when to stop. Label equivalence takes a
// fixed number of passes whatever the mask, and no host read:
//
//   1. tiles:  a block resolves one 32 x 32 tile in shared memory. A ballot
//              of the row's links gives every pixel the start of its row run
//              (no atomics); the runs of neighbouring rows are united with a
//              lock-free atomicMin union-find on the shared parent array, once
//              per pair of touching runs, not once per pixel. Every run
//              start then finds its root and points at it, so its pixels
//              read the root in one hop, and the minimum of `init` is carried
//              per local root (a shared atomicMin, skipped when it cannot
//              lower the slot). Out go parent[pixel] = global index of the
//              local root, and out[root] = the carried minimum; other mask
//              pixels get a NOT_ROOT marker, pixels outside an OUTSIDE
//              marker. The pass is bound by latency, not bytes (barriers
//              between its phases), so blocks are small (256 threads, four
//              rows a thread, all loads issued first) and eight share an SM.
//   2. seams:  one thread per pixel of a tile's first row / first column
//              that links across the seam unites the two roots in the global
//              parent array: find both roots (with path halving), atomicMin
//              the smaller into the larger root's slot, and go on with what
//              the atomic returned until both sides have one root. A stale
//              read only costs a retry: parents only ever fall, and the
//              atomic decides. Runs along a seam unite once, at their start.
//   3. fold:   every local root that is not its component's root finds that
//              root and folds its carried minimum into the root's slot: one
//              atomicMin per tile and component, not per pixel (the sea is
//              ~10^6 pixels but a few thousand local roots), and none where
//              the slot is already lower. The find leaves the local root
//              pointing at the root.
//   4. result: every mask pixel reads its root's slot (pixel -> local root
//              -> root, two hops after the fold); OUTSIDE becomes -1.
//
// Roots are the smallest flat index of their set at every level (a union
// always hangs the larger root under the smaller), so parent chains fall
// strictly and cannot cycle. All parent and slot accesses are single aligned
// 32-bit words. Scratch (the parent array) comes from the wrapper; the
// result array doubles as the slot array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // a warp is one tile row
constexpr int TH = 32;
constexpr int TILE_WARPS = 8;
constexpr int ROWS_PER_WARP = TH / TILE_WARPS;
constexpr int BIG = 0x7fffffff;
constexpr int NOT_ROOT = 0x7fffffff;      // mask pixel, not its tile's root
constexpr int OUTSIDE = (int)0x80000000;  // below any init (> -2^30)
constexpr unsigned FULL = 0xffffffffu;
constexpr int FLAT_THREADS = 256;

__device__ __forceinline__ int shared_find(volatile int* p, int x) {
  int q;
  while ((q = p[x]) != x) x = q;
  return x;
}

// Unite the sets of a and b: the larger root goes under the smaller. The
// atomic returns what the slot held; if that was not the root itself,
// another union got there first, and its target has to join b as well.
__device__ __forceinline__ void shared_unite(volatile int* p, int a, int b) {
  while (true) {
    a = shared_find(p, a);
    b = shared_find(p, b);
    if (a == b) return;
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin((int*)&p[a], b);
    if (old == a) return;
    a = old;
  }
}

// Root of x in the global parent array, halving the path on the way: every
// visited node is pointed at its grandparent (a plain store: any ancestor is
// a valid parent, and parents only fall).
__device__ __forceinline__ int global_find(int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    int gp = __ldcg(parent + p);
    if (gp != p) parent[x] = gp;
    x = p;
    p = gp;
  }
  return x;
}

__device__ __forceinline__ void global_unite(int* parent, int a, int b) {
  while (true) {
    a = global_find(parent, a);
    b = global_find(parent, b);
    if (a == b) return;
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;
  }
}

// Step 1. Block (32, 8): warp ty owns rows ty, ty + 8, ty + 16, ty + 24 of
// the tile, lane tx column tx. Eight small blocks fit an SM, so one block's
// loads overlap another's barriers; all of a thread's loads go out first.
__global__ void __launch_bounds__(TW* TILE_WARPS)
    cc_tiles_kernel(const uint8_t* __restrict__ mask,
                    const int* __restrict__ init, int* __restrict__ parent,
                    int* __restrict__ out, int H, int W) {
  __shared__ uint8_t s_mask[TH][TW];
  __shared__ int s_parent[TH * TW];
  __shared__ int s_min[TH * TW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TW + tx, y0 = blockIdx.y * TH;
  bool m[ROWS_PER_WARP];
  int v[ROWS_PER_WARP], start[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int y = y0 + ty + k * TILE_WARPS;
    const bool in = x < W && y < H;
    const int g = y * W + x;
    m[k] = in && mask[g] != 0;
    v[k] = in && init != nullptr ? init[g] : g;
  }

  // row runs: the start of a pixel's run is the highest lane <= tx with no
  // link to its left neighbour (lane 0 never has one)
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int r = ty + k * TILE_WARPS, l = r * TW + tx;
    const bool left_m = __shfl_up_sync(FULL, (int)m[k], 1) != 0;
    const bool left = m[k] && tx > 0 && left_m;
    const unsigned links = __ballot_sync(FULL, left);
    start[k] = 31 - __clz(~links & (FULL >> (31 - tx)));
    s_mask[r][tx] = m[k];
    s_parent[l] = r * TW + start[k];
    s_min[l] = BIG;
  }
  __syncthreads();

  // unite with the run above, once per pair of touching runs: the pixel to
  // the left does it when it links both to this pixel and upwards
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int r = ty + k * TILE_WARPS, l = r * TW + tx;
    if (m[k] && r > 0 && s_mask[r - 1][tx] &&
        !(start[k] < tx && s_mask[r - 1][tx - 1]))
      shared_unite(s_parent, l, l - TW);
  }
  __syncthreads();

  // every run start finds the root and points at it, so that its run reads
  // the root in one hop (a run start that is a root points at itself)
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int l = (ty + k * TILE_WARPS) * TW + tx;
    if (start[k] == tx) s_parent[l] = shared_find(s_parent, l);
  }
  __syncthreads();

  int root[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    // what the run start holds is a root or on the way to one: a root
    // never changes, and a run start under a root was just pointed at it
    root[k] = shared_find(s_parent, (ty + k * TILE_WARPS) * TW + start[k]);
    if (m[k] && v[k] < ((volatile int*)s_min)[root[k]])
      atomicMin(&s_min[root[k]], v[k]);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int r = ty + k * TILE_WARPS, l = r * TW + tx;
    const int y = y0 + r;
    if (x >= W || y >= H) continue;
    const int g = y * W + x;
    if (!m[k]) {
      out[g] = OUTSIDE;
      continue;
    }
    parent[g] = (y0 + root[k] / TW) * W + blockIdx.x * TW + root[k] % TW;
    out[g] = root[k] == l ? s_min[l] : NOT_ROOT;
  }
}

// Step 2. Flat index over the seam pixels: first the first rows of the tile
// rows 1.., then the first columns of the tile columns 1...
__global__ void cc_seams_kernel(const uint8_t* __restrict__ mask, int* parent,
                                int H, int W, int n_row_seams,
                                int n_col_seams) {
  const int i = blockIdx.x * FLAT_THREADS + threadIdx.x;
  const int n_h = n_row_seams * W;
  if (i < n_h) {
    const int y = (i / W + 1) * TH, x = i % W;
    const int g = y * W + x;
    if (!mask[g] || !mask[g - W]) return;
    // inside a tile column the run along the seam unites at its start; at a
    // tile corner every link does, since the left links there are seams too
    if (x % TW != 0 && mask[g - 1] && mask[g - W - 1]) return;
    global_unite(parent, g, g - W);
  } else if (i < n_h + n_col_seams * H) {
    const int j = i - n_h;
    const int x = (j / H + 1) * TW, y = j % H;
    const int g = y * W + x;
    if (!mask[g] || !mask[g - 1]) return;
    if (y % TH != 0 && mask[g - W] && mask[g - W - 1]) return;
    global_unite(parent, g, g - 1);
  }
}

// Step 3.
__global__ void cc_fold_kernel(int* parent, int* out, int n) {
  const int g = blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (g >= n) return;
  const int v = out[g];
  if (v == NOT_ROOT || v == OUTSIDE) return;  // not a local root
  if (__ldcg(parent + g) == g) return;        // the component's root itself
  const int r = global_find(parent, g);
  parent[g] = r;
  if (v < __ldcg(out + r)) atomicMin(out + r, v);
}

// Step 4. Only slots of component roots are read, and those are not written.
__global__ void cc_result_kernel(const int* __restrict__ parent, int* out,
                                 int n) {
  const int g = blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (g >= n) return;
  if (out[g] == OUTSIDE) {
    out[g] = -1;
    return;
  }
  int r = g, p;
  while ((p = parent[r]) != r) r = p;
  if (r != g) out[g] = __ldcg(out + r);
}

int blocks_for(long long n) {
  return (int)((n + FLAT_THREADS - 1) / FLAT_THREADS);
}

}  // namespace

extern "C" {

// The component minimum of `init` (null: the flat index) over `mask` (one
// byte a pixel, nonzero = in) into `out`; `parent` is scratch of H * W
// ints. Four launches on `stream`, no synchronisation. Needs 2 * H * W <
// 2^31. Returns the cudaError_t of the launches.
int cc_scan_min(const uint8_t* mask, const int* init, int* parent, int* out,
                int H, int W, void* stream) {
  if (H < 1 || W < 1 || 2LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = H * W;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  cc_tiles_kernel<<<dim3(tiles_x, tiles_y), dim3(TW, TILE_WARPS), 0, s>>>(
      mask, init, parent, out, H, W);
  const long long seams = (long long)(tiles_y - 1) * W +
                          (long long)(tiles_x - 1) * H;
  cc_seams_kernel<<<blocks_for(seams > 0 ? seams : 1), FLAT_THREADS, 0, s>>>(
      mask, parent, H, W, tiles_y - 1, tiles_x - 1);
  cc_fold_kernel<<<blocks_for(n), FLAT_THREADS, 0, s>>>(parent, out, n);
  cc_result_kernel<<<blocks_for(n), FLAT_THREADS, 0, s>>>(parent, out, n);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
