// Per-cell adaptive search radii (trackpy's adaptive subnet shrinking) as
// one level sweep of a union-find.
//
// Replaces no TPU kernel: the JAX package computes these radii on the host
// too (core/tracking.py:adaptive_effective_ranges, numpy / scipy), by a
// recursion that re-solves the connected components of every oversized
// subnet at a radius shrunk by `step`, 80-150 solves a frame of ~2,700
// cells. This source computes the same radii, and counts the same solves,
// from the tables on the card.
//
// Function. Frame t's cells link to frame t-1's (the carry's, for t = 0):
// a point is (cy + cum_y, cx + cum_x, sqrt(w) * sqrt(max(area, 0))) in
// float64, cum the sequential float64 running sum of the drifts seeded
// with the carry's, and a pair's distance is
// sqrt((dy * dy + dx * dx) + da * da), every operation rounded on its own
// (no contraction), bit for bit the host's. The recursion's radii are
// r_0 = search_range, r_{i+1} = r_i * step while r_{i+1} >= stop (levels
// 0..L). At level i the graph's edges are the pairs with dist < r_i, and
// its components nest: a level-(i+1) component lies in one level-i
// component, so the recursion's re-solve of a component equals the global
// components one level down, restricted to it. A cell's radius is
// r_{1 + max D}, or r_0 if D is empty, with D the levels i < L at which the
// cell has an edge and its component holds more than `limit` cells. The
// solves of a frame are 1 (if it has any pair) plus the (level i < L,
// component) pairs where the component is oversized and has an edge of a
// deeper level.
//
// Bound on an H100: fp64 arithmetic of the pair pass. The tables are a
// few hundred KB; the distances are T x N x N float64 evaluations (8 x
// 4096^2 at capacity 4096: ~1.1 GFLOP; 8 x 8192^2: ~4.3 GFLOP, about
// 0.03 / 0.13 ms at 34 TFLOP/s fp64; the ~2,700 valid rows a frame need
// 0.4 GFLOP, 0.012 ms), and only ~1e5 pairs a frame pass r_0. The sweep's work is small (~1e5 edges, ~45 levels) but sequential
// in levels, so it is bound by barrier latency.
//
// Design, three launches:
//   1. pairs<count>: a block takes 256 cells of one frame and walks 1024
//      of the previous frame's rows in 256-row tiles staged in shared
//      memory (a block whose cells are all empty rows leaves at once),
//      evaluating every pair by brute force (a candidate passes a squared
//      bound before its square root is taken). Each kept pair's level,
//      max{i : dist < r_i}, goes into a shared histogram, flushed with one
//      atomic a level and block. The host reads the total to size the edge
//      list exactly.
//   2. pairs<emit>: the same walk; each pair is written at its (frame,
//      level) slot of the edge list, a counting sort by level.
//   3. sweep: one block a frame, because the levels have to be visited in
//      order and a frame's union-find (2 x N nodes) fits one SM's shared
//      memory up to N = 8192 (163,840 B of the 227 KB); larger tables keep
//      the same arrays in device memory. From the deepest level to 0: hook
//      that level's edges with lock-free atomicMin unions (the larger root
//      goes under the smaller, so parent chains fall and never cycle),
//      compress every node to its root, count each root's cells, and mark
//      a cell's first oversized level and each oversized root with a
//      deeper edge (one solve, claimed once by an atomicAnd). Components
//      are sets, so the result is the same whatever order the unions race
//      in.
// No host read inside; the wrapper reads the edge total and the solves.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_CARDS = 64;
constexpr int MAX_LEVELS = 512;
constexpr int PAIR_THREADS = 256;
constexpr int PAIR_ROWS = 1024;        // previous rows a pair block walks
constexpr int SWEEP_THREADS = 1024;
constexpr int DEEP = 1 << 30;          // a root's component has a deeper edge
constexpr int COUNT_MASK = DEEP - 1;

inline int current_card() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS)
    return -1;
  return dev;
}

struct Tables {
  const float* cy;       // (T, N)
  const float* cx;
  const float* area;
  const uint8_t* valid;
  const float* pcy;      // the carry's frame (K,), or null
  const float* pcx;
  const float* parea;
  const uint8_t* pvalid;
  const double* drift;   // (T, 2)
  const double* cum0;    // (2,) the carry's running sum
  int T, N, K, nlev;
  double r0, step, thr, aw;
};

// numpy's maximum(a, 0): a NaN stays NaN
__device__ __forceinline__ double side(float area, double aw) {
  const float m = (area >= 0.f || area != area) ? area : 0.f;
  return __dmul_rn(aw, (double)__fsqrt_rn(m));
}

// r_0..r_{nlev-1} and, in thread 0, the running drift sums of frames t - 1
// and t (cum[0..1] and cum[2..3]); call before a barrier
__device__ void radii_and_cum(const Tables& a, int t, double* s_r,
                              double* s_cum) {
  if (threadIdx.x != 0) return;
  double r = a.r0;
  s_r[0] = r;
  for (int i = 1; i < a.nlev; ++i) {
    r = __dmul_rn(r, a.step);
    s_r[i] = r;
  }
  double y = a.cum0[0], x = a.cum0[1], py = y, px = x;
  for (int s = 0; s <= t; ++s) {
    py = y;
    px = x;
    y = __dadd_rn(y, a.drift[2 * s]);
    x = __dadd_rn(x, a.drift[2 * s + 1]);
  }
  s_cum[0] = py;
  s_cum[1] = px;
  s_cum[2] = y;
  s_cum[3] = x;
}

__device__ __forceinline__ int block_sum(int v, int* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) s += s_red[w];
    s_red[0] = s;
  }
  __syncthreads();
  return s_red[0];
}

// s_off[l] = first slot of frame t's level-l edges, s_off[nlev] = the end
__device__ void level_offsets(const int* counts, int t, int nlev, int* s_off,
                              int* s_red) {
  int part = 0;
  for (int k = threadIdx.x; k < t * nlev; k += blockDim.x) part += counts[k];
  const int base = block_sum(part, s_red);
  for (int l = threadIdx.x; l < nlev; l += blockDim.x)
    s_off[l + 1] = counts[t * nlev + l];
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = base;
    for (int l = 0; l < nlev; ++l) {
      const int c = s_off[l + 1];
      s_off[l] = acc;
      acc += c;
    }
    s_off[nlev] = acc;
  }
  __syncthreads();
}

// Pass 1 (kEmit false): counts[t * nlev + level] and meta[0] (the total).
// Pass 2 (kEmit true): edges (cell row, previous row) in level slots.
template <bool kEmit>
__global__ void __launch_bounds__(PAIR_THREADS)
    pairs_kernel(Tables a, int* counts, int* cursor, int* meta,
                 int2* edges) {
  __shared__ double s_r[MAX_LEVELS];
  __shared__ int s_lev[MAX_LEVELS + 1];
  __shared__ double s_cum[4];
  __shared__ double s_y[PAIR_THREADS], s_x[PAIR_THREADS], s_a[PAIR_THREADS];
  __shared__ int s_red[PAIR_THREADS / 32];
  const int t = blockIdx.y, tid = threadIdx.x;
  const int P = t > 0 ? a.N : a.K;  // frame 0 without a carry: none
  const int j_begin = blockIdx.z * PAIR_ROWS;
  const int j_end = min(P, j_begin + PAIR_ROWS);
  const int i = blockIdx.x * PAIR_THREADS + tid;
  const size_t g = (size_t)t * a.N + i;
  const bool live = i < a.N && a.valid[g] != 0;
  // the whole block leaves together: no rows, or no cell
  if (j_begin >= j_end || !__syncthreads_or(live)) return;
  radii_and_cum(a, t, s_r, s_cum);
  if (kEmit) {
    level_offsets(counts, t, a.nlev, s_lev, s_red);
  } else {
    for (int l = tid; l < a.nlev; l += PAIR_THREADS) s_lev[l] = 0;
    __syncthreads();
  }
  const float* pcy = t > 0 ? a.cy + (size_t)(t - 1) * a.N : a.pcy;
  const float* pcx = t > 0 ? a.cx + (size_t)(t - 1) * a.N : a.pcx;
  const float* par = t > 0 ? a.area + (size_t)(t - 1) * a.N : a.parea;
  const uint8_t* pva = t > 0 ? a.valid + (size_t)(t - 1) * a.N : a.pvalid;

  double y = 0.0, x = 0.0, s = 0.0;
  if (live) {
    y = __dadd_rn((double)a.cy[g], s_cum[2]);
    x = __dadd_rn((double)a.cx[g], s_cum[3]);
    s = side(a.area[g], a.aw);
  }
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const double r0 = s_r[0];
  int kept = 0;
  for (int j0 = j_begin; j0 < j_end; j0 += PAIR_THREADS) {
    const int j = j0 + tid;
    double ty = nan, tx = nan, ta = nan;
    if (j < j_end && pva[j] != 0) {
      ty = __dadd_rn((double)pcy[j], s_cum[0]);
      tx = __dadd_rn((double)pcx[j], s_cum[1]);
      ta = side(par[j], a.aw);
    }
    __syncthreads();
    s_y[tid] = ty;
    s_x[tid] = tx;
    s_a[tid] = ta;
    __syncthreads();
    if (!live) continue;
    const int n = min(PAIR_THREADS, j_end - j0);
    for (int k = 0; k < n; ++k) {
      const double dy = __dsub_rn(y, s_y[k]);
      const double dx = __dsub_rn(x, s_x[k]);
      const double da = __dsub_rn(s, s_a[k]);
      const double d2 = __dadd_rn(__dadd_rn(__dmul_rn(dy, dy), __dmul_rn(dx, dx)),
                                  __dmul_rn(da, da));
      if (!(d2 <= a.thr)) continue;  // far, or an empty row (NaN)
      const double dist = __dsqrt_rn(d2);
      if (!(dist < r0)) continue;
      int lev = 0;
      while (lev + 1 < a.nlev && dist < s_r[lev + 1]) ++lev;
      if (kEmit) {
        const int slot = s_lev[lev] + atomicAdd(cursor + t * a.nlev + lev, 1);
        edges[slot] = make_int2(i, j0 + k);
      } else {
        atomicAdd(s_lev + lev, 1);
        ++kept;
      }
    }
  }
  if (kEmit) return;
  __syncthreads();
  for (int l = tid; l < a.nlev; l += PAIR_THREADS)
    if (s_lev[l] != 0) atomicAdd(counts + t * a.nlev + l, s_lev[l]);
  const int total = block_sum(kept, s_red);
  if (tid == 0 && total != 0) atomicAdd(meta, total);
}

__device__ __forceinline__ int find_root(volatile int* p, int x) {
  int q;
  while ((q = p[x]) != x) x = q;
  return x;
}

// the larger root goes under the smaller; an atomic that finds its slot
// already moved hands the union on to what it found there
__device__ __forceinline__ void unite(volatile int* p, int a, int b) {
  while (true) {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin((int*)&p[a], b);
    if (old == a) return;
    a = old;
  }
}

// Pass 3: radius (T, N) float32; meta[1] += the solves; cum_out = the
// running sum after the last frame. Node v < N is frame t's row v, node
// N + j the previous frame's row j. kShared: the union-find in dynamic
// shared memory, else in `ws` (per frame `stride` ints).
template <bool kShared>
__global__ void __launch_bounds__(SWEEP_THREADS)
    sweep_kernel(Tables a, const int* counts, const int2* edges, int limit,
                 float* radius, int* meta, double* cum_out, int* ws,
                 long long stride) {
  extern __shared__ __align__(16) int smem[];
  __shared__ double s_r[MAX_LEVELS];
  __shared__ int s_lev[MAX_LEVELS + 1];
  __shared__ double s_cum[4];
  __shared__ int s_red[SWEEP_THREADS / 32];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int N = a.N, V = N + max(a.N, a.K), nlev = a.nlev;
  int* base = kShared ? smem : ws + (size_t)t * stride;
  volatile int* parent = base;
  volatile int* cnt = base + V;
  volatile short* maxlev = (volatile short*)(base + 2 * V);
  volatile short* first = maxlev + N;
  radii_and_cum(a, t, s_r, s_cum);
  level_offsets(counts, t, nlev, s_lev, s_red);
  if (t == a.T - 1 && tid == 0) {
    cum_out[0] = s_cum[2];
    cum_out[1] = s_cum[3];
  }
  for (int v = tid; v < V; v += SWEEP_THREADS) parent[v] = v;
  for (int c = tid; c < N; c += SWEEP_THREADS) {
    maxlev[c] = -1;
    first[c] = -1;
  }
  __syncthreads();
  int solves = (tid == 0 && s_lev[nlev] > s_lev[0]) ? 1 : 0;
  bool hooked = false;  // unions since the last compression
  for (int lev = nlev - 1; lev >= 0; --lev) {
    const int e0 = s_lev[lev], e1 = s_lev[lev + 1];
    for (int e = e0 + tid; e < e1; e += SWEEP_THREADS) {
      const int2 p = edges[e];
      unite(parent, p.x, N + p.y);
      if (maxlev[p.x] < 0) maxlev[p.x] = (short)lev;  // every writer: lev
    }
    hooked = hooked || e1 > e0;
    __syncthreads();
    // the deepest level has r_{lev+1} < stop: no re-solve below it; nor is
    // there anything to count before the first edge
    if (lev == nlev - 1 || e0 == s_lev[nlev]) continue;
    if (hooked) {
      for (int v = tid; v < V; v += SWEEP_THREADS)
        if (parent[v] != v) parent[v] = find_root(parent, v);
      hooked = false;
      __syncthreads();
    }
    for (int c = tid; c < N; c += SWEEP_THREADS)
      if (maxlev[c] >= 0) cnt[parent[c]] = 0;
    __syncthreads();
    for (int c = tid; c < N; c += SWEEP_THREADS) {
      if (maxlev[c] < 0) continue;
      const int r = parent[c];
      atomicAdd((int*)&cnt[r], 1);
      if (maxlev[c] > lev && !(cnt[r] & DEEP)) atomicOr((int*)&cnt[r], DEEP);
    }
    __syncthreads();
    for (int c = tid; c < N; c += SWEEP_THREADS) {
      if (maxlev[c] < 0) continue;
      const int r = parent[c];
      const int v = cnt[r];
      if ((v & COUNT_MASK) <= limit) continue;
      if (first[c] < 0) first[c] = (short)lev;
      if ((v & DEEP) && (atomicAnd((int*)&cnt[r], ~DEEP) & DEEP)) ++solves;
    }
    __syncthreads();
  }
  for (int c = tid; c < N; c += SWEEP_THREADS) {
    const int f = first[c];
    radius[(size_t)t * N + c] = __double2float_rn(f >= 0 ? s_r[f + 1] : s_r[0]);
  }
  const int total = block_sum(solves, s_red);
  if (tid == 0 && total != 0) atomicAdd(meta + 1, total);
}

Tables make_tables(const float* cy, const float* cx, const float* area,
                   const uint8_t* valid, const float* pcy, const float* pcx,
                   const float* parea, const uint8_t* pvalid,
                   const double* drift, const double* cum0, int T, int N,
                   int K, int nlev, double r0, double step, double thr,
                   double aw) {
  Tables a;
  a.cy = cy;
  a.cx = cx;
  a.area = area;
  a.valid = valid;
  a.pcy = pcy;
  a.pcx = pcx;
  a.parea = parea;
  a.pvalid = pvalid;
  a.drift = drift;
  a.cum0 = cum0;
  a.T = T;
  a.N = N;
  a.K = pcy != nullptr ? K : 0;
  a.nlev = nlev;
  a.r0 = r0;
  a.step = step;
  a.thr = thr;
  a.aw = aw;
  return a;
}

// Union-find bytes of one frame: parent and count a node, two shorts a
// cell.
long long sweep_bytes(int N, int K) {
  const long long V = (long long)N + (N > K ? N : K);
  return 8 * V + 4LL * N;
}

// (cells / 256, frames, previous rows / 1024)
dim3 pair_grid(const Tables& a) {
  const int rows = a.N > a.K ? a.N : a.K;
  return dim3((a.N + PAIR_THREADS - 1) / PAIR_THREADS, a.T,
              (rows + PAIR_ROWS - 1) / PAIR_ROWS);
}

bool bad_sizes(int T, int N, int K, int nlev) {
  return T < 1 || N < 1 || K < 0 || nlev < 1 || nlev > MAX_LEVELS ||
         (long long)T * N >= (1LL << 31) || K >= (1 << 30);
}

}  // namespace

extern "C" {

// The most union-find bytes the sweep can hold in shared memory on the
// calling thread's card (0 if it cannot tell).
int radii_shared_limit() {
  const int dev = current_card();
  int most = 0;
  if (dev < 0 ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  // the sweep's static arrays come out of the same budget
  return most - (MAX_LEVELS * 8 + (MAX_LEVELS + 1) * 4 + 32 +
                 SWEEP_THREADS / 32 * 4);
}

// Pass 1. counts: (T * nlev) zeroed ints; meta: 2 zeroed ints (meta[0]
// gets the number of pairs). The carry (pcy.. pvalid, K rows) may be
// null. thr: a squared bound above r0^2 (no pair beyond it is kept).
int radii_count(const float* cy, const float* cx, const float* area,
                const uint8_t* valid, const float* pcy, const float* pcx,
                const float* parea, const uint8_t* pvalid,
                const double* drift, const double* cum0, int T, int N, int K,
                int nlev, double r0, double step, double thr, double aw,
                int* counts, int* meta, void* stream) {
  if (bad_sizes(T, N, K, nlev)) return (int)cudaErrorInvalidValue;
  const Tables a = make_tables(cy, cx, area, valid, pcy, pcx, parea, pvalid,
                               drift, cum0, T, N, K, nlev, r0, step, thr, aw);
  pairs_kernel<false><<<pair_grid(a), PAIR_THREADS, 0,
                        (cudaStream_t)stream>>>(a, counts, nullptr, meta,
                                                nullptr);
  return (int)cudaGetLastError();
}

// Passes 2 and 3. cursor: (T * nlev) zeroed ints; edges: meta[0] int2
// slots (at least one); radius: (T, N) float32; cum_out: 2 doubles; ws:
// null for the shared form, else T x (8 (N + max(N, K)) + 4 N) bytes.
int radii_sweep(const float* cy, const float* cx, const float* area,
                const uint8_t* valid, const float* pcy, const float* pcx,
                const float* parea, const uint8_t* pvalid,
                const double* drift, const double* cum0, int T, int N, int K,
                int nlev, double r0, double step, double thr, double aw,
                const int* counts, int* cursor, int* meta, int2* edges,
                int limit, float* radius, double* cum_out, int* ws,
                void* stream) {
  if (bad_sizes(T, N, K, nlev)) return (int)cudaErrorInvalidValue;
  const Tables a = make_tables(cy, cx, area, valid, pcy, pcx, parea, pvalid,
                               drift, cum0, T, N, K, nlev, r0, step, thr, aw);
  cudaStream_t s = (cudaStream_t)stream;
  pairs_kernel<true><<<pair_grid(a), PAIR_THREADS, 0, s>>>(
      a, (int*)counts, cursor, meta, edges);
  const long long bytes = sweep_bytes(N, a.K);
  if (ws != nullptr) {
    sweep_kernel<false><<<T, SWEEP_THREADS, 0, s>>>(
        a, counts, edges, limit, radius, meta, cum_out, ws, bytes / 4);
    return (int)cudaGetLastError();
  }
  static std::atomic<long long> opted[MAX_CARDS];
  const int dev = current_card();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (opted[dev].load() < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted[dev].store(bytes);
  }
  sweep_kernel<true><<<T, SWEEP_THREADS, (size_t)bytes, s>>>(
      a, counts, edges, limit, radius, meta, cum_out, nullptr, 0);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
