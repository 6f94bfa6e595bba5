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
// The diffusion. Function: the greatest fixpoint below the initial state of
//   BF:  lam = min(lam, max(min of the 4 neighbours' lam, img)), from
//        lam0 = img on seeds, +inf elsewhere;
//   CC:  lbl = min(lbl, min of the 4 neighbours' lbl) inside the mask, from
//        lbl0 = init (or the flat index); `fill` = H * W outside, -1 in the
//        result.
// Bound on an H100: memory for the function itself (auxiliary plane and
// initial state read once, the result written once, 12 B/px), but a value
// has to travel the pixel diameter of the widest plateau or flood path
// (~75-125 px on the pipeline's frames), and a schedule that goes to device
// memory and back to the host for every step of that way is bound by launch
// and queue latency, not by bytes.
//
// Design: tile-resident relaxation in one persistent cooperative launch.
// Both combines are monotone (a value only falls, and never below the
// fixpoint), so the fixpoint does not depend on the order of the updates.
// A block takes a 64 x 64 tile with a one-pixel halo of the state, and the
// auxiliary plane, into shared memory and relaxes it there IN PLACE to the
// tile's own fixpoint: each thread walks a 16-pixel segment with the
// running value in a register, down, right, up, left in turn, so a value
// crosses the tile along a straight run in one sweep; a sweep that changed
// nothing ends the tile. The tile goes back to device memory in place,
// only the words that changed. A tile whose border row or column changed
// marks the neighbouring tile dirty; after a grid-wide sync the next round
// relaxes only dirty tiles, and the kernel ends with the first round that
// marked none. Rounds count tiles crossed, not pixels, and the host reads
// nothing. The first round builds the initial state from the inputs
// (seeds / mask and init), so no separate pass prepares it.
// Neighbouring blocks read a tile's border for their halo while it is being
// written back: harmless, because every value a reader can see is a state
// the relaxation passed through (32-bit words, never torn), and the writer
// marks the reader dirty whenever its border changed, so the reader runs
// again on the final values. BF values are selections (fminf / fmaxf) of
// input values, never arithmetic, so bits carry over whatever the order.
// The grid is what the card holds at once (occupancy x SMs); blocks loop
// over tiles.
//
// The settle. Bound: memory and launches, sweep after sweep: one Jacobi
// sweep reads the comparison mask and the labels and writes the labels
// (and the arrival stamp of the pixels that settle), ~40 integer
// operations per pixel. Design: one thread per pixel and one launch per
// sweep with ping-pong label buffers, in batches of eight; only the last
// sweep of a batch records "changed" in a device flag, which the host reads
// once per batch (a last sweep that changed nothing proves convergence, and
// the extra sweeps of the final batch are no-ops).
// The settle must stay Jacobi: its arrival stamp t is the sweep index, and
// the watershed-line pass orders line pixels by (lam, t, index). An in-place
// or Gauss-Seidel update would change t and hence the lines. Label domain as
// in _settle_math: > 0 label, 0 unsettled, -1 line, -2 void.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

// --- the diffusion -----------------------------------------------------------

constexpr int TILE = 64;                      // interior edge of a tile
constexpr int PITCH = TILE + 3;               // odd: row and column walks are
                                              // both free of bank conflicts
constexpr int SEG = 16;                       // pixels a thread walks a sweep
constexpr int DIFF_THREADS = TILE * TILE / SEG;
constexpr int CELLS = (TILE + 2) * PITCH;

// Bellman-Ford flood levels: aux = img, seed = the seed labels.
struct BfCombine {
  using T = float;
  using Aux = float;
  __device__ static T identity() { return INFINITY; }
  __device__ static Aux outside_aux() { return INFINITY; }
  __device__ T initial(Aux img, const int* seeds, int p) const {
    return seeds[p] > 0 ? img : INFINITY;
  }
  __device__ T relax(T st, T cand, Aux img) const {
    return fminf(st, fmaxf(cand, img));
  }
  __device__ static T lower(T a, T b) { return fminf(a, b); }
  __device__ T from_global(T v, Aux) const { return v; }
  __device__ T to_global(T v, Aux) const { return v; }
};

// Component minimum: aux = the mask, seed = init (null: the flat index).
// Outside the mask the state is `fill` in the tile and -1 in device memory.
struct CcCombine {
  using T = int;
  using Aux = uint8_t;
  int fill;
  __device__ static T identity() { return 0x7fffffff; }
  __device__ static Aux outside_aux() { return 0; }
  __device__ T initial(Aux m, const int* init, int p) const {
    return m ? (init != nullptr ? init[p] : p) : fill;
  }
  __device__ T relax(T st, T cand, Aux m) const {
    return m ? min(st, cand) : fill;
  }
  __device__ static T lower(T a, T b) { return min(a, b); }
  __device__ T from_global(T v, Aux m) const { return m ? v : fill; }
  __device__ T to_global(T v, Aux m) const { return m ? v : -1; }
};

// flags: dirty[2][tiles], any[3], rounds[1]; see diffusion_kernel.
template <class C>
__global__ void __launch_bounds__(DIFF_THREADS)
    diffusion_kernel(C c, const typename C::Aux* __restrict__ aux,
                     const int* __restrict__ seed, typename C::T* a,
                     int* flags, int H, int W) {
  using T = typename C::T;
  using Aux = typename C::Aux;
  namespace cg = cooperative_groups;
  __shared__ T s[CELLS];
  __shared__ Aux s_aux[CELLS];
  __shared__ int s_sides;
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  const int tiles = tiles_x * tiles_y;
  int* any = flags + 2 * tiles;
  const int t = threadIdx.x;
  const int u = t % TILE, seg = t / TILE;

  // round r + 1 relaxes at least what Jacobi sweep r + 1 would, so H * W
  // rounds are enough for any input
  int round = 0;
  for (; round <= H * W; ++round) {
    int* dirty_now = flags + (round & 1) * tiles;
    int* dirty_next = flags + ((round + 1) & 1) * tiles;
    int* any_next = any + (round + 1) % 3;
    if (blockIdx.x == 0 && t == 0) any[(round + 2) % 3] = 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      // only this block touches dirty_now[tile] in this round
      if (round > 0 && __ldcg(dirty_now + tile) == 0) continue;
      const int y0 = (tile / tiles_x) * TILE, x0 = (tile % tiles_x) * TILE;
      __syncthreads();  // the previous tile's shared state is done with
      if (t == 0) {
        dirty_now[tile] = 0;
        s_sides = 0;
      }
      // the tile and its halo; beyond the image the combine's identity
      for (int i = t; i < (TILE + 2) * (TILE + 2); i += DIFF_THREADS) {
        const int ly = i / (TILE + 2), lx = i % (TILE + 2);
        const int y = y0 + ly - 1, x = x0 + lx - 1;
        T v = C::identity();
        Aux av = C::outside_aux();
        if (y >= 0 && y < H && x >= 0 && x < W) {
          const int p = y * W + x;
          av = aux[p];
          v = round == 0 ? c.initial(av, seed, p)
                         : c.from_global(__ldcg(a + p), av);
        }
        s[ly * PITCH + lx] = v;
        s_aux[ly * PITCH + lx] = av;
      }
      __syncthreads();

      // relax in place to the tile's fixpoint: sweeps walk down, right, up,
      // left in turn; every sweep updates every pixel from all four
      // neighbours, so one sweep without a change is the fixpoint
      for (int sweep = 0;; ++sweep) {
        const bool vertical = (sweep & 1) == 0, forward = (sweep & 2) == 0;
        const int along = forward ? seg * SEG : seg * SEG + SEG - 1;
        int p = vertical ? (along + 1) * PITCH + u + 1
                         : (u + 1) * PITCH + along + 1;
        const int ds = (vertical ? PITCH : 1) * (forward ? 1 : -1);
        const int os = vertical ? 1 : PITCH;
        bool changed = false;
        T run = s[p - ds];
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const T st = s[p];
          const T cand = C::lower(C::lower(run, s[p + ds]),
                                  C::lower(s[p - os], s[p + os]));
          const T nv = c.relax(st, cand, s_aux[p]);
          if (nv != st) {
            s[p] = nv;
            changed = true;
          }
          run = nv;
          p += ds;
        }
        if (!__syncthreads_or(changed)) break;
      }

      // back to device memory, the changed words only; a changed border
      // row or column marks the tile beyond it for the next round
      int sides = 0;
      for (int i = t; i < TILE * TILE; i += DIFF_THREADS) {
        const int ly = i / TILE, lx = i % TILE;
        const int y = y0 + ly, x = x0 + lx;
        if (y >= H || x >= W) continue;
        const int p = y * W + x, q = (ly + 1) * PITCH + lx + 1;
        const Aux av = s_aux[q];
        const T nv = c.to_global(s[q], av);
        const T old = round == 0 ? c.to_global(c.initial(av, seed, p), av)
                                 : __ldcg(a + p);
        if (round == 0 || nv != old) a[p] = nv;
        if (nv != old)
          sides |= (ly == 0 ? 1 : 0) | (ly == TILE - 1 ? 2 : 0) |
                   (lx == 0 ? 4 : 0) | (lx == TILE - 1 ? 8 : 0);
      }
      if (sides) atomicOr(&s_sides, sides);
      __syncthreads();
      if (t == 0 && s_sides) {
        const int ty = tile / tiles_x, tx = tile % tiles_x;
        int marked = 0;
        if ((s_sides & 1) && ty > 0) dirty_next[tile - tiles_x] = marked = 1;
        if ((s_sides & 2) && ty < tiles_y - 1)
          dirty_next[tile + tiles_x] = marked = 1;
        if ((s_sides & 4) && tx > 0) dirty_next[tile - 1] = marked = 1;
        if ((s_sides & 8) && tx < tiles_x - 1) dirty_next[tile + 1] = marked = 1;
        if (marked) *any_next = 1;
      }
    }
    grid.sync();
    if (__ldcg(any_next) == 0) break;
  }
  if (blockIdx.x == 0 && t == 0) flags[2 * tiles + 3] = round + 1;
}

int diffusion_tiles(int H, int W) {
  return ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
}

// One cooperative launch: as many blocks as the card holds at once, at most
// one a tile.
template <class C>
int launch_diffusion(C c, const typename C::Aux* aux, const int* seed,
                     typename C::T* a, int* flags, int H, int W,
                     cudaStream_t s) {
  static int resident = 0;
  if (H < 1 || W < 1 || 2LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, diffusion_kernel<C>, DIFF_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident = sms * per_sm;
  }
  const int tiles = diffusion_tiles(H, W);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, (2 * tiles + 4) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&c, &aux, &seed, &a, &flags, &H, &W};
  return (int)cudaLaunchCooperativeKernel(
      (void*)diffusion_kernel<C>, dim3(tiles < resident ? tiles : resident),
      dim3(DIFF_THREADS), args, 0, s);
}

// --- the settle --------------------------------------------------------------

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

// The diffusion entry points run to the fixpoint in one launch on `stream`
// and do not synchronise. `flags` is scratch of diffusion_flag_ints(H, W)
// ints; its last int receives the number of rounds. Return the cudaError_t
// of the launch.

int diffusion_flag_ints(int H, int W) { return 2 * diffusion_tiles(H, W) + 4; }

// lam (H, W) from img and the seed labels (seeds > 0).
int bf_diffusion(const float* img, const int* seeds, float* lam, int* flags,
                 int H, int W, void* stream) {
  return launch_diffusion(BfCombine{}, img, seeds, lam, flags, H, W,
                          (cudaStream_t)stream);
}

// The component minimum of `init` (null: the flat index) over `mask` (one
// byte a pixel, nonzero = in) into `lbl`; -1 outside the mask.
int cc_diffusion(const uint8_t* mask, const int* init, int* lbl, int* flags,
                 int H, int W, void* stream) {
  return launch_diffusion(CcCombine{H * W}, mask, init, lbl, flags, H, W,
                          (cudaStream_t)stream);
}

int settle_mask(const float* lam, int* mask, int H, int W, void* stream) {
  settle_mask_kernel<<<grid_for(H, W), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      lam, mask, H, W);
  return (int)cudaGetLastError();
}

// Runs n_sweeps (even, >= 2) Jacobi sweeps a -> b -> a -> ... so the labels
// land back in `a`; sweep k of the batch stamps t = it0 + k on the pixels it
// settles. `flag` is zeroed first and set by the LAST sweep iff it settled
// any pixel. Returns the cudaError_t of the launches.
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
