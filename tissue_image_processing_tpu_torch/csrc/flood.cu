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
// The settle. Function: the ascending Meyer settle of _settle_math, iterated
// as exact Jacobi sweeps from the seeds to the first sweep that settles
// nothing: labels (> 0 label, 0 unsettled, -1 line, -2 void) and the arrival
// stamp t = the sweep at which a pixel settled (seeds 0, never BIG_T).
// Bound: memory for the function (comparison mask and seeds read once, labels
// and stamps written once, 16 B/px). But the result depends on the schedule:
// the label a pixel takes (-1 if its settled donors disagree AT THAT SWEEP)
// and its stamp are those of the Jacobi sequence, and the watershed-line pass
// orders line pixels by (lam, t, index). No in-place or Gauss-Seidel update
// computes that, and a launch a sweep is bound by launch and queue latency.
//
// Design: temporal blocking with ghost zones in one persistent cooperative
// launch. A round is SK = 8 sweeps. A block takes a 64 x 64 tile with a halo
// SK pixels deep (80 x 80) into shared memory as it stood when the round
// began and runs the round's sweeps there: sweep j computes the cells at
// least j pixels inside the 80 x 80 region, so every cell it computes reads
// neighbours that are exact after sweep j - 1, and after sweep SK exactly
// the tile is left. A pixel of the tile that settles is stored at once
// (label and stamp it0 + j - 1); nothing else is written. grid.sync() ends
// the round.
//   Inside the tile a thread owns a strip of 20 rows of one column and keeps
//   its unsettled cells as bits of a register, with the comparison mask of
//   those cells as eight more words (< and <= a direction); the strips'
//   unsettled words are published in shared memory once a sweep
//   (double-buffered). _settle_math then runs on whole words: not ready while
//   a lower neighbour is unsettled, a donor is a <= neighbour that was
//   settled when the sweep began, a void needs every <= neighbour settled.
//   Only the few cells that pass are visited one by one, and nearly all of
//   them settle. A neighbour's label is read only if its published bit says
//   it was settled when the sweep began, and then it can no longer change:
//   labels are updated in place with one barrier a sweep and the sequence is
//   still Jacobi. A sweep that settles nothing in its region ends the tile's
//   round early (nothing can settle in the tile after it).
//   A block that has a single tile (the grid covers the image) keeps it in
//   shared memory and registers from round to round: the tile's own cells
//   are exact there after every round and nobody else changes them, so only
//   the halo is loaded again. Threads are laid out for that: the 64 own
//   columns first, a warp a strip of 32, then the halo's.
//   The race designed out: another block stores into this tile's halo while
//   it is being loaded. One label plane, in place, and THE STAMP DECIDES
//   what the loader makes of a pixel. t < it0 (the round's first sweep):
//   settled in an earlier round, so label and stamp were complete before the
//   last grid.sync() and the label counts. t >= it0: stored this round, unsettled
//   when it began, whatever the label plane holds by now. t == BIG_T:
//   unsettled or a negative seed (settled from the start with no stamp); the
//   value is the seed's. Every case gives the state at the round's start; no
//   ordering between the two stores is needed. Round 0 reads only the seeds.
//   Gating: a change at sweep s needs a change at sweep s - 1 within one
//   pixel, so a tile can change during a round only if something settled
//   within SK <= 64 pixels of it in the LAST sweep of the round before: it
//   runs iff itself or one of its 8 neighbours did then. ("Nothing changed
//   in my own tile" would be wrong: a front can enter from next door.) A
//   tile with no unsettled pixel is done for good. Round 0 runs every tile
//   and writes the initial state, so no separate pass prepares it.
//   Convergence: a round whose last sweep settled nothing anywhere ends the
//   kernel. The host reads nothing; rounds and sweeps are left in the flags.
// Label domain as in _settle_math. The comparison mask is settle_mask's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// The library serves every card of the process, from several host threads:
// what a launch learns from the calling thread's current card (occupancy, a
// shared memory size opted into) is cached by card, in atomics.
constexpr int MAX_CARDS = 64;

// the calling thread's current card, or -1
inline int current_card() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS)
    return -1;
  return dev;
}

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
  static std::atomic<int> resident[MAX_CARDS];  // blocks a card holds at once
  if (H < 1 || W < 1 || 2LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int dev = current_card();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, diffusion_kernel<C>, DIFF_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident[dev] = sms * per_sm;
  }
  const int held = resident[dev];
  const int tiles = diffusion_tiles(H, W);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, (2 * tiles + 4) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&c, &aux, &seed, &a, &flags, &H, &W};
  return (int)cudaLaunchCooperativeKernel(
      (void*)diffusion_kernel<C>, dim3(tiles < held ? tiles : held),
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

// Settle tiling: a round is SK sweeps on ST x ST tiles with an SK-deep halo.
constexpr int ST = 64;
constexpr int SK = 8;
constexpr int SE = ST + 2 * SK;            // edge of the region in shared memory
constexpr int SSEG = 4;                    // strips a column
constexpr int SROWS = SE / SSEG;           // rows a strip: one thread's cells
constexpr int SETTLE_THREADS = SE * SSEG;
constexpr int SETTLE_MIN_BLOCKS = 4;       // blocks an SM the registers must allow
constexpr int SLOAD = 4;                   // rows a thread loads at a time
constexpr int BIG_T = (1 << 30) - 1;       // stamp of a pixel that never settles
static_assert(SE % SSEG == 0 && SROWS + 2 <= 32, "a strip and its two "
              "neighbours must fit one 32-bit word");
static_assert(SK <= ST, "the gate looks one tile around");
static_assert(SLOAD <= 8, "a chunk's bits of one direction fill a byte at most");

// The bits of the strip starting at row r0 whose rows lie in [lo, hi).
__device__ __forceinline__ unsigned strip_bits(int lo, int hi, int r0) {
  lo = max(lo - r0, 0);
  hi = min(hi - r0, SROWS);
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

// flags: changed[2][tiles], done[tiles], any[3], negative seeds, rounds,
// sweeps.
__global__ void __launch_bounds__(SETTLE_THREADS, SETTLE_MIN_BLOCKS)
    settle_kernel(const int* __restrict__ mask, const int* __restrict__ seeds,
                  int* lbl, int* t, int* flags, int H, int W) {
  namespace cg = cooperative_groups;
  __shared__ int s_lbl[SE * SE];
  __shared__ unsigned s_u[2][SSEG][SE];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (W + ST - 1) / ST, tiles_y = (H + ST - 1) / ST;
  const int tiles = tiles_x * tiles_y;
  int* done = flags + 2 * tiles;
  int* any = flags + 3 * tiles;
  int* has_negative = any + 3;
  const int tid = threadIdx.x;
  // the tile's own columns first, a warp a strip of 32 of them, then the
  // halo's: from round 1 on a block that keeps its tile loads the halo only
  const bool col_own = tid < ST * SSEG;
  const int seg = col_own ? tid / ST : (tid - ST * SSEG) / (2 * SK);
  const int hx = (tid - ST * SSEG) % (2 * SK);
  const int lx = col_own ? SK + tid % ST : (hx < SK ? hx : ST + hx);
  const int r0 = seg * SROWS;
  const unsigned own_rows = strip_bits(SK, SK + ST, r0);
  const bool keep = gridDim.x >= tiles;  // one tile a block at most
  int last_sweep = 0;  // thread 0: the last sweep that settled a pixel
  // a thread's strip: u = its unsettled cells; lt[d], le[d] = the mask's
  // comparison bits of those, a word a direction (N, S, W, E); inside = its
  // cells in the image
  unsigned u = 0, inside = 0, lt[4] = {0, 0, 0, 0}, le[4] = {0, 0, 0, 0};

  int round = 0;
  for (;; ++round) {
    const int it0 = 1 + round * SK;  // the round's first sweep
    int* chg_now = flags + (round & 1) * tiles;
    const int* chg_prev = flags + ((round + 1) & 1) * tiles;
    // slot r % 3 is written in round r and read after its sync; the slot of
    // round r + 1 was last read after the sync of round r - 2
    if (blockIdx.x == 0 && tid == 0) any[(round + 1) % 3] = 0;
    // a negative seed is settled from the start and has no stamp: only then
    // does a later round need the seeds again (found in round 0)
    const bool negative = round > 0 && __ldcg(has_negative) != 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int ty = tile / tiles_x, tx = tile % tiles_x;
      if (round > 0) {
        // the gate: nine threads read the 3 x 3 flags of the last round
        int near = 0;
        if (tid < 9) {
          const int ny = ty + tid / 3 - 1, nx = tx + tid % 3 - 1;
          if (ny >= 0 && ny < tiles_y && nx >= 0 && nx < tiles_x)
            near = __ldcg(chg_prev + ny * tiles_x + nx);
        }
        const int finished = __ldcg(done + tile);
        if (!__syncthreads_or(near) || finished) {
          if (tid == 0) chg_now[tile] = 0;
          continue;
        }
      }
      __syncthreads();  // the previous tile's shared state is done with

      // the region as it stood when the round began; beyond the image a
      // cell is unsettled for ever (reads 0, is never computed)
      const int gx = tx * ST - SK + lx, gy0 = ty * ST - SK + r0;
      const bool col_in = gx >= 0 && gx < W;
      // A block that has one tile keeps it: the tile's own cells are exact
      // in shared memory after every round and change nowhere else, so from
      // round 1 on only the halo is loaded again
      const unsigned fresh =
          keep && round > 0 && col_own ? ~own_rows : ~0u;
      u &= ~fresh;
      inside &= ~fresh;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        lt[d] &= ~fresh;
        le[d] &= ~fresh;
      }
#pragma unroll
      for (int i0 = 0; i0 < SROWS; i0 += SLOAD) {
        if (((fresh >> i0) & ((1u << SLOAD) - 1u)) == 0) continue;
        // independent loads first, so that a chunk costs one latency: the
        // label is read even where the stamp will say not to use it
        int stamp[SLOAD], old[SLOAD], sd[SLOAD], mk[SLOAD];
        unsigned took = 0;
#pragma unroll
        for (int k = 0; k < SLOAD; ++k) {
          const int i = i0 + k, gy = gy0 + i, p = gy * W + gx;
          stamp[k] = BIG_T;
          old[k] = sd[k] = mk[k] = 0;
          if (i < SROWS && col_in && gy >= 0 && gy < H && ((fresh >> i) & 1)) {
            took |= 1u << k;
            if (round > 0) {
              stamp[k] = __ldcg(t + p);
              old[k] = __ldcg(lbl + p);
            }
            if (round == 0 || negative) sd[k] = seeds[p];
            mk[k] = mask[p];
          }
        }
        // the mask's bits of the chunk's unsettled cells, a byte a direction
        unsigned lt4 = 0, le4 = 0, open4 = 0;
#pragma unroll
        for (int k = 0; k < SLOAD; ++k) {
          const int i = i0 + k;
          if (i >= SROWS || !((fresh >> i) & 1)) continue;
          const int v = stamp[k] < it0 ? old[k] : (stamp[k] == BIG_T ? sd[k] : 0);
          if (round == 0 && ((took >> k) & 1)) {
            if (col_own && ((own_rows >> i) & 1)) {
              const int p = (gy0 + i) * W + gx;
              lbl[p] = v;
              t[p] = v > 0 ? 0 : BIG_T;
            }
            if (v < 0) *has_negative = 1;
          }
          if (v == 0) {
            open4 |= 1u << k;
            // bit d of a nibble to bit 0 of byte d
            lt4 |= (((unsigned)(mk[k] & 0xf) * 0x00204081u) & 0x01010101u) << k;
            le4 |= (((unsigned)((mk[k] >> 4) & 0xf) * 0x00204081u) & 0x01010101u) << k;
          }
          s_lbl[(r0 + i) * SE + lx] = v;
        }
        u |= open4 << i0;
        inside |= took << i0;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          lt[d] |= ((lt4 >> (8 * d)) & 0xffu) << i0;
          le[d] |= ((le4 >> (8 * d)) & 0xffu) << i0;
        }
      }
      s_u[0][seg][lx] = u;
      __syncthreads();

      int last_changed = 0, j_last = 0;
      for (int j = 1; j <= SK; ++j) {
        const unsigned(*cur)[SE] = s_u[(j - 1) & 1];
        bool changed = false;
        // a strip with no unsettled cell in the sweep's region has nothing to do
        const unsigned open = u & inside & strip_bits(j, SE - j, r0);
        if (open != 0 && lx >= j && lx < SE - j) {
          // unsettled bits of the four neighbours when the sweep began: the
          // strip's own word with the rows above and below it, west, east
          const unsigned above = seg > 0 ? cur[seg - 1][lx] : ~0u;
          const unsigned below = seg < SSEG - 1 ? cur[seg + 1][lx] : ~0u;
          const unsigned col = (u << 1) | ((above >> (SROWS - 1)) & 1u) |
                               ((below & 1u) << (SROWS + 1));
          const unsigned un[4] = {col, col >> 2, cur[seg][lx - 1],
                                  cur[seg][lx + 1]};
          // _settle_math on whole words: not ready while a lower neighbour is
          // unsettled; a donor must be <= and settled; a void needs every <=
          // neighbour settled. What is left almost always settles
          unsigned waiting = 0, donor = 0, blocked = 0;
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            waiting |= lt[d] & un[d];
            donor |= le[d] & ~un[d];
            blocked |= le[d] & un[d];
          }
          unsigned cand = open & ~waiting & (donor | ~blocked);
          while (cand) {
            const int i = __ffs(cand) - 1;
            cand &= cand - 1;
            const int c = (r0 + i) * SE + lx;
            const int at[4] = {c - SE, c + SE, c - 1, c + 1};
            int minl = 1 << 30, maxl = 0;
#pragma unroll
            for (int d = 0; d < 4; ++d)
              if (((le[d] & ~un[d]) >> i) & 1u) {
                const int q = s_lbl[at[d]];  // settled before this sweep
                if (q > 0) {
                  minl = min(minl, q);
                  maxl = max(maxl, q);
                }
              }
            int nl = 0;
            if (maxl > 0)
              nl = minl != maxl ? -1 : maxl;  // donors disagree: a line
            else if (!((blocked >> i) & 1u))
              nl = -2;  // void: nothing can ever donate
            if (nl != 0) {
              s_lbl[c] = nl;  // nobody reads it before the next sweep
              u &= ~(1u << i);
              changed = true;
              if (col_own && ((own_rows >> i) & 1)) {
                const int p = (gy0 + i) * W + gx;
                t[p] = it0 + j - 1;
                lbl[p] = nl;
              }
            }
          }
        }
        s_u[j & 1][seg][lx] = u;
        last_changed = __syncthreads_or(changed);
        if (!last_changed) break;  // nothing can settle in the tile after it
        j_last = j;
      }

      const int left = __syncthreads_or(col_own && (u & inside & own_rows) != 0);
      if (tid == 0) {
        chg_now[tile] = last_changed;
        if (last_changed) any[round % 3] = 1;
        if (!left) done[tile] = 1;
        if (j_last) last_sweep = max(last_sweep, it0 + j_last - 1);
      }
    }
    grid.sync();
    if (__ldcg(any + round % 3) == 0) break;
  }
  if (tid == 0) {
    if (blockIdx.x == 0) flags[3 * tiles + 4] = round + 1;
    atomicMax(flags + 3 * tiles + 5, last_sweep);
  }
}

int settle_tiles(int H, int W) {
  return ((H + ST - 1) / ST) * ((W + ST - 1) / ST);
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

int settle_flag_ints(int H, int W) { return 3 * settle_tiles(H, W) + 6; }

// The whole settle in one cooperative launch on `stream`, no synchronisation:
// from the comparison mask (settle_mask) and the seeds to the labels `lbl` and
// arrival stamps `t`, every pixel of both written. `flags` is scratch of
// settle_flag_ints(H, W) ints; its last two receive the number of rounds and
// of sweeps (the highest stamp given). Returns the cudaError_t of the launch.
int settle_sweeps(const int* mask, const int* seeds, int* lbl, int* t,
                  int* flags, int H, int W, void* stream) {
  static std::atomic<int> resident[MAX_CARDS];  // blocks a card holds at once
  cudaStream_t s = (cudaStream_t)stream;
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int dev = current_card();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, settle_kernel, SETTLE_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident[dev] = sms * per_sm;
  }
  const int held = resident[dev];
  const int tiles = settle_tiles(H, W);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, settle_flag_ints(H, W) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&mask, &seeds, &lbl, &t, &flags, &H, &W};
  return (int)cudaLaunchCooperativeKernel(
      (void*)settle_kernel, dim3(tiles < held ? tiles : held),
      dim3(SETTLE_THREADS), args, 0, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
