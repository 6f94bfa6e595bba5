// Int8 3x3 SAME convolution with the int8 U-Net's fused epilogue.
//
// Replaces: tissue_image_processing_tpu/models/quant.py:_conv_s8 (l.65, an
//   XLA int8 convolution with int32 accumulation, not a Pallas kernel) with
//   the float32 epilogue that follows it in _dc_int8 / _dc_int8_split
//   (_epilogue, ReLU, + shift) and the _quant that requantizes its output
//   for the next conv. PyTorch has no int8 convolution on CUDA.
//
// On the int8 U-Net path every 3x3 conv runs here: per double conv, the
// first conv (over the block input, or over the (up, skip) pair as a split
// conv — two inputs, two int32 accumulators, no concat tensor) and the
// second. At the reference width (depth 3, 128 filters) that is 14 launches
// a forward.
//
// Bound on an H100: operations. A conv does 2 * pixels * 9 * Cin * Cout
// int8 operations against the 1,979 TOP/s dense int8 peak and moves pixels
// * (Cin + Cout) bytes against 3.35 TB/s: above ~1 KOP a byte the tensor
// cores bound it, so every conv from Cin = 128 up is operation bound; the
// first (Cin = 2) is byte bound.
//
// Three forms, chosen by shape in the wrapper (ops/conv_s8_cuda.py:
// conv_s8_form), all computing the same function bit for bit:
//   tensor core  every input (each half of a split) with Cin % 64 == 0;
//   first conv   a single input with Cin <= 7 and Cout % 64 == 0, <= 256;
//   generic      everything else (narrow test networks, odd channel counts).
// Each form's note stands above its kernel.
//
// Exactness. The int32 sums are exact, so they equal any other order's. The
// epilogue follows the JAX package's float32 order with separate
// round-to-nearest multiplies and adds (no FMA contraction):
//   single: y = acc * (wscale[n] * s0) + bias[n]
//   split:  y = (acc_up * s0 + acc_skip * s1) * wscale[n] + bias[n]
//   then    y = max(y, 0) + shift[n];  q = rint(clip(y * qmul, -127, 127))
// where s0 = in_scale / 127, s1 = skip_scale / 127, qmul = 127 / out_scale
// are float32 scalars the wrapper computes on the card (correctly rounded
// divisions) and passes by pointer, so nothing is read back to the host.
// rint rounds half to even, as jnp.round and torch.round do. The two sums
// of a split conv stay apart until each is scaled.

#include <cuda.h>
#include <cuda_runtime.h>
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

// ---------------------------------------------------------------------------
// Shared pieces.

__device__ __forceinline__ int ld32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue after y's dequantize: ReLU, + shift, requantize. Returns
// the int8 result in the low byte: v + 1.5 * 2^23 with v in [-127, 127]
// lies in [2^23, 2^24), where floats are the integers, so the add rounds v
// to an integer, half to even, exactly as __float2int_rn does, and the low
// bits of its pattern (0x4B400000 + rint(v)) are rint(v) in two's
// complement. An add on the FMA pipe instead of a conversion on the
// quarter-rate conversion pipe.
__device__ __forceinline__ uint32_t requant(float y, float sh, float qmul) {
  y = __fadd_rn(fmaxf(y, 0.0f), sh);
  const float v = fminf(fmaxf(__fmul_rn(y, qmul), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Two requant results as two int8 bytes (low 16 bits).
__device__ __forceinline__ uint16_t pack2(uint32_t q0, uint32_t q1) {
  return static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
}

// float(acc) exactly, for |acc| < 2^22 (the first conv's sums), on the FMA
// pipe: the pattern 0x4B400000 + acc is the float 1.5 * 2^23 + acc.
__device__ __forceinline__ float small_int2float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
}

// single: acc * mult + bias, mult = wscale * s0
__device__ __forceinline__ float dequant1(int acc, float mult, float bi) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), mult), bi);
}

// split: (acc_up * s0 + acc_skip * s1) * wscale + bias
__device__ __forceinline__ float dequant2(int a0, int a1, float s0, float s1,
                                          float ws, float bi) {
  const float sum = __fadd_rn(__fmul_rn(__int2float_rn(a0), s0),
                              __fmul_rn(__int2float_rn(a1), s1));
  return __fadd_rn(__fmul_rn(sum, ws), bi);
}

// ---------------------------------------------------------------------------
// Generic form (the kernel's first form, kept for every shape the other
// two do not take): an implicit GEMM, M = B * H * W pixels, N = Cout, K =
// 9 * Cin (tap-major, k = (dy * 3 + dx) * Cin + c), on mma.sync m16n8k32
// s8 -> s32.
// A block owns 128 pixels x 128 output channels and walks K in chunks of 32
// through a double buffer in shared memory (cp.async, zero-filled outside
// the image); its 8 warps each own 64 x 32 of the tile. When Cin is a
// multiple of 32 a chunk lies inside one tap and a thread fetches its
// pixel's 16 channels with one 16-byte copy; otherwise a thread gathers its
// 16 (tap, channel) bytes one at a time, predicated on the image edge and
// on k < 9 * Cin. Shared rows are 48 bytes apart, so the fragment loads of
// a warp hit 32 different banks. What bounds it: a 32-byte K step between
// two barriers, warp-level MMA, one tile a block; 7.5x its operation bound
// at the reference width (PERF.md).

namespace generic {

constexpr int BM = 128;        // pixels a block
constexpr int BN = 128;        // output channels a block
constexpr int BK = 32;         // K a chunk (one mma depth)
constexpr int ROW = 48;        // bytes between shared rows (32 + 16 pad)
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N

struct Operand {
  const int8_t* x;   // (B, H, W, cin) int8, channels last
  const int8_t* w;   // (Np, kp) int8, packed
  int cin, kp;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* src,
                                           int src_bytes) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Tiles {
  int8_t a[2][BM * ROW];
  int8_t b[2][BN * ROW];
};

// Stage chunk kt of operand `op` into buffer `buf`. Each thread fills half a
// row (16 bytes) of the A tile (pixel lp) and of the B tile (channel lp).
__device__ __forceinline__ void load_chunk(const Operand& op, Tiles& t,
                                           int buf, int kt, int lp, int half,
                                           bool mvalid, int pb, int ph, int pw,
                                           int H, int W, int n0) {
  const int k0 = kt * BK;
  int8_t* dst_a = &t.a[buf][lp * ROW + half * 16];
  if (op.cin % BK == 0) {
    const int tap = k0 / op.cin;
    const int c0 = k0 - tap * op.cin;
    const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
    const bool ok = mvalid && hh >= 0 && hh < H && ww >= 0 && ww < W;
    const int8_t* src =
        ok ? op.x + ((static_cast<size_t>(pb) * H + hh) * W + ww) * op.cin +
                 c0 + half * 16
           : op.x;
    cp_async16(dst_a, src, ok ? 16 : 0);
  } else {
    const int K = 9 * op.cin;
    alignas(16) int8_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = k0 + half * 16 + j;
      int8_t val = 0;
      if (mvalid && k < K) {
        const int tap = k / op.cin;
        const int c = k - tap * op.cin;
        const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          val = op.x[((static_cast<size_t>(pb) * H + hh) * W + ww) * op.cin + c];
      }
      v[j] = val;
    }
    *reinterpret_cast<int4*>(dst_a) = *reinterpret_cast<const int4*>(v);
  }
  cp_async16(&t.b[buf][lp * ROW + half * 16],
             op.w + static_cast<size_t>(n0 + lp) * op.kp + k0 + half * 16, 16);
}

// The whole K loop of one operand into acc (64 x 32 of the tile per warp:
// 4 m16 x 4 n8 fragments).
__device__ __forceinline__ void gemm(const Operand& op, Tiles& t,
                                     int (&acc)[4][4][4], int lp, int half,
                                     bool mvalid, int pb, int ph, int pw, int H,
                                     int W, int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int nk = op.kp / BK;
  load_chunk(op, t, 0, 0, lp, half, mvalid, pb, ph, pw, H, W, n0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_chunk(op, t, buf ^ 1, kt + 1, lp, half, mvalid, pb, ph, pw, H, W,
                 n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* As = t.a[buf];
    const int8_t* Bs = t.b[buf];
    int b[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + g;
      b[ni][0] = ld32(&Bs[col * ROW + tg * 4]);
      b[ni][1] = ld32(&Bs[col * ROW + 16 + tg * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = wm * 64 + mi * 16 + g;
      int a[4];
      a[0] = ld32(&As[row * ROW + tg * 4]);
      a[1] = ld32(&As[(row + 8) * ROW + tg * 4]);
      a[2] = ld32(&As[row * ROW + 16 + tg * 4]);
      a[3] = ld32(&As[(row + 8) * ROW + 16 + tg * 4]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a, b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
    conv3x3_s8_kernel(Operand op0, Operand op1, int B, int H, int W, int cout,
                      const float* __restrict__ wscale,
                      const float* __restrict__ bias,
                      const float* __restrict__ shift,
                      const float* __restrict__ s0p,
                      const float* __restrict__ s1p,
                      const float* __restrict__ qmulp,
                      int8_t* __restrict__ out) {
  __shared__ __align__(16) Tiles tiles;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lp = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int m = m0 + lp;
  const bool mvalid = m < M;
  const int pw = mvalid ? m % W : 0;
  const int ph = mvalid ? (m / W) % H : 0;
  const int pb = mvalid ? m / (W * H) : 0;

  int acc0[4][4][4] = {};
  gemm(op0, tiles, acc0, lp, half, mvalid, pb, ph, pw, H, W, n0);
  int acc1[4][4][4] = {};  // the skip's sums; dead in the single form
  if constexpr (SPLIT)
    gemm(op1, tiles, acc1, lp, half, mvalid, pb, ph, pw, H, W, n0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const float s0 = *s0p, qmul = *qmulp;
  const float s1 = SPLIT ? *s1p : 0.0f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * 32 + ni * 8 + tg * 2 + j;
      if (n >= cout) continue;
      const float ws = wscale[n], bi = bias[n], sh = shift[n];
      const float mult = SPLIT ? ws : __fmul_rn(ws, s0);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + wm * 64 + mi * 16 + g + r * 8;
          if (row >= M) continue;
          const int e = r * 2 + j;
          float y;
          if constexpr (SPLIT) {
            const float sum =
                __fadd_rn(__fmul_rn(__int2float_rn(acc0[mi][ni][e]), s0),
                          __fmul_rn(__int2float_rn(acc1[mi][ni][e]), s1));
            y = __fadd_rn(__fmul_rn(sum, mult), bi);
          } else {
            y = __fadd_rn(__fmul_rn(__int2float_rn(acc0[mi][ni][e]), mult), bi);
          }
          y = __fadd_rn(fmaxf(y, 0.0f), sh);
          const float v = fminf(fmaxf(__fmul_rn(y, qmul), -127.0f), 127.0f);
          out[static_cast<size_t>(row) * cout + n] =
              static_cast<int8_t>(__float2int_rn(v));
        }
      }
    }
  }
}

}  // namespace generic

// ---------------------------------------------------------------------------
// Tensor-core form: warp-specialised wgmma on TMA-staged tiles.
//
// What bounds it: the tensor cores (15 TOP/s an SM) and, behind them, the L2
// bytes a tile's operands cost. Design:
// - A persistent kernel, one block an SM, walking output tiles; each block
//   is one producer warpgroup (one thread issues every TMA copy) and two
//   consumer warpgroups running wgmma.mma_async m64nNk32 s8 -> s32 with both
//   operands in shared memory. A ring of stages (as many as fit in shared
//   memory beside the staging tile, at most TC_MAX_STAGES) with a full and an
//   empty mbarrier each decouples the two.
// - A tile is a rectangle of output pixels in one frame: 2 * MW image rows
//   of 64 pixels (consumer warpgroup g owns rows g * MW ...), times BN
//   output channels. A stage is one tap (dy, dx) and 128 input channels:
//   the A box x[b, h0+dy-1 : +2MW, w0+dx-1 : +64, c0 : c0+128] by a 4-D
//   tiled TMA copy, whose out-of-image (and past-Cin) elements TMA fills
//   with zeros — SAME padding with no predicate — and the B box of the
//   packed (Np, Kp) weights at k = tap * Cin + c0, n0 (rows past Np are
//   zero-filled as well). Both are K-major in 128-byte rows with the
//   128-byte swizzle, the layout wgmma reads for 8-bit types; a stage is
//   four k32 steps. When Cin is not a multiple of 128 the last chunk of a
//   tap reads the next tap's weights against zero activations.
// - L2 bytes per operation: a 128 x 256 tile costs 48 KB a stage for 8.4
//   MOP (~11 TB/s from L2 at the full rate; without its epilogue the kernel
//   reaches ~2,000 TOP/s on such tiles, PERF.md, so L2 keeps up). Sharing
//   the B tile across a 2-block cluster by TMA multicast was measured
//   slower (PERF.md) and is not used.
// - Tile shapes by conv (the wrapper picks them): single with Cout > 128:
//   MW = 1, BN = 256 (128 accumulator registers a thread); single with Cout
//   <= 128: MW = 2, BN = 128 (two m64 subtiles a warpgroup); split: MW = 1,
//   BN = 128 with two accumulator sets of 64 registers, the up K loop then
//   the skip K loop, so the two sums stay apart until the epilogue.
// - Epilogue: registers -> the fused float32 epilogue -> int8 in a
//   swizzled shared staging tile (conflict-free 2-byte writes) -> 16-byte
//   coalesced stores of whole pixel rows. Meanwhile the producer is already
//   loading the next tile's stages, but the block's tensor cores wait: the
//   epilogue is what bounds the convs of small K. It runs on 8 warps, so
//   its per-channel parameters are loaded two column pairs ahead, and the
//   final rounding is an add on the FMA pipe (requant) instead of a
//   conversion; the int32 -> float32 conversion stays (sums reach 2^27).

constexpr int TC_MAX_STAGES = 8;  // shared stages in the ring, at most
constexpr int TC_SMEM = 232448;   // shared memory a block may take
constexpr int TC_KC = 128;        // K bytes a stage (one 128-byte swizzle span)
constexpr int TC_COLS = 64;       // pixels of one image row: one m64 subtile
constexpr int TC_THREADS = 384;   // consumer warpgroups 0, 1; producer 2

struct TcParams {
  int B, H, W, cout, cin0, cin1, tiles_w, tiles_h, tiles_n;
  const float* wscale;
  const float* bias;
  const float* shift;
  const float* s0p;
  const float* s1p;
  const float* qmulp;
  int8_t* out;
};

template <int MW, int BN>
struct TcShape {
  static constexpr int A_BYTES = 2 * MW * TC_COLS * TC_KC;
  static constexpr int B_BYTES = BN * TC_KC;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGING_BYTES = 2 * MW * TC_COLS * BN;
  // beside the staging tile, the barriers and up to 1 KB to align the
  // stages to the swizzle period: as many stages as fit
  static constexpr int FIT =
      (TC_SMEM - STAGING_BYTES - 1024) / (STAGE_BYTES + 16);
  static constexpr int STAGES = FIT < TC_MAX_STAGES ? FIT : TC_MAX_STAGES;
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + STAGING_BYTES + 16 * STAGES + 1024;
  static_assert(STAGES >= 2, "two stages at least");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete. A wait that outlasts 20 s (a
// lost TMA copy, a barrier miscounted) traps: the launch fails with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t spins = 0;
  uint64_t t0 = 0;
  while (!mbar_try_wait(a, parity)) {
    if ((++spins & 0xFFFF) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      if (t0 == 0)
        t0 = t;
      else if (t - t0 > 20000000000ull)
        __trap();
    }
  }
}

// One arrival of a consumer warp on the empty barrier of a stage.
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane) {
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart. A k32 step within the 128-byte row adds 32 bytes
// (2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (it sees only the asm's operands).
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define TC_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define TC_R16(i) TC_R4(i), TC_R4(i + 4), TC_R4(i + 8), TC_R4(i + 12)
#define TC_R64(i) TC_R16(i), TC_R16(i + 16), TC_R16(i + 32), TC_R16(i + 48)

// d (64 x 128 s32, the wgmma fragment) += A (64 x 32 s8) * B (32 x 128 s8)
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " %64, %65, p;\n}\n"
      : TC_R64(0)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256 s32) += A (64 x 32 s8) * B (32 x 256 s8)
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "
      "%94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : TC_R64(0), TC_R64(64)
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db);
  else
    wgmma_n128(d, da, db);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

struct Tile {
  int b, h0, w0, n0;
};

// Tile u: N tile fastest, then M tiles, which are (frame, row block,
// column block) with the column block fastest. The wrapper's
// _tc_tile_origin is the same arithmetic.
template <int MW, int BN>
__device__ __forceinline__ Tile tc_tile(int u, const TcParams& p) {
  const int nt = u % p.tiles_n;
  const int m = u / p.tiles_n;
  const int hw = p.tiles_h * p.tiles_w;
  const int b = m / hw, r = m - b * hw;
  const int ht = r / p.tiles_w;
  return {b, ht * 2 * MW, (r - ht * p.tiles_w) * TC_COLS, nt * BN};
}

// One operand's K loop into acc (MW m64 subtiles of this warpgroup). `it`
// counts stages over the block's whole run, as the producer does.
template <int MW, int BN>
__device__ __forceinline__ int tc_mainloop(int (&acc)[MW][BN / 2], int nk,
                                           int it, int wg, int lane,
                                           uint8_t* smem, uint64_t* full,
                                           uint64_t* empty) {
  using S = TcShape<MW, BN>;
#pragma unroll
  for (int i = 0; i < MW; ++i) fence_acc(acc[i]);
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb, ++it) {
    const int s = it % S::STAGES;
    mbar_wait(&full[s], (it / S::STAGES) & 1);
    const uint32_t a =
        smem_u32(smem + s * S::STAGE_BYTES) + wg * MW * TC_COLS * TC_KC;
    const uint64_t db = sw128_desc(smem_u32(smem + s * S::STAGE_BYTES +
                                            S::A_BYTES));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_KC / 32; ++kk) {
#pragma unroll
      for (int i = 0; i < MW; ++i)
        wgmma_s8<BN>(acc[i], sw128_desc(a + i * TC_COLS * TC_KC) + 2 * kk,
                     db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done with it
    if (prev >= 0) release_stage(&empty[prev], lane);
    prev = s;
  }
  wgmma_wait<0>();
  if (prev >= 0) release_stage(&empty[prev], lane);
#pragma unroll
  for (int i = 0; i < MW; ++i) fence_acc(acc[i]);
  return it;
}

// This warpgroup's MW x 64 pixels x BN channels: fused epilogue into the
// staging tile (16-byte chunk c of row r at chunk c ^ (r & 7)), then
// coalesced stores of whole pixel rows.
template <int MW, int BN, bool SPLIT>
__device__ __forceinline__ void tc_epilogue(const int (&acc)[MW][BN / 2],
                                            const int (&acc1)[BN / 2],
                                            const TcParams& p, const Tile& t,
                                            int wg, int tid, uint8_t* stg) {
  const int warp = tid >> 5, lane = tid & 31;
  const float s0 = *p.s0p, qmul = *p.qmulp;
  const float s1 = SPLIT ? *p.s1p : 0.0f;
  named_barrier_sync(1 + wg, 128);  // the last tile's stores have read stg
  // column pair j's (wscale, bias, shift), loaded two pairs ahead of its
  // use: with two warps a scheduler the loads' latency is not hidden
  // otherwise
  constexpr int PAIRS = BN / 8;
  float prm[3][6];
  auto load_pair = [&](int j, float (&q)[6]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = t.n0 + 8 * j + 2 * (lane & 3) + e;
      const bool ok = n < p.cout;
      q[e] = ok ? __ldg(p.wscale + n) : 0.0f;
      q[2 + e] = ok ? __ldg(p.bias + n) : 0.0f;
      q[4 + e] = ok ? __ldg(p.shift + n) : 0.0f;
    }
  };
  load_pair(0, prm[0]);
  load_pair(1, prm[1]);
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    if (j + 2 < PAIRS) load_pair(j + 2, prm[(j + 2) % 3]);
    const float(&q)[6] = prm[j % 3];
    const float mult[2] = {SPLIT ? q[0] : __fmul_rn(q[0], s0),
                           SPLIT ? q[1] : __fmul_rn(q[1], s0)};
    const float bis[2] = {q[2], q[3]}, shs[2] = {q[4], q[5]};
#pragma unroll
    for (int i = 0; i < MW; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = i * TC_COLS + warp * 16 + (lane >> 2) + 8 * r;
        uint32_t out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = acc[i][4 * j + 2 * r + e];
          const float y =
              SPLIT ? dequant2(v, acc1[4 * j + 2 * r + e], s0, s1, mult[e],
                               bis[e])
                    : dequant1(v, mult[e], bis[e]);
          out[e] = requant(y, shs[e], qmul);
        }
        *reinterpret_cast<uint16_t*>(
            stg + row * BN + ((((j >> 1) ^ (row & 7))) << 4) + ((j & 1) << 3) +
            2 * (lane & 3)) = pack2(out[0], out[1]);
      }
    }
  }
  named_barrier_sync(1 + wg, 128);
  constexpr int CHUNKS = BN / 16;
  const bool vec = (p.cout & 15) == 0;
  for (int idx = tid; idx < MW * TC_COLS * CHUNKS; idx += 128) {
    const int row = idx / CHUNKS, c = idx % CHUNKS;
    const int h = t.h0 + wg * MW + row / TC_COLS, w = t.w0 + row % TC_COLS;
    const int n = t.n0 + 16 * c;
    if (t.b >= p.B || h >= p.H || w >= p.W || n >= p.cout) continue;
    const uint8_t* src = stg + row * BN + ((c ^ (row & 7)) << 4);
    int8_t* dst = p.out + ((static_cast<size_t>(t.b) * p.H + h) * p.W + w) *
                              p.cout + n;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < 16 && n + e < p.cout; ++e)
        dst[e] = static_cast<int8_t>(src[e]);
    }
  }
}

template <int MW, int BN, bool SPLIT>
__global__ void __launch_bounds__(TC_THREADS, 1)
    conv3x3_s8_tc_kernel(const __grid_constant__ CUtensorMap mx0,
                         const __grid_constant__ CUtensorMap mw0,
                         const __grid_constant__ CUtensorMap mx1,
                         const __grid_constant__ CUtensorMap mw1,
                         const TcParams p) {
  using S = TcShape<MW, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* staging = smem + S::STAGES * S::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + S::STAGING_BYTES);
  uint64_t* empty = full + S::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int units = p.tiles_n * p.B * p.tiles_h * p.tiles_w;
  const int nk0 = 9 * ((p.cin0 + TC_KC - 1) / TC_KC);
  const int nk1 = SPLIT ? 9 * ((p.cin1 + TC_KC - 1) / TC_KC) : 0;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Tile t = tc_tile<MW, BN>(u, p);
        for (int op = 0; op < (SPLIT ? 2 : 1); ++op) {
          const CUtensorMap* mx = op ? &mx1 : &mx0;
          const CUtensorMap* mw = op ? &mw1 : &mw0;
          const int cin = op ? p.cin1 : p.cin0;
          for (int tap = 0; tap < 9; ++tap) {
            for (int c0 = 0; c0 < cin; c0 += TC_KC, ++it) {
              const int s = it % S::STAGES;
              mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);
              uint8_t* a = smem + s * S::STAGE_BYTES;
              uint8_t* b = a + S::A_BYTES;
              mbar_expect_tx(&full[s], S::STAGE_BYTES);
              tma_load_4d(a, mx, &full[s], c0, t.w0 + tap % 3 - 1,
                          t.h0 + tap / 3 - 1, t.b);
              tma_load_2d(b, mw, &full[s], tap * cin + c0, t.n0);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns image rows wg * MW ... of a tile ----
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
    uint8_t* stg = staging + wg * MW * TC_COLS * BN;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Tile t = tc_tile<MW, BN>(u, p);
      int acc[MW][BN / 2];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0;
      it = tc_mainloop<MW, BN>(acc, nk0, it, wg, lane, smem, full, empty);
      if constexpr (SPLIT) {
        int acc1[1][BN / 2];
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc1[0][e] = 0;
        it = tc_mainloop<1, BN>(acc1, nk1, it, wg, lane, smem, full, empty);
        tc_epilogue<MW, BN, true>(acc, acc1[0], p, t, wg, tid, stg);
      } else {
        tc_epilogue<MW, BN, false>(acc, acc[0], p, t, wg, tid, stg);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// First-conv form (Cin <= 7): the network's first conv, Cin = 2, K = 18.
//
// What bounds it: bytes — its int8 output (Cout bytes a pixel against Cin
// read) — and, close behind, the epilogue's ~11 float32 instructions an
// output value. Design: a block owns FC_ROWS x FC_COLS output pixels of one
// frame; it loads their (FC_ROWS + 2) x (FC_COLS + 2) x Cin halo once with
// coalesced byte loads, keeps the packed (Cout, Kp) weights in shared
// memory, builds each pixel's zero-padded K = Kp im2col row in shared
// memory (a thread a pixel) and runs mma.sync m16n8k32 on it: a warp owns
// 32 pixels of one image row and walks Cout in passes of 64 channels. The
// epilogue writes int8 pairs into the warp's staging rows (Cout + 16 bytes
// apart: conflict-free) and the warp stores its 32 contiguous pixels x Cout
// bytes with 16-byte stores.

constexpr int FC_ROWS = 4;        // image rows a block
constexpr int FC_COLS = 64;       // pixels a row
constexpr int FC_THREADS = 256;   // a thread a pixel while building im2col
constexpr int FC_BN = 64;         // output channels an mma pass
constexpr int FC_MAX_COUT = 256;  // output channels the form takes, at most
static_assert(FC_ROWS * FC_COLS == FC_THREADS, "a thread a pixel");
static_assert(FC_COLS % 32 == 0, "a warp owns 32 pixels of one row");

struct FcParams {
  const int8_t* x;
  const int8_t* w;
  int cin, B, H, W, cout;
  const float* wscale;
  const float* bias;
  const float* shift;
  const float* s0p;
  const float* qmulp;
  int8_t* out;
};

__host__ __device__ constexpr int fc_halo_bytes(int cin) {
  return ((FC_ROWS + 2) * (FC_COLS + 2) * cin + 15) & ~15;
}

// shared bytes: weights, im2col rows, halo, the warps' staging rows
__host__ __device__ constexpr int fc_smem_bytes(int ks, int cin, int cout) {
  return (cout + FC_THREADS) * (32 * ks + 16) + fc_halo_bytes(cin) +
         (FC_THREADS / 32) * 32 * (cout + 16);
}

template <int KS>  // Kp = 32 * KS
__global__ void __launch_bounds__(FC_THREADS)
    conv3x3_s8_first_kernel(const FcParams p) {
  constexpr int KP = 32 * KS, ROW = KP + 16, HC = FC_COLS + 2;
  extern __shared__ __align__(16) uint8_t fsm[];
  int8_t* wsm = reinterpret_cast<int8_t*>(fsm);          // cout x ROW
  int8_t* im = wsm + p.cout * ROW;                       // pixels x ROW
  int8_t* halo = im + FC_THREADS * ROW;                  // rows x HC x cin
  int8_t* stg = halo + fc_halo_bytes(p.cin);             // warps x 32 x ...
  const int b = blockIdx.z, h0 = blockIdx.y * FC_ROWS;
  const int w0 = blockIdx.x * FC_COLS, tid = threadIdx.x;

  for (int i = tid; i < p.cout * (KP / 16); i += FC_THREADS) {
    const int n = i / (KP / 16), c = i % (KP / 16);
    *reinterpret_cast<int4*>(wsm + n * ROW + 16 * c) =
        *reinterpret_cast<const int4*>(p.w + static_cast<size_t>(n) * KP +
                                       16 * c);
  }
  for (int i = tid; i < (FC_ROWS + 2) * HC * p.cin; i += FC_THREADS) {
    const int px = i / p.cin, c = i - px * p.cin;
    const int hh = h0 - 1 + px / HC, ww = w0 - 1 + px % HC;
    int8_t v = 0;
    if (hh >= 0 && hh < p.H && ww >= 0 && ww < p.W)
      v = p.x[((static_cast<size_t>(b) * p.H + hh) * p.W + ww) * p.cin + c];
    halo[i] = v;
  }
  __syncthreads();
  {  // this thread's pixel's im2col row, k = (dy * 3 + dx) * cin + c,
     // walking (dy, dx, c) along k without a division
    const int8_t* px = halo + ((tid / FC_COLS) * HC + tid % FC_COLS) * p.cin;
    const int K = 9 * p.cin;
    int dx = 0, c = 0, tap_off = 0;  // tap_off = (dy * HC + dx) * cin
#pragma unroll
    for (int k = 0; k < KP; k += 4) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k + e < K)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      px[tap_off + c])) << (8 * e);
        if (++c == p.cin) {
          c = 0;
          tap_off += dx == 2 ? (HC - 2) * p.cin : p.cin;
          dx = dx == 2 ? 0 : dx + 1;
        }
      }
      *reinterpret_cast<uint32_t*>(im + tid * ROW + k) = word;
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int srow = p.cout + 16;
  int8_t* wst = stg + warp * 32 * srow;
  const float s0 = *p.s0p, qmul = *p.qmulp;
  for (int n0 = 0; n0 < p.cout; n0 += FC_BN) {
    int acc[2][FC_BN / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      int bf[FC_BN / 8][2];
#pragma unroll
      for (int ni = 0; ni < FC_BN / 8; ++ni) {
        const int8_t* col = wsm + (n0 + ni * 8 + g) * ROW + ks * 32 + tg * 4;
        bf[ni][0] = ld32(col);
        bf[ni][1] = ld32(col + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* row = im + (warp * 32 + mi * 16 + g) * ROW + ks * 32 +
                            tg * 4;
        const int a[4] = {ld32(row), ld32(row + 8 * ROW), ld32(row + 16),
                          ld32(row + 8 * ROW + 16)};
#pragma unroll
        for (int ni = 0; ni < FC_BN / 8; ++ni)
          mma_s8(acc[mi][ni], a, bf[ni][0], bf[ni][1]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < FC_BN / 8; ++ni) {
      const int n = n0 + ni * 8 + tg * 2;  // < cout - 1: cout % 64 == 0
      const float2 ws = __ldg(reinterpret_cast<const float2*>(p.wscale + n));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(p.bias + n));
      const float2 sh = __ldg(reinterpret_cast<const float2*>(p.shift + n));
      const float mult[2] = {__fmul_rn(ws.x, s0), __fmul_rn(ws.y, s0)};
      const float bis[2] = {bi.x, bi.y}, shs[2] = {sh.x, sh.y};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)  // |acc| <= 64 * 128^2 < 2^22
            q[e] = requant(__fadd_rn(__fmul_rn(small_int2float(
                                         acc[mi][ni][2 * r + e]), mult[e]),
                                     bis[e]),
                           shs[e], qmul);
          *reinterpret_cast<uint16_t*>(wst + (mi * 16 + g + 8 * r) * srow +
                                       n) = pack2(q[0], q[1]);
        }
      }
    }
  }
  __syncwarp();
  // the warp's 32 pixels are contiguous in the image row: cout bytes each
  const int chunks = p.cout / 16;
  const int h = h0 + warp / (FC_COLS / 32);
  const int wbase = w0 + (warp % (FC_COLS / 32)) * 32;
  if (h >= p.H) return;
  for (int i = lane; i < 32 * chunks; i += 32) {
    const int px = i / chunks, c = i - px * chunks;
    if (wbase + px >= p.W) continue;
    *reinterpret_cast<int4*>(
        p.out + ((static_cast<size_t>(b) * p.H + h) * p.W + wbase + px) *
                    p.cout + 16 * c) =
        *reinterpret_cast<const int4*>(wst + px * srow + 16 * c);
  }
}

// ---------------------------------------------------------------------------
// Host side.

enum { FORM_GENERIC = 0, FORM_TENSOR_CORE = 1, FORM_FIRST_CONV = 2 };
// Error codes beside cudaError_t's (kernel_error_string names them).
enum { ERR_NO_ENCODE = 10001, ERR_ENCODE = 10002, ERR_CONFIG = 10003 };

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver entry point: reached through the
// runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

int make_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// (B, H, W, cin) int8 activations: boxes of 128 channels x 64 columns x rows
int activation_map(CUtensorMap* map, const void* x, int cin, int B, int H,
                   int W, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cin),
                                 static_cast<cuuint64_t>(W) * cin,
                                 static_cast<cuuint64_t>(H) * W * cin};
  const cuuint32_t box[4] = {TC_KC, TC_COLS, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, x, 4, dims, strides, box);
}

// (np, kp) packed weights: boxes of 128 k x rows output channels
int weight_map(CUtensorMap* map, const void* w, int kp, int np, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(np)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {TC_KC, static_cast<cuuint32_t>(rows)};
  return make_map(map, w, 2, dims, strides, box);
}

template <int MW, int BN, bool SPLIT>
int launch_tc(const CUtensorMap& mx0, const CUtensorMap& mw0,
              const CUtensorMap& mx1, const CUtensorMap& mw1,
              const TcParams& p, cudaStream_t stream) {
  using S = TcShape<MW, BN>;
  auto kernel = conv3x3_s8_tc_kernel<MW, BN, SPLIT>;
  static std::atomic<int> resident[MAX_CARDS];  // blocks a card holds at once
  const int dev = current_card();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, TC_THREADS,
                                                      S::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (sms * per <= 0) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per;
  }
  const int held = resident[dev];
  const int units = p.tiles_n * p.B * p.tiles_h * p.tiles_w;
  const int grid = units < held ? units : held;
  kernel<<<grid, TC_THREADS, S::SMEM_BYTES, stream>>>(mx0, mw0, mx1, mw1, p);
  return cudaGetLastError();
}

template <int KS>
int launch_first(const FcParams& p, cudaStream_t stream) {
  auto kernel = conv3x3_s8_first_kernel<KS>;
  const int smem = fc_smem_bytes(KS, p.cin, p.cout);
  // above 48 KB only after this: once a card, at the largest shape the
  // form takes (Kp = 32 * KS holds 9 * cin), so the size never goes down
  static std::atomic<bool> opted_in[MAX_CARDS];
  const int dev = current_card();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const int most = fc_smem_bytes(KS, 32 * KS / 9, FC_MAX_COUT);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    opted_in[dev] = true;
  }
  const dim3 grid((p.W + FC_COLS - 1) / FC_COLS, (p.H + FC_ROWS - 1) / FC_ROWS,
                  p.B);
  kernel<<<grid, FC_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// form: 0 generic, 1 tensor core, 2 first conv (ops/conv_s8_cuda.py:
// conv_s8_form). x0 / w0 / cin0 / kp0: the (first) input and its packed
// weights; x1 == NULL is the single form, else the split form's skip input.
// np (the packed rows) is Cout rounded up to 128; kp a multiple of 32 >= 9 *
// cin. mw, bn, tiles_*: the tensor-core form's tile (2 * mw rows x 64
// pixels x bn channels) and tile counts, from the wrapper. wscale, bias,
// shift: Cout float32 on the card; s0, s1, qmul: float32 scalars on the card.
int conv3x3_s8(int form, const void* x0, const void* w0, int cin0, int kp0,
               const void* x1, const void* w1, int cin1, int kp1, int B, int H,
               int W, int cout, int np, int mw, int bn, int tiles_w,
               int tiles_h, int tiles_n, const void* wscale, const void* bias,
               const void* shift, const void* s0, const void* s1,
               const void* qmul, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ws = static_cast<const float*>(wscale);
  const float* bi = static_cast<const float*>(bias);
  const float* sh = static_cast<const float*>(shift);
  const float* p0 = static_cast<const float*>(s0);
  const float* p1 = static_cast<const float*>(s1);
  const float* pq = static_cast<const float*>(qmul);
  int8_t* o = static_cast<int8_t*>(out);
  const bool split = x1 != nullptr;
  if (form == FORM_TENSOR_CORE) {
    CUtensorMap mx0, mw0, mx1, mw1;
    int rc = activation_map(&mx0, x0, cin0, B, H, W, 2 * mw);
    if (rc == 0) rc = weight_map(&mw0, w0, kp0, np, bn);
    if (rc == 0 && split) rc = activation_map(&mx1, x1, cin1, B, H, W, 2 * mw);
    if (rc == 0 && split) rc = weight_map(&mw1, w1, kp1, np, bn);
    if (rc != 0) return rc;
    if (!split) {
      mx1 = mx0;
      mw1 = mw0;
    }
    const TcParams p{B,  H,  W,  cout, cin0, cin1, tiles_w, tiles_h, tiles_n,
                     ws, bi, sh, p0,   p1,   pq,   o};
    if (split && mw == 1 && bn == 128)
      return launch_tc<1, 128, true>(mx0, mw0, mx1, mw1, p, s);
    if (!split && mw == 1 && bn == 256)
      return launch_tc<1, 256, false>(mx0, mw0, mx1, mw1, p, s);
    if (!split && mw == 2 && bn == 128)
      return launch_tc<2, 128, false>(mx0, mw0, mx1, mw1, p, s);
    return ERR_CONFIG;
  }
  if (form == FORM_FIRST_CONV) {
    if (split || cout % FC_BN != 0 || cout > FC_MAX_COUT ||
        (kp0 != 32 && kp0 != 64) || 9 * cin0 > kp0)
      return ERR_CONFIG;
    const FcParams p{static_cast<const int8_t*>(x0),
                     static_cast<const int8_t*>(w0),
                     cin0, B, H, W, cout, ws, bi, sh, p0, pq, o};
    return kp0 == 32 ? launch_first<1>(p, s) : launch_first<2>(p, s);
  }
  if (form != FORM_GENERIC) return ERR_CONFIG;
  generic::Operand op0{static_cast<const int8_t*>(x0),
                       static_cast<const int8_t*>(w0), cin0, kp0};
  generic::Operand op1{static_cast<const int8_t*>(x1),
                       static_cast<const int8_t*>(w1), cin1, kp1};
  const long long M = static_cast<long long>(B) * H * W;
  dim3 grid(static_cast<unsigned>((M + generic::BM - 1) / generic::BM),
            np / generic::BN);
  if (!split)
    generic::conv3x3_s8_kernel<false><<<grid, generic::THREADS, 0, s>>>(
        op0, op1, B, H, W, cout, ws, bi, sh, p0, p1, pq, o);
  else
    generic::conv3x3_s8_kernel<true><<<grid, generic::THREADS, 0, s>>>(
        op0, op1, B, H, W, cout, ws, bi, sh, p0, p1, pq, o);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled not found through the runtime";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_CONFIG:
      return "conv3x3_s8: no kernel for this form and tile";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
