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
// Design (the first, simple form; tensor-memory / TMA is later work): an
// implicit GEMM, M = B * H * W pixels, N = Cout, K = 9 * Cin (tap-major, k =
// (dy * 3 + dx) * Cin + c), on mma.sync m16n8k32 s8 -> s32. A block owns 128
// pixels x 128 output channels and walks K in chunks of 32 through a double
// buffer in shared memory (cp.async, zero-filled outside the image); its 8
// warps each own 64 x 32 of the tile. When Cin is a multiple of 32 a chunk
// lies inside one tap and a thread fetches its pixel's 16 channels with one
// 16-byte copy; otherwise (the first conv, Cin = 2) a thread gathers its 16
// (tap, channel) bytes one at a time, predicated on the image edge and on k
// < 9 * Cin. The weights are packed by the wrapper as (Cout rounded up to
// 128, K rounded up to 32) int8, zero-padded, k contiguous for each output
// channel (the col-major B operand of the mma). Shared rows are 48 bytes
// apart, so the fragment loads of a warp hit 32 different banks.
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
// rint rounds half to even, as jnp.round and torch.round do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// x0 / w0 / cin0 / kp0: the (first) input and its packed weights; x1 == NULL
// is the single form, else the split form's skip input. Np (the packed rows)
// is Cout rounded up to 128; kp a multiple of 32 >= 9 * cin. wscale, bias,
// shift: Cout float32 on the card; s0, s1, qmul: float32 scalars on the card.
int conv3x3_s8(const void* x0, const void* w0, int cin0, int kp0,
               const void* x1, const void* w1, int cin1, int kp1, int B, int H,
               int W, int cout, int np, const void* wscale, const void* bias,
               const void* shift, const void* s0, const void* s1,
               const void* qmul, void* out, void* stream) {
  Operand op0{static_cast<const int8_t*>(x0), static_cast<const int8_t*>(w0),
              cin0, kp0};
  Operand op1{static_cast<const int8_t*>(x1), static_cast<const int8_t*>(w1),
              cin1, kp1};
  const long long M = static_cast<long long>(B) * H * W;
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), np / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ws = static_cast<const float*>(wscale);
  const float* bi = static_cast<const float*>(bias);
  const float* sh = static_cast<const float*>(shift);
  const float* p0 = static_cast<const float*>(s0);
  const float* p1 = static_cast<const float*>(s1);
  const float* pq = static_cast<const float*>(qmul);
  int8_t* o = static_cast<int8_t*>(out);
  if (x1 == nullptr)
    conv3x3_s8_kernel<false><<<grid, THREADS, 0, s>>>(op0, op1, B, H, W, cout,
                                                      ws, bi, sh, p0, p1, pq, o);
  else
    conv3x3_s8_kernel<true><<<grid, THREADS, 0, s>>>(op0, op1, B, H, W, cout,
                                                     ws, bi, sh, p0, p1, pq, o);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
