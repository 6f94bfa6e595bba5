// The tracker's forward auction (core/tracking.py:auction_assignment): every
// round of one frame's auction in one launch of one block.
//
// Replaces no TPU kernel: the JAX package runs the rounds as a
// lax.while_loop (core/tracking.py:auction_assignment), which XLA keeps on
// the TPU; the port's plain version (_rounds_plain) is a Python loop that
// reads a flag and three boolean-mask indexings back each round. This
// source runs the same rounds with no host read and no launch between
// them.
//
// Function. Persons m < M each hold C candidates, the benefits b (M, C)
// (descending, -inf = none) and the objects cand (M, C) that the candidate
// pruning chose; objects k < K start at price 0 and no owner; eps is a
// float32 on the card. Round r (1 <= r <= max_rounds):
//   cur_eps = eps * exp2f(min(evictions, 10))  (PyTorch's float32 exp2)
//   vals = b - price[cand]; v1 / j1 = the max and its first index;
//   v2 = the max of the other candidates (-inf if none);
//   a person bids if it is in the mask, holds no object and v1 >= 0;
//   no bidder: the auction ends, this round counted;
//   bid = price[cand[j1]] + ((v1 - max(v2, 0)) + cur_eps);
//   each object bid on goes to its highest bid, ties to the lowest person;
//   its previous owner loses it (object -1, one more eviction), the winner
//   takes it and its price becomes the winning bid.
// Every float32 operation is rounded on its own (__fsub_rn / __fadd_rn /
// __fmul_rn, no contraction), so the ids are the plain loop's bit for bit.
// Bids are never NaN (benefits are finite or -inf, prices finite); a bid's
// order key is its float order (sign-folded bits) above 32 bits and the
// person's complement below, so one 64-bit atomicMax picks the winner.
//
// Bound on an H100: a round reads, for each active person, C benefits,
// indices and prices (C x 12 B; 4096-8192 persons x 8 x 12 B = 0.4-0.8 MB
// at most, from L2 after the first round): a few microseconds of memory
// traffic a round. A frame's 23-48 rounds are sequential, so the rounds'
// two block barriers and the dependent loads bound it, not the bytes.
//
// Design. One block of 1024 threads an auction (a frame's auction needs the
// previous frame's state, so frames cannot run side by side). A thread
// works persons p, p + 1024, ...; the per-object state (packed best bid 8
// B, price 4 B, owner 4 B), the list of objects bid on this round and the
// per-person state (object, evictions) live in shared memory while they fit
// (K = 8192 with M = 4096: 176 KB of the 227 KB), else in a device-memory
// workspace that stays in L2 (K = 16384 with M = 8192: 352 KB). A round is
// two phases and two barriers:
//   bid: each active person computes its bid and atomicMax-es its key into
//     its object's best; the first bidder of an object (the atomic's old
//     value is empty) appends the object to the round's list;
//     __syncthreads_or of "some person bid" ends the auction when false;
//   resolve: a thread an object of the list exchanges its best for empty,
//     evicts the owner, records the winner and sets the price. Each object
//     has one resolver and each person at most one object, so nothing
//     races. The list's counter alternates between two slots, the next
//     round's zeroed here.
// The kernel writes the round count to a device slot; the wrapper reads
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_CARDS = 64;
constexpr int THREADS = 1024;
constexpr int EPS_CAP = 10;          // cur_eps stops doubling after 10
constexpr unsigned long long EMPTY = 0ull;  // below every bid's key

inline int current_card() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS)
    return -1;
  return dev;
}

struct Args {
  const float* b;            // (M, C)
  const long long* cand;     // (M, C)
  const uint8_t* person;     // (M,) person mask
  const float* eps;          // ()
  long long* person_obj;     // (M,) out: object a person, -1 none
  int* rounds;               // () out
  int M, K, C, max_rounds;
};

// Bytes of the state: best, price, owner a object; the round's list (at
// most min(M, K) objects); object and evictions a person.
long long state_bytes(int M, int K) {
  const long long L = M < K ? M : K;
  return 16LL * K + 4LL * L + 8LL * M;
}

// float order as unsigned order (no NaN): positives above negatives
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
    auction_kernel(Args a, unsigned long long* ws) {
  extern __shared__ __align__(16) unsigned long long smem[];
  __shared__ int s_count[2];
  const int M = a.M, K = a.K, C = a.C;
  const int L = M < K ? M : K;
  unsigned long long* best = kShared ? smem : ws;
  float* price = reinterpret_cast<float*>(best + K);
  int* owner = reinterpret_cast<int*>(price + K);
  int* list = owner + K;
  int* pobj = list + L;
  int* evictions = pobj + M;
  const int tid = threadIdx.x;

  for (int k = tid; k < K; k += THREADS) {
    best[k] = EMPTY;
    price[k] = 0.f;
    owner[k] = -1;
  }
  for (int p = tid; p < M; p += THREADS) {
    pobj[p] = -1;
    evictions[p] = 0;
  }
  if (tid < 2) s_count[tid] = 0;
  const float eps = *a.eps;
  __syncthreads();

  int rounds = 0;
  for (int r = 1; r <= a.max_rounds; ++r) {
    rounds = r;
    int* count = &s_count[r & 1];
    int bid_any = 0;
    for (int p = tid; p < M; p += THREADS) {
      if (!a.person[p] || pobj[p] >= 0) continue;
      const float* bp = a.b + (long long)p * C;
      const long long* cp = a.cand + (long long)p * C;
      float v1 = __fsub_rn(bp[0], price[(int)cp[0]]);
      float v2 = __uint_as_float(0xff800000u);  // -inf
      int j1 = 0;
      for (int c = 1; c < C; ++c) {
        const float v = __fsub_rn(bp[c], price[(int)cp[c]]);
        if (v > v1) {
          v2 = v1;
          v1 = v;
          j1 = c;
        } else if (v > v2) {
          v2 = v;
        }
      }
      if (!(v1 >= 0.f)) continue;
      bid_any = 1;
      const int obj = (int)cp[j1];
      const int e = evictions[p] < EPS_CAP ? evictions[p] : EPS_CAP;
      const float cur_eps = __fmul_rn(eps, exp2f((float)e));
      const float incr = __fadd_rn(__fsub_rn(v1, fmaxf(v2, 0.f)), cur_eps);
      const float bid = __fadd_rn(price[obj], incr);
      const unsigned long long key =
          ((unsigned long long)order_bits(bid) << 32) | (unsigned)~p;
      if (atomicMax(&best[obj], key) == EMPTY)
        list[atomicAdd(count, 1)] = obj;
    }
    if (!__syncthreads_or(bid_any)) break;
    const int n = *count;
    for (int i = tid; i < n; i += THREADS) {
      const int obj = list[i];
      const unsigned long long key = atomicExch(&best[obj], EMPTY);
      const int winner = (int)~(unsigned)(key & 0xffffffffull);
      const int q = owner[obj];
      if (q >= 0) {
        pobj[q] = -1;
        evictions[q] += 1;
      }
      owner[obj] = winner;
      pobj[winner] = obj;
      price[obj] = from_order_bits((unsigned)(key >> 32));
    }
    if (tid == 0) s_count[(r + 1) & 1] = 0;
    __syncthreads();
  }
  for (int p = tid; p < M; p += THREADS) a.person_obj[p] = pobj[p];
  if (tid == 0) *a.rounds = rounds;
}

}  // namespace

extern "C" {

// The most state bytes (state_bytes) the kernel can hold in shared memory
// on the calling thread's card (0 if it cannot tell).
int auction_shared_limit() {
  const int dev = current_card();
  int most = 0;
  if (dev < 0 ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return most - 16;  // the two list counters, aligned
}

// One auction. b: (M, C) float32; cand: (M, C) int64 in [0, K); person:
// (M,) bytes; eps: one float32; person_obj: (M,) int64 out; rounds: one
// int32 out; ws: null for the shared form, else state_bytes(M, K) bytes.
int auction_solve(const float* b, const long long* cand,
                  const uint8_t* person, const float* eps, int M, int K,
                  int C, int max_rounds, long long* person_obj, int* rounds,
                  void* ws, void* stream) {
  if (M < 0 || K < 1 || C < 1 || C > K || max_rounds < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{b, cand, person, eps, person_obj, rounds, M, K, C, max_rounds};
  cudaStream_t s = (cudaStream_t)stream;
  if (ws != nullptr) {
    auction_kernel<false><<<1, THREADS, 0, s>>>(
        a, (unsigned long long*)ws);
    return (int)cudaGetLastError();
  }
  const long long bytes = state_bytes(M, K);
  static std::atomic<long long> opted[MAX_CARDS];
  const int dev = current_card();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (opted[dev].load() < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        auction_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted[dev].store(bytes);
  }
  auction_kernel<true><<<1, THREADS, (size_t)bytes, s>>>(a, nullptr);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
