// The categorical pick of the LM engine for NVIDIA Hopper (sm_90a): for
// each row b of logits [B, V], the first index of the maximum of
// logits / T + gumbel(key, [B, V], dtype), the noise of element (b, v)
// drawn at flat index b * V + v.
//
// Replaces no TPU kernel: the JAX engine picks a categorical token with
// jax.random.categorical(sub, logits / T) (src/repro/serve/engine.py:60),
// which XLA runs as its threefry, -log(-log(u)), an add and an argmax.
// This kernel gives the same index, with the reference's roundings:
//   - bfloat16: logits / T rounded to bfloat16 (T, a Python float, is
//     rounded to bfloat16 first: a weak type); the noise
//     -bf16(log(-bf16(log(u)))) of 8-bit uniforms (threefry.cuh); the sum
//     rounded to bfloat16;
//   - float32: the quotient and the sum in float32; the noise from 23-bit
//     uniforms;
//   - ties go to the first index (argmax's), a NaN above every number,
//     -0 equal to +0.
//
// What bounds it on this card: operations.  A logit costs about 78 int32
// operations (the threefry hash of its flat index among them) against 2
// or 4 bytes read.  An SM runs them on two pipes of 64 lanes: the INT32
// pipe (rotates, xors, compares) and the FMA pipe, where ptxas puts the
// hash's adds (IMAD).  At a decode batch (B = 8, 393,216 logits) that is
// ~1 us over all 132 SMs, so the design fills every SM and keeps the
// fixed costs around the hashes short:
//   - The grid is (splits, B): each row is split over `splits` blocks of
//     256 threads, from kernel.pick_plan, which sizes the grid by the SM
//     count so that every SM holds a block (two at B = 8), with at least
//     1,024 logits a block.  Block i of a row takes the logits from
//     floor(i V / splits) to floor((i + 1) V / splits), each rounded down
//     to a multiple of kGroup (pick_bound).
//   - A thread takes kGroup = 4 consecutive logits a pass (one 8-byte load
//     of bf16, one 16-byte load of f32) and runs their 4 hash chains side
//     by side.  A block's range never crosses a multiple of 2^32 in the
//     flat index but in an instance of its own, so the count's high word
//     stays out of the loop.  Logits before the row's first aligned group,
//     or after its last, are taken one a thread.
//   - The division by T is the float64 product with 1 / T, rounded once
//     to float32: the same quotient as __fdiv_rn, without its per-logit
//     branch and slow path (quotient(); temperatures the argument leaves
//     out divide).
//   - bfloat16 noise takes 128 values, built once a device with this
//     file's gumbel_bf16 (da4ml_gumbel_noise_table, the wrapper's buffer);
//     each block copies the 512 bytes into shared memory while it hashes
//     its first group.
//   - A score becomes an unsigned key in argmax's order (order_key) and a
//     64-bit (key, ~index): the max of such words is argmax's pick, in any
//     order of combining.  A block reduces them by two warp reductions
//     (redux.sync, the high half then the low); then its thread 0 takes
//     the atomicMax of the row's word in the scratch and draws a ticket by
//     an acquire-release add, and the row's last block reads the word,
//     writes the index and leaves the word and the ticket zero again.  The
//     scratch ([B][2] 64-bit words, zero) comes from the wrapper: one a
//     stream, and one a CUDA-graph capture, which the wrapper holds until
//     that graph is destroyed (da4ml_capture_watch).  One launch a pick.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using da4ml_prng::gumbel_bf16;
using da4ml_prng::gumbel_bf16_mantissa;
using da4ml_prng::gumbel_f32;
using da4ml_prng::round_bf16;
using da4ml_prng::threefry_bits;

constexpr int kThreads = 256;    // kernel.PICK_THREADS
constexpr int kBlocksPerSM = 2;  // kernel.PICK_BLOCKS_PER_SM: the residency the build asks for
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;    // logits a thread takes a pass (kernel.PICK_GROUP)
constexpr int kNoise = 128;  // bfloat16 noise values

struct Pick {
  const char* logits;
  long long row_stride;  // bytes
  int V;
  int splits;  // blocks a row
  uint32_t k0, k1;
  float temperature;
  double rcp;       // 1 / temperature rounded to float64
  int exact_div;    // 1: every quotient by __fdiv_rn (a temperature the float64 product may miss)
  const float* noise;            // bfloat16: the 128 noise values
  unsigned long long* scratch;   // [B][2]: each row's best word and its ticket, zero
  long long* out;
};

// where block i of a row starts (i = splits: V): floor(i V / splits)
// rounded down to a multiple of kGroup (kernel.pick_bounds), in 32 bits
// where i V fits
__device__ __forceinline__ int pick_bound(int i, int V, int splits) {
  if (i >= splits) return V;
  const unsigned long long p = static_cast<unsigned long long>(i) * static_cast<unsigned>(V);
  const unsigned long long q = p >> 32 ? p / static_cast<unsigned>(splits)
                                       : static_cast<uint32_t>(p) / static_cast<uint32_t>(splits);
  return static_cast<int>(q & ~static_cast<unsigned long long>(kGroup - 1));
}

// a score's place in argmax's order as an unsigned integer: every NaN
// above every number and equal to the others, -0 equal to +0, else the
// order of the floats
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 + 0 = +0
  const uint32_t k = u ^ (static_cast<uint32_t>(static_cast<int32_t>(u) >> 31) | 0x80000000u);
  return isnan(s) ? 0xFFFFFFFFu : k;
}

// (key, v) as one word: a larger key first, then the lower index
__device__ __forceinline__ unsigned long long pack(uint32_t key, uint32_t v) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(~v);
}

// *p += v at device scope, returning the old value, with release and
// acquire semantics: this thread's earlier writes (its atomicMax) are seen
// by whoever reads the new value, and what they wrote before theirs is
// seen by this thread's later reads
__device__ __forceinline__ unsigned long long atom_add_acq_rel(unsigned long long* p,
                                                             unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

// the largest 64-bit word of the warp, in every lane: the largest high
// half, then the largest low half among the lanes that hold it
__device__ __forceinline__ unsigned long long warp_max64(unsigned long long w) {
  const uint32_t hi = static_cast<uint32_t>(w >> 32);
  const uint32_t top = __reduce_max_sync(0xFFFFFFFFu, hi);
  const uint32_t lo = __reduce_max_sync(0xFFFFFFFFu, hi == top ? static_cast<uint32_t>(w) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

__device__ __forceinline__ unsigned long long max64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// x / t rounded to float32, as __fdiv_rn(x, t).  EXACT: by __fdiv_rn.
// Else the float64 product x * rcp (rcp = 1 / t rounded to float64) is
// within 2^-51.9 of x / t (relative), while a quotient of two float32
// lies at least 2^-49 from every float32 rounding boundary when it is a
// normal number, and, in the subnormal range, unless t = odd * 2^a with
// an odd factor above 1 and a >= 1, where a quotient can lie on a midpoint
// (those t divide: kernel.exact_division, passed as exact_div): so the
// product rounds to the same float32, with no branch and no special case
// (zeros, infinities and NaNs alike).
template <bool EXACT>
__device__ __forceinline__ float quotient(float x, float t, double rcp) {
  if constexpr (EXACT) {
    return __fdiv_rn(x, t);
  } else {
    return __double2float_rn(static_cast<double>(x) * rcp);
  }
}

template <bool BF16, bool EXACT>
__device__ __forceinline__ float score(float x, uint32_t bits, const Pick& a, const float* noise) {
  if constexpr (BF16) {
    const float scaled = round_bf16(quotient<EXACT>(x, a.temperature, a.rcp));
    return round_bf16(__fadd_rn(scaled, noise[gumbel_bf16_mantissa(bits)]));
  } else {
    return __fadd_rn(quotient<EXACT>(x, a.temperature, a.rcp), gumbel_f32(bits));
  }
}

template <bool BF16>
__device__ __forceinline__ float logit_at(const char* row, int v) {
  if constexpr (BF16) {
    const uint16_t h = __ldg(reinterpret_cast<const unsigned short*>(row) + v);
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  } else {
    return __ldg(reinterpret_cast<const float*>(row) + v);
  }
}

// kGroup logits from row[v0] on, aligned to their size or to 16 bytes
template <bool BF16>
__device__ __forceinline__ void load_group(const char* row, int v0, float (&x)[kGroup]) {
  constexpr int kWords = kGroup * (BF16 ? 2 : 4) / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords % 4 == 0, "a group is 4, 8 or 16k bytes");
  const char* p = row + (BF16 ? 2ll : 4ll) * v0;
  uint32_t w[kWords];
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = q.x;
    w[1] = q.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (BF16) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      x[i] = __uint_as_float(w[i]);
    }
  }
}

// The block's best word over logits [lo, hi) of its row.  The flat index
// of logit v is (hi_word, lo_word + v).  GENERAL: the low word may wrap at
// v_wrap (a multiple of 2^32 lies in the block's range), where the high
// word steps, and the quotients are __fdiv_rn's; else the high word is
// constant and the quotients come from the float64 product.
template <bool BF16, bool GENERAL>
__device__ __forceinline__ unsigned long long scan(const Pick& a, const char* row, int lo, int hi,
                                                   uint32_t hi_word, uint32_t lo_word,
                                                   long long v_wrap, float* noise) {
  constexpr int kElem = BF16 ? 2 : 4;
  const auto bits_at = [&](int v) {
    uint32_t x0 = hi_word;
    if constexpr (GENERAL) x0 += static_cast<uint32_t>(v >= v_wrap);
    return threefry_bits(a.k0, a.k1, x0, lo_word + static_cast<uint32_t>(v));
  };
  // the logits before the first boundary of a group's size (at most 16
  // bytes) in [lo, hi), the groups, and the logits after the last group
  constexpr unsigned kAlign = kGroup * kElem < 16 ? kGroup * kElem : 16;
  const auto addr = reinterpret_cast<uintptr_t>(row + static_cast<long long>(lo) * kElem);
  const int head = min(hi - lo, static_cast<int>(((kAlign - (addr & (kAlign - 1))) & (kAlign - 1)) / kElem));
  const int body = lo + head;
  const int n_groups = (hi - body) / kGroup;
  const int tail = body + n_groups * kGroup;

  float table = 0.0f;
  if (BF16 && threadIdx.x < kNoise) table = __ldg(a.noise + threadIdx.x);

  // each thread visits its logits in increasing order: a strictly larger
  // key replaces the best, so ties keep the lower index
  uint32_t best_k = 0u, best_v = 0xFFFFFFFFu;
  float x[kGroup];
  uint32_t bits[kGroup];
  const auto hash_group = [&](int g) {
    const int v0 = body + g * kGroup;
    load_group<BF16>(row, v0, x);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) bits[j] = bits_at(v0 + j);
  };
  const auto take_group = [&](int g) {
    const int v0 = body + g * kGroup;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const uint32_t k = order_key(score<BF16, GENERAL>(x[j], bits[j], a, noise));
      if (k > best_k) {
        best_k = k;
        best_v = static_cast<uint32_t>(v0 + j);
      }
    }
  };
  // the first group is hashed while the noise table arrives
  int g = static_cast<int>(threadIdx.x);
  if (g < n_groups) hash_group(g);
  if constexpr (BF16) {
    if (threadIdx.x < kNoise) noise[threadIdx.x] = table;
    __syncthreads();
  }
  if (g < n_groups) take_group(g);
  for (g += kThreads; g < n_groups; g += kThreads) {
    hash_group(g);
    take_group(g);
  }
  unsigned long long best = pack(best_k, best_v);
  // the edges, one logit a thread
  const auto one = [&](int v) {
    const float s = score<BF16, GENERAL>(logit_at<BF16>(row, v), bits_at(v), a, noise);
    return pack(order_key(s), static_cast<uint32_t>(v));
  };
  if (static_cast<int>(threadIdx.x) < head) best = max64(best, one(lo + threadIdx.x));
  if (static_cast<int>(threadIdx.x) < hi - tail) best = max64(best, one(tail + threadIdx.x));
  return best;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) gumbel_pick_kernel(const Pick a) {
  __shared__ float noise[BF16 ? kNoise : 1];
  __shared__ unsigned long long warp_best[kWarps];
  const int row = blockIdx.y;
  const int lo = pick_bound(blockIdx.x, a.V, a.splits);
  const int hi = pick_bound(blockIdx.x + 1, a.V, a.splits);
  const char* row_p = a.logits + row * a.row_stride;
  // the flat index of logit v is base + v: its high word at lo, and where
  // the low word wraps if it does in [lo, hi) (a row spans < 2^31)
  const unsigned long long base = static_cast<unsigned long long>(row) * static_cast<unsigned>(a.V);
  const uint32_t hi_word = static_cast<uint32_t>((base + lo) >> 32);
  const uint32_t lo_word = static_cast<uint32_t>(base);
  const bool wraps = hi_word != static_cast<uint32_t>((base + hi - 1) >> 32);
  const long long v_wrap = wraps ? (1ll << 32) - lo_word : 1ll << 40;
  unsigned long long best =
      wraps || a.exact_div ? scan<BF16, true>(a, row_p, lo, hi, hi_word, lo_word, v_wrap, noise)
                           : scan<BF16, false>(a, row_p, lo, hi, hi_word, lo_word, v_wrap, noise);
  // the block's best: within each warp, then across the warps
  best = warp_max64(best);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp != 0) return;
  best = warp_max64(lane < kWarps ? warp_best[lane] : 0ull);
  if (lane != 0) return;
  if (a.splits == 1) {
    a.out[row] = static_cast<uint32_t>(~best);
    return;
  }
  // the row's best over its blocks: the last block to draw a ticket reads
  // it, writes the index and leaves the scratch zero.  The ticket's
  // release orders this block's max before it; in the last block its
  // acquire orders every other block's max before the read.
  unsigned long long* word = a.scratch + 2 * row;
  unsigned long long* ticket = word + 1;
  atomicMax(word, best);
  if (atom_add_acq_rel(ticket, 1ull) == static_cast<unsigned long long>(a.splits - 1)) {
    best = atomicExch(word, 0ull);
    *reinterpret_cast<volatile unsigned long long*>(ticket) = 0ull;
    a.out[row] = static_cast<uint32_t>(~best);
  }
}

__global__ void gumbel_noise_table_kernel(float* out) {
  out[threadIdx.x] = gumbel_bf16(threadIdx.x);
}

// the capture ids of watched graphs that are gone (da4ml_capture_watch)
std::mutex released_mutex;
std::vector<unsigned long long> released;

void CUDART_CB record_release(void* id) {
  std::lock_guard<std::mutex> lock(released_mutex);
  released.push_back(static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(id)));
}

}  // namespace

// bf16: 1 for bfloat16 logits, 0 for float32; B rows of V logits, row
// stride row_stride elements (unit stride along V); temperature already
// rounded to the logits' dtype, rcp its reciprocal rounded to float64,
// exact_div 1 where quotient() must divide (kernel.exact_division);
// splits blocks a row (kernel.pick_plan);
// noise: bf16's 128 values (da4ml_gumbel_noise_table); scratch: [B][2]
// zero 64-bit words, left zero (needed where splits > 1); out: int64 [B].
extern "C" int da4ml_gumbel_pick(int bf16, const void* logits, int B, int V,
                                 long long row_stride, unsigned int k0, unsigned int k1,
                                 float temperature, double rcp, int exact_div, int splits,
                                 const float* noise, unsigned long long* scratch, long long* out,
                                 void* stream) {
  if (logits == nullptr || out == nullptr || B < 1 || B > 65535 || V < 1 ||
      (B > 1 && row_stride < V) || splits < 1 || splits > V || (bf16 && noise == nullptr) ||
      (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pick a;
  a.logits = static_cast<const char*>(logits);
  a.row_stride = row_stride * (bf16 ? 2 : 4);
  a.V = V;
  a.splits = splits;
  a.k0 = k0;
  a.k1 = k1;
  a.temperature = temperature;
  a.rcp = rcp;
  a.exact_div = exact_div;
  a.noise = noise;
  a.scratch = scratch;
  a.out = out;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(B), 1);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    gumbel_pick_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    gumbel_pick_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fill out[0..127] (float32, on the device) with the bfloat16 noise of
// each 7-bit mantissa: one block, on `stream`.
extern "C" int da4ml_gumbel_noise_table(float* out, void* stream) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  gumbel_noise_table_kernel<<<1, kNoise, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

// The id of the capture `stream` is in, or 0 when it is not capturing.
extern "C" unsigned long long da4ml_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive) {
    return 0;
  }
  return id;
}

// Have the graph that `stream` is capturing report its capture id to
// da4ml_released_captures once the graph and every instance of it are
// destroyed (a user object the graph holds; its destructor, run on a
// CUDA-internal thread, only records the id).  0 on success.
extern "C" int da4ml_capture_watch(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorInvalidValue);
  cudaUserObject_t object;
  err = cudaUserObjectCreate(&object, reinterpret_cast<void*>(static_cast<uintptr_t>(id)),
                             record_release, 1, cudaUserObjectNoDestructorSync);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGraphRetainUserObject(graph, object, 1, cudaGraphUserObjectMove);
  if (err != cudaSuccess) cudaUserObjectRelease(object, 1);
  return static_cast<int>(err);
}

// Move up to `n` ids of watched captures whose graphs are gone into `out`;
// returns how many.
extern "C" int da4ml_released_captures(unsigned long long* out, int n) {
  std::lock_guard<std::mutex> lock(released_mutex);
  const int k = static_cast<int>(std::min<size_t>(released.size(), static_cast<size_t>(n)));
  std::copy(released.end() - k, released.end(), out);
  released.resize(released.size() - k);
  return k;
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
