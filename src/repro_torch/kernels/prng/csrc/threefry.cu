// Counter-based random draw for NVIDIA Hopper (sm_90a): jax.random's
// threefry2x32 over the flat index, its uniform, its normal and its
// Gumbel noise.
//
// Replaces no TPU kernel: the JAX package draws its parameters with
// jax.random (src/repro/models/transformer.py:_init_leaf,
// jax.random.normal per leaf), which XLA lowers to its own threefry.  The
// port draws the same numbers from the same keys, so init_params gives the
// JAX package's parameters, and a rank of a mesh draws only its own block
// of each leaf (each element depends only on the leaf's key and its global
// index, as under jax_threefry_partitionable).
//
// Per element of the output, one thread:
//   - the global flat index g = base + sum_m l_m * stride_m, where l_m are
//     the digits of the thread's local flat index over the window's merged
//     dims (at most 4; kernel.py/ref.py window_plan merges them);
//   - (y0, y1) = threefry2x32((k0, k1), (g >> 32, g & 0xffffffff)), 20
//     rounds in 32-bit registers, rotations as __funnelshift_l
//     (threefry.cuh); the 32 random bits are y0 ^ y1 (jax.random.bits);
//   - uniform: (bits >> 9) | 0x3f800000 as a float in [1, 2), minus 1,
//     times (maxval - minval) plus minval in one fmaf, clamped below at
//     minval (jax.random's _uniform, whose product and sum XLA fuses);
//   - normal: the uniform on [nextafter(-1, 0), 1), then sqrt(2) times
//     XLA's ErfInv32 (Giles' two 9-term polynomials, w = -log1p(-x^2),
//     each step an fmaf), times the leaf's scale, written as float32 or
//     rounded to bfloat16 (round to nearest even);
//   - gumbel: -log(-log(u)), u on [tiny, 1) (threefry.cuh's gumbel_f32 and
//     gumbel_bf16, which the categorical pick, gumbel_pick.cu, shares).
// Or the bits themselves, zero-extended into an int64 output, so the
// integer part can be held exactly against the plain version.
//
// What bounds it on this card: operations.  An element costs about 77
// int32 operations (2 for the index, 72 for the hash, 3 for the bits and
// the mantissa) against 2 to 8 bytes written, and Hopper's SM issues 64
// int32 lanes a clock; the float part (about 50 flops, log1pf's and
// sqrtf's own included) runs on the 128 FP32 lanes beside it.  So the design keeps
// everything in registers: no shared memory, no loads, one coalesced
// store a thread.  The index is 32-bit where the block has fewer than 2^32
// elements (the 64-bit division of a merged dim costs as much as a
// quarter of the hash), and a window of one merged dim needs no division.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "threefry.cuh"

namespace {

using da4ml_prng::gumbel_bf16;
using da4ml_prng::gumbel_bf16_mantissa;
using da4ml_prng::gumbel_f32;
using da4ml_prng::threefry_bits;

constexpr int kThreads = 256;
constexpr int kMaxDims = 4;

enum Kind : int {
  kBits = 0, kUniform = 1, kNormalF32 = 2, kNormalBf16 = 3, kGumbelF32 = 4, kGumbelBf16 = 5
};

struct Args {
  uint32_t k0, k1;
  unsigned long long base;  // global flat index of the block's first element
  long long n;              // elements of the block
  int nd;                   // merged dims, 1 .. kMaxDims
  long long len[kMaxDims];     // their extents, outermost first
  long long stride[kMaxDims];  // their strides in the global array
  float range, minval, scale;
  void* out;
};

// XLA's ErfInv32, each step of the polynomial a fused multiply-add
__device__ __forceinline__ float erf_inv32(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = fmaf(p, w, lt ? 3.43273939e-07f : 0.000100950558f);
  p = fmaf(p, w, lt ? -3.5233877e-06f : 0.00134934322f);
  p = fmaf(p, w, lt ? -4.39150654e-06f : -0.00367342844f);
  p = fmaf(p, w, lt ? 0.00021858087f : 0.00573950773f);
  p = fmaf(p, w, lt ? -0.00125372503f : -0.0076224613f);
  p = fmaf(p, w, lt ? -0.00417768164f : 0.00943887047f);
  p = fmaf(p, w, lt ? 0.246640727f : 1.00167406f);
  p = fmaf(p, w, lt ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, CUDART_INF_F) : __fmul_rn(p, x);
}

template <int KIND, typename Index>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args a) {
  const Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  if (static_cast<long long>(i) >= a.n) return;
  Index rem = i;
  unsigned long long g = a.base;
  // unrolled, so that each extent and stride is read from the parameters
  // by a constant index (a loop to a.nd copied the Args to the stack)
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < a.nd) {
      const Index len = static_cast<Index>(a.len[d]);
      const Index q = rem / len;
      g += static_cast<unsigned long long>(rem - q * len) *
           static_cast<unsigned long long>(a.stride[d]);
      rem = q;
    }
  }
  g += static_cast<unsigned long long>(rem) * static_cast<unsigned long long>(a.stride[0]);
  const uint32_t bits =
      threefry_bits(a.k0, a.k1, static_cast<uint32_t>(g >> 32), static_cast<uint32_t>(g));
  if constexpr (KIND == kBits) {
    static_cast<long long*>(a.out)[i] = static_cast<long long>(bits);
  } else if constexpr (KIND == kGumbelF32) {
    static_cast<float*>(a.out)[i] = gumbel_f32(bits);
  } else if constexpr (KIND == kGumbelBf16) {
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(gumbel_bf16(gumbel_bf16_mantissa(bits)));
  } else {
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    const float u = fmaxf(a.minval, fmaf(f, a.range, a.minval));
    if constexpr (KIND == kUniform) {
      static_cast<float*>(a.out)[i] = u;
    } else {
      const float v = __fmul_rn(__fmul_rn(1.41421354f, erf_inv32(u)), a.scale);
      if constexpr (KIND == kNormalF32) {
        static_cast<float*>(a.out)[i] = v;
      } else {
        static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <int KIND>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const unsigned long long blocks = (static_cast<unsigned long long>(a.n) + kThreads - 1) / kThreads;
  if (blocks * kThreads <= 0xFFFFFFFFull) {
    threefry_kernel<KIND, uint32_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  } else {
    threefry_kernel<KIND, unsigned long long>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int da4ml_threefry(int kind, unsigned int k0, unsigned int k1, unsigned long long base,
                              long long n, int nd, long long len0, long long len1, long long len2,
                              long long len3, long long stride0, long long stride1,
                              long long stride2, long long stride3, float range, float minval,
                              float scale, void* out, void* stream) {
  if (kind < kBits || kind > kGumbelBf16 || n <= 0 || nd < 1 || nd > kMaxDims || out == nullptr ||
      (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{k0, k1, base, n, nd, {len0, len1, len2, len3}, {stride0, stride1, stride2, stride3},
         range, minval, scale, out};
  long long total = 1;
  for (int d = 0; d < nd; ++d) {
    if (a.len[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    total *= a.len[d];
  }
  if (total != n) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBits: return static_cast<int>(launch<kBits>(a, s));
    case kUniform: return static_cast<int>(launch<kUniform>(a, s));
    case kNormalF32: return static_cast<int>(launch<kNormalF32>(a, s));
    case kNormalBf16: return static_cast<int>(launch<kNormalBf16>(a, s));
    case kGumbelF32: return static_cast<int>(launch<kGumbelF32>(a, s));
    default: return static_cast<int>(launch<kGumbelBf16>(a, s));
  }
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
