// Shared by threefry.cu (the draw) and gumbel_pick.cu (the categorical
// pick): jax.random's threefry2x32 hash of a 64-bit count, and its Gumbel
// noise (jax._src.random._gumbel, mode "low": -log(-log(u)), u uniform on
// [tiny, 1)) in float32 and in bfloat16.
//
// Each log is the CUDA math library's accurate logf (at most one ulp from
// the correctly rounded value; the build uses no fast math).  bfloat16
// follows XLA's arithmetic for a bfloat16 op: each log runs in float32 and
// rounds to bfloat16.  jax.random draws a bfloat16 uniform from 8 random
// bits (the low byte of the 32), of which it keeps 7 as the mantissa, so
// the bfloat16 noise is one of 128 values.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace da4ml_prng {

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);
  x1 ^= x0;
}

__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  mix<13>(x0, x1);
  mix<15>(x0, x1);
  mix<26>(x0, x1);
  mix<6>(x0, x1);
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  mix<17>(x0, x1);
  mix<29>(x0, x1);
  mix<16>(x0, x1);
  mix<24>(x0, x1);
}

// threefry2x32 of the count (x0, x1) under (k0, k1), as XLA's unrolled
// lowering of jax's threefry2x32_p; returns y0 ^ y1
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds_a(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds_b(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds_a(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds_b(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds_a(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

// the smallest normal float32 (and bfloat16): the Gumbel uniform's minval
constexpr float kTiny = 1.17549435e-38f;

// float32 noise: u = the top 23 bits as a float in [1, 2), less 1; the
// reference's fused u * (1 - tiny) + tiny, clamped below at tiny, is u
// itself but at u = 0, where it is tiny
__device__ __forceinline__ float gumbel_f32(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = f > 0.0f ? f : kTiny;
  return -logf(-logf(u));
}

// the bfloat16 uniform's 7 mantissa bits: the low byte of the bits, less
// its lowest bit
__device__ __forceinline__ uint32_t gumbel_bf16_mantissa(uint32_t bits) {
  return (bits & 0xFFu) >> 1;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bfloat16 noise of mantissa m (0..127): u = m / 128, or tiny at 0; the
// value is exactly a bfloat16
__device__ __forceinline__ float gumbel_bf16(uint32_t m) {
  const float u = m != 0u ? __uint2float_rn(m) * 0.0078125f : kTiny;
  return -round_bf16(logf(-round_bf16(logf(u))));
}

}  // namespace da4ml_prng
