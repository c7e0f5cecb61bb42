// Shared device helpers for the splat kernels: the repo's integer f16 codec,
// u8 unpacking and the entry constants.
//
// The f16 codec is NOT IEEE round-to-nearest-even and must never be replaced
// by __float2half_rn: the mantissa rounds half-up, subnormals flush to signed
// zero, overflow clamps to 0x7BFF (core/f16.py holds the same routine).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GS_SENTINEL 0xFFFFFFFFu

__device__ __forceinline__ uint32_t gs_f32_to_f16_bits(float x) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t sign = (b >> 16) & 0x8000u;
  const int exp = (int)((b >> 23) & 0xFFu);
  const uint32_t mant = b & 0x7FFFFFu;
  const uint32_t mant_r = (mant + 0x1000u) >> 13;  // half-up to 10 bits
  const int carry = (int)(mant_r >> 10);
  const uint32_t mant_h = (carry > 0 ? 0u : mant_r) & 0x3FFu;
  const int exp_h = exp - 112 + carry;
  if (exp_h <= 0) return sign;             // underflow -> signed zero
  if (exp_h > 30) return sign | 0x7BFFu;   // clamp to f16 max
  return sign | ((uint32_t)exp_h << 10) | mant_h;
}

__device__ __forceinline__ float gs_f16_bits_to_f32(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t exp = (h >> 10) & 0x1Fu;
  const uint32_t mant = h & 0x3FFu;
  if (exp == 0) return __uint_as_float(sign);  // subnormals read as zero
  return __uint_as_float(sign | ((exp + 112u) << 23) | (mant << 13));
}

__device__ __forceinline__ float gs_u8_unit(uint32_t w, int shift) {
  return (float)((w >> shift) & 0xFFu) * (1.0f / 255.0f);
}

namespace gs {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

}  // namespace gs
