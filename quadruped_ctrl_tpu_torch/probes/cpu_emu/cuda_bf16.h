// CPU stand-in for the bf16 conversions csrc/ uses, for emulate.py: float to
// bf16 rounds to nearest, ties to even, as __float2bfloat16_rn does (NaN and
// overflow aside); a bf16x2 holds x in its low half.
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t v;
};
struct __nv_bfloat162 {
  uint16_t x, y;
};
inline uint16_t emu_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}
inline float emu_f(uint16_t h) { return __uint_as_float(static_cast<uint32_t>(h) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_bf16(f)}; }
inline float __bfloat162float(__nv_bfloat16 h) { return emu_f(h.v); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {emu_bf16(a), emu_bf16(b)};
}
inline float __low2float(__nv_bfloat162 h) { return emu_f(h.x); }
inline float __high2float(__nv_bfloat162 h) { return emu_f(h.y); }
