// A CPU stand-in for the parts of <cuda_bf16.h> that the sources in
// ops/csrc/ use (see cuda_runtime.h beside this file): __nv_bfloat16 as
// its raw 16 bits, __float2bfloat16_rn rounding to nearest even on the
// bits as the card (and torch, and XLA) round, __bfloat162float widening
// exactly; __nv_bfloat162 a pair of them.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN: keep it a (quiet) NaN
    return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat162 __halves2bfloat162(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return {lo, hi};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
