// What the kernels' bfloat16 instantiations share (`--dtype bfloat16`, the
// JAX package's mixed precision): the element type of weights and
// activations is a template parameter W, float or __nv_bfloat16; every
// product and every accumulator stays float32.  A bfloat16 input is widened
// exactly (its bits are the top half of a float32); an output is rounded
// once to nearest even (__float2bfloat16_rn), as XLA's astype rounds.
// Only these intrinsics convert: no implicit bfloat16 arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gic {

using bf16 = __nv_bfloat16;

template <class W>
constexpr bool is_bf16 = std::is_same<W, bf16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// v rounded to W (float: unchanged), as a float.
template <class W>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (is_bf16<W>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// dst[i] = v in W (bfloat16: rounded once).
__device__ __forceinline__ void store_as(float* dst, size_t i, float v) {
  dst[i] = v;
}
__device__ __forceinline__ void store_as(bf16* dst, size_t i, float v) {
  dst[i] = __float2bfloat16_rn(v);
}

// A streaming store (evict-first: written once, read by another kernel).
__device__ __forceinline__ void store_cs(float* dst, size_t i, float v) {
  __stcs(dst + i, v);
}
__device__ __forceinline__ void store_cs(bf16* dst, size_t i, float v) {
  dst[i] = __float2bfloat16_rn(v);
}

// The low and high bfloat16 of a 32-bit word, widened.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Four neighbouring bfloat16 (8 bytes, 8-byte aligned, read-only) widened.
__device__ __forceinline__ float4 ld4_bf16(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// Eight neighbouring bfloat16 (16 bytes, 16-byte aligned, read-only)
// widened into out[0..8).
__device__ __forceinline__ void ld8_bf16(const bf16* p, float (&out)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  out[0] = bf16_lo(u.x);
  out[1] = bf16_hi(u.x);
  out[2] = bf16_lo(u.y);
  out[3] = bf16_hi(u.y);
  out[4] = bf16_lo(u.z);
  out[5] = bf16_hi(u.z);
  out[6] = bf16_lo(u.w);
  out[7] = bf16_hi(u.w);
}

// Four neighbouring elements of W, widened: 16 bytes of float32 by a
// read-only load, 8 of bfloat16 (aligned so).
__device__ __forceinline__ float4 ld4w(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4w(const bf16* p) { return ld4_bf16(p); }

// Four floats stored as neighbouring elements of W: 16 bytes of float32, 8
// of bfloat16, each rounded once (aligned so).
__device__ __forceinline__ void st4w(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4w(bf16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

}  // namespace gic
