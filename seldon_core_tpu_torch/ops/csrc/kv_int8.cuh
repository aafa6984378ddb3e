// The int8 K/V cache's quantizer on the device, one statement for the three
// kernels that write an int8 cache in their own launch (flash_decode.cu,
// flash_decode_paged.cu, kv_write.cu).  It is _quantize_kv of the reference
// (seldon_core_tpu/models/generate.py:133) bit for bit on the same bf16
// row: the absmax over the head dim of the values taken to f32, scale =
// max(absmax, 1e-12) / 127, q = clamp(round_half_even(x / scale), -127,
// 127).  Both divisions are IEEE round-to-nearest (__fdiv_rn, whatever the
// compiler's flags), never a reciprocal multiply, and rintf rounds half to
// even as jnp.round does.  An int8 value is exact in f32 and bf16.
// ops/_build.py hashes this header into every library's key.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace kvq {

// a row's scale from its absmax
__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-12f), 127.0f);
}

// one value's int8 code
__device__ __forceinline__ uint32_t code(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// 8 values to their 8 int8 codes, value i in byte i
__device__ __forceinline__ uint2 quant8(const float (&f)[8], float scale) {
  uint2 u;
  u.x = code(f[0], scale) | code(f[1], scale) << 8 | code(f[2], scale) << 16 |
        code(f[3], scale) << 24;
  u.y = code(f[4], scale) | code(f[5], scale) << 8 | code(f[6], scale) << 16 |
        code(f[7], scale) << 24;
  return u;
}

// 8 int8 codes (byte i is value i) to f32
__device__ __forceinline__ void dequant8(const uint2& u, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = static_cast<float>(static_cast<int>(u.x << (24 - 8 * i)) >> 24);
    f[4 + i] = static_cast<float>(static_cast<int>(u.y << (24 - 8 * i)) >> 24);
  }
}

// 8 bf16 values (16 bytes) to f32
__device__ __forceinline__ void bf16x8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float absmax8(const float (&f)[8]) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(f[i]));
  return a;
}

// the scale of a whole bf16 row of D values (D a multiple of 8, the row
// 16-byte aligned), read by one thread in 16-byte loads
__device__ __forceinline__ float bf16_row_scale(const __nv_bfloat16* row, int D) {
  float a = 0.f;
  for (int c = 0; c < D / 8; ++c) {
    float f[8];
    bf16x8(*reinterpret_cast<const uint4*>(row + 8 * c), f);
    a = fmaxf(a, absmax8(f));
  }
  return row_scale(a);
}

}  // namespace kvq
