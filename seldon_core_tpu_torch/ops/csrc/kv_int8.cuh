// The int8 K/V cache's quantizer on the device, one statement for the three
// kernels that write an int8 cache in their own launch (flash_decode.cu,
// flash_decode_paged.cu, kv_write.cu).  It is _quantize_kv of the reference
// (seldon_core_tpu/models/generate.py:133) bit for bit on the same bf16
// row: the absmax over the head dim of the values taken to f32, scale =
// max(absmax, 1e-12) / 127, q = clamp(round_half_even(x / scale), -127,
// 127).  Both divisions are IEEE round-to-nearest (__fdiv_rn, whatever the
// compiler's flags), never a reciprocal multiply, and rintf rounds half to
// even as jnp.round does.  An int8 value is exact in f32 and bf16.  Also
// the walks' widening of codes to bf16 (codes_bf16x2), which needs no
// conversion instruction.  ops/_build.py hashes this header into every
// library's key.

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

// Bytes 0 and 2 of w, two int8 codes, as a bf16x2 (byte 0 in the low
// half), exactly and without the conversion pipe (no I2F, no F2FP): each
// 16-bit half holds its code in its low byte, code = m - 128 s with m its
// low 7 bits and s its sign bit; (h & 0x7f) | 0x4300 is the bf16 of 128 +
// m and (h & 0x80) | 0xc300 that of -(128 + 128 s) (s lands on the
// exponent's lowest bit: -128 or -256), so one bf16x2 FMA, a * 1 + n,
// gives m - 128 s, an integer in [-128, 127] that bf16 holds exactly.  Two
// LOP3s and one bf16x2 add (the compiler emits the FMA as a HADD2) for two
// codes; bytes 1 and 3 are codes_bf16x2(w >> 8).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w) {
  const uint32_t a = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t n = (w & 0x00800080u) | 0xc300c300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(n));
  return d;
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

}  // namespace kvq
