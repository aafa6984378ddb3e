// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels share: the tile shape, the bf16 mma.sync
// helpers, the 64-row tile load and the one statement of which shapes and
// types the kernels take.  Included by both sources; ops/_build.py hashes
// this header into each library's key, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace flash {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // key rows per tile
constexpr int NWARPS = 4;              // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;                 // bf16 row padding: spreads banks
constexpr int MAX_D = 256;
constexpr int SMEM_LIMIT = 232448;     // 227 KB opt-in per block on sm_90
constexpr float NEG_INF = -1e30f;      // the TPU kernels' mask value
constexpr int DTYPE_BF16 = 0;          // dtype codes of the wrappers
constexpr int MAX_DEVICES = 64;

// the instantiated tile width for a head dim: the smallest of 64, 128, 256
// that holds it
inline int tile_width(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }

// 0, 1, 2 for tile width 64, 128, 256
inline int width_index(int DT) { return DT == 64 ? 0 : (DT == 128 ? 1 : 2); }

// bytes of one [64][DT + PAD] bf16 tile in shared memory
inline int tile_bytes(int DT) { return BQ * (DT + PAD) * 2; }

// The shape and type rules of both kernels: bf16, a head dim that is a
// multiple of 16 up to 256, a sequence length that is a multiple of 64.
// Returns false with the reason in why (why may be null when why_len is 0).
inline bool shape_ok(int head_dim, int seq_len, int dtype_code, char* why, int why_len) {
  if (dtype_code != DTYPE_BF16) {
    snprintf(why, why_len, "the flash-attention kernel takes bfloat16 q/k/v only");
    return false;
  }
  if (head_dim < 16 || head_dim > MAX_D || head_dim % 16 != 0) {
    snprintf(why, why_len,
             "head dim %d: the flash-attention kernel takes a multiple of 16 up to %d",
             head_dim, MAX_D);
    return false;
  }
  if (seq_len < BQ || seq_len % BQ != 0 || seq_len / BQ > 65535) {
    snprintf(why, why_len, "seq len %d: the flash-attention kernel takes a multiple of %d",
             seq_len, BQ);
    return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a(16x16, row) * b(16x8, col), bf16 inputs, f32 accumulators.
// Fragment layout (lane = 4 * g + t): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g], b1 =
// B[2t+8..2t+9][g]; d0, d1 = D[g][2t..2t+1], d2, d3 = D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 64 rows of width D (row stride `stride` elements, 16-byte aligned rows)
// into a [64][DT + PAD] shared tile; columns D..DT-1 are zeros
template <int DT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int D) {
  constexpr int LD = DT + PAD;
  constexpr int CH = DT / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < D) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace flash
