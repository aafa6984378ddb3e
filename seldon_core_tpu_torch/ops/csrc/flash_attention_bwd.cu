// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// o = softmax(q k^T / sqrt(D)) v, from the forward's per-row log-sum-exp.
//
// Replaces the two Pallas TPU kernels of seldon_core_tpu/ops/flash_attention.py
// (_bwd_impl :303): _bwd_dq_kernel (:208, pallas_call :331) and
// _bwd_dkv_kernel (:252, pallas_call :349), and computes what they compute,
// rounding where they round:
//   * s = (q.k) * (1/sqrt(D)) in f32 from bf16 products; causal masking by
//     global position with -1e30; p = exp(s - lse) in f32, lse the
//     forward's [B*H, S] f32 rows;
//   * dp = dO.v^T in f32; ds = p * (dp - dsum) in f32, dsum = rowsum(dO*o)
//     in f32 (the wrapper computes it, as XLA does outside the TPU kernels);
//   * dV = sum over query tiles of bf16(p)^T dO; dK = sum of bf16(ds)^T q,
//     times scale; dQ = sum over key tiles of bf16(ds) k, times scale; all
//     three f32 sums cast to bf16 at the end.  The scale multiplies each
//     f32 sum once, after the products, where the TPU kernels multiply
//     each tile's product: the two differ by f32 rounding only.
// Two passes (one kernel each), as on the TPU: no atomics, so the result
// is deterministic.
//
// Grouped-query attention: the JAX package repeats K/V over the group,
// runs the MHA kernels, rounds each query head's dK/dV to bf16 and sums the
// group (_flash_bwd :397-413).  Here the dK/dV block belongs to one kv head
// and walks the query tiles of all H/KV query heads that read it, summing
// their contributions in one f32 accumulator and writing dK/dV once.  That
// reads K/V at their stored size and keeps the repeated [B, H, S, D] copies
// out of device memory; it rounds once where the reference rounds H/KV + 1
// times, so it differs from the plain version by up to about a bf16 ulp of
// the sum (chip_smoke.py states the tolerance).
//
// Bound on an H100 SXM, at the training layer (q [16,16,512,64], k/v
// [16,4,512,64], bf16, causal): dQ must move q, k, v, dO, lse, dsum and dq
// once (~60 MB, ~18 us at 3.35 TB/s) and do 3 products over the causal
// pairs (12.9 GFLOP, ~13 us at 989 TFLOP/s), so it is bound by the bytes;
// dK/dV moves ~51 MB (~15 us) and does 4 products (17.2 GFLOP, ~17 us), so
// it is bound by the operations.  What the design does about it: the
// [S, S] scores never reach device memory, K/V tiles are read at their
// grouped size, and the four products run on the bf16 tensor cores.
//
// Design (simple first, the forward's building blocks): 64-row tiles, four
// warps of 16 rows, mma.sync m16n8k16 bf16 with f32 accumulators.
//   * dQ: one block per (b*H + h, query tile i); it keeps Q and dO tiles in
//     shared memory and walks key tiles 0..i (causal) or all, staging K and
//     V.  s and p stay in registers; dp is made 16 keys at a time and turned
//     into ds, which is repacked from the accumulator layout into the A
//     operand of ds.K, so neither reaches shared memory.
//   * dK/dV: one block per (b*KV + kv head, key tile j); it keeps K and V in
//     shared memory and walks, for each query head of the group, query
//     tiles j..n-1 (causal) or all, staging Q, dO, lse and dsum.  The
//     transposes (p^T dO and ds^T q) are avoided by computing s^T = K.Q^T
//     and dp^T = V.dO^T directly, with the block's keys as rows: p^T and
//     ds^T then sit in registers in the accumulator layout, which is the A
//     layout of the next product.
//   * Registers: a warp's 16 rows of an f32 [64, DT] accumulator take DT/2
//     registers per thread.  At tile width 64 and 128 the dK/dV block keeps
//     both accumulators; at 256 (2 x 128 would not fit in 255 registers) it
//     walks the query tiles twice, dV on the first pass and dK on the
//     second.
// Tiles strictly above the causal diagonal are skipped, not masked; only
// the diagonal tile is masked.  Head dims below the tile width are
// zero-padded in shared memory and their products skipped.  No wgmma, TMA,
// cp.async pipelining or producer warp yet.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include "flash_common.cuh"

#include <atomic>
#include <cmath>

namespace {

using namespace flash;

struct Params {
  const __nv_bfloat16* q;     // [B,H,S,D] by strides
  const __nv_bfloat16* k;     // [B,KV,S,D] by strides
  const __nv_bfloat16* v;     // [B,KV,S,D] by strides
  const __nv_bfloat16* dout;  // [B,H,S,D] by strides
  const float* lse;           // [B*H, S] contiguous
  const float* dsum;          // [B*H, S] contiguous
  __nv_bfloat16* dq;          // [B,H,S,D] contiguous
  __nv_bfloat16* dk;          // [B,KV,S,D] contiguous
  __nv_bfloat16* dv;          // [B,KV,S,D] contiguous
  int H, KV, S, D;
  long long qs[3], ks[3], vs[3], dos[3];  // element strides of b, h, s (d is 1)
  float scale;
  int causal;
};

// four [64][DT + PAD] bf16 tiles, and the dK/dV block's lse and dsum rows
inline int smem_dq(int DT) { return 4 * tile_bytes(DT); }
inline int smem_dkv(int DT) { return 4 * tile_bytes(DT) + 2 * BQ * 4; }

// acc (16 rows of the warp, C layout) * scale as bf16 into rows row0 and
// row0 + 8 of a contiguous [., D] output
template <int DT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row0, int D,
                                           const float (&acc)[DT / 8][4], float scale) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  __nv_bfloat16* r0 = out + (row0 + g) * D;
  __nv_bfloat16* r1 = r0 + 8LL * D;
#pragma unroll
  for (int n = 0; n < DT / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(r0 + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(r1 + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
    }
  }
}

template <int DT>
__device__ __forceinline__ void zero(float (&acc)[DT / 8][4]) {
#pragma unroll
  for (int n = 0; n < DT / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// s[8][4] += A(16 rows of the warp at `a`, row stride LD) . B(64 rows at
// `b`)^T over the first D columns: the 16 x 64 product whose 8 column tiles
// are rows of `b`
template <int DT>
__device__ __forceinline__ void rows_by_rows(float (&s)[8][4], const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int D) {
  constexpr int LD = DT + PAD;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    if (kk * 16 < D) {  // block-uniform: padded depth adds nothing
      const __nv_bfloat16* pa = a + g * LD + kk * 16 + t * 2;
      const uint32_t a0 = ld32(pa), a1 = ld32(pa + 8 * LD);
      const uint32_t a2 = ld32(pa + 8), a3 = ld32(pa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* pb = b + (j * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(pb), ld32(pb + 8));
      }
    }
  }
}

// dp[2][4] = A(16 rows of the warp at `a`) . B(rows c0 .. c0+15 at `b`)^T:
// the two 8-wide column tiles of a 16-column step
template <int DT>
__device__ __forceinline__ void rows_by_16(float (&dp)[2][4], const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int D) {
  constexpr int LD = DT + PAD;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DT / 16; ++kd) {
    if (kd * 16 < D) {
      const __nv_bfloat16* pa = a + g * LD + kd * 16 + t * 2;
      const uint32_t a0 = ld32(pa), a1 = ld32(pa + 8 * LD);
      const uint32_t a2 = ld32(pa + 8), a3 = ld32(pa + 8 * LD + 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const __nv_bfloat16* pb = b + (jj * 8 + g) * LD + kd * 16 + t * 2;
        mma_bf16(dp[jj], a0, a1, a2, a3, ld32(pb), ld32(pb + 8));
      }
    }
  }
}

// acc[n] += A . B(16 rows at `b`, all D columns), A the 16 x 16 operand of
// a 16-deep step given as two accumulator tiles x0, x1 (columns 0-7 and
// 8-15) rounded to bf16: the accumulator layout of two 8-wide tiles is,
// element for element, the A layout of one 16-deep step
template <int DT>
__device__ __forceinline__ void acc_by_rows(float (&acc)[DT / 8][4], const float (&x0)[4],
                                            const float (&x1)[4], const __nv_bfloat16* b,
                                            int D) {
  constexpr int LD = DT + PAD;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const uint32_t a0 = pack_f32(x0[0], x0[1]);
  const uint32_t a1 = pack_f32(x0[2], x0[3]);
  const uint32_t a2 = pack_f32(x1[0], x1[1]);
  const uint32_t a3 = pack_f32(x1[2], x1[3]);
  const __nv_bfloat16* pb = b + t * 2 * LD + g;
#pragma unroll
  for (int n = 0; n < DT / 8; ++n) {
    if (n * 8 < D) {  // block-uniform
      const __nv_bfloat16* c = pb + n * 8;
      mma_bf16(acc[n], a0, a1, a2, a3, pack_bf16(c[0], c[LD]), pack_bf16(c[8 * LD], c[9 * LD]));
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DT + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks = dOs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int r0 = warp * 16;
  const int qrow0 = q0 + r0 + g;  // the thread's two query rows
  const int qrow1 = qrow0 + 8;

  load_tile<DT>(Qs, p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2], p.qs[2], p.D);
  load_tile<DT>(dOs, p.dout + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2], p.dos[2], p.D);
  const long long rows = static_cast<long long>(bh) * p.S;
  const float lse0 = p.lse[rows + qrow0], lse1 = p.lse[rows + qrow1];
  const float dsum0 = p.dsum[rows + qrow0], dsum1 = p.dsum[rows + qrow1];
  const __nv_bfloat16* kbase = p.k + b * p.ks[0] + kvh * p.ks[1];
  const __nv_bfloat16* vbase = p.v + b * p.vs[0] + kvh * p.vs[1];

  float acc[DT / 8][4];
  zero<DT>(acc);
  const int n_kt = p.causal ? qt + 1 : p.S / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DT>(Ks, kbase + k0 * p.ks[2], p.ks[2], p.D);
    load_tile<DT>(Vs, vbase + k0 * p.vs[2], p.vs[2], p.D);
    __syncthreads();

    // p = exp(scale * q.k - lse) for the warp's 16 rows x 64 keys; element
    // e of tile j sits at row g + 8*(e >= 2), key j*8 + 2t + (e & 1)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    rows_by_rows<DT>(s, Qs + r0 * LD, Ks, p.D);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (p.causal && key > (e < 2 ? qrow0 : qrow1)) x = NEG_INF;
        s[j][e] = expf(x - (e < 2 ? lse0 : lse1));
      }
    }
    // 16 keys at a time: dp = dO.v^T, ds = p (dp - dsum), acc += bf16(ds) k
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float dp[2][4];
      rows_by_16<DT>(dp, dOs + r0 * LD, Vs + kk * 16 * LD, p.D);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[jj][e] = s[2 * kk + jj][e] * (dp[jj][e] - (e < 2 ? dsum0 : dsum1));
      }
      acc_by_rows<DT>(acc, dp[0], dp[1], Ks + kk * 16 * LD, p.D);
    }
  }
  store_rows<DT>(p.dq, rows + q0 + r0, p.D, acc, p.scale);
}

// One walk of a dK/dV block over the query tiles of its group's heads:
// dV += bf16(p)^T dO when DV, dK += bf16(ds)^T q when DK (unscaled)
template <int DT, bool DV, bool DK>
__device__ __forceinline__ void dkv_walk(const Params& p, const __nv_bfloat16* Ks,
                                         const __nv_bfloat16* Vs, __nv_bfloat16* Qs,
                                         __nv_bfloat16* dOs, float* lse_s, float* dsum_s,
                                         int b, int kvh, int kt, float (&acc_v)[DT / 8][4],
                                         float (&acc_k)[DT / 8][4]) {
  constexpr int LD = DT + PAD;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = warp * 16;
  const int krow0 = kt * BK + r0 + g;  // the thread's two key rows
  const int krow1 = krow0 + 8;
  const int group = p.H / p.KV;
  const int n_qt = p.S / BQ;
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const long long rows = static_cast<long long>(b * p.H + h) * p.S;
    for (int qt = p.causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<DT>(Qs, p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2], p.qs[2], p.D);
      load_tile<DT>(dOs, p.dout + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2], p.dos[2], p.D);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        lse_s[i] = p.lse[rows + q0 + i];
        dsum_s[i] = p.dsum[rows + q0 + i];
      }
      __syncthreads();

      // p^T = exp(scale * k.q - lse) for the warp's 16 keys x 64 queries;
      // element e of tile j sits at key g + 8*(e >= 2), query j*8 + 2t + (e & 1)
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      rows_by_rows<DT>(s, Ks + r0 * LD, Qs, p.D);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + t * 2 + (e & 1);
          float x = s[j][e] * p.scale;
          if (p.causal && (e < 2 ? krow0 : krow1) > q0 + qi) x = NEG_INF;
          s[j][e] = expf(x - lse_s[qi]);
        }
      }
      // 16 queries at a time
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (DV) acc_by_rows<DT>(acc_v, s[2 * kk], s[2 * kk + 1], dOs + kk * 16 * LD, p.D);
        if constexpr (DK) {
          float dp[2][4];  // dp^T = v.dO^T, then ds^T = p^T (dp^T - dsum)
          rows_by_16<DT>(dp, Vs + r0 * LD, dOs + kk * 16 * LD, p.D);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[jj][e] = s[2 * kk + jj][e] *
                          (dp[jj][e] - dsum_s[(2 * kk + jj) * 8 + t * 2 + (e & 1)]);
          }
          acc_by_rows<DT>(acc_k, dp[0], dp[1], Qs + kk * 16 * LD, p.D);
        }
      }
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DT + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* dOs = Qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LD);
  float* dsum_s = lse_s + BQ;

  const int bkv = blockIdx.x;
  const int b = bkv / p.KV;
  const int kvh = bkv - b * p.KV;
  const int kt = blockIdx.y;  // causal: key tile 0 walks the most query tiles
  const int r0 = (threadIdx.x >> 5) * 16;
  load_tile<DT>(Ks, p.k + b * p.ks[0] + kvh * p.ks[1] + kt * BK * p.ks[2], p.ks[2], p.D);
  load_tile<DT>(Vs, p.v + b * p.vs[0] + kvh * p.vs[1] + kt * BK * p.vs[2], p.vs[2], p.D);
  // (dkv_walk's first barrier orders these loads before any read)

  const long long out_row = static_cast<long long>(bkv) * p.S + kt * BK + r0;
  if constexpr (DT <= 128) {
    float acc_v[DT / 8][4], acc_k[DT / 8][4];
    zero<DT>(acc_v);
    zero<DT>(acc_k);
    dkv_walk<DT, true, true>(p, Ks, Vs, Qs, dOs, lse_s, dsum_s, b, kvh, kt, acc_v, acc_k);
    store_rows<DT>(p.dv, out_row, p.D, acc_v, 1.0f);
    store_rows<DT>(p.dk, out_row, p.D, acc_k, p.scale);
  } else {  // one accumulator: dV on the first walk, dK on the second
    float acc[DT / 8][4];
    zero<DT>(acc);
    dkv_walk<DT, true, false>(p, Ks, Vs, Qs, dOs, lse_s, dsum_s, b, kvh, kt, acc, acc);
    store_rows<DT>(p.dv, out_row, p.D, acc, 1.0f);
    zero<DT>(acc);
    dkv_walk<DT, false, true>(p, Ks, Vs, Qs, dOs, lse_s, dsum_s, b, kvh, kt, acc, acc);
    store_rows<DT>(p.dk, out_row, p.D, acc, p.scale);
  }
}

// Which shapes and types the backward takes: exactly what the forward takes
// (flash_common.cuh), with shared memory for the larger of its two kernels.
// Returns the dynamic shared memory in bytes, or -1 with the reason in why.
int plan(int head_dim, int seq_len, int dtype_code, char* why, int why_len) {
  if (!shape_ok(head_dim, seq_len, dtype_code, why, why_len)) return -1;
  const int DT = tile_width(head_dim);
  const int smem = smem_dq(DT) > smem_dkv(DT) ? smem_dq(DT) : smem_dkv(DT);
  if (smem > SMEM_LIMIT) {
    snprintf(why, why_len,
             "the flash-attention backward needs %d KiB shared memory (budget %d KiB)",
             smem >> 10, SMEM_LIMIT >> 10);
    return -1;
  }
  return smem;
}

// per kernel (dQ, dK/dV), tile width (64, 128, 256) and device: the
// shared-memory opt-in is set
std::atomic<bool> g_smem_set[2][3][MAX_DEVICES];

int fill(Params& p, const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* dsum, int B, int H, int KV, int S, int D, int causal,
         const long long* strides) {
  if (plan(D, S, DTYPE_BF16, nullptr, 0) < 0 || B < 1 || KV < 1 || H < KV || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq = p.dk = p.dv = nullptr;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.dos[i] = strides[9 + i];
  }
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  p.causal = causal ? 1 : 0;
  return 0;
}

int launch(int which_kernel, const Params& p, int B, void* stream) {
  const int DT = tile_width(p.D);
  const int w = width_index(DT);
  void (*kernel)(const Params);
  int smem;
  dim3 grid;
  if (which_kernel == 0) {
    kernel = w == 0 ? flash_bwd_dq_kernel<64>
                    : (w == 1 ? flash_bwd_dq_kernel<128> : flash_bwd_dq_kernel<256>);
    smem = smem_dq(DT);
    grid = dim3(B * p.H, p.S / BQ);
  } else {
    kernel = w == 0 ? flash_bwd_dkv_kernel<64>
                    : (w == 1 ? flash_bwd_dkv_kernel<128> : flash_bwd_dkv_kernel<256>);
    smem = smem_dkv(DT);
    grid = dim3(B * p.KV, p.S / BK);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[which_kernel][w][dev].load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[which_kernel][w][dev].store(true);
  }
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory the backward takes for this head dim, sequence
// length and dtype code (0 = bfloat16), or -1 with the reason in why.
int flash_attention_bwd_smem_bytes(int head_dim, int seq_len, int dtype_code, char* why,
                                   int why_len) {
  return plan(head_dim, seq_len, dtype_code, why, why_len);
}

// Both launch on `stream` (a cudaStream_t as an integer handle) and return
// cudaGetLastError() after the launch: 0 means launched.  q/dout
// [B,H,S,D], k/v [B,KV,S,D] bf16 with element strides[12] = (b, h, s) of
// q, k, v, dout and unit stride along D, every row 16-byte aligned; lse and
// dsum [B*H,S] f32 contiguous; dq [B,H,S,D], dk/dv [B,KV,S,D] bf16
// contiguous.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dsum, void* dq, int B, int H,
                                  int KV, int S, int D, int causal, const long long* strides,
                                  void* stream) {
  Params p;
  const int rc = fill(p, q, k, v, dout, lse, dsum, B, H, KV, S, D, causal, strides);
  if (rc != 0) return rc;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  return launch(0, p, B, stream);
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* dsum, void* dk,
                                   void* dv, int B, int H, int KV, int S, int D, int causal,
                                   const long long* strides, void* stream) {
  Params p;
  const int rc = fill(p, q, k, v, dout, lse, dsum, B, H, KV, S, D, causal, strides);
  if (rc != 0) return rc;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  return launch(1, p, B, stream);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
