// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v,
// plus the per-row log-sum-exp of the scaled scores.
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/flash_attention.py
// (_fwd_impl :136, kernel body _flash_kernel :56) and computes what it
// computes, in the same order:
//   * q [B,H,S,D], k/v [B,KV,S,D], H a multiple of KV (grouped-query
//     attention is native: query head h reads kv head h / (H/KV), so K/V
//     are never repeated);
//   * scores (q.k) * (1/sqrt(D)) in f32 from bf16 products; causal masking
//     by global position with -1e30;
//   * an online softmax over K/V tiles: running max m and normaliser l in
//     f32, p = exp(s - m) cast to bf16 (V's dtype) before the PV product,
//     the f32 accumulator rescaled by alpha = exp(m_prev - m) every tile;
//   * o = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30)).
// Tiles strictly above the causal diagonal are skipped, not masked: with
// 64-row query tiles and 64-row K/V tiles, query tile i reads K/V tiles
// 0..i only, and only tile i is partly masked.
//
// Bound on an H100 SXM: at the served prefill (q [32,16,512,64], k/v
// [32,4,512,64], bf16) the call must move q, k, v, o and lse once (~85 MB,
// ~25 us at 3.35 TB/s) and do 4*B*H*D*S(S+1)/2 = 17.2 GFLOP (~17 us at
// 989 TFLOP/s), so it is bound by the bytes.  What the design does about
// it: the [S, S] scores never reach device memory; each block reads its
// query tile once and streams the K/V of its kv head through shared
// memory, and the H/KV query heads that share a kv head read the same K/V,
// which therefore hit in the 50 MB L2 after the first.
//
// Design (simple first): one block per (b*H + h, 64-row query tile), four
// warps, each owning 16 query rows.  A loop inside the block walks the K/V
// tiles (the TPU grid's sequential ik axis).  Q stays in shared memory;
// each K/V tile of 64 rows is staged through shared memory with 16-byte
// loads.  Both products run on the bf16 tensor cores through mma.sync
// m16n8k16 with f32 accumulators, whose register layout is documented, so
// the accumulator is rescaled in registers and the score accumulators are
// repacked in registers as the A operand of the PV product.  Head dims
// below the instantiated tile width (64, 128 or 256) are zero-padded in
// shared memory and their products skipped.  No wgmma, TMA, cp.async
// pipelining or producer warp yet.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).
// The tile shape, the mma.sync helpers and the shape rules are shared with
// the backward kernels (flash_common.cuh).

#include "flash_common.cuh"

#include <atomic>
#include <cmath>

namespace {

using namespace flash;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;   // [B, H, S, D] contiguous
  float* lse;         // [B*H, S] contiguous
  int H, KV, S, D;
  long long qs[3], ks[3], vs[3];  // element strides of b, h, s (d is 1)
  float scale;
  int causal;
};

inline int smem_for(int DT) { return 3 * tile_bytes(DT); }  // Q, K, V tiles

template <int DT>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  constexpr int LD = DT + PAD;
  constexpr int NT_D = DT / 8;   // 8-wide column tiles of o
  constexpr int KS_D = DT / 16;  // 16-deep steps of q.k
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row half of a fragment
  const int t = lane & 3;   // column pair within a fragment
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // merged kv row (bh / H) * KV + (bh % H) / (H / KV), as kv_index does
  const int kvh = h / (p.H / p.KV);
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int r0 = warp * 16;
  const int qrow0 = q0 + r0 + g;      // the thread's two query rows
  const int qrow1 = qrow0 + 8;

  load_tile<DT>(Qs, p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2], p.qs[2], p.D);
  const __nv_bfloat16* kbase = p.k + b * p.ks[0] + kvh * p.ks[1];
  const __nv_bfloat16* vbase = p.v + b * p.vs[0] + kvh * p.vs[1];

  float o[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // BQ == BK: causal query tile qt needs K/V tiles 0..qt; later ones are
  // fully masked and skipped
  const int n_kt = p.causal ? qt + 1 : p.S / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DT>(Ks, kbase + k0 * p.ks[2], p.ks[2], p.D);
    load_tile<DT>(Vs, vbase + k0 * p.vs[2], p.vs[2], p.D);
    __syncthreads();

    // s = q k^T for the warp's 16 rows x 64 keys (8 column tiles)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS_D; ++kk) {
      if (kk * 16 < p.D) {  // block-uniform: padded depth adds nothing
        const __nv_bfloat16* qa = Qs + (r0 + g) * LD + kk * 16 + t * 2;
        const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD);
        const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* kb = Ks + (j * 8 + g) * LD + kk * 16 + t * 2;
          mma_bf16(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
        }
      }
    }

    // scale, mask, and the running max of each of the thread's two rows;
    // accumulator element e sits at row g + 8*(e >= 2), key t*2 + (e & 1)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (p.causal && key > (e < 2 ? qrow0 : qrow1)) x = NEG_INF;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    // a row's 64 scores live in the 4 threads of its quad
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // o += bf16(p) v: the score tiles 2kk and 2kk+1 are, element for
    // element, the A fragment of keys kk*16 .. kk*16+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vb = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        if (n * 8 < p.D) {  // block-uniform
          const __nv_bfloat16* c = vb + n * 8;
          mma_bf16(o[n], a0, a1, a2, a3, pack_bf16(c[0], c[LD]),
                   pack_bf16(c[8 * LD], c[9 * LD]));
        }
      }
    }
  }

  // o = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30))
  const float lf0 = fmaxf(l0, 1e-30f), lf1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* orow0 = p.o + (static_cast<long long>(bh) * p.S + qrow0) * p.D;
  __nv_bfloat16* orow1 = orow0 + 8LL * p.D;
#pragma unroll
  for (int n = 0; n < NT_D; ++n) {
    const int col = n * 8 + t * 2;
    if (col < p.D) {
      *reinterpret_cast<__nv_bfloat162*>(orow0 + col) =
          __floats2bfloat162_rn(o[n][0] / lf0, o[n][1] / lf0);
      *reinterpret_cast<__nv_bfloat162*>(orow1 + col) =
          __floats2bfloat162_rn(o[n][2] / lf1, o[n][3] / lf1);
    }
  }
  if (t == 0) {
    p.lse[static_cast<long long>(bh) * p.S + qrow0] = m0 + logf(lf0);
    p.lse[static_cast<long long>(bh) * p.S + qrow1] = m1 + logf(lf1);
  }
}

// Which shapes and types the kernel takes (flash_common.cuh), for the
// launch and for flash_attention_smem_bytes (which the Python wrapper asks
// before it picks the kernel).  Returns the dynamic shared memory in bytes,
// or -1 with the reason in why (why may be null when why_len is 0).
int plan(int head_dim, int seq_len, int dtype_code, char* why, int why_len) {
  if (!shape_ok(head_dim, seq_len, dtype_code, why, why_len)) return -1;
  const int smem = smem_for(tile_width(head_dim));
  if (smem > SMEM_LIMIT) {
    snprintf(why, why_len, "flash attention needs %d KiB shared memory (budget %d KiB)",
             smem >> 10, SMEM_LIMIT >> 10);
    return -1;
  }
  return smem;
}

// per tile width (64, 128, 256) and device: the shared-memory opt-in is set
std::atomic<bool> g_smem_set[3][MAX_DEVICES];

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for this head dim, sequence
// length and dtype code (0 = bfloat16), or -1 with the reason in why.
int flash_attention_smem_bytes(int head_dim, int seq_len, int dtype_code, char* why,
                               int why_len) {
  return plan(head_dim, seq_len, dtype_code, why, why_len);
}

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  q [B,H,S,D],
// k/v [B,KV,S,D] bf16 with element strides[9] = (b, h, s) of q, k, v and
// unit stride along D, every row 16-byte aligned; o [B,H,S,D] bf16 and
// lse [B*H,S] f32, both contiguous.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int KV, int S, int D, int causal,
                               const long long* strides, void* stream) {
  const int smem = plan(D, S, DTYPE_BF16, nullptr, 0);
  if (smem < 0 || B < 1 || KV < 1 || H < KV || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  p.causal = causal ? 1 : 0;

  const int DT = tile_width(D);
  const int which = width_index(DT);
  void (*kernel)(const Params) =
      which == 0 ? flash_fwd_kernel<64> : (which == 1 ? flash_fwd_kernel<128> : flash_fwd_kernel<256>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[which][dev].load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[which][dev].store(true);
  }
  const dim3 grid(B * H, S / BQ);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
