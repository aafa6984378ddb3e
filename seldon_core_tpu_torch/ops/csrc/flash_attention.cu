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
// The softmax runs in base 2: t = s * (scale * log2 e) is one FMA folded
// into exp2(t - m2), and lse = m2 * ln 2 + log(l).  A masked score is
// stored as -1e30 / scale, so t is -1e30 * log2 e: -1e30 in natural units.
//
// Bound on an H100 SXM: at the served prefill (q [32,16,512,64], k/v
// [32,4,512,64], bf16) the call must move q, k, v, o and lse once (~85 MB,
// ~25 us at 3.35 TB/s) and do 4*B*H*D*S(S+1)/2 = 17.2 GFLOP (~17 us at
// 989 TFLOP/s), so it is bound by the bytes, with the products close
// behind; exp2 of every score on the SFUs (16 a clock per SM) is a third
// limit of the same size at D = 64.  The [S, S] scores never reach device
// memory, and the H/KV query heads that share a kv head read the same K/V,
// which therefore hit in the 50 MB L2 after the first.
//
// Design: persistent CTAs, one per SM, each walking its share of the work
// items (a query tile of one b*H + h), longest causal tiles first.  A CTA
// has 288 threads: two consumer warpgroups own 64 query rows each, and one
// producer warp keeps the loads in flight.  At DT = 128 and 256 an item is
// 64 rows and a CTA has one consumer warpgroup (160 threads): ptxas gives
// each of 288 threads at most 168 registers (it allots them by whole
// warpgroups), and the O accumulator (64 or 128 f32 a thread) beside S
// spilled there; setmaxnreg did not lift the limit for the consumers' code.
//   * Loads by TMA (cp.async.bulk.tensor, 4-d maps over [B, H|KV, S, D] by
//     the tensors' own strides, 128-byte swizzle).  A 128-byte swizzle row
//     holds 64 bf16 columns, so a tile of width DT (64, 128 or 256, the
//     smallest that holds D) is DT/64 boxes; columns D..DT-1 and rows past
//     S are filled with zeros by the TMA unit.  Q goes into one of two
//     buffers per item; K and V go through a ring of 3 stages (2 at DT >=
//     128, for room) with a full and an empty mbarrier each: the producer
//     waits for a stage (or Q buffer) to be empty, arms its full barrier
//     with the byte count and issues the boxes; the consumers wait for
//     full, compute, and arrive on empty (one arrival per warp).  The ring
//     and the Q buffers run on from one item to the next, so the next
//     item's loads overlap this one's products and epilogue.
//   * S = Q K^T by wgmma.mma_async m64nBKk16 with both operands read from
//     shared memory through descriptors (K-major, 128-byte swizzle); the
//     f32 accumulator layout is that of mma.sync m16n8 repeated over BK/8
//     column tiles, so the online softmax stays in registers, the row max
//     and sum reduced over the quad with shuffles, and the row sum kept per
//     thread until the end.  exp2 is the SFU's ex2.approx.ftz.
//   * O += P V by wgmma m64n64k16 per 64 output columns, with P converted
//     to bf16 in registers as the A operand (the S accumulator is, element
//     for element, the A fragment) and V read from shared memory as an
//     MN-major B operand through the transpose bit.
//   * The two consumer warpgroups take turns at issuing S = Q K^T (named
//     barriers), so one's product overlaps the other's softmax.
//   * Causal tiles above the diagonal are never loaded; only tiles that
//     cross a warpgroup's diagonal, or the sequence end, are masked.
//   * At DT = 64 the last query tile of a sequence whose length is 64 mod
//     128 is ragged: its second warpgroup has no rows, waits on the ring
//     and releases it without computing, and writes nothing.
// K/V tiles are BK = 128 rows for DT <= 128 and 64 rows at DT = 256, where
// the accumulators of O (128 f32 a thread) and S (32) fill the registers.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers); the
// tensor maps are encoded on the host through cudaGetDriverEntryPoint, so
// the library needs no -lcuda.  The shape rules and the Hopper pieces
// (mbarriers, TMA, wgmma descriptors and products, the tensor-map encoder)
// are shared with the backward kernels (flash_common.cuh).

#include "flash_common.cuh"

#include <atomic>
#include <cmath>

namespace {

using namespace flash;

struct Params {
  __nv_bfloat16* o;   // [B, H, S, D] contiguous
  float* lse;         // [B*H, S] contiguous
  int H, KV, S, D;
  float scale_log2;   // (1/sqrt(D)) * log2(e)
  float masked;       // -1e30 / (1/sqrt(D)): a masked score before scaling
  int causal;
  int n_items;        // query tiles: B * H * ceil(S / rows)
};

// K/V rows per tile at a tile width
__host__ __device__ constexpr int kv_rows(int DT) { return DT <= 128 ? 128 : 64; }
// consumer warpgroups (64 query rows each) per CTA at a tile width
__host__ __device__ constexpr int consumer_groups(int DT) { return DT == 64 ? 2 : 1; }
// query rows per CTA, and threads: the consumers and one producer warp
__host__ __device__ constexpr int q_rows(int DT) { return 64 * consumer_groups(DT); }
__host__ __device__ constexpr int fwd_threads(int DT) { return (4 * consumer_groups(DT) + 1) * 32; }
// K/V ring depth: three stages where they fit beside two Q buffers
__host__ __device__ constexpr int stages(int DT) { return DT == 64 ? 3 : 2; }

// bytes of shared memory: two Q buffers, stages x (K, V), 1024 for the
// swizzle alignment, and the mbarriers
inline int smem_for(int DT) {
  const int q = (DT / BOX_COLS) * q_rows(DT) * 128;
  const int kv = (DT / BOX_COLS) * kv_rows(DT) * 128;
  return 2 * q + stages(DT) * 2 * kv + 1024 + 8 * (4 + 2 * stages(DT));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BK == 128) wgmma_ss_n128(d, a, b, scale_d);
  else wgmma_ss_n64(d, a, b, scale_d);
}

// The shared-memory layout of one tile width, from a 1024-aligned base:
// two Q buffers, STAGES x (K tile, V tile), then the mbarriers q_full[2],
// q_empty[2], full[STAGES], empty[STAGES].  A tile is DT/64 boxes of rows x
// 128 bytes.
template <int DT>
struct Ring {
  static constexpr int NB = DT / BOX_COLS;   // 64-column boxes per row
  static constexpr int BK = kv_rows(DT);
  static constexpr int STAGES = stages(DT);
  static constexpr int ROWS = q_rows(DT);
  static constexpr int Q_BOX = ROWS * 128;
  static constexpr int KV_BOX = BK * 128;
  static constexpr int KV_BYTES = NB * KV_BOX;
  uint32_t base, bars;
  __device__ explicit Ring(uint32_t b) : base(b), bars(b + 2 * NB * Q_BOX + STAGES * 2 * KV_BYTES) {}
  __device__ uint32_t q(int i) const { return base + i * NB * Q_BOX; }
  __device__ uint32_t k(int s) const { return base + 2 * NB * Q_BOX + s * 2 * KV_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + KV_BYTES; }
  __device__ uint32_t q_full(int i) const { return bars + 8 * i; }
  __device__ uint32_t q_empty(int i) const { return bars + 16 + 8 * i; }
  __device__ uint32_t full(int s) const { return bars + 32 + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 32 + 8 * (STAGES + s); }
};

// One work item: a query tile of one (b, h).  Items run longest first (the
// causal tiles with the most K/V tiles), and CTA c takes items c, c + G,
// c + 2G, ... of the G CTAs.
struct Item {
  int bh, q0, n_kt;
};

template <int DT>
__device__ __forceinline__ Item item_at(const Params& p, int it) {
  constexpr int ROWS = q_rows(DT), BK = kv_rows(DT);
  const int n_q = (p.S + ROWS - 1) / ROWS;
  const int BH = p.n_items / n_q;
  Item x;
  x.bh = it % BH;
  x.q0 = (n_q - 1 - it / BH) * ROWS;
  // K/V tiles: causal query rows q0.. need keys 0..their last row
  x.n_kt = p.causal ? (min(x.q0 + ROWS, p.S) - 1) / BK + 1 : (p.S + BK - 1) / BK;
  return x;
}


// The consumer warpgroups' part of one item: the walk over its K/V tiles in
// the ring (from ring position kc on), and the epilogue.
template <int DT>
__device__ __forceinline__ void consume(const Params& p, const Ring<DT>& r, const Item& x,
                                        int qb, int kc, int warp, int lane) {
  constexpr int NB = Ring<DT>::NB;
  constexpr int BK = Ring<DT>::BK;
  constexpr int STAGES = Ring<DT>::STAGES;
  constexpr bool TURNS = consumer_groups(DT) == 2;
  const int wg = warp >> 2;     // 64 rows each
  const int wi = warp & 3;      // 16 rows each within the warpgroup
  const int g = lane >> 2;      // row within the 8-row half of a fragment
  const int t = lane & 3;       // column pair within a fragment
  const int q0w = x.q0 + wg * 64;
  const int row0 = q0w + wi * 16 + g;  // the thread's two query rows
  const int row1 = row0 + 8;
  // K/V tiles this warpgroup computes on (it waits on and releases all n_kt)
  const int n_kt_w = q0w >= p.S ? 0 : (p.causal ? min(x.n_kt, (q0w + 63) / BK + 1) : x.n_kt);

  float o[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  // running max in base-2 units (t = s * scale * log2 e), masked level to start
  float m0 = NEG_INF * LOG2E, m1 = NEG_INF * LOG2E;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums
  const float sl2 = p.scale_log2;
  const uint32_t sq = r.q(qb) + wg * 64 * 128;

  for (int kt = 0; kt < x.n_kt; ++kt, ++kc) {
    const int s = kc % STAGES;
    mbar_wait(r.full(s), (kc / STAGES) & 1);
    if (TURNS) turn_wait(wg);
    if (kt < n_kt_w) {
      const int k0 = kt * BK;

      // S = Q K^T, 16 columns of D at a time; the padded depth past D is zeros
      float sc[BK / 2];
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes of a row
        wgmma_qk<BK>(sc, sw128_desc(sq + (kk / 4) * Ring<DT>::Q_BOX + off, 16, 1024),
                     sw128_desc(r.k(s) + (kk / 4) * Ring<DT>::KV_BOX + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (TURNS) turn_pass(wg);
      wgmma_wait_all();
      pin(sc);

      // element 4j+e sits at row (e < 2 ? row0 : row1), key k0 + 8j + 2t + (e & 1)
      const bool edge = (p.causal && k0 + BK - 1 > q0w) || k0 + BK > p.S;
      if (edge) {
        // the last key a row may see (its own position when causal; the
        // sequence end), as a column offset past this thread's pair 2t
        const int lim0 = (p.causal ? row0 : p.S - 1) - k0 - 2 * t;
        const int lim1 = (p.causal ? row1 : p.S - 1) - k0 - 2 * t;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * 8 + (e & 1) > (e < 2 ? lim0 : lim1)) sc[4 * j + e] = p.masked;
        }
      }
      float mx0 = sc[0], mx1 = sc[2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      // a row's scores live in the 4 threads of its quad
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      const float alpha0 = exp2_approx(m0 - mn0), alpha1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // p = exp2(s * scale * log2 e - m), one FMA and one exp2 a score,
      // packed to bf16 pairs: the score tiles 2kk and 2kk+1 are, element
      // for element, the A fragment of keys kk*16 .. kk*16+15
      uint32_t pa[BK / 4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = exp2_approx(fmaf(sc[4 * j], sl2, -mn0));
        const float p1 = exp2_approx(fmaf(sc[4 * j + 1], sl2, -mn0));
        const float p2 = exp2_approx(fmaf(sc[4 * j + 2], sl2, -mn1));
        const float p3 = exp2_approx(fmaf(sc[4 * j + 3], sl2, -mn1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[2 * j] = pack_f32(p0, p1);
        pa[2 * j + 1] = pack_f32(p2, p3);
      }
      l0 = fmaf(alpha0, l0, sum0);
      l1 = fmaf(alpha1, l1, sum1);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[n][4 * j] *= alpha0;
          o[n][4 * j + 1] *= alpha0;
          o[n][4 * j + 2] *= alpha1;
          o[n][4 * j + 3] *= alpha1;
        }
      }

      // O += bf16(P) V, 64 output columns per product; V box n, keys
      // kk*16..: 16 rows of 128 bytes, 8-row groups 1024 bytes apart
      pin(pa);
#pragma unroll
      for (int n = 0; n < NB; ++n) pin(o[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
          wgmma_rs_n64(o[n], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                       sw128_desc(r.v(s) + n * Ring<DT>::KV_BOX + kk * 16 * 128,
                                  Ring<DT>::KV_BOX, 1024),
                       1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(pa);
#pragma unroll
      for (int n = 0; n < NB; ++n) pin(o[n]);
    } else if (TURNS) {
      turn_pass(wg);  // no product here, but the turn moves on
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty(s));  // the stage may be loaded again
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(r.q_empty(qb));  // the Q buffer may be loaded again
  if (n_kt_w == 0) return;

  // o = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30)) in natural units
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float lf0 = fmaxf(l0, 1e-30f), lf1 = fmaxf(l1, 1e-30f);
  const long long bh = x.bh;
  __nv_bfloat16* orow0 = p.o + (bh * p.S + row0) * p.D;
  __nv_bfloat16* orow1 = orow0 + 8LL * p.D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n * BOX_COLS + j * 8 + t * 2;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(orow0 + col) =
            __floats2bfloat162_rn(o[n][4 * j] / lf0, o[n][4 * j + 1] / lf0);
        *reinterpret_cast<__nv_bfloat162*>(orow1 + col) =
            __floats2bfloat162_rn(o[n][4 * j + 2] / lf1, o[n][4 * j + 3] / lf1);
      }
    }
  }
  if (t == 0) {
    p.lse[bh * p.S + row0] = m0 * LN2 + logf(lf0);
    p.lse[bh * p.S + row1] = m1 * LN2 + logf(lf1);
  }
}

// A persistent CTA: it walks its items with the K/V ring and the two Q
// buffers running on across them, so the loads of the next item overlap the
// products and the epilogue of this one.
template <int DT>
__global__ void __launch_bounds__(fwd_threads(DT), 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using R = Ring<DT>;
  constexpr int n_consumer_warps = 4 * consumer_groups(DT);
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: every box starts on a multiple
  const R r((smem_u32(smem_raw) + 1023) & ~1023u);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(r.q_full(i), 1);
      mbar_init(r.q_empty(i), n_consumer_warps);
    }
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), n_consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int kc = 0;  // K/V tiles through the ring so far
  int li = 0;  // this CTA's items so far: item li uses Q buffer li & 1
  if (warp == n_consumer_warps) {  // the producer warp: one lane issues every load
    if (lane != 0) return;
    for (int it = blockIdx.x; it < p.n_items; it += gridDim.x, ++li) {
      const Item x = item_at<DT>(p, it);
      const int b = x.bh / p.H;
      const int h = x.bh - b * p.H;
      const int kvh = h / (p.H / p.KV);
      const int qb = li & 1;
      if (li >= 2) mbar_wait(r.q_empty(qb), ((li >> 1) - 1) & 1);
      mbar_expect_tx(r.q_full(qb), R::NB * R::Q_BOX);
      for (int c = 0; c < R::NB; ++c)
        tma_load(r.q(qb) + c * R::Q_BOX, &tq, r.q_full(qb), c * BOX_COLS, x.q0, h, b);
      for (int kt = 0; kt < x.n_kt; ++kt, ++kc) {
        const int s = kc % R::STAGES;
        if (kc >= R::STAGES) mbar_wait(r.empty(s), (kc / R::STAGES - 1) & 1);
        mbar_expect_tx(r.full(s), 2 * R::KV_BYTES);
        for (int c = 0; c < R::NB; ++c) {
          tma_load(r.k(s) + c * R::KV_BOX, &tk, r.full(s), c * BOX_COLS, kt * R::BK, kvh, b);
          tma_load(r.v(s) + c * R::KV_BOX, &tv, r.full(s), c * BOX_COLS, kt * R::BK, kvh, b);
        }
      }
    }
  } else {
    if (consumer_groups(DT) == 2 && warp >= 4) turn_pass(1);  // warpgroup 0 goes first
    for (int it = blockIdx.x; it < p.n_items; it += gridDim.x, ++li) {
      const Item x = item_at<DT>(p, it);
      mbar_wait(r.q_full(li & 1), (li >> 1) & 1);
      consume<DT>(p, r, x, li & 1, kc, warp, lane);
      kc += x.n_kt;
    }
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
// per device: its SM count (0 until asked), the persistent grid's size
std::atomic<int> g_sms[MAX_DEVICES];

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
// unit stride along D, every base 16-byte aligned and every stride of a
// dimension longer than 1 a multiple of 8 elements (TMA's rules); o
// [B,H,S,D] bf16 and lse [B*H,S] f32, both contiguous.  A tensor map that
// cannot be encoded answers cudaErrorInvalidValue.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int KV, int S, int D, int causal,
                               const long long* strides, void* stream) {
  const int smem = plan(D, S, DTYPE_BF16, nullptr, 0);
  if (smem < 0 || B < 1 || KV < 1 || H < KV || H % KV != 0) return (int)cudaErrorInvalidValue;
  const int DT = tile_width(D);
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, H, S, D, strides, 64 * consumer_groups(DT)) ||
      !encode(&tk, k, B, KV, S, D, strides + 3, kv_rows(DT)) ||
      !encode(&tv, v, B, KV, S, D, strides + 6, kv_rows(DT)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.D = D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  p.scale_log2 = scale * LOG2E;
  p.masked = NEG_INF / scale;
  p.causal = causal ? 1 : 0;
  const int rows = 64 * consumer_groups(DT);
  p.n_items = B * H * ((S + rows - 1) / rows);

  const int which = width_index(DT);
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const Params) =
      which == 0 ? flash_fwd_kernel<64>
                 : (which == 1 ? flash_fwd_kernel<128> : flash_fwd_kernel<256>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[which][dev].load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[which][dev].store(true);
  }
  int sms = g_sms[dev].load();
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    g_sms[dev].store(sms);
  }
  // one CTA per SM (each takes the SM's registers), never more than items
  const int grid = p.n_items < sms ? p.n_items : sms;
  kernel<<<grid, (4 * consumer_groups(DT) + 1) * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
