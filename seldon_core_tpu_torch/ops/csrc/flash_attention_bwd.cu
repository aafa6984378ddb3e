// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// o = softmax(q k^T / sqrt(D)) v, from the forward's o and per-row
// log-sum-exp.
//
// Replaces the two Pallas TPU kernels of seldon_core_tpu/ops/flash_attention.py
// (_bwd_impl :303): _bwd_dq_kernel (:208, pallas_call :331) and
// _bwd_dkv_kernel (:252, pallas_call :349), and computes what they compute,
// rounding where they round:
//   * s = (q.k) * (1/sqrt(D)) in f32 from bf16 products; causal masking by
//     global position with -1e30; p = exp(s - lse) in f32, lse the
//     forward's [B*H, S] f32 rows;
//   * dp = dO.v^T in f32; ds = p * (dp - dsum) in f32, dsum = rowsum(dO*o)
//     in f32 (on the TPU XLA computes it outside the kernels, :316-319;
//     here the dQ pass does, see below);
//   * dV = sum over query tiles of bf16(p)^T dO; dK = sum of bf16(ds)^T q,
//     times scale; dQ = sum over key tiles of bf16(ds) k, times scale; all
//     three f32 sums cast to bf16 at the end.  The scale multiplies each
//     f32 sum once, after the products, where the TPU kernels multiply
//     each tile's product: the two differ by f32 rounding only.
// p is exp2(s * scale * log2 e - lse * log2 e): one FMA and the SFU's
// ex2.approx, as in the forward; a masked score gives p = 0, as
// exp(-1e30 - lse) does.
//
// Grouped-query attention: the JAX package repeats K/V over the group,
// runs the MHA kernels, rounds each query head's dK/dV to bf16 and sums the
// group (_flash_bwd :397-413).  Here a dK/dV item belongs to one kv head
// and walks the query tiles of all H/KV query heads that read it, summing
// their contributions in one f32 accumulator and writing dK/dV once.  That
// reads K/V at their stored size and keeps the repeated [B, H, S, D] copies
// out of device memory; it rounds once where the reference rounds H/KV + 1
// times, so it differs from the plain version by up to about a bf16 ulp of
// the sum (chip_smoke.py states the tolerance).
//
// Bound on an H100 SXM, at the training layer (q [16,16,512,64], k/v
// [16,4,512,64], bf16, causal): dQ must read q, k, v, dO, o and lse and
// write dq and dsum once (~77 MB, ~23 us at 3.35 TB/s) and do 3 products
// over the causal pairs (12.9 GFLOP, ~13 us at 989 TFLOP/s), so it is bound
// by the bytes; dK/dV moves ~51 MB (~15 us) and does 4 products (17.2
// GFLOP, ~17 us), so it is bound by the operations.  At (4,16,4,2048,64)
// both are bound by the operations: dQ 51.6 GFLOP (~52 us), dK/dV 68.8
// GFLOP (~70 us).
//
// Design.  Two passes, one kernel each, as on the TPU: no atomics, so the
// result is deterministic (FA3's single pass sums dQ with atomics; partial
// dQ sums in scratch would move 8-32x dQ's bytes in f32).  Both kernels
// have the forward's shape (flash_attention.cu):
//   * Persistent CTAs (one per SM; two for dK/dV at DT = 64), each walking
//     its share of the work items, longest first, taken in a snake (CTA c
//     takes the c-th item of even rounds and the (G-1-c)-th of odd
//     rounds), so the CTA with a round's longest item has the next round's
//     shortest.  A dQ item is a query tile of one (b, h), the last tile
//     (the most key tiles) first; a dK/dV item a 64-row key tile of one
//     (b, kv head), tile 0 (the most query tiles, times the group) first.
//     Causal items differ in length (at (4,16,4,2048,64) a dK/dV item
//     walks 4 to 128 query tiles); this order keeps the last wave from
//     being one long item: there no CTA walks more than 128 tile steps,
//     the mean.
//   * A CTA holds its item's "own" tiles (dQ: Q, dO and o; dK/dV: K and V)
//     in two buffers (one at DT = 256, for room) and streams the other side
//     (dQ: K and V; dK/dV: Q, dO and the lse and dsum rows) through an
//     mbarrier ring of 64-row stages, all loaded by one producer warp: TMA
//     tensor maps over the tensors' own strides (4-d, 128-byte swizzle,
//     columns past D and rows past S filled with zeros) and cp.async.bulk
//     for the f32 rows.  The ring and the own buffers run on across items,
//     so the next item's loads overlap this one's products and epilogue,
//     and no thread spends an instruction on a load.
//   * Every product is wgmma m64n64k16 with bf16 operands and f32 sums,
//     the B operand read by the tensor cores from the swizzled tiles:
//       dQ item, per consumer warpgroup of 64 query rows, per key tile:
//         S = Q K^T and dP = dO V^T (A and B from shared memory, K-major);
//         dS = P (dP - dsum) built in registers, which are, element for
//         element, the A fragment of the next product;
//         dQ += bf16(dS) K (A from registers, K as an MN-major B through
//         the transpose bit, as the forward's V in P V).
//       dK/dV item, per consumer warpgroup of 64 key rows, per query tile:
//         S^T = K Q^T and dP^T = V dO^T (the same form, roles swapped);
//         dV += bf16(P^T) dO and dK += bf16(dS^T) Q (registers times
//         MN-major B).
//     Nothing is transposed in memory.
//   * dsum is made in the dQ pass: its item holds the dO and o tiles of
//     its query rows, so each thread sums dO*o over a quarter of its two
//     rows (the two tiles share one swizzle, so a chunk of one lines up
//     with the same chunk of the other), the quad adds the quarters, and
//     the sums are used for dS and written to a [B*H, S] f32 buffer that
//     the dK/dV pass, launched next on the same stream, reads.  The whole
//     backward is two launches.
//   * Causal tiles past the diagonal are never loaded; the diagonal tile
//     is masked by a column limit.  A dQ warpgroup whose rows lie past S
//     (the ragged last item at S = 64 mod 128), or whose tile is wholly
//     masked, waits on the ring and releases it without computing.
//   * Widths.  dQ at DT = 64: two consumer warpgroups (64 query rows each)
//     and a producer warp, 288 threads, at most 168 registers a thread;
//     the warpgroups take turns at issuing S and dP (the forward's named
//     barriers), so one's products run while the other builds dS.  dK/dV
//     at DT = 64: one consumer warpgroup and a producer warp (160
//     threads), two CTAs per SM, which ptxas also caps at 168 registers;
//     two independent CTAs ran faster than two warpgroups sharing one
//     ring.  At DT = 128 and 256 both kernels run one consumer warpgroup,
//     one CTA per SM, up to 255 registers; at DT = 256 the dK/dV item
//     walks its query tiles twice, dV on the first walk and dK on the
//     second, with one [64, 256] f32 accumulator.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a): dQ <64> 140 registers, <128> 188,
// <256> 230; dK/dV <64> 168 (32 bytes of spill stores and loads), <128>
// 255, <256> 242; no other spills.  The dK/dV item keeps two [64, DT] f32
// accumulators (dK and dV) beside the S^T and dP^T accumulators, which is
// what fills the registers.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include "flash_common.cuh"

#include <atomic>
#include <cmath>

namespace {

using namespace flash;

constexpr int TILE = 64;  // rows of a streamed tile and of a warpgroup's own rows

struct Params {
  const float* lse;    // [B*H, S] contiguous
  float* dsum;         // [B*H, S] contiguous: written by dQ, read by dK/dV
  __nv_bfloat16* dq;   // [B, H, S, D] contiguous
  __nv_bfloat16* dk;   // [B, KV, S, D] contiguous
  __nv_bfloat16* dv;   // [B, KV, S, D] contiguous
  int H, KV, S, D;
  float scale;         // 1/sqrt(D)
  float scale_log2;    // scale * log2(e)
  int causal;
  int n_items;
};

// For kernel K (0 dQ, 1 dK/dV) at a tile width: consumer warpgroups per
// CTA (dK/dV always has one), CTAs per SM, own rows per item, threads
// (consumers and one producer warp); then own buffers and ring stages
__host__ __device__ constexpr int groups(int K, int DT) { return DT == 64 && K == 0 ? 2 : 1; }
__host__ __device__ constexpr int ctas_per_sm(int K, int DT) { return DT == 64 && K == 1 ? 2 : 1; }
__host__ __device__ constexpr int own_rows(int K, int DT) { return TILE * groups(K, DT); }
__host__ __device__ constexpr int threads(int K, int DT) { return (4 * groups(K, DT) + 1) * 32; }
__host__ __device__ constexpr int own_bufs(int DT) { return DT == 256 ? 1 : 2; }
__host__ __device__ constexpr int stages(int DT) { return DT == 64 ? 4 : (DT == 128 ? 3 : 2); }
// dK/dV walks over the query tiles: dV and dK together, or one after the other
__host__ __device__ constexpr int dkv_walks(int DT) { return DT == 256 ? 2 : 1; }

// The shared-memory layout of one kernel at one tile width, from a
// 1024-aligned base: NOWN own buffers of OWN_T tiles (own_rows rows each),
// STAGES ring stages of ST_T tiles (64 rows each), with ROWS_F32 the lse
// and dsum rows of each stage, then the mbarriers own_full[NOWN],
// own_empty[NOWN], full[STAGES], empty[STAGES].  A tile is DT/64 boxes of
// rows x 128 bytes.
template <int K, int DT, int OWN_T, int ST_T, bool ROWS_F32>
struct Layout {
  static constexpr int NB = DT / BOX_COLS;
  static constexpr int OWN_BOX = own_rows(K, DT) * 128;
  static constexpr int ST_BOX = TILE * 128;
  static constexpr int OWN_TILE = NB * OWN_BOX;
  static constexpr int ST_TILE = NB * ST_BOX;
  static constexpr int NOWN = own_bufs(DT);
  static constexpr int STAGES = stages(DT);
  static constexpr int OWN_BYTES = NOWN * OWN_T * OWN_TILE;
  static constexpr int ST_BYTES = STAGES * ST_T * ST_TILE;
  static constexpr int F32_BYTES = ROWS_F32 ? STAGES * 2 * TILE * 4 : 0;
  static constexpr int SMEM = OWN_BYTES + ST_BYTES + F32_BYTES + 16 * (NOWN + STAGES) + 1024;
  uint32_t base;
  __device__ explicit Layout(uint32_t b) : base(b) {}
  __device__ uint32_t own(int i, int t) const { return base + (i * OWN_T + t) * OWN_TILE; }
  __device__ uint32_t st(int s, int t) const {
    return base + OWN_BYTES + (s * ST_T + t) * ST_TILE;
  }
  __device__ uint32_t lse(int s) const { return base + OWN_BYTES + ST_BYTES + s * 2 * TILE * 4; }
  __device__ uint32_t dsum(int s) const { return lse(s) + TILE * 4; }
  __device__ uint32_t bar(int i) const { return base + OWN_BYTES + ST_BYTES + F32_BYTES + 8 * i; }
  __device__ uint32_t own_full(int i) const { return bar(i); }
  __device__ uint32_t own_empty(int i) const { return bar(NOWN + i); }
  __device__ uint32_t full(int s) const { return bar(2 * NOWN + s); }
  __device__ uint32_t empty(int s) const { return bar(2 * NOWN + STAGES + s); }
};
// dQ: own (Q, dO, o), stages (K, V); dK/dV: own (K, V), stages (Q, dO, lse, dsum)
template <int DT>
using DqLayout = Layout<0, DT, 3, 2, false>;
template <int DT>
using DkvLayout = Layout<1, DT, 2, 2, true>;

// the dynamic shared memory of the dQ (0) or dK/dV (1) kernel at a tile width
inline int smem_for(int which_kernel, int DT) {
  if (which_kernel == 0)
    return DT == 64 ? DqLayout<64>::SMEM : (DT == 128 ? DqLayout<128>::SMEM : DqLayout<256>::SMEM);
  return DT == 64 ? DkvLayout<64>::SMEM : (DT == 128 ? DkvLayout<128>::SMEM : DkvLayout<256>::SMEM);
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// acc + the f32 dot product of eight bf16 pairs (a bf16 product is exact
// in f32, so each FMA rounds only the sum)
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// The item a CTA takes in round r: items run longest first, and the CTAs
// take them in a snake, so the CTA with one round's longest item has the
// next round's shortest.
__device__ __forceinline__ int item_of(int r) {
  const int G = gridDim.x;
  return r * G + ((r & 1) ? G - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x));
}

// A dQ item: own_rows query rows from q0 of one b*H + h, walking key tiles
// 0..n_kt-1; the last query tiles (the most key tiles) first.
struct DqItem {
  int bh, q0, n_kt;
};

template <int DT>
__device__ __forceinline__ DqItem dq_item(const Params& p, int it) {
  constexpr int ROWS = own_rows(0, DT);
  const int n_q = (p.S + ROWS - 1) / ROWS;
  const int BH = p.n_items / n_q;
  DqItem x;
  x.bh = it % BH;
  x.q0 = (n_q - 1 - it / BH) * ROWS;
  x.n_kt = (p.causal ? min(x.q0 + ROWS, p.S) : p.S) / TILE;
  return x;
}

// A dK/dV item: own_rows key rows from k0 of one b*KV + kv head, walking
// query tiles qt0..n_qt-1 of each of the group's query heads (twice at
// DT = 256); key tile 0 (the most query tiles) first.
struct DkvItem {
  int bkv, k0, qt0, n_qt;
};

template <int DT>
__device__ __forceinline__ DkvItem dkv_item(const Params& p, int it) {
  constexpr int ROWS = own_rows(1, DT);
  const int n_k = (p.S + ROWS - 1) / ROWS;
  const int BKV = p.n_items / n_k;
  DkvItem x;
  x.bkv = it % BKV;
  x.k0 = (it / BKV) * ROWS;
  x.n_qt = p.S / TILE;
  x.qt0 = p.causal ? x.k0 / TILE : 0;
  return x;
}

template <int DT>
__device__ __forceinline__ int dkv_steps(const Params& p, const DkvItem& x) {
  return dkv_walks(DT) * (p.H / p.KV) * (x.n_qt - x.qt0);
}

// acc * scale as bf16 into rows row and row + 8 of a contiguous [., D]
// output: element 4j+e of box n sits at row (e < 2 ? row : row + 8), column
// 64n + 8j + 2t + (e & 1)
template <int NB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row, int D, int t,
                                           const float (&acc)[NB][32], float scale) {
  __nv_bfloat16* r0 = out + row * D;
  __nv_bfloat16* r1 = r0 + 8LL * D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n * BOX_COLS + j * 8 + t * 2;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(r0 + col) =
            __floats2bfloat162_rn(acc[n][4 * j] * scale, acc[n][4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(r1 + col) =
            __floats2bfloat162_rn(acc[n][4 * j + 2] * scale, acc[n][4 * j + 3] * scale);
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][32]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
}

// d (+)= A(64 rows at a) . B(64 rows at b)^T over DT columns: both tiles
// K-major in 64-column boxes of a_box and b_box bytes; the padded depth
// past D is zeros
template <int DT>
__device__ __forceinline__ void rows_by_rows(float (&d)[32], uint32_t a, int a_box, uint32_t b,
                                             int b_box) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes of a row
    wgmma_ss_n64(d, sw128_desc(a + (kk / 4) * a_box + off, 16, 1024),
                 sw128_desc(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
}

// acc[n] += A(64 x 64, registers: x[4kk..4kk+3] the 16-deep step kk) .
// B(the 64-row streamed tile at b, rows as the depth: MN-major), 64 output
// columns per box n
template <int NB>
__device__ __forceinline__ void regs_by_tile(float (&acc)[NB][32], const uint32_t (&x)[16],
                                             uint32_t b) {
  constexpr int BOX = TILE * 128;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
      wgmma_rs_n64(acc[n], x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3],
                   sw128_desc(b + n * BOX + kk * 16 * 128, BOX, 1024), 1);
  }
}

// ---------------------------------------------------------------- dQ ----

// The consumer warpgroups' part of one dQ item: dsum of its rows, the walk
// over its key tiles in the ring (from ring position kc on), the epilogue.
template <int DT>
__device__ __forceinline__ void dq_consume(const Params& p, const DqLayout<DT>& l,
                                           const DqItem& x, int ob, int kc, int warp, int lane) {
  using L = DqLayout<DT>;
  constexpr int NB = L::NB;
  constexpr bool TURNS = groups(0, DT) == 2;
  const int wg = warp >> 2;        // 64 rows each
  const int g = lane >> 2;         // row within the 8-row half of a fragment
  const int t = lane & 3;          // column pair within a fragment
  const int r0 = (warp & 3) * 16 + g;  // the thread's rows in the warpgroup: r0, r0 + 8
  const int q0w = x.q0 + wg * TILE;
  const bool active = q0w < p.S;
  // key tiles this warpgroup computes on (it waits on and releases all n_kt)
  const int n_kt_w = !active ? 0 : (p.causal ? q0w / TILE + 1 : x.n_kt);
  const uint32_t qa = l.own(ob, 0) + wg * TILE * 128;  // the warpgroup's rows of each box
  const uint32_t da = l.own(ob, 1) + wg * TILE * 128;
  const long long rows = static_cast<long long>(x.bh) * p.S + q0w;

  // dsum = rowsum(dO * o) in f32: a quarter of each row per thread, two
  // 16-byte chunks a box, then the quad's sum
  float dsum0 = 0.f, dsum1 = 0.f, lse0 = 0.f, lse1 = 0.f;
  if (active) {
    const uint32_t oa = l.own(ob, 2) + wg * TILE * 128;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = c * L::OWN_BOX + r0 * 128 + (2 * t + h) * 16;
        dsum0 = dot8(ld_shared_v4(da + off), ld_shared_v4(oa + off), dsum0);
        dsum1 = dot8(ld_shared_v4(da + off + 8 * 128), ld_shared_v4(oa + off + 8 * 128), dsum1);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, off);
      dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, off);
    }
    if (t == 0) {
      p.dsum[rows + r0] = dsum0;
      p.dsum[rows + r0 + 8] = dsum1;
    }
    lse0 = p.lse[rows + r0] * LOG2E;
    lse1 = p.lse[rows + r0 + 8] * LOG2E;
  }

  float acc[NB][32];
  zero(acc);
  const float sl2 = p.scale_log2;
  // on the diagonal tile a key column 8j + 2t + (e & 1) past the row is masked
  const int lim0 = r0 - 2 * t, lim1 = lim0 + 8;
  for (int kt = 0; kt < x.n_kt; ++kt, ++kc) {
    const int s = kc % L::STAGES;
    mbar_wait(l.full(s), (kc / L::STAGES) & 1);
    if (TURNS) turn_wait(wg);
    if (kt < n_kt_w) {
      const uint32_t ks = l.st(s, 0), vs = l.st(s, 1);
      float sc[32], dp[32];
      pin(sc);
      pin(dp);
      wgmma_fence();
      rows_by_rows<DT>(sc, qa, L::OWN_BOX, ks, L::ST_BOX);   // S = Q K^T
      rows_by_rows<DT>(dp, da, L::OWN_BOX, vs, L::ST_BOX);   // dP = dO V^T
      wgmma_commit();
      if (TURNS) turn_pass(wg);
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      // ds = p (dp - dsum), p = exp2(s scale log2 e - lse log2 e), packed to
      // bf16 pairs: the score tiles 2kk and 2kk+1 are, element for element,
      // the A fragment of keys 16kk .. 16kk+15
      const bool diag = p.causal && kt * TILE == q0w;
      uint32_t dsb[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2_approx(fmaf(sc[4 * j + e], sl2, e < 2 ? -lse0 : -lse1));
          if (diag && 8 * j + (e & 1) > (e < 2 ? lim0 : lim1)) pe = 0.f;
          v[e] = pe * (dp[4 * j + e] - (e < 2 ? dsum0 : dsum1));
        }
        dsb[2 * j] = pack_f32(v[0], v[1]);
        dsb[2 * j + 1] = pack_f32(v[2], v[3]);
      }

      // dQ += bf16(dS) K, K as an MN-major B
      pin(dsb);
#pragma unroll
      for (int n = 0; n < NB; ++n) pin(acc[n]);
      wgmma_fence();
      regs_by_tile(acc, dsb, ks);
      wgmma_commit();
      wgmma_wait_all();
      pin(dsb);
#pragma unroll
      for (int n = 0; n < NB; ++n) pin(acc[n]);
    } else if (TURNS) {
      turn_pass(wg);  // no product here, but the turn moves on
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(l.empty(s));  // the stage may be loaded again
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(l.own_empty(ob));  // the own buffer may be loaded again
  if (active) store_rows(p.dq, rows + r0, p.D, t, acc, p.scale);
}

template <int DT>
__global__ void __launch_bounds__(threads(0, DT), 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap to, const Params p) {
  using L = DqLayout<DT>;
  constexpr int n_consumer_warps = 4 * groups(0, DT);
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: every box starts on a multiple
  const L l((smem_u32(smem_raw) + 1023) & ~1023u);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::NOWN; ++i) {
      mbar_init(l.own_full(i), 1);
      mbar_init(l.own_empty(i), n_consumer_warps);
    }
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(l.full(s), 1);
      mbar_init(l.empty(s), n_consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int kc = 0;  // key tiles through the ring so far
  int li = 0;  // this CTA's items so far: item li uses own buffer li % NOWN
  if (warp == n_consumer_warps) {  // the producer warp: one lane issues every load
    if (lane != 0) return;
    const int group = p.H / p.KV;
    for (int r = 0; r * static_cast<int>(gridDim.x) < p.n_items; ++r) {
      const int it = item_of(r);
      if (it >= p.n_items) continue;
      const DqItem x = dq_item<DT>(p, it);
      const int b = x.bh / p.H;
      const int h = x.bh - b * p.H;
      const int kvh = h / group;
      const int ob = li % L::NOWN;
      if (li >= L::NOWN) mbar_wait(l.own_empty(ob), (li / L::NOWN - 1) & 1);
      mbar_expect_tx(l.own_full(ob), 3 * L::OWN_TILE);
      for (int c = 0; c < L::NB; ++c) {
        const uint32_t box = c * L::OWN_BOX;
        tma_load(l.own(ob, 0) + box, &tq, l.own_full(ob), c * BOX_COLS, x.q0, h, b);
        tma_load(l.own(ob, 1) + box, &tdo, l.own_full(ob), c * BOX_COLS, x.q0, h, b);
        tma_load(l.own(ob, 2) + box, &to, l.own_full(ob), c * BOX_COLS, x.q0, h, b);
      }
      for (int kt = 0; kt < x.n_kt; ++kt, ++kc) {
        const int s = kc % L::STAGES;
        if (kc >= L::STAGES) mbar_wait(l.empty(s), (kc / L::STAGES - 1) & 1);
        mbar_expect_tx(l.full(s), 2 * L::ST_TILE);
        for (int c = 0; c < L::NB; ++c) {
          tma_load(l.st(s, 0) + c * L::ST_BOX, &tk, l.full(s), c * BOX_COLS, kt * TILE, kvh, b);
          tma_load(l.st(s, 1) + c * L::ST_BOX, &tv, l.full(s), c * BOX_COLS, kt * TILE, kvh, b);
        }
      }
      ++li;
    }
  } else {
    if (groups(0, DT) == 2 && warp >= 4) turn_pass(1);  // warpgroup 0 goes first
    for (int r = 0; r * static_cast<int>(gridDim.x) < p.n_items; ++r) {
      const int it = item_of(r);
      if (it >= p.n_items) continue;
      const DqItem x = dq_item<DT>(p, it);
      const int ob = li % L::NOWN;
      mbar_wait(l.own_full(ob), (li / L::NOWN) & 1);
      dq_consume<DT>(p, l, x, ob, kc, warp, lane);
      kc += x.n_kt;
      ++li;
    }
  }
}

// -------------------------------------------------------------- dK/dV ----

// One walk of a dK/dV item (64 key rows, one consumer warpgroup) over the
// query tiles of its group's heads, from ring position kc on: dV +=
// bf16(P^T) dO when DV, dK += bf16(dS^T) Q when DK (unscaled).
template <int DT, bool DV, bool DK>
__device__ __forceinline__ void dkv_walk(const Params& p, const DkvLayout<DT>& l,
                                         const DkvItem& x, int ob, int& kc, int warp, int lane,
                                         float (&acc_v)[DT / BOX_COLS][32],
                                         float (&acc_k)[DT / BOX_COLS][32]) {
  using L = DkvLayout<DT>;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // key rows r0, r0 + 8 of the item
  const uint32_t ka = l.own(ob, 0);
  const uint32_t va = l.own(ob, 1);
  const float sl2 = p.scale_log2;
  // on the diagonal tile a query column 8j + 2t + (e & 1) before the key is masked
  const int lim0 = r0 - 2 * t, lim1 = lim0 + 8;
  const int group = p.H / p.KV;
  for (int hg = 0; hg < group; ++hg) {
    for (int qt = x.qt0; qt < x.n_qt; ++qt, ++kc) {
      const int s = kc % L::STAGES;
      mbar_wait(l.full(s), (kc / L::STAGES) & 1);
      // (causal: the walk starts at the item's diagonal tile qt0, so no
      // tile is wholly masked)
      const uint32_t qs = l.st(s, 0), dos = l.st(s, 1);
      float sc[32], dp[32];
      pin(sc);
      if constexpr (DK) pin(dp);
      wgmma_fence();
      rows_by_rows<DT>(sc, ka, L::OWN_BOX, qs, L::ST_BOX);                  // S^T = K Q^T
      if constexpr (DK) rows_by_rows<DT>(dp, va, L::OWN_BOX, dos, L::ST_BOX);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      if constexpr (DK) pin(dp);

      // element 4j+e: key row r0 + 8 (e >= 2), query column 8j + 2t + (e & 1)
      const bool diag = p.causal && qt * TILE == x.k0;
      uint32_t pb[16], dsb[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lse = ld_shared_f2(l.lse(s) + (8 * j + 2 * t) * 4);
        float2 dsum = make_float2(0.f, 0.f);
        if constexpr (DK) dsum = ld_shared_f2(l.dsum(s) + (8 * j + 2 * t) * 4);
        float pv[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2_approx(fmaf(sc[4 * j + e], sl2, -((e & 1) ? lse.y : lse.x) * LOG2E));
          if (diag && 8 * j + (e & 1) < (e < 2 ? lim0 : lim1)) pe = 0.f;
          pv[e] = pe;
          if constexpr (DK) dv[e] = pe * (dp[4 * j + e] - ((e & 1) ? dsum.y : dsum.x));
        }
        if constexpr (DV) {
          pb[2 * j] = pack_f32(pv[0], pv[1]);
          pb[2 * j + 1] = pack_f32(pv[2], pv[3]);
        }
        if constexpr (DK) {
          dsb[2 * j] = pack_f32(dv[0], dv[1]);
          dsb[2 * j + 1] = pack_f32(dv[2], dv[3]);
        }
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, dO and Q as MN-major B
      if constexpr (DV) {
        pin(pb);
#pragma unroll
        for (int n = 0; n < L::NB; ++n) pin(acc_v[n]);
      }
      if constexpr (DK) {
        pin(dsb);
#pragma unroll
        for (int n = 0; n < L::NB; ++n) pin(acc_k[n]);
      }
      wgmma_fence();
      if constexpr (DV) regs_by_tile(acc_v, pb, dos);
      if constexpr (DK) regs_by_tile(acc_k, dsb, qs);
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (DV) {
        pin(pb);
#pragma unroll
        for (int n = 0; n < L::NB; ++n) pin(acc_v[n]);
      }
      if constexpr (DK) {
        pin(dsb);
#pragma unroll
        for (int n = 0; n < L::NB; ++n) pin(acc_k[n]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(l.empty(s));  // the stage may be loaded again
    }
  }
}

// The consumer warpgroup's part of one dK/dV item: its walks and epilogue.
template <int DT>
__device__ __forceinline__ void dkv_consume(const Params& p, const DkvLayout<DT>& l,
                                            const DkvItem& x, int ob, int kc, int warp,
                                            int lane) {
  constexpr int NB = DT / BOX_COLS;
  const int t = lane & 3;
  const long long row = static_cast<long long>(x.bkv) * p.S + x.k0 + warp * 16 + (lane >> 2);
  if constexpr (dkv_walks(DT) == 1) {
    float acc_v[NB][32], acc_k[NB][32];
    zero(acc_v);
    zero(acc_k);
    dkv_walk<DT, true, true>(p, l, x, ob, kc, warp, lane, acc_v, acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(l.own_empty(ob));  // the own buffer may be loaded again
    store_rows(p.dv, row, p.D, t, acc_v, 1.0f);
    store_rows(p.dk, row, p.D, t, acc_k, p.scale);
  } else {  // one accumulator: dV on the first walk, dK on the second
    float acc[NB][32];
    zero(acc);
    dkv_walk<DT, true, false>(p, l, x, ob, kc, warp, lane, acc, acc);
    store_rows(p.dv, row, p.D, t, acc, 1.0f);
    zero(acc);
    dkv_walk<DT, false, true>(p, l, x, ob, kc, warp, lane, acc, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(l.own_empty(ob));
    store_rows(p.dk, row, p.D, t, acc, p.scale);
  }
}

template <int DT>
__global__ void __launch_bounds__(threads(1, DT), ctas_per_sm(1, DT))
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = DkvLayout<DT>;
  constexpr int n_consumer_warps = 4;
  extern __shared__ unsigned char smem_raw[];
  const L l((smem_u32(smem_raw) + 1023) & ~1023u);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::NOWN; ++i) {
      mbar_init(l.own_full(i), 1);
      mbar_init(l.own_empty(i), n_consumer_warps);
    }
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(l.full(s), 1);
      mbar_init(l.empty(s), n_consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int kc = 0;  // query tiles through the ring so far
  int li = 0;  // this CTA's items so far
  if (warp == n_consumer_warps) {  // the producer warp: one lane issues every load
    if (lane != 0) return;
    const int group = p.H / p.KV;
    for (int r = 0; r * static_cast<int>(gridDim.x) < p.n_items; ++r) {
      const int it = item_of(r);
      if (it >= p.n_items) continue;
      const DkvItem x = dkv_item<DT>(p, it);
      const int b = x.bkv / p.KV;
      const int kvh = x.bkv - b * p.KV;
      const int ob = li % L::NOWN;
      if (li >= L::NOWN) mbar_wait(l.own_empty(ob), (li / L::NOWN - 1) & 1);
      mbar_expect_tx(l.own_full(ob), 2 * L::OWN_TILE);
      for (int c = 0; c < L::NB; ++c) {
        const uint32_t box = c * L::OWN_BOX;
        tma_load(l.own(ob, 0) + box, &tk, l.own_full(ob), c * BOX_COLS, x.k0, kvh, b);
        tma_load(l.own(ob, 1) + box, &tv, l.own_full(ob), c * BOX_COLS, x.k0, kvh, b);
      }
      for (int w = 0; w < dkv_walks(DT); ++w) {
        for (int hg = 0; hg < group; ++hg) {
          const int h = kvh * group + hg;
          const long long rows = static_cast<long long>(b * p.H + h) * p.S;
          for (int qt = x.qt0; qt < x.n_qt; ++qt, ++kc) {
            const int s = kc % L::STAGES;
            if (kc >= L::STAGES) mbar_wait(l.empty(s), (kc / L::STAGES - 1) & 1);
            mbar_expect_tx(l.full(s), 2 * L::ST_TILE + 2 * TILE * 4);
            for (int c = 0; c < L::NB; ++c) {
              tma_load(l.st(s, 0) + c * L::ST_BOX, &tq, l.full(s), c * BOX_COLS, qt * TILE, h, b);
              tma_load(l.st(s, 1) + c * L::ST_BOX, &tdo, l.full(s), c * BOX_COLS, qt * TILE, h,
                       b);
            }
            bulk_load(l.lse(s), p.lse + rows + qt * TILE, TILE * 4, l.full(s));
            bulk_load(l.dsum(s), p.dsum + rows + qt * TILE, TILE * 4, l.full(s));
          }
        }
      }
      ++li;
    }
  } else {
    for (int r = 0; r * static_cast<int>(gridDim.x) < p.n_items; ++r) {
      const int it = item_of(r);
      if (it >= p.n_items) continue;
      const DkvItem x = dkv_item<DT>(p, it);
      const int ob = li % L::NOWN;
      mbar_wait(l.own_full(ob), (li / L::NOWN) & 1);
      dkv_consume<DT>(p, l, x, ob, kc, warp, lane);
      kc += dkv_steps<DT>(p, x);
      ++li;
    }
  }
}

// Which shapes and types the backward takes: exactly what the forward takes
// (flash_common.cuh), with shared memory for the larger of its two kernels.
// Returns the dynamic shared memory in bytes, or -1 with the reason in why.
int plan(int head_dim, int seq_len, int dtype_code, char* why, int why_len) {
  if (!shape_ok(head_dim, seq_len, dtype_code, why, why_len)) return -1;
  const int DT = tile_width(head_dim);
  const int smem = smem_for(0, DT) > smem_for(1, DT) ? smem_for(0, DT) : smem_for(1, DT);
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
// per device: its SM count (0 until asked), the persistent grid's size
std::atomic<int> g_sms[MAX_DEVICES];

// Checks the shape, fills the common parameters, sets the kernel's
// shared-memory opt-in once per device and returns the persistent grid
// (ctas_per_sm CTAs per SM, never more than items) in grid; 0 or a CUDA
// error.
int prepare(Params& p, const void* kernel, int which_kernel, const void* lse, void* dsum, int B,
            int H, int KV, int S, int D, int causal, int n_items, int* grid) {
  if (plan(D, S, DTYPE_BF16, nullptr, 0) < 0 || B < 1 || KV < 1 || H < KV || H % KV != 0 ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 || reinterpret_cast<uintptr_t>(dsum) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<float*>(dsum);
  p.dq = p.dk = p.dv = nullptr;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.D = D;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  p.scale_log2 = p.scale * LOG2E;
  p.causal = causal ? 1 : 0;
  p.n_items = n_items;
  const int DT = tile_width(D);
  const int w = width_index(DT);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[which_kernel][w][dev].load()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_for(which_kernel, DT));
    if (e != cudaSuccess) return (int)e;
    g_smem_set[which_kernel][w][dev].store(true);
  }
  int sms = g_sms[dev].load();
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    g_sms[dev].store(sms);
  }
  const int ctas = ctas_per_sm(which_kernel, DT) * sms;
  *grid = n_items < ctas ? n_items : ctas;
  return 0;
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
// cudaGetLastError() after the launch: 0 means launched.  q/dout/o
// [B,H,S,D], k/v [B,KV,S,D] bf16 with element strides[15] = (b, h, s) of
// q, k, v, dout, o and unit stride along D, every base 16-byte aligned and
// every stride of a dimension longer than 1 a multiple of 8 elements
// (TMA's rules); lse and dsum [B*H,S] f32 contiguous and 16-byte aligned;
// dq [B,H,S,D], dk/dv [B,KV,S,D] bf16 contiguous.  The dQ kernel writes
// dsum, which the dK/dV kernel reads: launch dQ first, on the same stream.
// A tensor map that cannot be encoded answers cudaErrorInvalidValue.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                  const void* o, const void* lse, void* dsum, void* dq, int B,
                                  int H, int KV, int S, int D, int causal,
                                  const long long* strides, void* stream) {
  const int DT = tile_width(D);
  const int w = width_index(DT);
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                 const CUtensorMap, const Params) =
      w == 0 ? flash_bwd_dq_kernel<64> : (w == 1 ? flash_bwd_dq_kernel<128> : flash_bwd_dq_kernel<256>);
  const int rows = own_rows(0, DT);
  Params p;
  int grid = 0;
  int rc = prepare(p, reinterpret_cast<const void*>(kernel), 0, lse, dsum, B, H, KV, S, D, causal,
                   B * H * ((S + rows - 1) / rows), &grid);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv, tdo, to;
  if (!encode(&tq, q, B, H, S, D, strides, rows) ||
      !encode(&tk, k, B, KV, S, D, strides + 3, TILE) ||
      !encode(&tv, v, B, KV, S, D, strides + 6, TILE) ||
      !encode(&tdo, dout, B, H, S, D, strides + 9, rows) ||
      !encode(&to, o, B, H, S, D, strides + 12, rows))
    return (int)cudaErrorInvalidValue;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  kernel<<<grid, threads(0, DT), smem_for(0, DT), static_cast<cudaStream_t>(stream)>>>(tq, tk, tv,
                                                                                   tdo, to, p);
  return (int)cudaGetLastError();
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* dsum, void* dk,
                                   void* dv, int B, int H, int KV, int S, int D, int causal,
                                   const long long* strides, void* stream) {
  const int DT = tile_width(D);
  const int w = width_index(DT);
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                 const Params) =
      w == 0 ? flash_bwd_dkv_kernel<64>
             : (w == 1 ? flash_bwd_dkv_kernel<128> : flash_bwd_dkv_kernel<256>);
  const int rows = own_rows(1, DT);
  Params p;
  int grid = 0;
  int rc = prepare(p, reinterpret_cast<const void*>(kernel), 1, lse, const_cast<void*>(dsum), B,
                   H, KV, S, D, causal, B * KV * ((S + rows - 1) / rows), &grid);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, B, H, S, D, strides, TILE) ||
      !encode(&tk, k, B, KV, S, D, strides + 3, rows) ||
      !encode(&tv, v, B, KV, S, D, strides + 6, rows) ||
      !encode(&tdo, dout, B, H, S, D, strides + 9, TILE))
    return (int)cudaErrorInvalidValue;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  kernel<<<grid, threads(1, DT), smem_for(1, DT), static_cast<cudaStream_t>(stream)>>>(tq, tk, tv,
                                                                                    tdo, p);
  return (int)cudaGetLastError();
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
