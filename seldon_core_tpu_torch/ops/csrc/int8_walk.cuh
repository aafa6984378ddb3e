// The int8-K/V tile walk, one statement for the int8 variants of both
// decode kernels (flash_decode.cu's two-tier segments, flash_decode_paged.cu's
// block pool): how a warp stages a tile of TILE positions of int8 K and V
// codes with their f32 scales in shared memory, and the per-tile step that
// takes the staged tile into the warp's online softmax (m, l, acc) with both
// products on the tensor cores.  The two kernels differ only in where a
// tile's rows come from, their split and their combine.  ops/_build.py
// hashes this header into every library's key.
//
// The arithmetic is the reference's _attend_two_tier / _attend_paged with
// scales (seldon_core_tpu/models/generate.py:162-227, :1086): a score is (q
// . k_int8) * (1/sqrt(D)) * k_s[j] in f32 (taken times log2 e: every exp is
// the SFU's exp2), p = exp(s - m) times v_s[j] is rounded to bf16 and times
// v_int8 summed in f32, and l sums the unscaled exp.  Every product of
// codes is exact: an int8 code is exact in bf16.
//
// The tile.  A stage holds a tile's K codes [TILE][DT], its V codes
// [TILE][DT] (DT = tile_cols(D): 64, 128 or 256 bytes a row; the columns
// past D are never written and meet q's zeros or land in o's columns past
// D), then k_s [TILE] and v_s [TILE].  The warp's lanes fill it with
// cp.async (stage_tile): lane l copies half of row l & 15's 16-byte
// chunks of K and of V and one of its two scales, one row's addresses a
// lane, and then arrives on the stage's mbarrier with
// cp.async.mbarrier.arrive.noinc, so the barrier (32 arrivals) completes
// when every copy of the tile has landed: codes and scales on the same
// stage, no load of either in the walk.  A lane writes the chunks into
// their swizzled places (chunk_off), which the operand loads below undo.
//
// The per-tile step (Walk::step).  S = Q K^T and O += P V are mma.sync
// m16n8k16, bf16 in and f32 out, with the G query rows on M (8 of 16 rows
// unless the group passes 8):
//   * Q K^T: q's k order is permuted (i8_k_dims in ops/flash_decode.py): lane tig of a quad
//     takes the DT/4 neighbouring columns DT/4 tig ... of every position,
//     one 16-byte load a position at DT = 64, and the 4 codes of k-step ks,
//     bytes 4 ks .. 4 ks + 3 of that run, are its B operand of that step
//     (bytes 0, 2 the low pair, 1, 3 the high one); the sum is the same.
//   * P V: the n columns are permuted: column n of n-tile j is dim NT n + j
//     (NT = DT / 8 n-tiles), so a lane's codes of one position for all its
//     n-tiles are NT neighbouring bytes, one 8-byte load at DT = 64; the
//     four positions of its B operands (2 tig + {0, 1, 8, 9}) are paired by
//     one PRMT an n-tile.  The store undoes the permutation (Walk::store).
//   * The codes become bf16 by kvq::codes_bf16x2 (two LOP3s and a bf16x2
//     add a pair): no I2F, no LDS.U8 in the walk, and no F2FP but P's.
//   * A lane's operand offsets in the stage are computed once (begin), and
//     the ring's stage and phase advance without a division.
//   * The swizzle (chunk_off): a shared-memory access of a warp is served
//     128 bytes at a time, an 8-lane phase of 16-byte loads or a 16-lane
//     phase of 8-byte loads.  At DT = 64 a K phase reads two whole
//     neighbouring rows, and a V phase 32 bytes of four rows 2 apart; with
//     chunk c of row r at chunk (4 (r & 1) + c) ^ (2 ((r >> 1) & 3)) of the
//     128-byte line r >> 1, both are conflict-free.  At DT = 128 (a line a
//     row) the usual c ^ (r & 7) makes both conflict-free; at DT = 256, K is
//     conflict-free and V 2-way.  ops/flash_decode.py (i8_stage_offset,
//     i8_k_dims, i8_v_dims) states the same plan, which the CPU tests
//     emulate fragment by fragment and bank by bank.

#pragma once

#include "flash_common.cuh"
#include "kv_int8.cuh"

namespace i8w {

constexpr int TILE = 16;                   // positions a tile: one PV k-step
constexpr int SCALE_BYTES = 2 * TILE * 4;  // a stage's k_s and v_s
constexpr int MAX_SPLIT = 8;               // blocks a cluster, at most
constexpr int RING_BUDGET = 64 * 1024;     // bytes of stages a block aims at
constexpr int MAX_DEPTH = 4;               // stages of a warp's ring, at most (at least 2)
constexpr int COPIERS = 32;                // arrivals a stage: every lane of the warp
constexpr unsigned FULL = 0xffffffffu;

// warps a block: 8 up to a head dim of 128, else 4
__host__ __device__ constexpr int nwarps(int D) { return D <= 128 ? 8 : 4; }

// bytes of a staged row for a head dim: 64, 128 or 256
__host__ __device__ constexpr int tile_cols(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }

// query rows a block: one m16 tile, 8 of its rows unless the group passes 8
__host__ __device__ constexpr int row_tile(int G) { return G > 8 ? 16 : 8; }

// byte offset of 16-byte chunk c of row r in a staged [TILE][DT] tile
template <int DT>
__host__ __device__ constexpr int chunk_off(int r, int c) {
  return DT == 64    ? (r >> 1) * 128 + 16 * ((((r & 1) << 2) | c) ^ (((r >> 1) & 3) << 1))
         : DT == 128 ? r * 128 + 16 * (c ^ (r & 7))
                     : r * 256 + 16 * (c ^ ((r & 7) ^ ((c >> 3) << 1)));
}

// Shared memory, in bytes from a 128-aligned base: each warp's ring of
// `depth` stages (K codes, V codes, k_s, v_s); after the walk, reusing the
// ring, the warps' m, l [NW][GT] and acc [NW][GT][D], the weights
// [MAX_SPLIT + 2][GT] and rank 0's gather of every rank's (M, L, O) per row
// [MAX_SPLIT][GT * (D + 2)], all f32; last one mbarrier a stage.  The ring
// is as deep as RING_BUDGET holds (2 to 4 stages a warp): 52 KB a block
// at D = 64 (3 stages of 2,176 bytes a warp), 66-68 KB above, so the one
// block an SM of the served rounds keeps more than the ~20 KB an SM of
// copies in flight that HBM's rate needs (deeper rings, 4 and 6 stages,
// measured no faster on the card: the walk's instructions, not the bytes
// in flight, set a tile's time).  i8_walk_layout in ops/flash_decode.py
// is the same rule.
struct Layout {
  int nw, depth, stage, m, l, acc, weights, gather, bars, bytes;
};

__host__ __device__ inline Layout layout(int D, int GT) {
  Layout L;
  L.nw = nwarps(D);
  L.stage = 2 * TILE * tile_cols(D) + SCALE_BYTES;
  const int depth = RING_BUDGET / (L.nw * L.stage);
  L.depth = depth < 2 ? 2 : (depth > MAX_DEPTH ? MAX_DEPTH : depth);
  const int ring = L.nw * L.depth * L.stage;
  L.m = 0;
  L.l = L.m + L.nw * GT * 4;
  L.acc = L.l + L.nw * GT * 4;
  L.weights = L.acc + L.nw * GT * D * 4;
  L.gather = L.weights + (MAX_SPLIT + 2) * GT * 4;
  const int end = L.gather + MAX_SPLIT * GT * (D + 2) * 4;
  L.bars = ((ring > end ? ring : end) + 7) & ~7;
  L.bytes = L.bars + 8 * L.nw * L.depth + 128;  // 128: the base's alignment
  return L;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// the barrier's arrival once this lane's earlier cp.async copies land
__device__ __forceinline__ void arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A warp stages one tile into the stage at `st` (every lane calls it):
// lane l takes row r = l & 15, copies half l >> 4 of its K and V chunks
// (those below D / 16; the two halves of a row are neighbouring lanes 16
// apart, so each copy instruction reads 16 whole 32-byte sectors) and its
// k_s (lanes 0-15) or v_s (16-31), then arrives on bar: one row's
// addresses a lane.  src(r, k, v, ks, vs) points k, v at row r's codes and
// ks, vs at its scales, or answers false for a row past the share, which
// is left as it is (the walk masks it).
template <int DT, typename RowSrc>
__device__ __forceinline__ void stage_tile(uint32_t st, int lane, int D, uint32_t bar,
                                           RowSrc src) {
  constexpr int HALF = DT / 32;  // chunks a lane: half of a staged row's
  const int r = lane & 15, c0 = (lane >> 4) * HALF;
  const int8_t *k, *v;
  const float *ks, *vs;
  if (src(r, k, v, ks, vs)) {
#pragma unroll
    for (int c = c0; c < c0 + HALF; ++c) {
      if (c >= D / 16) break;
      cp_async16(st + chunk_off<DT>(r, c), k + 16 * c);
      cp_async16(st + TILE * DT + chunk_off<DT>(r, c), v + 16 * c);
    }
    cp_async4(st + 2 * TILE * DT + 4 * lane, lane < 16 ? ks : vs);
  }
  arrive_on_copies(bar);
}

// d += A(16x16, bf16, row) * B(16x8, bf16, col), f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// q at (row, col) and (row, col + 2) as a bf16x2, or zeros off the tile
// (col and col + 2 lie on the same side of D: D is a multiple of 16)
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qb, long long row_stride, int row,
                                           int rows, int col, int D) {
  if (row >= rows || col >= D) return 0u;
  const __nv_bfloat16* s = qb + row * row_stride + col;
  __nv_bfloat162 v;
  v.x = s[0];
  v.y = s[2];
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warp's walk over its tiles: q as the A operand of every k-step, and
// its online softmax (m, l, acc) over the tiles it has taken.  Lane (gid,
// tig) = (lane / 4, lane % 4) holds rows gid (and gid + 8 at GT = 16).
template <int DT, int GT>
struct Walk {
  static constexpr int KS = DT / 16;  // QK^T k-steps
  static constexpr int NT = DT / 8;   // PV n-tiles
  static constexpr int QB = DT / 4;   // K bytes a lane a position
  static constexpr int VW = NT / 4;  // V words a lane a position
  uint32_t qa[KS][4];
  float m0, m1, l0, l1;
  float acc[NT][4];
  // the lane's operand offsets in a stage: its K chunks of positions gid
  // and 8 + gid, its V bytes of positions 2 tig + {0, 1, 8, 9}
  int koff[2][QB / 16], voff[4][VW > 4 ? VW / 4 : 1];

  // q's rows [gn] of `row_stride` from qb: k slots 2 tig, 2 tig + 1 of step
  // ks are dims d, d + 2 and slots 2 tig + 8, + 9 are d + 1, d + 3, d = QB
  // tig + 4 ks (the staged K codes' order; zeros past D and past gn)
  __device__ __forceinline__ void begin(const __nv_bfloat16* qb, long long row_stride, int gn,
                                        int D, int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int d = QB * tig + 4 * ks;
      qa[ks][0] = q_pair(qb, row_stride, gid, gn, d, D);
      qa[ks][1] = GT == 16 ? q_pair(qb, row_stride, gid + 8, gn, d, D) : 0u;
      qa[ks][2] = q_pair(qb, row_stride, gid, gn, d + 1, D);
      qa[ks][3] = GT == 16 ? q_pair(qb, row_stride, gid + 8, gn, d + 1, D) : 0u;
    }
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < QB / 16; ++h)
        koff[t][h] = chunk_off<DT>(8 * t + gid, (QB / 16) * tig + h);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = 2 * tig + (s & 1) + 8 * (s >> 1);
      if constexpr (DT == 64) {
        voff[s][0] = TILE * DT + chunk_off<DT>(r, gid >> 1) + 8 * (gid & 1);
      } else {
#pragma unroll
        for (int h = 0; h < VW / 4; ++h)
          voff[s][h] = TILE * DT + chunk_off<DT>(r, (VW / 4) * gid + h);
      }
    }
  }

  // One staged tile of `tcnt` (1..TILE) positions at `tile` (a shared
  // address: K, V, k_s, v_s) into (m, l, acc).  Positions past tcnt are
  // masked (their codes, whatever the stage holds, meet p = 0: any byte is a
  // finite code).
  __device__ __forceinline__ void step(const unsigned char* tile, int tcnt, float scale_log2,
                                       int lane) {
    const int tig = lane & 3;
    const float* ksc = reinterpret_cast<const float*>(tile + 2 * TILE * DT);
    const float* vsc = ksc + TILE;
    // S = Q K^T: n-tile t is positions 8 t .. 8 t + 7; the B operand of
    // position 8 t + gid is its codes QB tig .. QB tig + QB - 1
    float sc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
      uint32_t w[KS];
#pragma unroll
      for (int h = 0; h < QB / 16; ++h) {
        const uint4 u = *reinterpret_cast<const uint4*>(tile + koff[t][h]);
        w[4 * h] = u.x;
        w[4 * h + 1] = u.y;
        w[4 * h + 2] = u.z;
        w[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma(sc[t], qa[ks], kvq::codes_bf16x2(w[ks]), kvq::codes_bf16x2(w[ks] >> 8));
    }
    // scaled to base 2 and by k_s; positions past tcnt masked; v_s 0 there
    // (a stage's stale scale could be anything)
    float vs[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float2 k2 = *reinterpret_cast<const float2*>(ksc + 8 * t + 2 * tig);
      const float2 v2 = *reinterpret_cast<const float2*>(vsc + 8 * t + 2 * tig);
      const int pos = 8 * t + 2 * tig;
      const float kx = scale_log2 * k2.x, ky = scale_log2 * k2.y;
      vs[t][0] = pos < tcnt ? v2.x : 0.f;
      vs[t][1] = pos + 1 < tcnt ? v2.y : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[t][e] = pos + (e & 1) < tcnt ? sc[t][e] * ((e & 1) ? ky : kx) : -INFINITY;
    }
    // the online softmax, once a tile: a row's max over its quad; P (times
    // v_s, rounded to bf16) as the A operand of the PV step
    uint32_t pa[4];
    {
      float mx = fmaxf(m0, fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1])));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float alpha = flash::exp2_approx(m0 - mx);  // 0 while m0 is still -inf
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float e0 = flash::exp2_approx(sc[t][0] - mx), e1 = flash::exp2_approx(sc[t][1] - mx);
        sum += e0 + e1;
        pa[2 * t] = flash::pack_f32(e0 * vs[t][0], e1 * vs[t][1]);
      }
      l0 = l0 * alpha + sum;
      m0 = mx;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= alpha;
        acc[j][1] *= alpha;
      }
    }
    if constexpr (GT == 16) {
      float mx = fmaxf(m1, fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3])));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float alpha = flash::exp2_approx(m1 - mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float e2 = flash::exp2_approx(sc[t][2] - mx), e3 = flash::exp2_approx(sc[t][3] - mx);
        sum += e2 + e3;
        pa[2 * t + 1] = flash::pack_f32(e2 * vs[t][0], e3 * vs[t][1]);
      }
      l1 = l1 * alpha + sum;
      m1 = mx;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2] *= alpha;
        acc[j][3] *= alpha;
      }
    } else {
      pa[1] = pa[3] = 0u;
    }
    // O += P V: the B operand of n-tile j pairs byte j of the lane's NT
    // codes (dims NT gid ...) of positions 2 tig, 2 tig + 1 (low) and of 2
    // tig + 8, + 9 (high)
    uint32_t vw[4][VW];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (DT == 64) {
        const uint2 u = *reinterpret_cast<const uint2*>(tile + voff[s][0]);
        vw[s][0] = u.x;
        vw[s][1] = u.y;
      } else {
#pragma unroll
        for (int h = 0; h < VW / 4; ++h) {
          const uint4 u = *reinterpret_cast<const uint4*>(tile + voff[s][h]);
          vw[s][4 * h] = u.x;
          vw[s][4 * h + 1] = u.y;
          vw[s][4 * h + 2] = u.z;
          vw[s][4 * h + 3] = u.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t sel = (j & 3) | (4 + (j & 3)) << 8;  // byte j & 3 of each into bytes 0, 2
      mma(acc[j], pa, kvq::codes_bf16x2(prmt(vw[0][j >> 2], vw[1][j >> 2], sel)),
          kvq::codes_bf16x2(prmt(vw[2][j >> 2], vw[3][j >> 2], sel)));
    }
  }

  // after the last tile: each lane's l covers its quad's positions
  __device__ __forceinline__ void finish() {
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
  }

  // this warp's (m, l) into sm_m, sm_l [NW][GT] and acc into sm_acc
  // [NW][GT][D], in dim order: acc[j][e] (e = 0, 1; rows gid) is dim NT (2
  // tig + e) + j, so each lane stores two runs of NT neighbouring dims a row
  __device__ __forceinline__ void store(float* sm_m, float* sm_l, float* sm_acc, int warp, int gn,
                                        int D, int lane) const {
    const int gid = lane >> 2, tig = lane & 3;
    if (tig == 0) {
      if (gid < gn) {
        sm_m[warp * GT + gid] = m0;
        sm_l[warp * GT + gid] = l0;
      }
      if (GT == 16 && gid + 8 < gn) {
        sm_m[warp * GT + gid + 8] = m1;
        sm_l[warp * GT + gid + 8] = l1;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int j = 0; j < NT; j += 4) {
        const int d = NT * (2 * tig + e) + j;
        if (d >= D) continue;
        if (gid < gn)
          *reinterpret_cast<float4*>(sm_acc + (warp * GT + gid) * D + d) =
              make_float4(acc[j][e], acc[j + 1][e], acc[j + 2][e], acc[j + 3][e]);
        if (GT == 16 && gid + 8 < gn)
          *reinterpret_cast<float4*>(sm_acc + (warp * GT + gid + 8) * D + d) =
              make_float4(acc[j][2 + e], acc[j + 1][2 + e], acc[j + 2][2 + e], acc[j + 3][2 + e]);
      }
    }
  }
};

// n bytes as one register-sized value: 2, 4, 8 or 16
template <int N> struct Bytes;
template <> struct Bytes<2> { using type = unsigned short; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

// The fresh K/V rows of a decode step, quantized by the warp that walks
// their position (warp-uniform; every lane calls each step): lane l takes
// the E = DT / 32 values E l .. E l + E - 1 of each bf16 row (the lanes with
// E l < D), loaded at entry; quantize() takes each row's absmax by a warp
// reduction and the codes by kv_int8.cuh, bit for bit the reference's
// quantizer, so every lane has both scales and only 2 E + 2 IEEE divisions
// (6 at D = 64) stand in its way.
template <int DT>
struct Fresh {
  static constexpr int E = DT / 32;
  using Raw = typename Bytes<2 * E>::type;
  using Codes = typename Bytes<E>::type;
  Raw kraw, vraw;  // the lane's bf16 values of K and of V
  Codes k, v;      // their codes
  float ks, vs;

  __device__ __forceinline__ void load(const __nv_bfloat16* kr, const __nv_bfloat16* vr, int D,
                                       int lane) {
    kraw = vraw = Raw{};
    if (E * lane < D) {
      kraw = *reinterpret_cast<const Raw*>(kr + E * lane);
      vraw = *reinterpret_cast<const Raw*>(vr + E * lane);
    }
  }

  __device__ __forceinline__ void quantize() {
    const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kraw);
    const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vraw);
    float kf[E], vf[E], ka = 0.f, va = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      kf[i] = __bfloat162float(kh[i]);
      vf[i] = __bfloat162float(vh[i]);
      ka = fmaxf(ka, fabsf(kf[i]));
      va = fmaxf(va, fabsf(vf[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ka = fmaxf(ka, __shfl_xor_sync(FULL, ka, o));
      va = fmaxf(va, __shfl_xor_sync(FULL, va, o));
    }
    ks = kvq::row_scale(ka);
    vs = kvq::row_scale(va);
    union {
      Codes c;
      unsigned char b[E];
    } kc, vc;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      kc.b[i] = static_cast<unsigned char>(kvq::code(kf[i], ks));
      vc.b[i] = static_cast<unsigned char>(kvq::code(vf[i], vs));
    }
    k = kc.c;
    v = vc.c;
  }

  // into row rr of a staged tile (the warp's last, once its copies have
  // landed), so the walk attends the codes as the reference writes them
  __device__ __forceinline__ void stage(unsigned char* tile, int rr, int D, int lane) const {
    if (E * lane < D) {
      const int off = chunk_off<DT>(rr, E * lane / 16) + E * lane % 16;
      *reinterpret_cast<Codes*>(tile + off) = k;
      *reinterpret_cast<Codes*>(tile + TILE * DT + off) = v;
    }
    if (lane == 0) {
      reinterpret_cast<float*>(tile + 2 * TILE * DT)[rr] = ks;
      reinterpret_cast<float*>(tile + 2 * TILE * DT)[TILE + rr] = vs;
    }
    __syncwarp();
  }

  // into a cache row (codes) and its scales
  __device__ __forceinline__ void write(int8_t* krow, int8_t* vrow, float* ksp, float* vsp, int D,
                                        int lane) const {
    if (E * lane < D) {
      *reinterpret_cast<Codes*>(krow + E * lane) = k;
      *reinterpret_cast<Codes*>(vrow + E * lane) = v;
    }
    if (lane == 0) {
      *ksp = ks;
      *vsp = vs;
    }
  }
};

}  // namespace i8w
