// Paged flash decode for Hopper (sm_90a): one query token per (row, kv
// head) over that row's positions of a KV block pool, read through the
// row's block table, with the decode step's fresh K/V row written into the
// pool in the same launch.
//
// Replaces what the reference computes in XLA for the continuous lane's
// decode step (seldon_core_tpu/models/generate.py: _paged_write :1057, then
// _attend_paged :1086 at W = 1, in _paged_block :1102), the paged form of
// the Pallas TPU kernel seldon_core_tpu/ops/flash_decode.py (flash_decode
// :87, _decode_kernel :47, pallas_call :125).  The arithmetic is the
// two-segment kernel's (flash_decode.cu):
//   * q [B,KV,G,D] (the G query heads of a kv head on the rows of an m16
//     tile), pools [N,KV,bs,D], row b's positions [0, lens[b]), position j
//     at row j % bs of pool block table[b, j / bs];
//   * scores (q.k) * (1/sqrt(D)) in f32 from bf16 inputs, taken times
//     log2 e so every exp is the SFU's exp2;
//   * an online softmax (running max m, normaliser l in f32), p cast to
//     bf16 before the PV product, the accumulator rescaled by exp(m_prev -
//     m); o = acc / max(l, 1e-30) in bf16.
//
// The fused write.  With k_new/v_new ([B,KV,1,D]) the kernel stores each
// valid row's fresh K/V at position lens[b] - 1 through the table (what
// kv_write_paged did in a launch of its own before every attention) and
// attends with that position taken from the fresh input, not read back
// from the pool: only the rank whose share holds it touches it.  An
// inactive row (valid[b] false) writes nothing and attends over the pool
// as it stands; its o is computed and no token reads it.  The reference
// routes an inactive row's write to the scratch block 0, which the next
// read of block 0 would race with inside one launch, so the port's pools
// differ from the reference's only in block 0, which no valid row reads.
// A row whose length lies outside [1, nblk * bs] writes nothing either.
//
// Bound on an H100 SXM: ~G FLOP per byte of K/V, far below the ~295 at
// which the card becomes compute-bound, so the bound is the bytes: K and
// V of each row's positions read once (~18.4 MB, ~5.5 us at the served
// round: B=32, KV=4, D=64, 560 positions).  What held the first paged
// design back was not the bytes: its cluster split the table's width, not
// the row's length, and its CUDA-core walk spent ~30 instructions a
// position a lane group (unpacks, FMAs, shuffle levels, a rescale every 2
// positions).  This design:
//   * Splits by the row's own length, on the device.  The host picks C,
//     the blocks of a cluster (1, 2, 4 or 8), from the shapes and the
//     table's width without a sync (decode_split_plan, aiming at ~one
//     block per SM: a cluster's barriers and DSMEM combine cost ~2 us, so
//     the served round, B=32 x 4 kv heads, runs C = 1); each block reads
//     lens[b] and takes its share (share_of below, paged_shares in
//     ops/flash_decode.py): the non-empty shares are whole pool blocks,
//     differ by at most one block and hold at least MIN_SPAN positions
//     each, so a short row leaves the later ranks empty (m = -inf, l = 0)
//     and no block walks the empty tail of the table.
//   * Puts both products on the tensor cores.  Each of the block's warps
//     (8 up to D = 128, else 4) takes every 8th (4th) tile of 16 positions
//     of the block's share; per tile, S = Q K^T is mma.sync m16n8k16 (bf16
//     in, f32 out) with the G query rows on M (4 of 16 at the flagship,
//     the rest zero), K through ldmatrix;
//     P goes from the S accumulator's registers to the A operand's without
//     shared memory (FA2's layout trick), and O += P V is m16n8k16 with V
//     through ldmatrix.trans.  A row's max and sum need the accumulator
//     quad's two shuffle levels, and the accumulator is rescaled once per
//     16 positions.  (The swap-AB form, S^T = K Q^T on wgmma m64n8k16, was
//     not taken: at 16 positions a warp and a walk this short, mma.sync
//     needs no warpgroup barrier and no shared-memory operand staging.
//     Tiles of 32 positions and four independent accumulators over the
//     QK^T k-steps measured no faster on the card: the walk waits on the
//     loads, which reach ~2.2 TB/s from HBM, more than on the products.)
//   * Fills each warp's own ring of 1-4 tiles (64 KB a block) by TMA: per
//     pool block, one box of 64 columns x 16 rows (two of 8 rows where bs
//     is a multiple of 8 only) for each 64 columns of the tile width (64,
//     128 or 256: the columns past D come in as zeros, so no loop of the
//     products has a bound that depends on D, and the compiler issues all
//     of a tile's ldmatrix loads ahead of its products), over a 4-d map of
//     the pool [N, KV, bs, D], with the 128-byte swizzle, so ldmatrix
//     reads conflict-free; lane 0 issues the warp's next tile as soon as
//     the warp is done with a stage, so no block-wide barrier stands in
//     the walk.  The table entries of 32 tiles at a time are read by the
//     warp's lanes up front.
//   * Combines the warps, then the cluster's blocks, in a fixed order: each
//     block pushes (M, L, O) into rank 0's shared memory through DSMEM and
//     rank 0 combines in rank order, in one launch with no atomics.  A
//     repeat gives the same bits, and since position j goes to a tile by
//     its index, a row's bits depend on lens[b] and C only, never on which
//     physical blocks hold it.
//
// The float32 path (paged_decode_f32_kernel) serves the float32 pools of
// an f32 model, such as a speculative unit's f32 draft (hd 32, group 1,
// pool blocks of 16), with the same share rule, fused write and combine.
//   * What bounds it.  A score costs hd FMAs for 4 hd bytes of K (PV the
//     same for V): ~G/2 FLOP a byte, where the card's 67 TFLOP/s of f32
//     FMAs bind only above ~20 FLOP a byte (67e12 / 3.35e12).  So the
//     bytes bound the walk: K and V of the row's positions read once
//     (~2.5 us at the draft's step, B=32 x 2 kv heads x 512 positions of
//     hd 32).  A walk that loads V rows from global memory inside its PV
//     loop pays a dependent trip to device memory every few positions, and
//     tiles of 32 positions a warp leave most warps idle at one row (8
//     ranks of 64 positions): both keep it far from that bound.
//   * Staging.  Each warp walks every NW-th tile of F32_TILE (8) positions
//     of the block's share, so a share of MIN_SPAN positions gives every
//     warp a tile.  A warp's tiles reach its own ring of 2-4 stages by TMA
//     (a tile lies in one pool block: per 32 columns one box of 8 rows of
//     128 bytes with the 128-byte swizzle, K then V, over a 4-d f32 map
//     of the pool; columns past hd come in as zeros); lane 0 issues the
//     ring's tiles at entry and the next one as soon as the warp is done
//     with a stage, so every copy of a short share is in flight at once
//     and none waits on the walk.  The scores read K from shared memory,
//     4 lanes a position (every 4th 16-byte chunk of the row each, summed
//     by two shuffle levels; the swizzle puts a phase's 8 rows on 8
//     different bank groups); PV reads one V row a position with a lane on
//     every 32nd column (one 128-byte line a row, no conflict) and p from
//     its position's lane by shuffle: no global load inside the loop.
//   * Entry.  The length's load, q's, the table row's prefetch toward L2
//     and the tensor maps' are in flight together; each warp arms its own
//     barriers (no block barrier before its first copies); the fresh row
//     waits in registers and reaches the pool after the walk.  A launch's
//     chain is then the length, the table (from L2), the copies and the
//     combine.  On an H100 SXM that chain and the launch take ~4 us with
//     every row empty, ~6 us as a cluster (paged_f32_turns.py), and the
//     walk adds the bytes at ~2.6 TB/s.
//   * Products.  f32 FMAs on the CUDA cores, never the tensor cores:
//     mma.sync takes f32 only as TF32 (10 mantissa bits), which moves an
//     f32 draft's logits by ~1e-3, enough to turn an argmax away from the
//     reference's; and at ~G/2 FLOP a byte the FMAs cost less than the
//     bytes do.
//
// The int8 path (paged_decode_i8_kernel, flash_decode_paged_i8_launch)
// serves the int8 K/V cache's pools (kv_quant = "int8"): codes int8 [N, KV,
// bs, D] and scale planes f32 [N, KV, bs] (the reference's [N, bs, KV],
// laid out so that a tile's scales are one contiguous run), q, the fresh
// rows and o in bf16.  It computes the reference's _attend_paged with
// scales (generate.py:1086, _grouped_qk / _grouped_pv): a score is (q .
// k_int8) * (1/sqrt(D)) * k_s[j] in f32 (every product exact: int8 codes
// are exact in bf16), V enters as p * v_s[j] rounded to bf16 times v_int8,
// in f32, and l sums the unscaled exp.
//   * What bounds it: the bytes, 2 D + 8 a position and kv head for K and V
//     with their scales (~9.75 MB, ~2.91 us at 3.35 TB/s, at the served
//     round: B=32, KV=4, D=64, 560 positions; ~21.7 us at 4,160).
//   * What held the first int8 design back (commit da270b9: the bf16
//     walk's tiles and mma.sync, the B operands built from codes in
//     registers, bulk copies of the code and scale runs into unswizzled
//     stages): 1.07-1.18x the bf16 kernel's time at half its bytes, 39% of
//     the byte bound at 4,160 positions.
//     Its walk loop (cuobjdump -sass, hd 64, 8 rows) held 64 code
//     conversions (I2F.S8, I2FP.F32.S32, I2F.S16: 16 results a clock an SM,
//     against 128 FMAs; at 4,160 positions the conversions alone outlast
//     the byte bound), 36 F2FP and 32 byte loads (LDS.S8) a tile; K was
//     read as 32-bit words 4-way bank-conflicted, V a byte a load, each
//     4-way conflicted.
//   * This design walks int8_walk.cuh's tiles, the two-tier kernel's int8
//     walk too: the bf16 walk's warps, tiles of 16 positions and share
//     rule; each warp's ring of 2-4 stages filled by its lanes' cp.async
//     (16-byte chunks of the pool's rows into a swizzled stage, the tile's
//     k_s and v_s on the same stage and mbarrier); both products mma.sync
//     m16n8k16 with q's k order and V's n order permuted so a lane's K
//     codes of a position are one 16-byte load and its V codes one 8-byte
//     load (D = 64), conflict-free; the codes widened to bf16 by two LOP3s
//     and a bf16x2 add a pair (kvq::codes_bf16x2).  Its walk loop holds no
//     code conversion, no byte load and P's 2 F2FP (4 at 16 rows), as the
//     bf16 walk's does; its two I2F.RP are load_blocks' division by bs, a
//     table lookup once in 32 tiles.  The cluster is i8_paged_cluster's
//     (ops/flash_decode.py): paged_cluster's, doubled for long tables while
//     two blocks an SM hold the grid.  The pool's rows must be contiguous
//     (a row stride of D bytes) and D a multiple of 16.
//   * The fused write quantizes: the warp that walks position n - 1
//     quantizes the fresh bf16 rows, spread over its 32 lanes with a warp
//     reduction (i8w::Fresh, bit for bit the reference's quantizer), while
//     its first copies fly; the codes and scales replace that position in
//     its last stage, so it is attended as the reference writes and reads
//     it (codes times scale), and reach the pool after the walk.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers); the
// tensor maps are encoded on the host (flash_common.cuh), no -lcuda.

#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "int8_walk.cuh"

#include <algorithm>
#include <atomic>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

using namespace flash;

constexpr int TILE = 16;               // positions a warp takes at a time (PV k-steps of 16)
constexpr int BOX_BYTES = TILE * 128;  // a tile's 64 columns: TILE rows of 128 bytes
constexpr int MAX_BOX_ROWS = 16;       // rows of a TMA box: 16, or 8 where bs % 16 != 0
constexpr int MAX_SPLIT = 8;           // blocks per cluster: the portable limit
constexpr int MIN_SPAN = 64;           // the fewest positions a non-empty share holds unless alone
constexpr int RING_BUDGET = 64 * 1024; // bytes of ring a block aims at
constexpr unsigned FULL = 0xffffffffu;
constexpr int DTYPE_F32 = 1;           // the wrappers' dtype code for float32 (0: bfloat16)
constexpr int F32_TILE = 8;            // positions an f32 warp takes at a time: a box's rows
constexpr int F32_BOX_COLS = 32;       // f32 columns in a 128-byte swizzle row
constexpr int F32_BOX_BYTES = F32_TILE * 128;  // one f32 box: 8 rows of 128 bytes
constexpr int F32_RING_BUDGET = 64 * 1024;     // bytes of f32 ring a block aims at
constexpr int F32_MAX_DEPTH = 4;       // stages of an f32 warp's ring, at most (at least 2)
constexpr int DTYPE_I8 = 2;            // the wrappers' code for int8 pools with bf16 q

// warps per block: 8 up to a head dim of 128; 4 above, where the warps'
// partial outputs would not fit beside the cluster's gather
__host__ __device__ constexpr int nwarps(int D) { return D <= 128 ? 8 : 4; }

// the instantiated tile width for a head dim: 64, 128 or 256 columns, all
// of them loaded (TMA fills the columns past D with zeros), so the
// products' loops have no bound that depends on D
__host__ __device__ constexpr int tile_cols(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }
static_assert(nwarps(64) <= MAX_SPLIT, "the weights region holds MAX_SPLIT per row");

template <typename T>                  // T: the element type of q, the pools and o
struct ParamsT {
  const T* q;
  long long qs[3];                     // element strides of b, kv head, group row (d is 1)
  T* pool_k;
  T* pool_v;
  long long ks[3], vs[3];              // element strides of block, kv head, row (d is 1)
  const int* table;                    // [B, nblk] int32 block ids, contiguous
  const int* lens;                     // [B] int32 positions per row
  const T* k_new;                      // [B, KV, 1, D] or null: no fused write
  const T* v_new;
  long long kns[2], vns[2];            // element strides of b, kv head
  const unsigned char* valid;          // [B] bool, or null: every row valid
  float* k_scale;                      // int8 pools: scale planes [N, KV, bs] f32, contiguous
  float* v_scale;                      // (null on the float paths)
  T* o;                                // [B, KV, G, D] contiguous
  int nblk, bs, nblocks;               // table width, rows per pool block, blocks in the pool
  int KV, G, D;
  int split;                           // C: blocks per cluster
  int box_rows;                        // rows of a TMA box (MAX_BOX_ROWS or 8)
  float scale_log2;                    // (1/sqrt(D)) log2 e
};
using Params = ParamsT<__nv_bfloat16>;

// Block r's share [p0, p1) of a row's n positions when a cluster of C
// blocks splits them in pool blocks of bs rows: k ranks take ceil(n / bs)
// blocks, q or q + 1 each (the extra ones last, with the partial block),
// where k is the largest count <= C that leaves every share at least
// MIN_SPAN positions; ranks >= k are empty.  paged_shares in
// ops/flash_decode.py is the same rule, which the CPU tests test.
__host__ __device__ inline void share_of(int n, int C, int bs, int r, int& p0, int& p1) {
  const int nb = (n + bs - 1) / bs;
  int k = C;
  for (; k > 1; --k) {
    const int q = nb / k;
    const int rem = nb - q * k;
    const int last = n - (nb - q - (rem > 0 ? 1 : 0)) * bs;  // the last share's positions
    if (q * bs >= MIN_SPAN && last >= MIN_SPAN) break;
  }
  if (r >= k) {
    p0 = p1 = n;
    return;
  }
  const int q = nb / k;
  const int rem = nb - q * k;
  const int start = r * q + (r > k - rem ? r - (k - rem) : 0);
  const int blocks = q + (r >= k - rem ? 1 : 0);
  p0 = start * bs < n ? start * bs : n;
  p1 = (start + blocks) * bs < n ? (start + blocks) * bs : n;
}

// Shared memory, in bytes from a 1024-aligned base: each warp's ring of
// DEPTH stages (a stage is a tile's K boxes, then its V boxes); after the
// walk, reusing the ring, the warps' (m, l, acc) per row, the weights, and
// rank 0's gather of every rank's (M, L, O) per row; last the mbarriers.
struct Layout {
  int depth, slot, scratch, weights, gather, bars, bytes;
};

__host__ __device__ inline Layout layout_for(int D, int GT) {
  const int NW = nwarps(D);
  Layout L;
  L.slot = 2 * (tile_cols(D) / BOX_COLS) * BOX_BYTES;
  const int depth = RING_BUDGET / (NW * L.slot);
  L.depth = depth < 1 ? 1 : (depth > 4 ? 4 : depth);
  const int ring = NW * L.depth * L.slot;
  L.scratch = 0;                                    // floats: m, l [NW][GT]; acc [NW][GT][D]
  L.weights = (NW * GT * (D + 2)) * 4;              // floats: [MAX_SPLIT + 2][GT]
  L.gather = L.weights + (MAX_SPLIT + 2) * GT * 4;      // floats: [MAX_SPLIT][GT * (D + 2)]
  const int end = L.gather + MAX_SPLIT * GT * (D + 2) * 4;
  L.bars = ((ring > end ? ring : end) + 7) & ~7;
  L.bytes = L.bars + 8 * NW * L.depth + 1024;       // 1024: the base's alignment
  return L;
}

// query rows a float32 block takes: the group rounded up to 1, 2, 4 or 8
__host__ __device__ constexpr int f32_rows(int G) { return G <= 1 ? 1 : (G <= 2 ? 2 : (G <= 4 ? 4 : 8)); }

// columns of V a float32 lane holds, and 32-column boxes a staged row
// takes: D <= 32 * f32_cols(D)
__host__ __device__ constexpr int f32_cols(int D) { return D <= 32 ? 1 : (D <= 64 ? 2 : (D <= 128 ? 4 : 8)); }

// warps of a float32 block: 8 up to a head dim of 128; 4 above, so that two
// stages a warp fit
__host__ __device__ constexpr int f32_warps(int D) { return D <= 128 ? 8 : 4; }

// The float32 path's shared memory, in bytes from a 1024-aligned base: each
// warp's ring of `depth` stages (a stage is a tile's K boxes, then its V
// boxes); after the walk, reusing the ring, the warps' m, l [NW][GT] and
// acc [NW][GT][D], the weights [MAX_SPLIT + 2][GT] and rank 0's gather of
// every rank's (M, L, O) per row [MAX_SPLIT][GT * (D + 2)], all f32; past
// both, q [GT][32 * f32_cols(D)] (zeros past the group and past D); last
// the mbarriers.  paged_f32_layout in ops/flash_decode.py is the same rule.
struct LayoutF32 {
  int nw, depth, stage, m, l, acc, weights, gather, q, bars, bytes;
};

__host__ __device__ inline LayoutF32 layout_f32(int D, int GT) {
  LayoutF32 L;
  const int DW = f32_cols(D);
  L.nw = f32_warps(D);
  L.stage = 2 * DW * F32_BOX_BYTES;
  const int depth = F32_RING_BUDGET / (L.nw * L.stage);
  L.depth = depth < 2 ? 2 : (depth > F32_MAX_DEPTH ? F32_MAX_DEPTH : depth);
  const int ring = L.nw * L.depth * L.stage;
  L.m = 0;
  L.l = L.m + L.nw * GT * 4;
  L.acc = L.l + L.nw * GT * 4;
  L.weights = L.acc + L.nw * GT * D * 4;
  L.gather = L.weights + (MAX_SPLIT + 2) * GT * 4;
  const int end = L.gather + MAX_SPLIT * GT * (D + 2) * 4;
  L.q = ((ring > end ? ring : end) + 15) & ~15;
  L.bars = (L.q + GT * 32 * DW * 4 + 7) & ~7;
  L.bytes = L.bars + 8 * L.nw * L.depth + 1024;  // 1024: the base's alignment
  return L;
}

// 0..3 for 1, 2, 4, 8
inline int log2_index(int x) { return x <= 1 ? 0 : (x <= 2 ? 1 : (x <= 4 ? 2 : 3)); }

// The shape and type rules: bfloat16 or float32, or int8 pools with
// bfloat16 q (code 2), a head dim that is a multiple of 8 up to 256 (of 16
// for int8 pools), a group of at least one row, pool blocks of a multiple
// of 8 rows.  Returns the dynamic shared memory in bytes, or -1 with the
// reason in why (why may be null when why_len is 0).
int plan(int head_dim, int group, int block_size, int dtype_code, char* why, int why_len) {
  if (dtype_code != DTYPE_BF16 && dtype_code != DTYPE_F32 && dtype_code != DTYPE_I8) {
    snprintf(why, why_len,
             "the paged flash-decode kernel takes bfloat16 or float32 q/k/v, or int8 pools with "
             "bfloat16 q, only");
    return -1;
  }
  const int unit = dtype_code == DTYPE_I8 ? 16 : 8;
  if (head_dim < unit || head_dim > MAX_D || head_dim % unit != 0) {
    snprintf(why, why_len,
             "head dim %d: the paged flash-decode kernel takes a multiple of %d up to %d%s",
             head_dim, unit, MAX_D, dtype_code == DTYPE_I8 ? " with int8 pools" : "");
    return -1;
  }
  if (group < 1) {
    snprintf(why, why_len, "group %d: the paged flash-decode kernel takes at least one row",
             group);
    return -1;
  }
  if (block_size < 8 || block_size % 8 != 0) {
    snprintf(why, why_len,
             "pool blocks of %d rows: the paged flash-decode kernel takes a multiple of 8",
             block_size);
    return -1;
  }
  const int smem = dtype_code == DTYPE_F32  ? layout_f32(head_dim, f32_rows(group)).bytes
                   : dtype_code == DTYPE_I8 ? i8w::layout(head_dim, i8w::row_tile(group)).bytes
                                            : layout_for(head_dim, group > 8 ? 16 : 8).bytes;
  if (smem > SMEM_LIMIT) {
    snprintf(why, why_len, "paged flash decode needs %d KiB shared memory (budget %d KiB)",
             smem >> 10, SMEM_LIMIT >> 10);
    return -1;
  }
  return smem;
}

// byte offset of 16-byte chunk c of row r in a tile of 64-column boxes
// written by TMA with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * BOX_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A(16x16, bf16, row) * B(16x8, bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 of q at (row, col), (row, col + 1), or zeros off the tile
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qb, long long row_stride, int row,
                                           int rows, int col, int D) {
  if (row >= rows || col >= D) return 0u;
  const __nv_bfloat16* s = qb + row * row_stride + col;
  __nv_bfloat162 v;
  v.x = s[0];
  v.y = s[1];
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) { *o = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }

// A block's end, shared by both paths once its warps' (m, l, acc) per row
// are in shared memory: per row the block's (M, L, O) with O = sum_w acc_w
// wt_w, L = sum_w l_w wt_w, wt_w = exp(m_w - M), in warp order; then o, or
// with a cluster each rank's (M, L, O) into rank 0's gather through DSMEM
// and rank 0's combine in rank order.  The caller has arrived on the
// cluster barrier (split > 1) before any warp wrote its scratch.
template <typename T, int NW, int GT>
__device__ __forceinline__ void combine_store(const ParamsT<T>& p, int rank, int bk, int g0,
                                              int gn, const float* sm_m, const float* sm_l,
                                              const float* sm_acc, float* sm_w, float* gather) {
  constexpr int NTHREADS = NW * 32;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
  if (threadIdx.x < gn) {
    const int g = threadIdx.x;
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w * GT + g]);
    float L = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float mw = sm_m[w * GT + g];
      const float wt = mw == -INFINITY ? 0.f : exp2_approx(mw - M);  // 0: a warp with no tile
      sm_w[w * GT + g] = wt;
      L = fmaf(sm_l[w * GT + g], wt, L);
    }
    sm_w[MAX_SPLIT * GT + g] = M;
    sm_w[(MAX_SPLIT + 1) * GT + g] = L;
  }
  __syncthreads();
  const int stride = GT * (p.D + 2);
  float* mine_out = gather;
  if (p.split > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    mine_out = cluster.map_shared_rank(gather, 0) + rank * stride;
    if (threadIdx.x < gn) {
      mine_out[threadIdx.x] = sm_w[MAX_SPLIT * GT + threadIdx.x];
      mine_out[GT + threadIdx.x] = sm_w[(MAX_SPLIT + 1) * GT + threadIdx.x];
    }
  }
  for (int e = threadIdx.x; e < gn * p.D; e += NTHREADS) {
    const int g = e / p.D;
    const int d = e - g * p.D;
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) O = fmaf(sm_acc[(w * GT + g) * p.D + d], sm_w[w * GT + g], O);
    if (p.split == 1)
      store_out(p.o + (static_cast<long long>(bk) * p.G + g0 + g) * p.D + d,
                O / fmaxf(sm_w[(MAX_SPLIT + 1) * GT + g], 1e-30f));
    else
      mine_out[2 * GT + g * p.D + d] = O;
  }
  if (p.split == 1) return;

  // rank 0 combines the cluster's blocks in rank order, from its own shared
  // memory once the cluster barrier has made every rank's stores visible
  cluster.sync();
  if (rank != 0) return;
  if (threadIdx.x < gn) {
    const int g = threadIdx.x;
    float M = -INFINITY;
    for (int r = 0; r < p.split; ++r) M = fmaxf(M, gather[r * stride + g]);
    float L = 0.f;
    for (int r = 0; r < p.split; ++r) {
      const float mr = gather[r * stride + g];
      const float wt = mr == -INFINITY ? 0.f : exp2_approx(mr - M);  // 0: an empty share
      sm_w[r * GT + g] = wt;
      L = fmaf(gather[r * stride + GT + g], wt, L);
    }
    sm_w[MAX_SPLIT * GT + g] = L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gn * p.D; e += NTHREADS) {
    const int g = e / p.D;
    const int d = e - g * p.D;
    float O = 0.f;
    for (int r = 0; r < p.split; ++r)
      O = fmaf(gather[r * stride + 2 * GT + g * p.D + d], sm_w[r * GT + g], O);
    store_out(p.o + (static_cast<long long>(bk) * p.G + g0 + g) * p.D + d,
              O / fmaxf(sm_w[MAX_SPLIT * GT + g], 1e-30f));
  }
}

template <int DT, int GT>
__global__ void __launch_bounds__(nwarps(DT) * 32)
    paged_decode_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int NW = nwarps(DT);
  constexpr int KSTEPS = DT / 16;  // QK^T k-steps over the tile width
  constexpr int NT = DT / 8;       // PV n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = lane >> 2;        // the accumulator rows of this lane: r0, r0 + 8
  const int cq = (lane & 3) * 2;   // and its column pair within an 8-column tile
  const int rank = static_cast<int>(cluster.block_rank());
  const int bk = blockIdx.x / p.split;  // b * KV + kv head
  const int b = bk / p.KV;
  const int kvh = bk - b * p.KV;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, p.G - g0);
  const Layout lay = layout_for(p.D, GT);

  // the row's length, at most the table's width, and whether its fresh
  // row is written and attended from the input
  const int len = p.lens[b];
  const int width = p.nblk * p.bs;
  const int n = min(max(len, 0), width);
  const bool fresh = p.k_new != nullptr && (p.valid == nullptr || p.valid[b] != 0) && len >= 1 &&
                     len <= width;
  int p0, p1;
  share_of(n, p.split, p.bs, rank, p0, p1);
  const int cnt = p1 - p0;
  const int ntiles = (cnt + TILE - 1) / TILE;
  const int mine = warp < ntiles ? (ntiles - 1 - warp) / NW + 1 : 0;  // this warp's tiles
  // the warp that walks the share's last tile holds position n - 1
  const bool holds_fresh = fresh && cnt > 0 && p1 == n && warp == (ntiles - 1) % NW;

  const uint32_t bar0 = base + lay.bars + 8 * warp * lay.depth;
  const uint32_t ring = base + warp * lay.depth * lay.slot;
  const int kbytes = lay.slot / 2;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NW * lay.depth; ++i) mbar_init(base + lay.bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the fresh row: its 16-byte chunks to lanes c < D / 8, written into the
  // pool now (no block of this launch reads that pool row: the one that
  // attends over it takes it from these registers)
  uint4 fk = make_uint4(0u, 0u, 0u, 0u), fv = fk;
  if (holds_fresh && lane < p.D / 8) {
    fk = *reinterpret_cast<const uint4*>(p.k_new + b * p.kns[0] + kvh * p.kns[1] + lane * 8);
    fv = *reinterpret_cast<const uint4*>(p.v_new + b * p.vns[0] + kvh * p.vns[1] + lane * 8);
    if (blockIdx.y == 0) {
      const int j = n - 1;
      const int blk = j / p.bs;
      const long long phys = min(max(p.table[b * p.nblk + blk], 0), p.nblocks - 1);
      const long long row = j - blk * p.bs;
      *reinterpret_cast<uint4*>(p.pool_k + phys * p.ks[0] + kvh * p.ks[1] + row * p.ks[2] +
                                lane * 8) = fk;
      *reinterpret_cast<uint4*>(p.pool_v + phys * p.vs[0] + kvh * p.vs[1] + row * p.vs[2] +
                                lane * 8) = fv;
    }
  }

  // q as the A operand of every k-step: rows g0 + r0 (and + 8 at GT = 16)
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* qb = p.q + b * p.qs[0] + kvh * p.qs[1] + g0 * p.qs[2];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + cq;
      qa[ks][0] = q_pair(qb, p.qs[2], r0, gn, c, p.D);
      qa[ks][1] = GT == 16 ? q_pair(qb, p.qs[2], r0 + 8, gn, c, p.D) : 0u;
      qa[ks][2] = q_pair(qb, p.qs[2], r0, gn, c + 8, p.D);
      qa[ks][3] = GT == 16 ? q_pair(qb, p.qs[2], r0 + 8, gn, c + 8, p.D) : 0u;
    }
  }

  // the pool blocks of this warp's tiles 32 at a time: lane l holds those
  // of its tile batch * 32 + l, one per row box
  constexpr int MAX_BOXES = TILE / 8;
  const int R = p.box_rows;
  int phys[MAX_BOXES];
#pragma unroll
  for (int rb = 0; rb < MAX_BOXES; ++rb) phys[rb] = 0;
  auto load_blocks = [&](int batch) {
    const int lo = p0 + (warp + (batch * 32 + lane) * NW) * TILE;
#pragma unroll
    for (int rb = 0; rb < MAX_BOXES; ++rb)
      if (rb * R < TILE && lo + rb * R < p1)
        phys[rb] = min(max(p.table[b * p.nblk + (lo + rb * R) / p.bs], 0), p.nblocks - 1);
  };
  // stage i % DEPTH takes this warp's i-th tile: lane 0 arms the stage's
  // barrier and issues one box per (row box, 64 columns) of K, then of V
  auto issue = [&](int i) {
    if (i > 0 && (i & 31) == 0) load_blocks(i >> 5);
    int ph[MAX_BOXES];
#pragma unroll
    for (int rb = 0; rb < MAX_BOXES; ++rb) ph[rb] = __shfl_sync(FULL, phys[rb], i & 31);
    if (lane != 0) return;
    const int lo = p0 + (warp + i * NW) * TILE;
    const int nbox = (min(p1, lo + TILE) - lo + R - 1) / R;
    constexpr int COLS = DT / BOX_COLS;
    const uint32_t kdst = ring + (i % lay.depth) * lay.slot;
    const uint32_t bar = bar0 + 8 * (i % lay.depth);
    mbar_expect_tx(bar, 2 * nbox * COLS * R * 128);
#pragma unroll
    for (int rb = 0; rb < MAX_BOXES; ++rb) {
      if (rb >= nbox) break;
      const int j = lo + rb * R;
      const int row = j - (j / p.bs) * p.bs;
      const int phys = ph[rb];
#pragma unroll
      for (int cb = 0; cb < COLS; ++cb) {
        const uint32_t off = cb * BOX_BYTES + rb * R * 128;
        tma_load(kdst + off, &tk, bar, cb * BOX_COLS, row, kvh, phys);
        tma_load(kdst + kbytes + off, &tv, bar, cb * BOX_COLS, row, kvh, phys);
      }
    }
  };
  __syncthreads();  // the barriers are initialised
  if (mine > 0) {
    load_blocks(0);
    for (int i = 0; i < lay.depth && i < mine; ++i) issue(i);
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // ldmatrix row addresses: lanes 8i..8i+7 give matrix i's rows.  K: the
  // matrices are (positions 0-7, chunk 2ks), (0-7, 2ks+1), (8-15, 2ks),
  // (8-15, 2ks+1); V (transposed): (0-7, 2jp), (8-15, 2jp), (0-7, 2jp+1),
  // (8-15, 2jp+1)
  const int mi = lane >> 3;
  const int k_row = (mi >> 1) * 8 + (lane & 7);
  const int v_row = (mi & 1) * 8 + (lane & 7);

  for (int i = 0; i < mine; ++i) {
    const int s = i % lay.depth;
    mbar_wait(bar0 + 8 * s, (i / lay.depth) & 1);
    const uint32_t kt = ring + s * lay.slot;
    const uint32_t vt = kt + kbytes;
    const int lo = (warp + i * NW) * TILE;  // local to the share
    const int tcnt = min(TILE, cnt - lo);
    if (holds_fresh && i == mine - 1) {     // position n - 1 from the input, not the pool
      const int rr = n - 1 - (p0 + lo);
      if (lane < p.D / 8) {
        *reinterpret_cast<uint4*>(smem + (kt - base) + swz(rr, lane)) = fk;
        *reinterpret_cast<uint4*>(smem + (vt - base) + swz(rr, lane)) = fv;
      }
      __syncwarp();
    }
    // S = Q K^T: NS tiles of 8 positions
    constexpr int NS = TILE / 8;
    float sc[NS][4];
#pragma unroll
    for (int t = 0; t < NS; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int t = 0; t < NS; t += 2) {
        uint32_t kb[4];
        ldsm_x4(kt + swz(t * 8 + k_row, 2 * ks + (mi & 1)), kb);
        mma_bf16(sc[t], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[t + 1], qa[ks], kb[2], kb[3]);
      }
    }
    // scaled to base 2; positions past the share's end masked
#pragma unroll
    for (int t = 0; t < NS; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[t][e] = t * 8 + cq + (e & 1) < tcnt ? sc[t][e] * p.scale_log2 : -INFINITY;
    // the online softmax, once per tile: a row's max over its quad; P as
    // the A operand of each 16-position PV k-step, cast to the cache dtype
    uint32_t pa[NS / 2][4];
    {
      float mx = m0;
#pragma unroll
      for (int t = 0; t < NS; ++t) mx = fmaxf(mx, fmaxf(sc[t][0], sc[t][1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float alpha = exp2_approx(m0 - mx);  // 0 while m0 is still -inf
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const float e0 = exp2_approx(sc[t][0] - mx), e1 = exp2_approx(sc[t][1] - mx);
        sum += e0 + e1;
        pa[t / 2][(t & 1) * 2] = pack_f32(e0, e1);
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
      float mx = m1;
#pragma unroll
      for (int t = 0; t < NS; ++t) mx = fmaxf(mx, fmaxf(sc[t][2], sc[t][3]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float alpha = exp2_approx(m1 - mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const float e2 = exp2_approx(sc[t][2] - mx), e3 = exp2_approx(sc[t][3] - mx);
        sum += e2 + e3;
        pa[t / 2][(t & 1) * 2 + 1] = pack_f32(e2, e3);
      }
      l1 = l1 * alpha + sum;
      m1 = mx;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2] *= alpha;
        acc[j][3] *= alpha;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) pa[kk][1] = pa[kk][3] = 0u;
    }
    // O += P V.  V rows past the share's end may hold anything (a stage's
    // earlier tile, another row's data): their halves are zeroed, as p = 0
    // there would not cancel a NaN
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const int c0 = kk * 16 + cq;
      const uint32_t keep_lo = (c0 < tcnt ? 0xffffu : 0u) | (c0 + 1 < tcnt ? 0xffff0000u : 0u);
      const uint32_t keep_hi =
          (c0 + 8 < tcnt ? 0xffffu : 0u) | (c0 + 9 < tcnt ? 0xffff0000u : 0u);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t vb[4];
        ldsm_x4_trans(vt + swz(kk * 16 + v_row, 2 * jp + (mi >> 1)), vb);
        mma_bf16(acc[2 * jp], pa[kk], vb[0] & keep_lo, vb[1] & keep_hi);
        mma_bf16(acc[2 * jp + 1], pa[kk], vb[2] & keep_lo, vb[3] & keep_hi);
      }
    }
    __syncwarp();  // every lane has read the stage: it may be refilled
    if (i + lay.depth < mine) issue(i + lay.depth);
  }
  // each lane's l covers its quad's columns: sum over the quad
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  // rank 0's gather shares the ring's space: a rank writes it only once
  // every rank of the cluster is past its walk
  if (p.split > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();  // every warp is done with its ring: the scratch reuses it

  // the warps' (m, l, acc) per row, then the block's combine
  float* sm_m = reinterpret_cast<float*>(smem + lay.scratch);  // [NW][GT]
  float* sm_l = sm_m + NW * GT;                                 // [NW][GT]
  float* sm_acc = sm_l + NW * GT;                               // [NW][GT][D]
  float* sm_w = reinterpret_cast<float*>(smem + lay.weights);   // [MAX_SPLIT + 2][GT]
  float* gather = reinterpret_cast<float*>(smem + lay.gather);  // [MAX_SPLIT][GT * (D + 2)]
  if ((lane & 3) == 0) {
    if (r0 < gn) {
      sm_m[warp * GT + r0] = m0;
      sm_l[warp * GT + r0] = l0;
    }
    if (GT == 16 && r0 + 8 < gn) {
      sm_m[warp * GT + r0 + 8] = m1;
      sm_l[warp * GT + r0 + 8] = l1;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = j * 8 + cq;
    if (d < p.D) {
      if (r0 < gn)
        *reinterpret_cast<float2*>(sm_acc + (warp * GT + r0) * p.D + d) =
            make_float2(acc[j][0], acc[j][1]);
      if (GT == 16 && r0 + 8 < gn)
        *reinterpret_cast<float2*>(sm_acc + (warp * GT + r0 + 8) * p.D + d) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
  combine_store<__nv_bfloat16, NW, GT>(p, rank, bk, g0, gn, sm_m, sm_l, sm_acc, sm_w, gather);
}

// The float32 path.  A block is (row, kv head, rank, tile of GT query
// rows); each warp walks every NW-th tile of F32_TILE positions of the
// rank's share through its own TMA ring (see the note at the top).
template <int DW, int GT>
__global__ void __launch_bounds__(f32_warps(32 * DW) * 32)
    paged_decode_f32_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const ParamsT<float> p) {
  constexpr int NW = f32_warps(32 * DW);
  constexpr int DT = 32 * DW;  // columns a staged row: DW boxes of 32, zeros past D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bk = blockIdx.x / p.split;  // b * KV + kv head
  const int b = bk / p.KV;
  const int kvh = bk - b * p.KV;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, p.G - g0);
  const LayoutF32 lay = layout_f32(p.D, GT);
  const int D = p.D;

  // Entry, ordered so that the loads which do not wait on the row's length
  // are in flight while it comes: the length, the table row toward L2, both
  // tensor maps, q into shared memory; each warp's lane 0 initialises its
  // own barriers, so no block-wide barrier stands before its first copies.
  const int len = p.lens[b];
  for (int c = threadIdx.x * 32; c < p.nblk; c += NW * 32 * 32)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p.table + b * p.nblk + c));
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  const uint32_t bar0 = base + lay.bars + 8 * warp * lay.depth;
  const uint32_t ring = base + warp * lay.depth * lay.stage;
  const int kbytes = lay.stage / 2;
  if (lane == 0) {
    for (int i = 0; i < lay.depth; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // q's rows to shared memory, zeros past the group and past D
  float* sq = reinterpret_cast<float*>(smem + lay.q);
  {
    const float* qb = p.q + b * p.qs[0] + kvh * p.qs[1] + g0 * p.qs[2];
    for (int e = threadIdx.x; e < GT * DT; e += NW * 32) {
      const int g = e / DT;
      const int d = e - g * DT;
      sq[e] = g < gn && d < D ? qb[g * p.qs[2] + d] : 0.f;
    }
  }

  const int width = p.nblk * p.bs;
  const int n = min(max(len, 0), width);
  const bool fresh = p.k_new != nullptr && (p.valid == nullptr || p.valid[b] != 0) && len >= 1 &&
                     len <= width;
  int p0, p1;
  share_of(n, p.split, p.bs, rank, p0, p1);
  const int cnt = p1 - p0;
  const int ntiles = (cnt + F32_TILE - 1) / F32_TILE;
  const int mine = warp < ntiles ? (ntiles - 1 - warp) / NW + 1 : 0;  // this warp's tiles
  // the warp that walks the share's last tile holds position n - 1
  const bool holds_fresh = fresh && cnt > 0 && p1 == n && warp == (ntiles - 1) % NW;
  // the fresh row's 16-byte chunks c = lane + 32 u, in registers from here:
  // the loads land while the walk's copies fly, and nothing waits on them
  // before the last tile
  constexpr int FCH = (DT / 4 + 31) / 32;
  float4 fk[FCH], fv[FCH];
#pragma unroll
  for (int u = 0; u < FCH; ++u) fk[u] = fv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (holds_fresh) {
    const float* kf = p.k_new + b * p.kns[0] + kvh * p.kns[1];
    const float* vf = p.v_new + b * p.vns[0] + kvh * p.vns[1];
#pragma unroll
    for (int u = 0; u < FCH; ++u) {
      const int c = lane + 32 * u;
      if (c < D / 4) {
        fk[u] = *reinterpret_cast<const float4*>(kf + 4 * c);
        fv[u] = *reinterpret_cast<const float4*>(vf + 4 * c);
      }
    }
  }

  // the pool blocks of this warp's tiles 32 at a time: lane l holds that of
  // its tile batch * 32 + l (a tile of 8 lies in one pool block: shares
  // start on a pool block and bs is a multiple of 8)
  int phys = 0;
  auto load_blocks = [&](int batch) {
    const int lo = p0 + (warp + (batch * 32 + lane) * NW) * F32_TILE;
    if (lo < p1) phys = min(max(p.table[b * p.nblk + lo / p.bs], 0), p.nblocks - 1);
  };
  // stage i % depth takes this warp's i-th tile: lane 0 arms the stage's
  // barrier and issues one box per 32 columns of K, then of V
  auto issue = [&](int i) {
    if (i > 0 && (i & 31) == 0) load_blocks(i >> 5);
    const int ph = __shfl_sync(FULL, phys, i & 31);
    if (lane != 0) return;
    const int lo = p0 + (warp + i * NW) * F32_TILE;
    const int row = lo - (lo / p.bs) * p.bs;
    const uint32_t kdst = ring + (i % lay.depth) * lay.stage;
    const uint32_t bar = bar0 + 8 * (i % lay.depth);
    mbar_expect_tx(bar, lay.stage);
#pragma unroll
    for (int cb = 0; cb < DW; ++cb) {
      tma_load(kdst + cb * F32_BOX_BYTES, &tk, bar, cb * F32_BOX_COLS, row, kvh, ph);
      tma_load(kdst + kbytes + cb * F32_BOX_BYTES, &tv, bar, cb * F32_BOX_COLS, row, kvh, ph);
    }
  };
  __syncwarp();  // this warp's barriers are initialised
  if (mine > 0) {
    load_blocks(0);
    for (int i = 0; i < lay.depth && i < mine; ++i) issue(i);
  }
  __syncthreads();  // q is in shared memory

  // scores: lane = r + 8 * part takes position r of a tile and the row's
  // 16-byte chunks part, part + 4, ...; PV: every 32nd column a lane
  const int r = lane & 7;
  const int part = lane >> 3;
  float m[GT], l[GT], acc[GT][DW];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < DW; ++t) acc[g][t] = 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    const int s = i % lay.depth;
    mbar_wait(bar0 + 8 * s, (i / lay.depth) & 1);
    unsigned char* kt = smem + (ring - base) + s * lay.stage;
    const unsigned char* vt = kt + kbytes;
    const int lo = p0 + (warp + i * NW) * F32_TILE;
    const int tcnt = min(F32_TILE, p1 - lo);  // >= 1
    if (holds_fresh && i == mine - 1) {       // position n - 1 from the input, not the pool
      const int rr = n - 1 - lo;
#pragma unroll
      for (int u = 0; u < FCH; ++u) {
        const int c = lane + 32 * u;
        if (c < D / 4) {
          const int off = (c >> 3) * F32_BOX_BYTES + rr * 128 + (((c & 7) ^ rr) << 4);
          *reinterpret_cast<float4*>(kt + off) = fk[u];
          *reinterpret_cast<float4*>(kt + kbytes + off) = fv[u];
        }
      }
      __syncwarp();
    }
    // this lane's part of its position's dot products with the query rows
    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] = 0.f;
#pragma unroll
    for (int k = 0; k < DT / 16; ++k) {
      const int c = part + 4 * k;
      const float4 kv = *reinterpret_cast<const float4*>(
          kt + (c >> 3) * F32_BOX_BYTES + r * 128 + (((c & 7) ^ r) << 4));
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + g * DT + 4 * c);
        sc[g] = fmaf(qv.x, kv.x, sc[g]);
        sc[g] = fmaf(qv.y, kv.y, sc[g]);
        sc[g] = fmaf(qv.z, kv.z, sc[g]);
        sc[g] = fmaf(qv.w, kv.w, sc[g]);
      }
    }
    // the online softmax over the tile, scaled to base 2: the parts' sums
    // (the same bits in all four), the tile's max over its 8 positions;
    // each lane keeps its own position's share of l
    float pr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sc[g] += __shfl_xor_sync(FULL, sc[g], 8);
      sc[g] += __shfl_xor_sync(FULL, sc[g], 16);
      const float sg = r < tcnt ? sc[g] * p.scale_log2 : -INFINITY;
      float mx = sg;
#pragma unroll
      for (int o = 1; o < F32_TILE; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float mnew = fmaxf(m[g], mx);            // finite: the tile holds a position
      const float alpha = exp2_approx(m[g] - mnew);  // 0 while m is still -inf
      pr[g] = exp2_approx(sg - mnew);                // 0 off the tile
      l[g] = fmaf(l[g], alpha, pr[g]);
#pragma unroll
      for (int t = 0; t < DW; ++t) acc[g][t] *= alpha;
      m[g] = mnew;
    }
    // O += P V from the stage: position jj's p from lane jj, its V row's
    // columns lane + 32 t (rows past tcnt are never read)
#pragma unroll
    for (int jj = 0; jj < F32_TILE; ++jj) {
      if (jj >= tcnt) break;
      float v[DW];
#pragma unroll
      for (int t = 0; t < DW; ++t)
        v[t] = *reinterpret_cast<const float*>(vt + t * F32_BOX_BYTES + jj * 128 +
                                               (((lane >> 2) ^ jj) << 4) + (lane & 3) * 4);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pj = __shfl_sync(FULL, pr[g], jj);
#pragma unroll
        for (int t = 0; t < DW; ++t) acc[g][t] = fmaf(pj, v[t], acc[g][t]);
      }
    }
    __syncwarp();  // every lane has read the stage: it may be refilled
    if (i + lay.depth < mine) issue(i + lay.depth);
  }
  // l over the 8 positions (the four parts of a position hold the same l)
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int o = 1; o < F32_TILE; o <<= 1) l[g] += __shfl_xor_sync(FULL, l[g], o);
  // the fresh row into the pool, once this warp's copies have landed (no
  // block of this launch reads that pool row: a block that attends over it
  // takes it from k_new / v_new over whatever its copy of that row brought)
  if (holds_fresh && blockIdx.y == 0) {
    const int j = n - 1;
    const int blk = j / p.bs;
    const long long pb = min(max(p.table[b * p.nblk + blk], 0), p.nblocks - 1);
    const long long row = j - blk * p.bs;
#pragma unroll
    for (int u = 0; u < FCH; ++u) {
      const int c = lane + 32 * u;
      if (c < D / 4) {
        *reinterpret_cast<float4*>(p.pool_k + pb * p.ks[0] + kvh * p.ks[1] + row * p.ks[2] +
                                   4 * c) = fk[u];
        *reinterpret_cast<float4*>(p.pool_v + pb * p.vs[0] + kvh * p.vs[1] + row * p.vs[2] +
                                   4 * c) = fv[u];
      }
    }
  }
  // rank 0's gather shares the ring's space: a rank writes it only once
  // every rank of the cluster is past its walk
  if (p.split > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();  // every warp is done with its ring: the scratch reuses it

  float* sm_m = reinterpret_cast<float*>(smem + lay.m);    // [NW][GT]
  float* sm_l = reinterpret_cast<float*>(smem + lay.l);    // [NW][GT]
  float* sm_acc = reinterpret_cast<float*>(smem + lay.acc);  // [NW][GT][D]
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= gn) break;
    if (lane == 0) {
      sm_m[warp * GT + g] = m[g];
      sm_l[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < DW; ++t)
      if (lane + 32 * t < D) sm_acc[(warp * GT + g) * D + lane + 32 * t] = acc[g][t];
  }
  combine_store<float, NW, GT>(p, rank, bk, g0, gn, sm_m, sm_l, sm_acc,
                               reinterpret_cast<float*>(smem + lay.weights),
                               reinterpret_cast<float*>(smem + lay.gather));
}

// The int8 path.  A block is (row, kv head, rank, tile of GT query rows);
// each warp walks every NW-th tile of i8w::TILE positions of the rank's
// share through its own ring, staged and stepped by int8_walk.cuh (see the
// note at the top).
template <int DT, int GT>
__global__ void __launch_bounds__(nwarps(DT) * 32)
    paged_decode_i8_kernel(const Params p) {
  constexpr int NW = nwarps(DT);
  constexpr int TILE = i8w::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127) & ~127u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bk = blockIdx.x / p.split;  // b * KV + kv head
  const int b = bk / p.KV;
  const int kvh = bk - b * p.KV;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, p.G - g0);
  const i8w::Layout lay = i8w::layout(p.D, GT);
  const int D = p.D;
  int8_t* pool_k = reinterpret_cast<int8_t*>(p.pool_k);
  int8_t* pool_v = reinterpret_cast<int8_t*>(p.pool_v);

  // the row's length, at most the table's width, and whether its fresh
  // row is written and attended from the input
  const int len = p.lens[b];
  // the table row's prefetch toward L2 flies while it comes
  for (int c = threadIdx.x * 32; c < p.nblk; c += NW * 32 * 32)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p.table + b * p.nblk + c));
  const int width = p.nblk * p.bs;
  const int n = min(max(len, 0), width);
  const bool fresh = p.k_new != nullptr && (p.valid == nullptr || p.valid[b] != 0) && len >= 1 &&
                     len <= width;
  int p0, p1;
  share_of(n, p.split, p.bs, rank, p0, p1);
  const int cnt = p1 - p0;
  const int ntiles = (cnt + TILE - 1) / TILE;
  const int mine = warp < ntiles ? (ntiles - 1 - warp) / NW + 1 : 0;  // this warp's tiles
  // the warp that walks the share's last tile holds position n - 1
  const bool holds_fresh = fresh && cnt > 0 && p1 == n && warp == (ntiles - 1) % NW;

  const uint32_t bar0 = base + lay.bars + 8 * warp * lay.depth;
  const uint32_t ring = base + warp * lay.depth * lay.stage;
  if (lane == 0) {
    for (int i = 0; i < lay.depth; ++i) mbar_init(bar0 + 8 * i, i8w::COPIERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the pool blocks of this warp's tiles 32 at a time: lane l holds, for
  // its tile batch * 32 + l, the block and first row of positions lo and lo
  // + 8 (a tile's 8-row halves each lie in one pool block: shares start on
  // a pool block and bs is a multiple of 8)
  int phys[2] = {0, 0}, row0[2] = {0, 0};
  auto load_blocks = [&](int batch) {
    const int lo = p0 + (warp + (batch * 32 + lane) * NW) * TILE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lo + 8 * h;
      if (j < p1) {
        const int blk = j / p.bs;
        phys[h] = min(max(p.table[b * p.nblk + blk], 0), p.nblocks - 1);
        row0[h] = j - blk * p.bs;
      }
    }
  };
  // stage s takes this warp's i-th tile: rows 8 h .. 8 h + 7 from pool
  // block ph[h], rows rw[h] .., codes and scales (K and V planes [N, KV, bs,
  // D] and [N, KV, bs])
  auto issue = [&](int i, int s) {
    if (i > 0 && (i & 31) == 0) load_blocks(i >> 5);
    const long long ph0 = __shfl_sync(FULL, phys[0], i & 31);
    const long long ph1 = __shfl_sync(FULL, phys[1], i & 31);
    const long long rw0 = __shfl_sync(FULL, row0[0], i & 31);
    const long long rw1 = __shfl_sync(FULL, row0[1], i & 31);
    const int8_t* const k0 = pool_k + ph0 * p.ks[0] + kvh * p.ks[1] + rw0 * D;
    const int8_t* const k1 = pool_k + ph1 * p.ks[0] + kvh * p.ks[1] + rw1 * D;
    const int8_t* const v0 = pool_v + ph0 * p.vs[0] + kvh * p.vs[1] + rw0 * D;
    const int8_t* const v1 = pool_v + ph1 * p.vs[0] + kvh * p.vs[1] + rw1 * D;
    const long long s0 = (ph0 * p.KV + kvh) * p.bs + rw0;
    const long long s1 = (ph1 * p.KV + kvh) * p.bs + rw1;
    const int lo = p0 + (warp + i * NW) * TILE;
    i8w::stage_tile<DT>(ring + s * lay.stage, lane, D, bar0 + 8 * s,
                        [&](int r, const int8_t*& k, const int8_t*& v, const float*& ks,
                            const float*& vs) {
                          if (lo + r >= p1) return false;
                          const bool h = r >= 8;
                          const int rr = r & 7;
                          k = (h ? k1 : k0) + rr * D;
                          v = (h ? v1 : v0) + rr * D;
                          ks = p.k_scale + (h ? s1 : s0) + rr;
                          vs = p.v_scale + (h ? s1 : s0) + rr;
                          return true;
                        });
  };
  // the fresh rows' loads go first, then the ring's copies, then q's loads,
  // whose use waits for them while the copies fly; the fresh rows are
  // quantized meanwhile
  i8w::Fresh<DT> fr;
  if (holds_fresh)
    fr.load(p.k_new + b * p.kns[0] + kvh * p.kns[1], p.v_new + b * p.vns[0] + kvh * p.vns[1], D,
            lane);
  __syncwarp();  // this warp's barriers are initialised
  if (mine > 0) {
    load_blocks(0);
    for (int i = 0; i < lay.depth && i < mine; ++i) issue(i, i);
  }
  i8w::Walk<DT, GT> walk;
  walk.begin(p.q + b * p.qs[0] + kvh * p.qs[1] + g0 * p.qs[2], p.qs[2], gn, D, lane);
  if (holds_fresh) fr.quantize();
  for (int i = 0, s = 0, phase = 0; i < mine; ++i) {  // tile i in stage s = i % depth
    mbar_wait(bar0 + 8 * s, phase);
    unsigned char* tile = smem + (ring - base) + s * lay.stage;
    const int lo = p0 + (warp + i * NW) * TILE;
    if (holds_fresh && i == mine - 1) fr.stage(tile, n - 1 - lo, D, lane);
    walk.step(tile, min(TILE, p1 - lo), p.scale_log2, lane);
    __syncwarp();  // every lane has read the stage: it may be refilled
    if (i + lay.depth < mine) issue(i + lay.depth, s);
    if (++s == lay.depth) s = 0, phase ^= 1;
  }
  walk.finish();
  // the fresh codes and scales into the pool, once this warp's copies have
  // landed (a block that attends over that row takes it from its own
  // registers over whatever its copy brought)
  if (holds_fresh && blockIdx.y == 0) {
    const int j = n - 1;
    const int blk = j / p.bs;
    const long long pb = min(max(p.table[b * p.nblk + blk], 0), p.nblocks - 1);
    const long long row = j - blk * p.bs;
    const long long srow = (pb * p.KV + kvh) * p.bs + row;
    fr.write(pool_k + pb * p.ks[0] + kvh * p.ks[1] + row * p.ks[2],
             pool_v + pb * p.vs[0] + kvh * p.vs[1] + row * p.vs[2], p.k_scale + srow,
             p.v_scale + srow, D, lane);
  }
  // rank 0's gather shares the ring's space: a rank writes it only once
  // every rank of the cluster is past its walk
  if (p.split > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();  // every warp is done with its ring: the scratch reuses it

  float* sm_m = reinterpret_cast<float*>(smem + lay.m);      // [NW][GT]
  float* sm_l = reinterpret_cast<float*>(smem + lay.l);      // [NW][GT]
  float* sm_acc = reinterpret_cast<float*>(smem + lay.acc);  // [NW][GT][D]
  walk.store(sm_m, sm_l, sm_acc, warp, gn, D, lane);
  combine_store<__nv_bfloat16, NW, GT>(p, rank, bk, g0, gn, sm_m, sm_l, sm_acc,
                                       reinterpret_cast<float*>(smem + lay.weights),
                                       reinterpret_cast<float*>(smem + lay.gather));
}

using KernelF32 = void (*)(const CUtensorMap, const CUtensorMap, const ParamsT<float>);

// per (columns a lane, query rows) and device: the shared-memory opt-in is set
std::atomic<bool> g_smem_set_f32[4][4][MAX_DEVICES];

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const Params);

// per (tile width, row tile) and device: the shared-memory opt-in is set
std::atomic<bool> g_smem_set[3][2][MAX_DEVICES];

using KernelI8 = void (*)(const Params);

// per (tile width, row tile) and device: the int8 path's opt-in is set
std::atomic<bool> g_smem_set_i8[3][2][MAX_DEVICES];

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for this head dim, group
// (query heads per kv head), pool block size and dtype code (0 =
// bfloat16, 1 = float32), or -1 with the reason in why.
int flash_decode_paged_smem_bytes(int head_dim, int group, int block_size, int dtype_code,
                                  char* why, int why_len) {
  return plan(head_dim, group, block_size, dtype_code, why, why_len);
}

}  // extern "C"

namespace {

template <typename T>
ParamsT<T> fill_params(const void* q, void* pool_k, void* pool_v, const int* table,
                       const int* lens, const void* k_new, const void* v_new, const void* valid,
                       void* o, int nblocks, int nblk, int bs, int KV, int G, int D, int split,
                       const long long* strides) {
  ParamsT<T> p;
  p.q = static_cast<const T*>(q);
  p.pool_k = static_cast<T*>(pool_k);
  p.pool_v = static_cast<T*>(pool_v);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  p.table = table;
  p.lens = lens;
  p.k_new = static_cast<const T*>(k_new);
  p.v_new = static_cast<const T*>(v_new);
  for (int i = 0; i < 2; ++i) {
    p.kns[i] = strides[9 + i];
    p.vns[i] = strides[11 + i];
  }
  p.valid = static_cast<const unsigned char*>(valid);
  p.k_scale = p.v_scale = nullptr;
  p.o = static_cast<T*>(o);
  p.nblk = nblk;
  p.bs = bs;
  p.nblocks = nblocks;
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.split = split;
  p.box_rows = bs % MAX_BOX_ROWS == 0 ? MAX_BOX_ROWS : 8;
  p.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  return p;
}

// a launch of a cluster of `split` blocks along x
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, dim3 grid, int threads, int smem, int split, void* stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A 4-d map over an f32 pool [N][KV][bs][D] (element strides st = block,
// kv head, row; d is 1) with boxes of 32 columns x F32_TILE rows, 128-byte
// swizzle, zeros out of bounds; a dimension of size 1 takes the row stride
// (TMA wants every stride a multiple of 16 bytes), as encode() does.
bool encode_f32(CUtensorMap* map, const void* base, int N, int heads, int S, int D,
                const long long* st) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t s_bytes = static_cast<cuuint64_t>(st[2]) * 4;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(N)};
  cuuint64_t strides[3] = {s_bytes, heads == 1 ? s_bytes : static_cast<cuuint64_t>(st[1]) * 4,
                           N == 1 ? s_bytes : static_cast<cuuint64_t>(st[0]) * 4};
  cuuint32_t box[4] = {F32_BOX_COLS, F32_TILE, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_f32(const ParamsT<float>& p, int B, int smem, void* stream,
                       const CUtensorMap& tk, const CUtensorMap& tv) {
  const int GT = f32_rows(p.G);
  const int DW = f32_cols(p.D);
  const int ci = log2_index(DW);
  const int gi = log2_index(GT);
  const KernelF32 kernels[4][4] = {
      {paged_decode_f32_kernel<1, 1>, paged_decode_f32_kernel<1, 2>,
       paged_decode_f32_kernel<1, 4>, paged_decode_f32_kernel<1, 8>},
      {paged_decode_f32_kernel<2, 1>, paged_decode_f32_kernel<2, 2>,
       paged_decode_f32_kernel<2, 4>, paged_decode_f32_kernel<2, 8>},
      {paged_decode_f32_kernel<4, 1>, paged_decode_f32_kernel<4, 2>,
       paged_decode_f32_kernel<4, 4>, paged_decode_f32_kernel<4, 8>},
      {paged_decode_f32_kernel<8, 1>, paged_decode_f32_kernel<8, 2>,
       paged_decode_f32_kernel<8, 4>, paged_decode_f32_kernel<8, 8>}};
  const KernelF32 kernel = kernels[ci][gi];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!g_smem_set_f32[ci][gi][dev].load()) {
    // the largest this instance asks for: the widest head dim it serves
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             layout_f32(32 * DW, GT).bytes);
    if (e != cudaSuccess) return e;
    g_smem_set_f32[ci][gi][dev].store(true);
  }
  return launch_cluster(kernel, dim3(p.split * B * p.KV, (p.G + GT - 1) / GT),
                        f32_warps(p.D) * 32, smem, p.split, stream, tk, tv, p);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  dtype_code 0:
// q, the pools, k_new/v_new and o are bfloat16; 1: float32.  q [B,KV,G,D]
// with unit stride along D; pools pool_k/pool_v [nblocks,KV,bs,D] with
// unit stride along D, 16-byte aligned bases and strides that are
// multiples of 16 bytes (TMA's rules, on both paths); table [B,nblk] int32 contiguous; lens [B] int32 (row b
// attends over positions [0, lens[b]), clamped to [0, nblk*bs]);
// k_new/v_new [B,KV,1,D] with 16-byte aligned rows, or null for no fused
// write; valid [B] bool or null (every row valid); strides[13] = (b, kv
// head, row) element strides of q, (block, kv head, row) of pool_k and
// pool_v, (b, kv head) of k_new and v_new; o [B,KV,G,D] contiguous.  Each
// (b, kv head, row tile) is a cluster of `split` blocks (1, 2, 4 or 8)
// that split the row's positions by share_of.
int flash_decode_paged_launch(const void* q, void* pool_k, void* pool_v, const int* table,
                              const int* lens, const void* k_new, const void* v_new,
                              const void* valid, void* o, int nblocks, int nblk, int bs, int B,
                              int KV, int G, int D, int split, int dtype_code,
                              const long long* strides, void* stream) {
  const int smem = plan(D, G, bs, dtype_code, nullptr, 0);
  if (smem < 0 || B < 1 || KV < 1 || nblocks < 1 || nblk < 1 ||
      static_cast<long long>(nblk) * bs > (1 << 30) ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      (k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype_code == DTYPE_F32) {
    const ParamsT<float> p = fill_params<float>(q, pool_k, pool_v, table, lens, k_new, v_new,
                                                valid, o, nblocks, nblk, bs, KV, G, D, split,
                                                strides);
    CUtensorMap tk, tv;
    if (!encode_f32(&tk, pool_k, nblocks, KV, bs, D, strides + 3) ||
        !encode_f32(&tv, pool_v, nblocks, KV, bs, D, strides + 6))
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = launch_f32(p, B, smem, stream, tk, tv);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const Params p = fill_params<__nv_bfloat16>(q, pool_k, pool_v, table, lens, k_new, v_new, valid,
                                              o, nblocks, nblk, bs, KV, G, D, split, strides);
  CUtensorMap tk, tv;
  if (!encode(&tk, pool_k, nblocks, KV, bs, D, strides + 3, p.box_rows) ||
      !encode(&tv, pool_v, nblocks, KV, bs, D, strides + 6, p.box_rows))
    return (int)cudaErrorInvalidValue;

  const int GT = G > 8 ? 16 : 8;
  const int DT = tile_cols(D);
  const int wi = width_index(DT);
  const int gi = GT == 16 ? 1 : 0;
  const Kernel kernels[3][2] = {{paged_decode_kernel<64, 8>, paged_decode_kernel<64, 16>},
                                {paged_decode_kernel<128, 8>, paged_decode_kernel<128, 16>},
                                {paged_decode_kernel<256, 8>, paged_decode_kernel<256, 16>}};
  const Kernel kernel = kernels[wi][gi];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[wi][gi][dev].load()) {
    // the largest this instance asks for, over the head dims it serves
    int most = 0;
    for (int d = 8; d <= MAX_D; d += 8)
      if (tile_cols(d) == DT) most = std::max(most, layout_for(d, GT).bytes);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[wi][gi][dev].store(true);
  }
  e = launch_cluster(kernel, dim3(split * B * KV, (G + GT - 1) / GT), nwarps(D) * 32, smem, split,
                     stream, tk, tv, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The int8 pools' launch, on `stream`; returns cudaGetLastError() after the
// launch (0: launched).  As flash_decode_paged_launch with q, k_new/v_new
// and o bfloat16, the pools pool_k/pool_v int8 [nblocks,KV,bs,D] (D a
// multiple of 16; contiguous rows: a row stride of D, block and kv-head
// strides multiples of 16 bytes) and their scale planes pool_ks/pool_vs
// [nblocks,KV,bs] f32 contiguous.  The fused write stores each valid row's
// fresh K/V quantized (codes and scales) at position lens[b] - 1.
int flash_decode_paged_i8_launch(const void* q, void* pool_k, void* pool_v, void* pool_ks,
                                 void* pool_vs, const int* table, const int* lens,
                                 const void* k_new, const void* v_new, const void* valid, void* o,
                                 int nblocks, int nblk, int bs, int B, int KV, int G, int D,
                                 int split, const long long* strides, void* stream) {
  const int smem = plan(D, G, bs, DTYPE_I8, nullptr, 0);
  if (smem < 0 || B < 1 || KV < 1 || nblocks < 1 || nblk < 1 ||
      static_cast<long long>(nblk) * bs > (1 << 30) ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      (k_new == nullptr) != (v_new == nullptr) || pool_ks == nullptr || pool_vs == nullptr ||
      strides[5] != D || strides[8] != D)
    return (int)cudaErrorInvalidValue;
  Params p = fill_params<__nv_bfloat16>(q, pool_k, pool_v, table, lens, k_new, v_new, valid, o,
                                        nblocks, nblk, bs, KV, G, D, split, strides);
  p.k_scale = static_cast<float*>(pool_ks);
  p.v_scale = static_cast<float*>(pool_vs);
  const int GT = G > 8 ? 16 : 8;
  const int DT = tile_cols(D);
  const int wi = width_index(DT);
  const int gi = GT == 16 ? 1 : 0;
  const KernelI8 kernels[3][2] = {{paged_decode_i8_kernel<64, 8>, paged_decode_i8_kernel<64, 16>},
                                  {paged_decode_i8_kernel<128, 8>, paged_decode_i8_kernel<128, 16>},
                                  {paged_decode_i8_kernel<256, 8>, paged_decode_i8_kernel<256, 16>}};
  const KernelI8 kernel = kernels[wi][gi];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set_i8[wi][gi][dev].load()) {
    // the largest this instance asks for, over the head dims it serves
    int most = 0;
    for (int d = 16; d <= MAX_D; d += 16)
      if (tile_cols(d) == DT) most = std::max(most, i8w::layout(d, GT).bytes);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    g_smem_set_i8[wi][gi][dev].store(true);
  }
  e = launch_cluster(kernel, dim3(split * B * KV, (G + GT - 1) / GT), nwarps(D) * 32, smem, split,
                     stream, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* flash_decode_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
