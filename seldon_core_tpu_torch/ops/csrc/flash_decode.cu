// Flash decode for Hopper (sm_90a): one query token per (batch, kv head)
// group over a KV cache held in two segments, main[:n_main] ++
// chunk[:n_chunk], in one pass.
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/flash_decode.py
// (flash_decode :87, kernel body _decode_kernel :47, pallas_call :125) and
// computes what it computes:
//   * q [B,KV,G,D] (the G query heads of a kv head folded onto rows), k/v
//     segments [B,KV,L,D] at their stored (grouped) size, never repeated;
//   * scores (q.k) * (1/sqrt(D)) in f32 from bf16 inputs;
//   * an online softmax: running max m and normaliser l in f32, p = exp(s -
//     m) cast to bf16 (the cache dtype, JAX's p.astype(v.dtype)) before an
//     f32 PV product, the accumulator rescaled by exp(m_prev - m); the
//     scores are taken times log2 e and every exp is the SFU's exp2;
//   * o = acc / max(l, 1e-30) in q's dtype.
// The TPU kernel masks positions >= n_valid with -1e30 inside 128-slot
// blocks; this kernel reads only the valid positions of each segment and
// masks its own ragged edge, so it has no length rule: the L % 128 rule of
// the JAX function is a BlockSpec artefact that only the public Python
// function keeps, for parity.  The second segment is what the decode lane's
// two-tier cache needs (models/generate.py _attend_two_tier): the prefilled
// main cache and the chunk buffer that takes each new token's K/V.
// flash_decode over one cache passes a second segment of length 0.
//
// Bound on an H100 SXM: decode moves about G FLOP per byte of K/V (G = 4
// at the flagship: 16 heads over 4 kv heads), far below the ~295 at which
// the card becomes compute-bound, so the bound is the bytes: K and V of
// the valid positions read once.  At the served layer (B=32, KV=4, D=64,
// n_main=512, n_chunk=32) that is ~17.8 MB, ~5.3 us at 3.35 TB/s; HBM
// reaches that rate only with ~20 KB or more in flight on every SM.
//
// Design: the positions of each (b*KV + kv head, tile of up to 8 query
// rows) are split across the C blocks of one thread-block cluster (C = 1,
// 2, 4 or 8, launched with cudaLaunchKernelEx and a cluster dimension), so
// that the grid holds at least ~1.5 blocks per SM where the positions
// allow, and more than KV blocks at B = 1.  C and the split (span positions per
// block, the last one short) come from the caller
// (ops/flash_decode.py decode_split_plan) and depend only on B, KV, G, D
// and n_main + n_chunk: position j, counted across both segments, goes to
// block j / span, and within the block to slot (j % span) % slots, so a
// stream whose chunk buffer is merged into main at another point gives the
// same bits as one that is not.
//   * A block has 8 warps.  A cache row of D bf16 values is read as D/8
//     16-byte chunks by a group of lanes (lpr, the power of two >= D/8);
//     each lane group is a slot that takes every slots-th position of the
//     block's share, with its own (m, l, acc) over them, updated U
//     positions at a time.  The products are f32 FMAs on the CUDA cores:
//     at G = 4 the work is ~G FLOP per byte, and an m16 tensor-core tile
//     would be 3/4 padding.  Each score's sum over its lane group runs a
//     shuffle level at a time for all of a step's scores, so their
//     latencies overlap: on the card the walk is bound by these
//     instructions' latency more than by the bytes.
//   * K and V rows reach shared memory through a ring of NSTAGE stages
//     of U x slots positions (16 KB of K and V at D = 64), NSTAGE - 1
//     stages ahead of their use, by the bulk-copy engine
//     (cp.async.bulk, one copy per contiguous run of rows, completion on
//     an mbarrier per stage): 48 KB in flight per block, issued by one
//     thread, so the lanes spend no instructions on loads.  (Per-lane
//     16-byte cp.async copies measured no faster: the walk, not the
//     copies, sets a stage's time.)
//   * At the end the slots combine their (m, l, acc) in shared memory in a
//     fixed order.  With C > 1 each block stores its (m, l, acc) into rank
//     0's shared memory through distributed shared memory (map_shared_rank:
//     remote stores need no round trip, where remote loads would wait on
//     each), the cluster synchronises, and rank 0 combines them in rank
//     order: no scratch tensor, no atomics, and still one launch per call.
//     A repeat gives the same bits.
//
// The fused write.  With k_new/v_new ([B,KV,1,D]) the launch also does the
// decode step's K/V write (what kv_write.cu did in a launch of its own
// before every attention): the fresh row belongs at the last position, n -
// 1 over both segments (the chunk's last slot when n1 > 0, else main's),
// and is attended from the input, not read back.  The block whose share
// holds n - 1 (the last rank with a share, for every row tile) stops its
// bulk copies short of that slot, and in its last ring group the lane
// group that walks that slot stores the input row there, each lane its own
// 16-byte chunk, which it alone reads back: the walk itself is unchanged.
// Of those blocks the one of row tile 0 alone stores the row into the
// cache, with plain stores: no copy of this launch reads that slot, so the
// generic-proxy store never meets an async-proxy read of it.  The split
// still depends only on n, so a stream's merge of its chunk into main
// keeps its bits.
//
// The int8 K/V cache (kv_quant = "int8"; flash_decode_i8_launch,
// flash_decode_i8_kernel).  Segments of int8 codes with their scale planes
// k_s / v_s [B, KV, L] f32; the reference's _attend_two_tier with scales
// (generate.py:162-227, _grouped_qk and _pv_f32): a score is (q . k_int8) *
// (1/sqrt(D)) * k_s[j] in f32, V enters as p * v_s[j] rounded to bf16
// times v_int8, in f32; l sums the unscaled exp.
//   * What bounds it: the bytes, 2 D + 8 a position and kv head for K and V
//     with their scales (~9.75 MB, ~2.91 us at 3.35 TB/s at B=32, KV=4,
//     D=64 and 560 positions; ~21.7 us at 4,160).
//   * What held the first int8 design back (commit da270b9: this kernel's
//     template instantiated on int8 segments): 1.3x the bf16 kernel's time
//     at half its bytes, 31% of the byte bound at 4,160 positions.  Every
//     code went through the conversion pipe (a shift and an I2F a code: 32
//     I2F.S8 / I2FP.F32.S32 in the kernel's SASS at 4 rows, 16 results a
//     clock an SM against 128 FMAs); each slot loaded its positions' two
//     scales from global memory after its group's copies were issued, so
//     every group waited one round trip; the CUDA-core walk is bound by its
//     shuffle levels' latency; and every lane of the fresh row's group
//     re-read the whole bf16 row for its absmax.
//   * This design walks int8_walk.cuh's tiles, the paged kernel's int8 walk
//     too: each warp takes every NW-th tile of 16 positions of the block's
//     share through its own ring (2-4 stages, cp.async of 16-byte chunks
//     into a swizzled stage, the tile's k_s and v_s on the same stage and
//     mbarrier: no scale load in the walk); both products mma.sync
//     m16n8k16 with q's k order and V's n order permuted so each operand is
//     one or two vector loads without bank conflicts; the codes widened to
//     bf16 by two LOP3s and a bf16x2 add a pair (kvq::codes_bf16x2).  The
//     walk loop's SASS (hd 64, 8 rows) holds no I2F, no byte load and P's 2
//     F2FP.  A tile that straddles the end of main takes its rows from both
//     segments.  The split is i8_split_plan's (ops/flash_decode.py):
//     decode_split_plan at this walk's row tile and grid aim with a span
//     that is a multiple of 16, so tiles start at fixed global positions
//     and a row's bits still depend on n and C only (the ranks past n take
//     empty shares), doubled for long rows while two blocks an SM hold the
//     grid (B=32 at 4,160 positions: C = 2).  The combine is the warps',
//     then the cluster's through DSMEM, in a fixed order.
//   * The fused write: the warp that walks position n - 1 quantizes the
//     fresh bf16 rows once, spread over its 32 lanes with a warp reduction
//     (i8w::Fresh, the reference's quantizer bit for bit) while its first
//     copies fly, puts the codes and scales over that position's row of its
//     last stage, so it is attended as the reference writes and then reads
//     it, and in row tile 0 writes them into the slot after the walk.
//
// The continuous lane's block pool has a kernel of its own
// (flash_decode_paged.cu), with both products on the tensor cores.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>

#include "int8_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 256;
constexpr int MAX_GT = 8;              // query rows per block
constexpr int MAX_SPLIT = 8;           // blocks per cluster: the portable limit
constexpr int NSTAGE = 4;              // ring depth, in groups of U positions a slot
constexpr int SMEM_LIMIT = 232448;     // 227 KB opt-in per block on sm_90
constexpr int DTYPE_BF16 = 0;          // dtype codes of the wrappers
constexpr int DTYPE_I8 = 2;            // int8 K/V with f32 scales, bf16 q and o
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// positions per slot per ring stage: their K and V reach registers
// together; fewer at GT = 8 to stay clear of spills
__host__ __device__ constexpr int positions_per_stage(int GT) { return GT >= 8 ? 1 : 2; }

struct Segment {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long ks[3], vs[3];  // element strides of b, kv head, position (d is 1)
  int n;                   // positions read
};

struct Params {
  const __nv_bfloat16* q;
  long long qs[3];         // element strides of b, kv head, group row (d is 1)
  Segment seg[2];
  const __nv_bfloat16* k_new;  // [B, KV, 1, D] or null: no fused write
  const __nv_bfloat16* v_new;
  long long kns[2], vns[2];    // element strides of b and kv head of k_new, v_new
  __nv_bfloat16* o;        // [B, KV, G, D] contiguous
  int KV, G, D;
  int lpr;                 // lanes per cache row
  int split;               // C: blocks per cluster, one cluster per (b, kv head, row tile)
  int span;                // positions per block (the last block's share may be short)
  float scale_log2;         // (1/sqrt(D)) log2 e
};

// the power of two >= D / 8 (lanes that read one row, 16 bytes each)
__host__ __device__ inline int lanes_per_row(int D) {
  int lpr = 1;
  while (lpr * 8 < D) lpr <<= 1;
  return lpr;
}

// query rows a block takes: the power of two >= G, at most MAX_GT
inline int group_tile(int G) {
  int gt = 1;
  while (gt < G && gt < MAX_GT) gt <<= 1;
  return gt;
}

// Shared memory, in floats from the base: the ring (NSTAGE stages of K
// rows then V rows, U x slots positions each), which the slots' combine
// scratch (m, l, acc[lpr*8] per slot and row) reuses after the walk; then
// the slot weights per row; then, for each of up to MAX_SPLIT ranks, a
// block's (m, l, acc) per row: on rank 0 every rank of the cluster writes
// its own there; last, one mbarrier per ring stage, 8-byte aligned.
struct Layout {
  int scratch, weights, result, bars, bytes;
};

__host__ __device__ inline Layout layout_for(int D, int GT) {
  const int lpr = lanes_per_row(D);
  const int slots = NWARPS * (32 / lpr);
  const int hdp = lpr * 8;
  const int ring = NSTAGE * positions_per_stage(GT) * slots * D;  // floats: K and V rows
  const int scratch = slots * GT * (hdp + 2);
  Layout lay;
  lay.scratch = 0;
  lay.weights = ring > scratch ? ring : scratch;
  // the slot weights per row, later rank 0's rank weights and normaliser
  lay.result = lay.weights + (slots > MAX_SPLIT + 1 ? slots : MAX_SPLIT + 1) * GT;
  // mbarriers need 8-byte alignment: round up to an even float offset
  // (the weights' rows make the offset odd at 8 slots and GT = 1)
  lay.bars = (lay.result + MAX_SPLIT * GT * (hdp + 2) + 1) & ~1;
  lay.bytes = (lay.bars + 2 * NSTAGE) * 4;
  return lay;
}

// The shape and type rules: bf16, a head dim that is a multiple of 8 up to
// 256, a group of at least one row; the int8 cache (dtype code 2: int8 K/V,
// bf16 q) a head dim that is a multiple of 16 (a row of codes is whole
// 16-byte copies).  Returns the dynamic shared memory in bytes (the int8
// walk's is int8_walk.cuh's layout), or -1 with the reason in why (why may
// be null when why_len is 0).
int plan(int head_dim, int group, int dtype_code, char* why, int why_len) {
  if (dtype_code != DTYPE_BF16 && dtype_code != DTYPE_I8) {
    snprintf(why, why_len,
             "the flash-decode kernel takes bfloat16 q/k/v, or bfloat16 q with an int8 cache, "
             "only");
    return -1;
  }
  const int unit = dtype_code == DTYPE_I8 ? 16 : 8;
  if (head_dim < unit || head_dim > MAX_D || head_dim % unit != 0) {
    snprintf(why, why_len,
             "head dim %d: the flash-decode kernel takes a multiple of %d up to %d%s", head_dim,
             unit, MAX_D, dtype_code == DTYPE_I8 ? " with an int8 cache" : "");
    return -1;
  }
  if (group < 1) {
    snprintf(why, why_len, "group %d: the flash-decode kernel takes at least one query row",
             group);
    return -1;
  }
  const int smem = dtype_code == DTYPE_I8
                       ? i8w::layout(head_dim, i8w::row_tile(group)).bytes
                       : layout_for(head_dim, group_tile(group)).bytes;
  if (smem > SMEM_LIMIT) {
    snprintf(why, why_len, "flash decode needs %d KiB shared memory (budget %d KiB)",
             smem >> 10, SMEM_LIMIT >> 10);
    return -1;
  }
  return smem;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) { kvq::bf16x8(u, f); }

// 2^x on the SFU in one instruction: 0 for -inf (denormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of this parity has completed; traps
// after 2^33 clocks (seconds), so a fault ends the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// rows cache rows of row_bytes each, `stride` elements apart, into
// consecutive rows of shared memory by the bulk-copy engine, completion on
// bar: one copy when the rows are contiguous, else one a row
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, long long stride,
                                          int rows, int row_bytes, uint32_t bar) {
  const bool whole = stride * 2 == row_bytes;
  const int runs = whole ? 1 : rows;
  const int bytes = whole ? rows * row_bytes : row_bytes;
  for (int r = 0; r < runs; ++r)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst + r * row_bytes), "l"(src + r * stride), "r"(bytes), "r"(bar)
        : "memory");
}

// FRESH: the launch takes the decode step's K/V write (k_new/v_new set);
// without it the kernel is the plain attention, with none of the write's
// code
template <int GT, bool FRESH>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(const Params p) {
  constexpr int CB = 16;  // bytes of a lane's 8 values
  using Chunk = uint4;
  constexpr int U = positions_per_stage(GT);
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpr = p.lpr;
  const int rpw = 32 / lpr;            // rows (slots) per warp
  const int slots = NWARPS * rpw;
  const int sub = lane / lpr;
  const int c = lane - sub * lpr;      // the lane's 16-byte chunk of a row
  const int slot = warp * rpw + sub;
  const int d0 = c * 8;
  const bool active = d0 < p.D;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bk = blockIdx.x / p.split; // b * KV + kv head
  const int b = bk / p.KV;
  const int kvh = bk - b * p.KV;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, p.G - g0);
  // every block of the cluster must have started before another writes
  // into its shared memory: arrive now, wait before the first remote store
  if (p.split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const Segment& s0 = p.seg[0];
  const Segment& s1 = p.seg[1];
  const int n0 = s0.n;
  const int n = n0 + s1.n;
  // this block's share of the positions, by global index over both segments
  const int p0 = rank * p.span;
  const int cnt = max(0, min(n, p0 + p.span) - p0);
  // the block whose share ends at position n - 1 takes that row from
  // k_new/v_new when the write is fused in
  const bool holds_fresh = FRESH && cnt > 0 && p0 + cnt == n;
  const int copied = holds_fresh ? cnt - 1 : cnt;  // positions the ring copies
  const int T = slots * U;                       // positions per ring stage
  const int n_groups = (cnt + T - 1) / T;        // block-uniform
  const Layout lay = layout_for(p.D, GT);
  const int row_bytes = p.D * 2;
  const int stage_bytes = 2 * T * row_bytes;     // K rows, then V rows
  // where the fresh row sits in the ring: group, step and slot (-1: nowhere)
  const int fresh_grp = holds_fresh ? (cnt - 1) / T : -1;
  const int fresh_u = holds_fresh ? ((cnt - 1) % T) / slots : 0;
  const int fresh_slot = holds_fresh ? (cnt - 1) % slots : -1;
  const uint32_t ring = smem_u32(smem);
  const uint32_t bar0 = smem_u32(smem + lay.bars);
  // thread 0 loads ring group grp: local positions grp*T .. (in at most two
  // runs, split where main ends), K and V rows, and arms its barrier
  auto fill = [&](int grp) {
    if (grp >= n_groups) return;
    const int lo = grp * T;
    const int hi = min(copied, lo + T);  // short of the stale slot under a fused write
    const uint32_t kdst = ring + (grp % NSTAGE) * stage_bytes;
    const uint32_t bar = bar0 + 8 * (grp % NSTAGE);
    mbar_expect_tx(bar, 2 * max(hi - lo, 0) * row_bytes);
    for (int i = lo; i < hi;) {
      const int j = p0 + i;
      const bool in0 = j < n0;
      const int end = in0 ? min(hi, n0 - p0) : hi;
      const Segment& sg = in0 ? s0 : s1;
      const long long jj = in0 ? j : j - n0;
      const uint32_t off = (i - lo) * row_bytes;
      copy_rows(kdst + off, sg.k + b * sg.ks[0] + kvh * sg.ks[1] + jj * sg.ks[2], sg.ks[2],
                end - i, row_bytes, bar);
      copy_rows(kdst + T * row_bytes + off, sg.v + b * sg.vs[0] + kvh * sg.vs[1] + jj * sg.vs[2],
                sg.vs[2], end - i, row_bytes, bar);
      i = end;
    }
  };
  // the fresh row: the lane group that walks its slot loads it a group
  // ahead (its latency hidden behind the ring) and stores it into the
  // ring's empty slot; in row tile 0 the same lanes write it into its cache
  // slot (segment 1's last when it has positions, else segment 0's) as the
  // block leaves, after its last cluster barrier, whose release would
  // otherwise wait for the stores to reach memory
  const bool fresh_group = holds_fresh && slot == fresh_slot;
  const bool fresh_lanes = fresh_group && active;
  Chunk fk{}, fv{};
  auto load_fresh = [&]() {
    if (!fresh_group) return;
    const __nv_bfloat16* kr = p.k_new + b * p.kns[0] + kvh * p.kns[1];
    const __nv_bfloat16* vr = p.v_new + b * p.vns[0] + kvh * p.vns[1];
    if (!active) return;
    fk = *reinterpret_cast<const uint4*>(kr + d0);
    fv = *reinterpret_cast<const uint4*>(vr + d0);
  };
  auto write_fresh = [&]() {
    if (!fresh_lanes || blockIdx.y != 0) return;
    load_fresh();
    const bool w1 = s1.n > 0;  // the segment written
    const Segment& sw = w1 ? s1 : s0;
    const long long j = (w1 ? s1.n : n0) - 1;
    __nv_bfloat16* kd =
        const_cast<__nv_bfloat16*>(sw.k) + b * sw.ks[0] + kvh * sw.ks[1] + j * sw.ks[2];
    __nv_bfloat16* vd =
        const_cast<__nv_bfloat16*>(sw.v) + b * sw.vs[0] + kvh * sw.vs[1] + j * sw.vs[2];
    *reinterpret_cast<Chunk*>(kd + d0) = fk;
    *reinterpret_cast<Chunk*>(vd + d0) = fv;
  };
  if (fresh_grp == 0) load_fresh();
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const __nv_bfloat16* qp = p.q + b * p.qs[0] + kvh * p.qs[1] + (g0 + g) * p.qs[2] + d0;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = (g < gn && active) ? __bfloat162float(qp[e]) : 0.f;
  }
  // thread 0 starts the first NSTAGE - 1 groups' copies while q is on its
  // way (q's loads go first: behind the copies they would wait for them)
  if (threadIdx.x == 0) {
    for (int st = 0; st < NSTAGE; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < NSTAGE - 1; ++st) fill(st);
  }
  __syncthreads();  // the barriers are initialised

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }


  const unsigned char* smem_bytes = reinterpret_cast<const unsigned char*>(smem);
  for (int grp = 0; grp < n_groups; ++grp) {
    // the stage refilled here was read in the previous group, which ended
    // at a block barrier
    if (threadIdx.x == 0) fill(grp + NSTAGE - 1);
    mbar_wait(bar0 + 8 * (grp % NSTAGE), (grp / NSTAGE) & 1);
    // the slot's u-th position of the group is row u*slots + slot of the stage
    const unsigned char* stage =
        smem_bytes + (grp % NSTAGE) * stage_bytes + slot * row_bytes + c * CB;
    if (grp == fresh_grp && fresh_lanes) {
      // each lane stores its own chunk, which it alone reads back (the last
      // group: no copy refills this stage)
      *reinterpret_cast<Chunk*>(const_cast<unsigned char*>(stage) + fresh_u * slots * row_bytes) =
          fk;
      *reinterpret_cast<Chunk*>(const_cast<unsigned char*>(stage) +
                                (T + fresh_u * slots) * row_bytes) = fv;
    }
    bool ok[U];
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = (grp * U + u) * slots + slot < cnt;
      float kf[8];
      unpack8(ok[u] && active ? *reinterpret_cast<const Chunk*>(stage + u * slots * row_bytes)
                              : Chunk{},
              kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qr[g][e], kf[e], x);
        s[u][g] = x;
      }
    }
    // each score summed over its lane group: a level at a time for all of
    // them, so their shuffles overlap (lpr is uniform: no divergence); then
    // scaled by (1/sqrt(D)) log2 e, so the softmax runs in base 2
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < lpr) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GT; ++g) s[u][g] += __shfl_xor_sync(FULL, s[u][g], off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GT; ++g) s[u][g] = ok[u] ? s[u][g] * p.scale_log2 : -INFINITY;
    }
    // the online softmax over this group's U positions, row by row
    float pb[GT][U];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      if (mx == -INFINITY) {  // no valid position yet: nothing to add
#pragma unroll
        for (int u = 0; u < U; ++u) pb[g][u] = 0.f;
        continue;
      }
      const float alpha = exp2_approx(m[g] - mx);  // 0 while m is still -inf
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = exp2_approx(s[u][g] - mx);
        psum += pu;
        pb[g][u] = round_bf16(pu);  // p cast to bf16
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      unpack8(ok[u] && active
                  ? *reinterpret_cast<const Chunk*>(stage + (T + u * slots) * row_bytes)
                  : Chunk{},
              vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pb[g][u], vf[e], acc[g][e]);
      }
    }
    if (grp + 1 == fresh_grp) load_fresh();
    __syncthreads();  // every lane is done with this stage: it may be refilled
  }
  // the last group's barrier passed: the scratch reuses the ring

  // combine the slots: O = sum_s acc_s w_s, L = sum_s l_s w_s, w_s =
  // exp(m_s - M), M = max_s m_s, each sum in a fixed order
  const int HDP = lpr * 8;
  float* sm_m = smem + lay.scratch;      // [slots][GT]
  float* sm_l = sm_m + slots * GT;       // [slots][GT]
  float* sm_acc = sm_l + slots * GT;     // [slots][GT][HDP]
  float* sm_w = smem + lay.weights;      // [slots][GT]
  // this block's (M, L, O) per row: in its own shared memory when the
  // cluster is one block, else pushed into rank 0's, slot `rank` (remote
  // stores do not wait for an answer, as remote loads would)
  const int stride = GT * (HDP + 2);
  float* gather = smem + lay.result;     // [MAX_SPLIT][GT * (HDP + 2)]
  if (p.split > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* mine = (p.split == 1 ? gather : cluster.map_shared_rank(gather, 0)) + rank * stride;
  if (c == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[slot * GT + g] = m[g];
      sm_l[slot * GT + g] = l[g];
    }
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float4* dst = reinterpret_cast<float4*>(sm_acc + (slot * GT + g) * HDP + d0);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  if (warp < gn) {  // warp g weighs row g's slots; its lanes take every 32nd
    const int g = warp;
    float M = -INFINITY;
    for (int t = lane; t < slots; t += 32) M = fmaxf(M, sm_m[t * GT + g]);
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
    float L = 0.f;
    for (int t = lane; t < slots; t += 32) {
      const float mt = sm_m[t * GT + g];
      const float w = mt == -INFINITY ? 0.f : exp2_approx(mt - M);  // 0 for a slot that read nothing
      sm_w[t * GT + g] = w;
      L = fmaf(sm_l[t * GT + g], w, L);
    }
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(FULL, L, off);
    if (lane == 0) {
      mine[g] = M;
      mine[GT + g] = L;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * p.D; i += NTHREADS) {
    const int g = i / p.D;
    const int d = i - g * p.D;
    // four partial sums (slots is a multiple of 8), added in a fixed order
    float O4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < slots; t += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        O4[k] = fmaf(sm_acc[((t + k) * GT + g) * HDP + d], sm_w[(t + k) * GT + g], O4[k]);
    }
    const float O = (O4[0] + O4[1]) + (O4[2] + O4[3]);
    if (p.split == 1)
      p.o[(static_cast<long long>(bk) * p.G + g0 + g) * p.D + d] =
          __float2bfloat16(O / fmaxf(mine[GT + g], 1e-30f));
    else
      mine[2 * GT + g * HDP + d] = O;
  }
  if (p.split == 1) {
    write_fresh();
    return;
  }

  // rank 0 combines the cluster's blocks in rank order, from its own shared
  // memory once the cluster barrier has made every rank's stores visible
  cluster.sync();
  write_fresh();
  if (rank != 0) return;
  if (threadIdx.x < gn) {  // row g's rank weights and normaliser, in rank order
    const int g = threadIdx.x;
    float M = -INFINITY;
    for (int r = 0; r < p.split; ++r) M = fmaxf(M, gather[r * stride + g]);
    float L = 0.f;
    for (int r = 0; r < p.split; ++r) {
      const float w = exp2_approx(gather[r * stride + g] - M);  // 0 for an empty block
      sm_w[r * GT + g] = w;
      L = fmaf(gather[r * stride + GT + g], w, L);
    }
    sm_w[MAX_SPLIT * GT + g] = L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * p.D; i += NTHREADS) {
    const int g = i / p.D;
    const int d = i - g * p.D;
    float O = 0.f;
    for (int r = 0; r < p.split; ++r)
      O = fmaf(gather[r * stride + 2 * GT + g * HDP + d], sm_w[r * GT + g], O);
    p.o[(static_cast<long long>(bk) * p.G + g0 + g) * p.D + d] =
        __float2bfloat16(O / fmaxf(sm_w[MAX_SPLIT * GT + g], 1e-30f));
  }
}

// The int8 cache's kernel (see the note at the top).  A block is (b, kv
// head, rank, tile of GT query rows); each warp walks every NW-th tile of
// i8w::TILE positions of the rank's share through its own ring, staged and
// stepped by int8_walk.cuh.
struct SegmentI8 {
  const int8_t* k;
  const int8_t* v;
  long long ks[3], vs[3];    // element strides of b, kv head, position (d is 1)
  const float* k_s;          // scales [B, KV, L] f32, unit stride along L
  const float* v_s;
  long long kss[2], vss[2];  // element strides of b, kv head of k_s, v_s
  int n;                     // positions read
};

struct ParamsI8 {
  const __nv_bfloat16* q;
  long long qs[3];             // element strides of b, kv head, group row (d is 1)
  SegmentI8 seg[2];
  const __nv_bfloat16* k_new;  // [B, KV, 1, D] bf16 or null: no fused write
  const __nv_bfloat16* v_new;
  long long kns[2], vns[2];    // element strides of b and kv head of k_new, v_new
  __nv_bfloat16* o;            // [B, KV, G, D] contiguous
  int KV, G, D;
  int split;                   // C: blocks per cluster, one cluster per (b, kv head, row tile)
  int span;                    // positions per block, a multiple of i8w::TILE
  float scale_log2;            // (1/sqrt(D)) log2 e
};

// A block's end once its warps' (m, l, acc) per row are in shared memory:
// per row the block's (M, L, O) with O = sum_w acc_w wt_w, L = sum_w l_w
// wt_w, wt_w = exp(m_w - M), in warp order; then o, or with a cluster each
// rank's (M, L, O) into rank 0's gather through DSMEM and rank 0's combine
// in rank order.  Every block has arrived on the cluster barrier (split >
// 1) after its walk, before any warp wrote its scratch.
template <int NW, int GT>
__device__ __forceinline__ void combine_i8(const ParamsI8& p, int rank, int bk, int g0, int gn,
                                           const float* sm_m, const float* sm_l,
                                           const float* sm_acc, float* sm_w, float* gather) {
  constexpr int NT = NW * 32;
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
  for (int e = threadIdx.x; e < gn * p.D; e += NT) {
    const int g = e / p.D;
    const int d = e - g * p.D;
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) O = fmaf(sm_acc[(w * GT + g) * p.D + d], sm_w[w * GT + g], O);
    if (p.split == 1)
      p.o[(static_cast<long long>(bk) * p.G + g0 + g) * p.D + d] =
          __float2bfloat16(O / fmaxf(sm_w[(MAX_SPLIT + 1) * GT + g], 1e-30f));
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
  for (int e = threadIdx.x; e < gn * p.D; e += NT) {
    const int g = e / p.D;
    const int d = e - g * p.D;
    float O = 0.f;
    for (int r = 0; r < p.split; ++r)
      O = fmaf(gather[r * stride + 2 * GT + g * p.D + d], sm_w[r * GT + g], O);
    p.o[(static_cast<long long>(bk) * p.G + g0 + g) * p.D + d] =
        __float2bfloat16(O / fmaxf(sm_w[MAX_SPLIT * GT + g], 1e-30f));
  }
}

template <int DT, int GT, bool FRESH>
__global__ void __launch_bounds__(i8w::nwarps(DT) * 32)
    flash_decode_i8_kernel(const ParamsI8 p) {
  constexpr int NW = i8w::nwarps(DT);
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

  // this block's share [p0, hi) by global position over both segments;
  // p0 is a multiple of TILE, so every tile starts at a fixed position and
  // a row's bits depend on n and the split only, never on where main ends
  const SegmentI8& s0 = p.seg[0];
  const SegmentI8& s1 = p.seg[1];
  const int n0 = s0.n;
  const int n = n0 + s1.n;
  const int p0 = rank * p.span;
  const int hi = min(n, p0 + p.span);
  const int cnt = max(0, hi - p0);
  const int ntiles = (cnt + TILE - 1) / TILE;
  const int mine = warp < ntiles ? (ntiles - 1 - warp) / NW + 1 : 0;  // this warp's tiles
  // the warp that walks the share's last tile holds position n - 1
  const bool holds_fresh = FRESH && cnt > 0 && hi == n && warp == (ntiles - 1) % NW;

  const uint32_t bar0 = base + lay.bars + 8 * warp * lay.depth;
  const uint32_t ring = base + warp * lay.depth * lay.stage;
  if (lane == 0) {
    for (int i = 0; i < lay.depth; ++i) mbar_init(bar0 + 8 * i, i8w::COPIERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();  // this warp's barriers are initialised
  // (b, kv head)'s rows of each segment: codes, scales and row strides
  const int8_t* const k0 = s0.k + b * s0.ks[0] + kvh * s0.ks[1];
  const int8_t* const k1 = s1.k + b * s1.ks[0] + kvh * s1.ks[1];
  const int8_t* const v0 = s0.v + b * s0.vs[0] + kvh * s0.vs[1];
  const int8_t* const v1 = s1.v + b * s1.vs[0] + kvh * s1.vs[1];
  const float* const ks0 = s0.k_s + b * s0.kss[0] + kvh * s0.kss[1];
  const float* const ks1 = s1.k_s + b * s1.kss[0] + kvh * s1.kss[1];
  const float* const vs0 = s0.v_s + b * s0.vss[0] + kvh * s0.vss[1];
  const float* const vs1 = s1.v_s + b * s1.vss[0] + kvh * s1.vss[1];
  const int kst0 = static_cast<int>(s0.ks[2]), kst1 = static_cast<int>(s1.ks[2]);
  const int vst0 = static_cast<int>(s0.vs[2]), vst1 = static_cast<int>(s1.vs[2]);
  // stage s takes this warp's i-th tile: global positions lo .., from
  // segment 0 below n0, else from segment 1
  auto issue = [&](int i, int s) {
    const int lo = p0 + (warp + i * NW) * TILE;
    i8w::stage_tile<DT>(ring + s * lay.stage, lane, p.D, bar0 + 8 * s,
                        [&](int r, const int8_t*& k, const int8_t*& v, const float*& ks,
                            const float*& vs) {
                          const int j = lo + r;
                          if (j >= hi) return false;
                          const bool in0 = j < n0;
                          const int jj = in0 ? j : j - n0;
                          k = (in0 ? k0 : k1) + static_cast<long long>(jj) * (in0 ? kst0 : kst1);
                          v = (in0 ? v0 : v1) + static_cast<long long>(jj) * (in0 ? vst0 : vst1);
                          ks = (in0 ? ks0 : ks1) + jj;
                          vs = (in0 ? vs0 : vs1) + jj;
                          return true;
                        });
  };
  // the fresh rows' loads go first, then the ring's copies, then q's loads,
  // whose use waits for them while the copies fly; the fresh rows are
  // quantized meanwhile
  i8w::Fresh<DT> fresh;
  if (holds_fresh)
    fresh.load(p.k_new + b * p.kns[0] + kvh * p.kns[1], p.v_new + b * p.vns[0] + kvh * p.vns[1],
               p.D, lane);
  for (int i = 0; i < lay.depth && i < mine; ++i) issue(i, i);
  i8w::Walk<DT, GT> walk;
  walk.begin(p.q + b * p.qs[0] + kvh * p.qs[1] + g0 * p.qs[2], p.qs[2], gn, p.D, lane);
  if (holds_fresh) fresh.quantize();
  for (int i = 0, s = 0, phase = 0; i < mine; ++i) {  // tile i in stage s = i % depth
    mbar_wait(bar0 + 8 * s, phase);
    unsigned char* tile = smem + (ring - base) + s * lay.stage;
    const int lo = p0 + (warp + i * NW) * TILE;
    if (holds_fresh && i == mine - 1) fresh.stage(tile, n - 1 - lo, p.D, lane);
    walk.step(tile, min(TILE, hi - lo), p.scale_log2, lane);
    __syncwarp();  // every lane has read the stage: it may be refilled
    if (i + lay.depth < mine) issue(i + lay.depth, s);
    if (++s == lay.depth) s = 0, phase ^= 1;
  }
  walk.finish();
  // the fresh codes and scales into their slot (segment 1's last when it
  // has positions, else segment 0's), in row tile 0, once this warp's
  // copies have landed (another block's copy of that slot is replaced by
  // its own fresh codes in its stage)
  if (holds_fresh && blockIdx.y == 0) {
    const bool w1 = s1.n > 0;
    const SegmentI8& sw = w1 ? s1 : s0;
    const long long j = (w1 ? s1.n : n0) - 1;
    fresh.write(const_cast<int8_t*>(sw.k) + b * sw.ks[0] + kvh * sw.ks[1] + j * sw.ks[2],
                const_cast<int8_t*>(sw.v) + b * sw.vs[0] + kvh * sw.vs[1] + j * sw.vs[2],
                const_cast<float*>(sw.k_s) + b * sw.kss[0] + kvh * sw.kss[1] + j,
                const_cast<float*>(sw.v_s) + b * sw.vss[0] + kvh * sw.vss[1] + j, p.D, lane);
  }
  // rank 0's gather shares the ring's space: a rank writes it only once
  // every rank of the cluster is past its walk
  if (p.split > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();  // every warp is done with its ring: the scratch reuses it
  float* sm_m = reinterpret_cast<float*>(smem + lay.m);      // [NW][GT]
  float* sm_l = reinterpret_cast<float*>(smem + lay.l);      // [NW][GT]
  float* sm_acc = reinterpret_cast<float*>(smem + lay.acc);  // [NW][GT][D]
  walk.store(sm_m, sm_l, sm_acc, warp, gn, p.D, lane);
  combine_i8<NW, GT>(p, rank, bk, g0, gn, sm_m, sm_l, sm_acc,
                     reinterpret_cast<float*>(smem + lay.weights),
                     reinterpret_cast<float*>(smem + lay.gather));
}

// per group tile (1, 2, 4, 8), with or without the fused write, and
// device: the shared-memory opt-in is set
std::atomic<bool> g_smem_set[8][MAX_DEVICES];
// the int8 kernel's, per (tile width, row tile, fused write) and device
std::atomic<bool> g_smem_set_i8[3][2][2][MAX_DEVICES];

// a launch of a cluster of `split` blocks along x
template <typename K, typename P>
cudaError_t launch_cluster(K kernel, dim3 grid, int threads, int smem, int split, void* stream,
                           const P& p) {
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
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The bfloat16 launch: the checks, the parameters, the instance and the
// cluster launch.
int launch(const void* q, const void* k0, const void* v0, int n0, const void* k1, const void* v1,
           int n1, const void* k_new, const void* v_new, void* o, int B, int KV, int G, int D,
           int split, int span, const long long* strides, void* stream) {
  const int smem = plan(D, G, DTYPE_BF16, nullptr, 0);
  const int n = n0 + n1;  // split: 1, 2, 4 or 8, the portable cluster sizes
  if (smem < 0 || B < 1 || KV < 1 || n0 < 0 || n1 < 0 || n < 1 ||
      (split != 1 && split != 2 && split != 4 && split != 8) || span < 1 ||
      static_cast<long long>(split) * span < n || static_cast<long long>(split - 1) * span >= n ||
      (k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.seg[0].k = static_cast<const __nv_bfloat16*>(k0);
  p.seg[0].v = static_cast<const __nv_bfloat16*>(v0);
  p.seg[0].n = n0;
  p.seg[1].k = static_cast<const __nv_bfloat16*>(k1);
  p.seg[1].v = static_cast<const __nv_bfloat16*>(v1);
  p.seg[1].n = n1;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.seg[0].ks[i] = strides[3 + i];
    p.seg[0].vs[i] = strides[6 + i];
    p.seg[1].ks[i] = strides[9 + i];
    p.seg[1].vs[i] = strides[12 + i];
  }
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  for (int i = 0; i < 2; ++i) {
    p.kns[i] = strides[15 + i];
    p.vns[i] = strides[17 + i];
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.lpr = lanes_per_row(D);
  p.split = split;
  p.span = span;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));

  const int GT = group_tile(G);
  const bool fresh = k_new != nullptr;
  const int which = (GT == 1 ? 0 : (GT == 2 ? 1 : (GT == 4 ? 2 : 3))) + 4 * fresh;
  void (*const kernels[8])(const Params) = {
      flash_decode_kernel<1, false>, flash_decode_kernel<2, false>,
      flash_decode_kernel<4, false>, flash_decode_kernel<8, false>,
      flash_decode_kernel<1, true>,  flash_decode_kernel<2, true>,
      flash_decode_kernel<4, true>,  flash_decode_kernel<8, true>};
  void (*kernel)(const Params) = kernels[which];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[which][dev].load()) {
    // the largest the kernel asks for at this tile, over every head dim
    int most = 0;
    for (int d = 8; d <= MAX_D; d += 8) most = std::max(most, layout_for(d, GT).bytes);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[which][dev].store(true);
  }
  e = launch_cluster(kernel, dim3(split * B * KV, (G + GT - 1) / GT), NTHREADS, smem, split,
                     stream, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The int8 cache's launch: the checks (span a multiple of the tile; the
// last ranks' shares may be empty), the parameters, the instance and the
// cluster launch.
int launch_i8(const void* q, const void* k0, const void* v0, int n0, const void* k1,
              const void* v1, int n1, const void* k_new, const void* v_new, void* o, int B, int KV,
              int G, int D, int split, int span, const long long* strides,
              const void* const* scales, const long long* scale_strides, void* stream) {
  const int smem = plan(D, G, DTYPE_I8, nullptr, 0);
  const int n = n0 + n1;
  if (smem < 0 || B < 1 || KV < 1 || n0 < 0 || n1 < 0 || n < 1 ||
      (split != 1 && split != 2 && split != 4 && split != 8) || span < 1 ||
      span % i8w::TILE != 0 || static_cast<long long>(split) * span < n ||
      (k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  const int row_strides[4] = {5, 8, 11, 14};  // of the segments: the walk takes them as int
  for (int i : row_strides)
    if (strides[i] < 0 || strides[i] > INT32_MAX) return (int)cudaErrorInvalidValue;
  ParamsI8 p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  const void* ks[2] = {k0, k1};
  const void* vs[2] = {v0, v1};
  const int ns[2] = {n0, n1};
  for (int sgi = 0; sgi < 2; ++sgi) {
    SegmentI8& sg = p.seg[sgi];
    sg.k = static_cast<const int8_t*>(ks[sgi]);
    sg.v = static_cast<const int8_t*>(vs[sgi]);
    sg.n = ns[sgi];
    for (int i = 0; i < 3; ++i) {
      sg.ks[i] = strides[3 + 6 * sgi + i];
      sg.vs[i] = strides[6 + 6 * sgi + i];
    }
    sg.k_s = static_cast<const float*>(scales[2 * sgi]);
    sg.v_s = static_cast<const float*>(scales[2 * sgi + 1]);
    for (int i = 0; i < 2; ++i) {
      sg.kss[i] = scale_strides[4 * sgi + i];
      sg.vss[i] = scale_strides[4 * sgi + 2 + i];
    }
  }
  for (int i = 0; i < 3; ++i) p.qs[i] = strides[i];
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  for (int i = 0; i < 2; ++i) {
    p.kns[i] = strides[15 + i];
    p.vns[i] = strides[17 + i];
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.split = split;
  p.span = span;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));

  const int GT = i8w::row_tile(G);
  const int DT = i8w::tile_cols(D);
  const int wi = DT == 64 ? 0 : (DT == 128 ? 1 : 2);
  const int gi = GT == 16 ? 1 : 0;
  const int fi = k_new != nullptr;
  using Kernel = void (*)(const ParamsI8);
  const Kernel kernels[3][2][2] = {
      {{flash_decode_i8_kernel<64, 8, false>, flash_decode_i8_kernel<64, 8, true>},
       {flash_decode_i8_kernel<64, 16, false>, flash_decode_i8_kernel<64, 16, true>}},
      {{flash_decode_i8_kernel<128, 8, false>, flash_decode_i8_kernel<128, 8, true>},
       {flash_decode_i8_kernel<128, 16, false>, flash_decode_i8_kernel<128, 16, true>}},
      {{flash_decode_i8_kernel<256, 8, false>, flash_decode_i8_kernel<256, 8, true>},
       {flash_decode_i8_kernel<256, 16, false>, flash_decode_i8_kernel<256, 16, true>}}};
  const Kernel kernel = kernels[wi][gi][fi];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set_i8[wi][gi][fi][dev].load()) {
    // the largest this instance asks for, over the head dims it serves
    int most = 0;
    for (int d = 16; d <= MAX_D; d += 16)
      if (i8w::tile_cols(d) == DT) most = std::max(most, i8w::layout(d, GT).bytes);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    g_smem_set_i8[wi][gi][fi][dev].store(true);
  }
  e = launch_cluster(kernel, dim3(split * B * KV, (G + GT - 1) / GT), i8w::nwarps(D) * 32, smem,
                     split, stream, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for this head dim, group
// (query heads per kv head) and dtype code (0 = bfloat16, 2 = an int8
// cache with bfloat16 q), or -1 with the reason in why.
int flash_decode_smem_bytes(int head_dim, int group, int dtype_code, char* why, int why_len) {
  return plan(head_dim, group, dtype_code, why, why_len);
}

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  q [B,KV,G,D]
// bf16 with unit stride along D; the segments k0/v0 (n0 positions) and
// k1/v1 (n1 positions) [B,KV,*,D] bf16 with unit stride along D and
// 16-byte aligned rows; strides[19] = (b, kv head, row) element strides of
// q, k0, v0, k1, v1, then (b, kv head) of k_new and v_new; o [B,KV,G,D]
// bf16 contiguous.  n0 + n1 >= 1.  k_new/v_new [B,KV,1,D] bf16 with 16-byte
// aligned rows, or null: with them the launch writes the fresh row into
// position n0 + n1 - 1 (chunk slot n1 - 1 when n1 > 0, else main slot n0 -
// 1) and attends with it (see the note at the top).  The
// positions of each (b, kv head, row tile) are split across a cluster of
// `split` blocks (1, 2, 4 or 8), `span` positions each, with (split - 1) *
// span < n0 + n1 <= split * span.
int flash_decode_launch(const void* q, const void* k0, const void* v0, int n0, const void* k1,
                        const void* v1, int n1, const void* k_new, const void* v_new, void* o,
                        int B, int KV, int G, int D, int split, int span,
                        const long long* strides, void* stream) {
  return launch(q, k0, v0, n0, k1, v1, n1, k_new, v_new, o, B, KV, G, D, split, span, strides,
                stream);
}

// The int8 cache's launch: as flash_decode_launch, with the segments' K/V
// int8 [B,KV,*,D] (D a multiple of 16, rows 16-byte aligned) and their
// scale planes k0_s, v0_s, k1_s, v1_s [B,KV,*] f32 with unit stride along
// the positions; scale_strides[8] = (b, kv head) element strides of k0_s,
// v0_s, k1_s, v1_s.  k_new/v_new stay bf16: the launch quantizes them into
// the written slot (codes and scales) and attends with the codes.  `span`
// is a multiple of 16 (the walk's tile) with n0 + n1 <= split * span; the
// shares of the last ranks may be empty.
int flash_decode_i8_launch(const void* q, const void* k0, const void* v0, const void* k0_s,
                           const void* v0_s, int n0, const void* k1, const void* v1,
                           const void* k1_s, const void* v1_s, int n1, const void* k_new,
                           const void* v_new, void* o, int B, int KV, int G, int D, int split,
                           int span, const long long* strides, const long long* scale_strides,
                           void* stream) {
  const void* scales[4] = {k0_s, v0_s, k1_s, v1_s};
  for (int i = 0; i < 4; ++i)
    if (scales[i] == nullptr) return (int)cudaErrorInvalidValue;
  return launch_i8(q, k0, v0, n0, k1, v1, n1, k_new, v_new, o, B, KV, G, D, split, span, strides,
                   scales, scale_strides, stream);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
