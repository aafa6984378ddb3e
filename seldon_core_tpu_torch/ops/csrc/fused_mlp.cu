// Fused MLP + softmax for Hopper (sm_90a): probs = softmax(relu(x@W0+b0)...@WL+bL)
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/fused_mlp.py
// (fused_mlp_softmax :64, kernel body _mlp_kernel :44) and computes what it
// computes, in the same order: each layer's input is cast to bf16, the
// product accumulates in f32, the bf16 bias is added in f32 and relu applied
// in f32 (NaN kept), and the final logits get an f32 max-shifted softmax.
//
// Bound on an H100 SXM: at the served widths (784 -> 256 -> 256 -> 10, bf16
// weights) the call moves x (B*784*4 bytes) + the weights (~0.5 MB) + the
// probabilities (B*10*4) and does 2*B*268,288 FLOPs, so it is bound by the
// bytes at 3.35 TB/s at every batch size (~0.16 us at B=1: far below one
// launch).  What sets its time is latency: the first design streamed all
// the weights through one block's 64-row stage, ~21 dependent round trips
// to L2/HBM.  This design:
//   * Splits the weights over the C blocks (ranks) of one thread-block
//     cluster (C = 1, 2, 4, 8 or 16; 16 is a non-portable size), one
//     cluster per tile of BM batch rows; C and BM come from the caller
//     (ops/fused_mlp.py mlp_plan: the widest cluster for a few rows,
//     8-block clusters of a few rows a block beyond).  Rank r
//     owns cw_l = round16(ceil(N_l / C)) output columns of each hidden
//     layer l, from column r * cw_l; rank 0 owns the whole last layer.
//   * Puts all of a rank's weights in flight at entry: one thread issues
//     every TMA box of its hidden-layer slices (2-d tensor maps over W[K][N],
//     boxes of cw_l columns x up to 256 rows) and one bulk copy of the last
//     layer (rank 0), completion on one mbarrier per layer, so layer 0
//     starts when its slice lands and the others arrive meanwhile: one
//     memory round trip instead of one per 64-row stage.
//   * Keeps every activation on chip: each rank loads the x tile itself
//     (16-byte f32 loads, cast to bf16), computes its columns of a hidden
//     layer (bias, relu, bf16) into its own next-layer buffer and pushes
//     them into the buffer of every rank that computes the next layer
//     (rank 0 alone before the last layer) with st.async through
//     distributed shared memory, 16 bytes a store, each store completing
//     its bytes on the receiver's mbarrier of that layer -- the barrier
//     that also counts the layer's weights.  A rank starts a layer when
//     its weights and its whole input have landed: no cluster-wide barrier
//     between layers (one cost ~0.8 us at 16 blocks).  The next layer reads
//     its input locally; each rank's input buffer alternates between two,
//     and a peer can only write the one this rank read a layer ago after
//     receiving this rank's columns of that layer, sent once it was read.
//     Rank 0 computes the logits and the softmax and writes the
//     probabilities; the other ranks leave once rank 0 has all their
//     columns.  No atomics, no scratch in device memory.
//   * Does the products on the tensor cores (mma.sync m16n8k16, bf16 into
//     f32) with A and B swapped: a rank's output columns are M (16 a tile),
//     batch rows are N (8 a tile), so B = 1 fills an m16n8 tile's M.  The
//     k-steps of a layer are dealt into 8 classes (step % 8), each
//     summed in its own accumulator, and the 8 sums are added in a fixed
//     tree ((c0+c1)+(c2+c3))+((c4+c5)+(c6+c7)).  With few tiles the classes
//     of one tile go to several warps, each walking only its own (their
//     sums meet in shared memory), with many each warp takes whole tiles
//     and interleaves the 8 accumulators: the same operations in the
//     same order either way, and a column's position in its m16 tile (c %
//     16) and a row's in its n8 tile (row % 8) do not depend on C or BM,
//     so a row's probabilities are the same bits whatever the plan, and a
//     repeat gives the same bits.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>

#include "flash_common.cuh"  // mbarriers, bulk copies, the tensor-map encoder

namespace cg = cooperative_groups;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::smem_u32;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_LAYERS = 8;
constexpr int CLASSES = 8;             // k-step classes, summed in a fixed tree
constexpr int PAD = 8;                 // bf16 row padding of the activation buffers
constexpr int MAX_BOX = 256;           // TMA box dimensions
constexpr int SMEM_LIMIT = 232448;     // 227 KB opt-in per block on sm_90
constexpr int MAX_DEVICES = 64;

struct Params {
  CUtensorMap wmap[MAX_LAYERS];  // hidden layer l's W [K][N]; boxes of cw[l] x box_rows[l]
  const float* x;                // [B, dims[0]] f32
  float* out;                    // [B, dims[L]] f32
  const __nv_bfloat16* w_last;   // the last layer's W, copied whole by rank 0
  const __nv_bfloat16* b[MAX_LAYERS];
  int* shape_out;                // null, or {cluster blocks, grid blocks, BM} from block 0
  int B, n_layers, BM, C;
  int dims[MAX_LAYERS + 1];
  int cw[MAX_LAYERS];            // columns a rank owns (the last layer: round16(N), rank 0)
  int box_rows[MAX_LAYERS];
  int ld[2];                     // activation buffers' row strides, elements
  int buf_off[2];                // byte offsets into dynamic shared memory
  int w_off[MAX_LAYERS];
  int bias_off[MAX_LAYERS];      // a rank's cw[l] biases as f32
  int part_off, logits_off, bar_off;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
inline int align128(int v) { return (v + 127) & ~127; }

// the rows of one TMA box over a K-row slice: the largest multiple of 16
// that divides K and is at most 256, so the boxes tile the slice exactly
inline int box_rows_for(int K) {
  int best = 16;
  for (int r = 16; r <= MAX_BOX; r += 16)
    if (K % r == 0) best = r;
  return best;
}

// The one statement of which widths and plans the kernel takes and of its
// shared-memory layout, for the launch and for fused_mlp_smem_bytes (which
// ops/fused_mlp.py's mirror, _layout_bytes, is held to on the card).  Fills
// p's shape and layout; returns the dynamic shared memory in bytes, or -1
// with the reason in why (why may be null when why_len is 0).
int plan_layout(Params& p, int n_layers, const int* dims, int C, int BM, char* why,
                int why_len) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) {
    snprintf(why, why_len, "%d layers (the kernel takes at least 1 and at most %d)", n_layers,
             MAX_LAYERS);
    return -1;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) {
      snprintf(why, why_len, "layer width %d at position %d is not positive", dims[l], l);
      return -1;
    }
    p.dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] % 16 != 0) {
      snprintf(why, why_len, "layer %d input width %d is not a multiple of 16", l, dims[l]);
      return -1;
    }
  }
  if (dims[n_layers] > MAX_BOX) {
    snprintf(why, why_len, "output width %d (the kernel takes at most %d)", dims[n_layers],
             MAX_BOX);
    return -1;
  }
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) {
    snprintf(why, why_len, "a cluster of %d blocks (the kernel takes 1, 2, 4, 8 or 16)", C);
    return -1;
  }
  if (BM != 8 && BM != 16 && BM != 32 && BM != 64) {
    snprintf(why, why_len, "%d batch rows a block (the kernel takes 8, 16, 32 or 64)", BM);
    return -1;
  }
  const int L = n_layers;
  p.n_layers = L;
  p.C = C;
  p.BM = BM;
  for (int l = 0; l < L - 1; ++l) {
    p.cw[l] = round16((dims[l + 1] + C - 1) / C);
    if (p.cw[l] > MAX_BOX) {
      snprintf(why, why_len,
               "layer %d: %d columns a block over a cluster of %d (the kernel takes at most %d)",
               l, p.cw[l], C, MAX_BOX);
      return -1;
    }
    p.box_rows[l] = box_rows_for(dims[l]);
  }
  p.cw[L - 1] = round16(dims[L]);
  p.box_rows[L - 1] = 0;
  int ld0 = 0, ld1 = 0;
  for (int l = 0; l < L; ++l) {
    if (l & 1) ld1 = ld1 > dims[l] ? ld1 : dims[l];
    else ld0 = ld0 > dims[l] ? ld0 : dims[l];
  }
  p.ld[0] = ld0 + PAD;
  p.ld[1] = ld1 ? ld1 + PAD : 0;
  int off = 0;
  p.buf_off[0] = off;
  off = align128(off + BM * p.ld[0] * 2);
  p.buf_off[1] = off;
  off = align128(off + BM * p.ld[1] * 2);
  for (int l = 0; l < L - 1; ++l) {
    p.w_off[l] = off;
    off = align128(off + dims[l] * p.cw[l] * 2);
  }
  p.w_off[L - 1] = off;
  off = align128(off + dims[L - 1] * dims[L] * 2);
  for (int l = 0; l < L; ++l) {
    p.bias_off[l] = off;
    off = align128(off + p.cw[l] * 4);
  }
  p.part_off = off;
  off = align128(off + NWARPS * 32 * 4 * 4);
  p.logits_off = off;
  off = align128(off + BM * dims[L] * 4);
  p.bar_off = off;
  off = align128(off + L * 8);
  if (off > SMEM_LIMIT) {
    snprintf(why, why_len,
             "fused MLP needs %d KiB shared memory a block at a cluster of %d and %d rows "
             "(budget %d KiB)",
             off >> 10, C, BM, SMEM_LIMIT >> 10);
    return -1;
  }
  return off;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a * b: m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One tile's sum over the k-step classes [lo, lo + PER) (class c: steps c,
// c + 8, ...), each class in its own accumulator, then added pairwise,
// neighbours first: a subtree of the fixed 8-leaf tree
// ((c0+c1)+(c2+c3))+((c4+c5)+(c6+c7)), into r.  b_addr is this lane's
// ldmatrix row of the B operand (the batch rows) at step 0.  A hidden
// layer's A operand comes by ldmatrix.trans from its [K][cw] slice (a_addr
// at step 0, a_step bytes a step); the LAST layer's from its [K][N] copy,
// whose rows are not 16-byte aligned, by 16-bit loads (w_lane: row 2*t4,
// column m of step 0), zero past column N.
template <int PER, bool LAST>
__device__ __forceinline__ void product(float (&r)[4], int lo, int KS, uint32_t b_addr,
                                        uint32_t a_addr, int a_step,
                                        const __nv_bfloat16* w_lane, int N, int m) {
  float acc[PER][4];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int ks0 = lo; ks0 < KS; ks0 += CLASSES) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int ks = ks0 + j;
      if (ks < KS) {
        uint32_t a[4], b[2];
        ldsm_x2(b_addr + ks * 32, b);
        if (LAST) {
          const __nv_bfloat16* w0 = w_lane + ks * 16 * N;
          a[0] = m < N ? pack_raw(w0[0], w0[N]) : 0u;
          a[1] = m + 8 < N ? pack_raw(w0[8], w0[N + 8]) : 0u;
          a[2] = m < N ? pack_raw(w0[8 * N], w0[9 * N]) : 0u;
          a[3] = m + 8 < N ? pack_raw(w0[8 * N + 8], w0[9 * N + 8]) : 0u;
        } else {
          ldsm_x4_trans(a_addr + ks * a_step, a);
        }
        mma_bf16(acc[j], a, b);
      }
    }
  }
#pragma unroll
  for (int s = 1; s < PER; s <<= 1)
#pragma unroll
    for (int j = 0; j < PER; j += 2 * s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += acc[j + s][e];
  r[0] = acc[0][0], r[1] = acc[0][1], r[2] = acc[0][2], r[3] = acc[0][3];
}

template <bool LAST>
__device__ __forceinline__ void product_of(int per, float (&r)[4], int lo, int KS,
                                           uint32_t b_addr, uint32_t a_addr, int a_step,
                                           const __nv_bfloat16* w_lane, int N, int m) {
  if (per == 1) product<1, LAST>(r, lo, KS, b_addr, a_addr, a_step, w_lane, N, m);
  else if (per == 2) product<2, LAST>(r, lo, KS, b_addr, a_addr, a_step, w_lane, N, m);
  else if (per == 4) product<4, LAST>(r, lo, KS, b_addr, a_addr, a_step, w_lane, N, m);
  else product<8, LAST>(r, lo, KS, b_addr, a_addr, a_step, w_lane, N, m);
}

// the shared::cluster address of `local` (this block's shared memory) in
// block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// 16 bytes into a peer's shared memory, completing 16 bytes of the
// transaction count of the peer's mbarrier `bar` (both shared::cluster)
__device__ __forceinline__ void store_to_peer(uint32_t addr, const uint4& v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(NTHREADS) fused_mlp_softmax_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = p.n_layers;
  const int C = p.C;
  const int row0 = (blockIdx.x / C) * p.BM;
  const int rows = min(p.BM, p.B - row0);  // this tile's batch rows, >= 1
  const uint32_t base = smem_u32(smem);
  const uint32_t bar0 = base + p.bar_off;
  // whether this rank computes layer l, and how many of its columns
  auto owns = [&](int l) { return l == L - 1 ? rank == 0 : rank * p.cw[l] < p.dims[l + 1]; };
  auto own_cols = [&](int l) {
    return l == L - 1 ? (rank == 0 ? p.dims[L] : 0)
                      : max(0, min(p.cw[l], p.dims[l + 1] - rank * p.cw[l]));
  };

  // every load of the entry goes out before the first store: this rank's
  // biases (a layer's cw <= 256 columns: one a thread), the weights (the
  // last thread issues their copies), then the x tile in batches of 8
  // 16-byte loads a thread of the first 7 warps, cast to bf16 (the rows
  // past B are never read: their columns of every product are never stored)
  float bias_in[MAX_LAYERS];
#pragma unroll
  for (int l = 0; l < MAX_LAYERS; ++l) {
    bias_in[l] = 0.f;
    if (l < L && tid < p.cw[l]) {
      const int c = (l == L - 1 ? 0 : rank * p.cw[l]) + tid;
      if (c < p.dims[l + 1]) bias_in[l] = __bfloat162float(p.b[l][c]);
    }
  }
  if (tid == NTHREADS - 1) {
    if (p.shape_out != nullptr && blockIdx.x == 0) {
      p.shape_out[0] = static_cast<int>(cluster.num_blocks());
      p.shape_out[1] = static_cast<int>(gridDim.x);
      p.shape_out[2] = p.BM;
    }
    for (int l = 0; l < L; ++l) mbar_init(bar0 + 8 * l, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // layer l's barrier completes when this rank's weights of the layer
    // and the peers' columns of its input have landed; every weight copy
    // goes out now, all in flight at once
    for (int l = 0; l < L; ++l) {
      if (!owns(l)) continue;
      const int K = p.dims[l];
      const int wbytes = l == L - 1 ? K * p.dims[L] * 2 : K * p.cw[l] * 2;
      const int from_peers = l == 0 ? 0 : rows * (K - own_cols(l - 1)) * 2;
      mbar_expect_tx(bar0 + 8 * l, wbytes + from_peers);
      if (l == L - 1) {
        flash::bulk_load(base + p.w_off[l], p.w_last, wbytes, bar0 + 8 * l);
      } else {
        for (int k0 = 0; k0 < K; k0 += p.box_rows[l])
          tma_load_2d(base + p.w_off[l] + k0 * p.cw[l] * 2, &p.wmap[l], bar0 + 8 * l,
                      rank * p.cw[l], k0);
      }
    }
  }
  // every block of the cluster must have started (and initialised its
  // barriers) before another writes into its shared memory: arrive now,
  // wait before the first remote store
  if (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  {
    const int q4 = p.dims[0] / 4;  // 16-byte pieces of an x row
    const int total = rows * q4;
    const float4* src = reinterpret_cast<const float4*>(p.x + (size_t)row0 * p.dims[0]);
    __nv_bfloat16* h0 = reinterpret_cast<__nv_bfloat16*>(smem + p.buf_off[0]);
    constexpr int LOADERS = NTHREADS - 32;
    int r = tid / q4;
    int c = tid - r * q4;
    for (int i0 = tid; i0 < total && tid < LOADERS; i0 += 8 * LOADERS) {
      float4 v[8];
      int at[8];  // where piece u lands: row * ld + 4 * column
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        at[u] = r * p.ld[0] + 4 * c;
        if (i0 + u * LOADERS < total) v[u] = __ldg(src + r * q4 + c);
        for (c += LOADERS; c >= q4; c -= q4) ++r;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u * LOADERS < total)
          *reinterpret_cast<uint2*>(h0 + at[u]) =
              make_uint2(flash::pack_f32(v[u].x, v[u].y), flash::pack_f32(v[u].z, v[u].w));
    }
  }
#pragma unroll
  for (int l = 0; l < MAX_LAYERS; ++l)
    if (l < L && tid < p.cw[l]) reinterpret_cast<float*>(smem + p.bias_off[l])[tid] = bias_in[l];
  __syncthreads();  // x and the biases are in place; the barriers are initialised

  const int g = lane >> 2;   // the fragment's row group
  const int t4 = lane & 3;   // and its column pair
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const int K = p.dims[l];
    const int N = p.dims[l + 1];
    const int cw = p.cw[l];
    const int c0 = last ? 0 : rank * cw;
    const bool owner = owns(l);
    const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(smem + p.buf_off[l & 1]);
    const int ldi = p.ld[l & 1];
    __nv_bfloat16* nxt = reinterpret_cast<__nv_bfloat16*>(smem + p.buf_off[(l + 1) & 1]);
    const int ldn = p.ld[(l + 1) & 1];
    const float* bias = reinterpret_cast<const float*>(smem + p.bias_off[l]);
    float* logits = reinterpret_cast<float*>(smem + p.logits_off);
    if (owner) {  // block-uniform
      mbar_wait(bar0 + 8 * l, 0);  // the weights and the whole input are in place
      if (last && C > 1 && L > 1) cluster_arrive();  // the peers' stores have landed
      const int MT = cw / 16;
      const int NT = (rows + 7) / 8;
      const int T = MT * NT;
      int G = 1;  // warps a tile: with few tiles, a tile's classes spread over G warps
      while (T * G * 2 <= NWARPS) G *= 2;
      const int per = CLASSES / G;
      const int KS = K / 16;
      const __nv_bfloat16* wlast = reinterpret_cast<const __nv_bfloat16*>(smem + p.w_off[l]);
      // tile t's sum over the classes [lo, lo + per) of its k-steps, into r
      auto tile_sum = [&](int t, int lo, float (&r)[4]) {
        const int mt = t % MT;
        const int nt = t / MT;
        const uint32_t b_addr =
            smem_u32(in + (nt * 8 + (lane & 7)) * ldi + ((lane >> 3) & 1) * 8);
        const uint32_t a_addr =
            base + p.w_off[l] +
            (((lane & 7) + ((lane >> 4) << 3)) * cw + mt * 16 + ((lane >> 3) & 1) * 8) * 2;
        const int m = mt * 16 + g;
        if (last)
          product_of<true>(per, r, lo, KS, b_addr, a_addr, 0, wlast + 2 * t4 * N + m, N, m);
        else
          product_of<false>(per, r, lo, KS, b_addr, a_addr, 16 * cw * 2, wlast, N, m);
      };
      // bias, then relu and bf16 into this rank's next buffer, or the
      // logits; r[i] is output column c0 + mt*16 + g (+8 for i >= 2) of
      // batch row nt*8 + 2*t4 (+1 for odd i)
      auto epilogue = [&](int t, const float (&r)[4]) {
        const int mt = t % MT;
        const int nt = t / MT;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = mt * 16 + g + (i >> 1) * 8;
          const int n = nt * 8 + 2 * t4 + (i & 1);
          if (c0 + m < N && n < rows) {
            const float v = r[i] + bias[m];
            if (last) logits[n * N + m] = v;
            else nxt[n * ldn + c0 + m] = __float2bfloat16(v < 0.f ? 0.f : v);  // relu keeps NaN
          }
        }
      };
      if (G == 1) {  // whole tiles a warp
        for (int t = warp; t < T; t += NWARPS) {
          float r[4];
          tile_sum(t, 0, r);
          epilogue(t, r);
        }
      } else {  // G warps a tile, per classes each
        const int t = warp / G;
        float r[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < T) tile_sum(t, (warp % G) * per, r);
        reinterpret_cast<float4*>(part)[warp * 32 + lane] = make_float4(r[0], r[1], r[2], r[3]);
        __syncthreads();
        if (t < T && warp % G == 0) {  // the G subtree sums, in the tree's order
          float v[CLASSES][4];
#pragma unroll
          for (int j = 0; j < CLASSES; ++j) {
            if (j < G) {
              const float4 u = reinterpret_cast<const float4*>(part)[(warp + j) * 32 + lane];
              v[j][0] = u.x, v[j][1] = u.y, v[j][2] = u.z, v[j][3] = u.w;
            }
          }
#pragma unroll
          for (int s = 1; s < CLASSES; s <<= 1)
#pragma unroll
            for (int j = 0; j < CLASSES; j += 2 * s)
              if (s < G)
#pragma unroll
                for (int e = 0; e < 4; ++e) v[j][e] += v[j + s][e];
          epilogue(t, v[0]);
        }
      }
    }
    if (last) break;
    __syncthreads();  // this rank's columns are in its own next buffer
    const bool to_last = l + 1 == L - 1;
    if (C > 1) {
      if (l == 0) cluster_wait();  // every peer has started
      if (owner) {
        // copy them into the blocks that compute the next layer (rank 0
        // alone for the last), 16 bytes a store, each completing its bytes
        // on that block's barrier of the next layer
        const int chunks = own_cols(l) / 8;  // 16-byte pieces a row
        const int peers = to_last ? 1 : (p.dims[l + 2] + p.cw[l + 1] - 1) / p.cw[l + 1];
        const int per_peer = rows * chunks;
        for (int i = tid; i < peers * per_peer; i += NTHREADS) {
          const int peer = i / per_peer;
          const int rem = i - peer * per_peer;
          const int r = rem / chunks;
          const int ch = rem - r * chunks;
          if (peer == rank) continue;
          const __nv_bfloat16* src = nxt + r * ldn + c0 + ch * 8;
          store_to_peer(peer_addr(smem_u32(src), peer), *reinterpret_cast<const uint4*>(src),
                        peer_addr(bar0 + 8 * (l + 1), peer));
        }
      }
      // rank 0 alone computes the logits: the others leave once their
      // stores have landed, which rank 0's arrival below tells them
      if (to_last && rank != 0) {
        cluster_arrive();
        cluster_wait();
        return;
      }
    }
  }

  __syncthreads();  // the logits are in place
  // f32 max-shifted softmax over the out_dim logits, one warp per row
  const int out_dim = p.dims[L];
  const float* logits = reinterpret_cast<const float*>(smem + p.logits_off);
  for (int r = warp; r < rows; r += NWARPS) {
    const float* lr = logits + r * out_dim;
    float m = -INFINITY;
    for (int c = lane; c < out_dim; c += 32) m = fmaxf(m, lr[c]);
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int c = lane; c < out_dim; c += 32) s += expf(lr[c] - m);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int c = lane; c < out_dim; c += 32)
      p.out[(size_t)(row0 + r) * out_dim + c] = expf(lr[c] - m) / s;
  }
}

// the practical floor: a launch of the same grid, cluster and shared memory
// that does nothing
__global__ void __launch_bounds__(NTHREADS) fused_mlp_empty_kernel(const __grid_constant__ Params p) {
  (void)p;
}

// A 2-d map over W [K][N] bf16 (row stride N * 2 bytes, a multiple of 16),
// boxes of cw columns x rows rows, no swizzle, zeros past N
bool encode_weights(CUtensorMap* map, const void* w, int K, int N, int cw, int rows) {
  flash::EncodeTiled fn = flash::encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(cw), static_cast<cuuint32_t>(rows)};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// per device: the shared-memory opt-in and the non-portable cluster size
// are set for both kernels
std::atomic<bool> g_attrs_set[MAX_DEVICES];

cudaError_t set_attrs() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_attrs_set[dev].load()) return cudaSuccess;
  for (const void* k : {reinterpret_cast<const void*>(fused_mlp_softmax_kernel),
                        reinterpret_cast<const void*>(fused_mlp_empty_kernel)}) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  g_attrs_set[dev].store(true);
  return cudaSuccess;
}

cudaError_t launch(void (*kernel)(Params), const Params& p, int smem, void* stream) {
  cudaError_t e = set_attrs();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * ((p.B + p.BM - 1) / p.BM));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for an MLP of n_layers layers
// with widths dims[0..n_layers] at a cluster of C blocks and BM batch rows
// a block, or -1 with the reason in why when it cannot take them.
int fused_mlp_smem_bytes(int n_layers, const int* dims, int C, int BM, char* why, int why_len) {
  Params p;
  return plan_layout(p, n_layers, dims, C, BM, why, why_len);
}

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  dims holds
// n_layers + 1 ints; w and b hold n_layers device pointers each (bf16,
// W[l] row-major [dims[l], dims[l+1]], b[l] [dims[l+1]], W 16-byte
// aligned).  x is f32 [B, dims[0]] (16-byte aligned), out f32 [B,
// dims[n_layers]], both contiguous.  One cluster of C blocks per tile of BM
// rows (fused_mlp_smem_bytes must accept both).  shape_out, when not null,
// receives {blocks a cluster, blocks, BM} as the launched kernel sees them.
int fused_mlp_softmax_launch(const void* x, void* out, int B, int n_layers, const int* dims,
                             const void* const* w, const void* const* b, int C, int BM,
                             int* shape_out, void* stream) {
  Params p;
  const int smem = plan_layout(p, n_layers, dims, C, BM, nullptr, 0);
  if (smem < 0 || B < 1) return (int)cudaErrorInvalidValue;
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.shape_out = shape_out;
  for (int l = 0; l < n_layers; ++l) {
    p.b[l] = static_cast<const __nv_bfloat16*>(b[l]);
    if (l < n_layers - 1 &&
        !encode_weights(&p.wmap[l], w[l], dims[l], dims[l + 1], p.cw[l], p.box_rows[l]))
      return (int)cudaErrorInvalidValue;
  }
  p.w_last = static_cast<const __nv_bfloat16*>(w[n_layers - 1]);
  return (int)launch(fused_mlp_softmax_kernel, p, smem, stream);
}

// The empty kernel at the grid, cluster and shared memory that
// fused_mlp_softmax_launch would use for B rows: the launch's own cost.
int fused_mlp_empty_launch(int B, int n_layers, const int* dims, int C, int BM, void* stream) {
  Params p;
  const int smem = plan_layout(p, n_layers, dims, C, BM, nullptr, 0);
  if (smem < 0 || B < 1) return (int)cudaErrorInvalidValue;
  p.B = B;
  return (int)launch(fused_mlp_empty_kernel, p, smem, stream);
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
