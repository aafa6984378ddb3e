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
//     f32 PV product, the accumulator rescaled by exp(m_prev - m);
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
// n_main=512, n_chunk=32) that is ~17.8 MB, ~5.3 us at 3.35 TB/s.
//
// Design (simple first): one block of 8 warps per (b*KV + kv head, tile of
// up to 8 query rows of the group).  An mma.sync m16 tile would be 3/4
// padding at G = 4, and the work is bytes-bound, so the products are f32
// FMAs on the CUDA cores.  A cache row of D bf16 values is read as D/8
// 16-byte loads by a group of lanes (lpr, the power of two >= D/8), so a
// warp reads 32/lpr positions at once; each such lane group is a "slot"
// that walks every slots-th position, keeping U positions' K and V loads
// in flight per step, with its own (m, l, acc) over its positions.  A
// lane holds the 8 columns of q and of the accumulator that match its
// chunk of the row; scores are summed across the lane group with
// shuffles.  At the end the slots combine their (m, l, acc) in shared
// memory, in a fixed order, so a repeat gives the same bits.
//
// Later, not now: B = 1 gives only KV blocks (4 on 132 SMs).  Splitting
// the positions across blocks with a combine pass (flash-decoding) is a
// perf PR's work, as are cp.async/TMA staging and tensor-core products.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 256;
constexpr int MAX_GT = 8;              // query rows per block
constexpr int SMEM_LIMIT = 232448;     // 227 KB opt-in per block on sm_90
constexpr int DTYPE_BF16 = 0;          // dtype codes of the wrappers
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

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
  __nv_bfloat16* o;        // [B, KV, G, D] contiguous
  int KV, G, D;
  int lpr;                 // lanes per cache row
  float scale;
};

// the power of two >= D / 8 (lanes that read one row, 16 bytes each)
inline int lanes_per_row(int D) {
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

// shared memory of the combine: (m, l, acc[lpr*8]) per slot and row
inline int smem_for(int D, int GT) {
  const int lpr = lanes_per_row(D);
  const int slots = NWARPS * (32 / lpr);
  return slots * GT * (lpr * 8 + 2) * 4;
}

// The shape and type rules: bf16, a head dim that is a multiple of 8 up to
// 256, a group of at least one row.  Returns the dynamic shared memory in
// bytes, or -1 with the reason in why (why may be null when why_len is 0).
int plan(int head_dim, int group, int dtype_code, char* why, int why_len) {
  if (dtype_code != DTYPE_BF16) {
    snprintf(why, why_len, "the flash-decode kernel takes bfloat16 q/k/v only");
    return -1;
  }
  if (head_dim < 8 || head_dim > MAX_D || head_dim % 8 != 0) {
    snprintf(why, why_len,
             "head dim %d: the flash-decode kernel takes a multiple of 8 up to %d", head_dim,
             MAX_D);
    return -1;
  }
  if (group < 1) {
    snprintf(why, why_len, "group %d: the flash-decode kernel takes at least one query row",
             group);
    return -1;
  }
  const int smem = smem_for(head_dim, group_tile(group));
  if (smem > SMEM_LIMIT) {
    snprintf(why, why_len, "flash decode needs %d KiB shared memory (budget %d KiB)",
             smem >> 10, SMEM_LIMIT >> 10);
    return -1;
  }
  return smem;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int GT>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(const Params p) {
  // positions per slot per step: their K and V loads are all in flight
  // before the first is used; fewer at GT = 8 to stay clear of spills
  constexpr int U = GT >= 8 ? 2 : 4;
  extern __shared__ __align__(16) float smem[];

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
  const int bk = blockIdx.x;           // b * KV + kv head
  const int b = bk / p.KV;
  const int kvh = bk - b * p.KV;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, p.G - g0);

  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const __nv_bfloat16* qp = p.q + b * p.qs[0] + kvh * p.qs[1] + (g0 + g) * p.qs[2] + d0;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = (g < gn && active) ? __bfloat162float(qp[e]) : 0.f;
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const Segment& s0 = p.seg[0];
  const Segment& s1 = p.seg[1];
  const int n0 = s0.n;
  const int n = n0 + s1.n;
  const __nv_bfloat16* kb0 = s0.k + b * s0.ks[0] + kvh * s0.ks[1] + d0;
  const __nv_bfloat16* vb0 = s0.v + b * s0.vs[0] + kvh * s0.vs[1] + d0;
  const __nv_bfloat16* kb1 = s1.k + b * s1.ks[0] + kvh * s1.ks[1] + d0;
  const __nv_bfloat16* vb1 = s1.v + b * s1.vs[0] + kvh * s1.vs[1] + d0;

  // base is warp-uniform, so every lane reaches the shuffles below
  for (int base = warp * rpw; base < n; base += slots * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + sub + u * slots;
      ok[u] = j < n;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (ok[u] && active) {
        const bool in0 = j < n0;
        const long long jj = in0 ? j : j - n0;
        const __nv_bfloat16* kp = in0 ? kb0 + jj * s0.ks[2] : kb1 + jj * s1.ks[2];
        const __nv_bfloat16* vp = in0 ? vb0 + jj * s0.vs[2] : vb1 + jj * s1.vs[2];
        kr[u] = *reinterpret_cast<const uint4*>(kp);
        vr[u] = *reinterpret_cast<const uint4*>(vp);
      }
    }
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qr[g][e], kf[e], x);
        for (int off = lpr >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
        s[u][g] = ok[u] ? x * p.scale : -INFINITY;
      }
    }
    // the online softmax over this step's U positions, row by row
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
      const float alpha = expf(m[g] - mx);  // 0 while m is still -inf
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = expf(s[u][g] - mx);
        psum += pu;
        pb[g][u] = round_bf16(pu);  // p cast to the cache dtype
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      unpack8(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pb[g][u], vf[e], acc[g][e]);
      }
    }
  }

  // combine the slots: o = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30),
  // w_s = exp(m_s - max_s m_s), over the slots in index order
  const int HDP = lpr * 8;
  float* sm_m = smem;                    // [slots][GT]
  float* sm_l = sm_m + slots * GT;       // [slots][GT]
  float* sm_acc = sm_l + slots * GT;     // [slots][GT][HDP]
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
  for (int i = threadIdx.x; i < gn * p.D; i += NTHREADS) {
    const int g = i / p.D;
    const int d = i - g * p.D;
    float M = -INFINITY;
    for (int t = 0; t < slots; ++t) M = fmaxf(M, sm_m[t * GT + g]);
    float L = 0.f, O = 0.f;
    for (int t = 0; t < slots; ++t) {
      const float w = expf(sm_m[t * GT + g] - M);  // 0 for a slot that read nothing
      L = fmaf(sm_l[t * GT + g], w, L);
      O = fmaf(sm_acc[(t * GT + g) * HDP + d], w, O);
    }
    p.o[(static_cast<long long>(bk) * p.G + g0 + g) * p.D + d] =
        __float2bfloat16(O / fmaxf(L, 1e-30f));
  }
}

// per group tile (1, 2, 4, 8) and device: the shared-memory opt-in is set
std::atomic<bool> g_smem_set[4][MAX_DEVICES];

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for this head dim, group
// (query heads per kv head) and dtype code (0 = bfloat16), or -1 with the
// reason in why.
int flash_decode_smem_bytes(int head_dim, int group, int dtype_code, char* why, int why_len) {
  return plan(head_dim, group, dtype_code, why, why_len);
}

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  q [B,KV,G,D]
// bf16 with unit stride along D; the segments k0/v0 (n0 positions) and
// k1/v1 (n1 positions) [B,KV,*,D] bf16 with unit stride along D and
// 16-byte aligned rows; strides[15] = (b, kv head, row) element strides of
// q, k0, v0, k1, v1; o [B,KV,G,D] bf16 contiguous.  n0 + n1 >= 1.
int flash_decode_launch(const void* q, const void* k0, const void* v0, int n0, const void* k1,
                        const void* v1, int n1, void* o, int B, int KV, int G, int D,
                        const long long* strides, void* stream) {
  const int smem = plan(D, G, DTYPE_BF16, nullptr, 0);
  if (smem < 0 || B < 1 || KV < 1 || n0 < 0 || n1 < 0 || n0 + n1 < 1)
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
  p.o = static_cast<__nv_bfloat16*>(o);
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.lpr = lanes_per_row(D);
  p.scale = 1.0f / sqrtf(static_cast<float>(D));

  const int GT = group_tile(G);
  const int which = GT == 1 ? 0 : (GT == 2 ? 1 : (GT == 4 ? 2 : 3));
  void (*kernel)(const Params) =
      which == 0 ? flash_decode_kernel<1>
                 : (which == 1 ? flash_decode_kernel<2>
                               : (which == 2 ? flash_decode_kernel<4> : flash_decode_kernel<8>));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[which][dev].load()) {
    // the largest the kernel asks for at this tile (D = 8: the most slots)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_for(8, GT));
    if (e != cudaSuccess) return (int)e;
    g_smem_set[which][dev].store(true);
  }
  const dim3 grid(B * KV, (G + GT - 1) / GT);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
