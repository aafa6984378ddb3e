// Fused MLP + softmax for Hopper (sm_90a): probs = softmax(relu(x@W0+b0)...@WL+bL)
//
// Replaces the Pallas TPU kernel seldon_core_tpu/ops/fused_mlp.py
// (fused_mlp_softmax :64, kernel body _mlp_kernel :44) and computes what it
// computes, in the same order: each layer's input is cast to bf16, the
// product accumulates in f32, the bf16 bias is added in f32 and relu applied
// in f32, and the final logits get an f32 max-shifted softmax.
//
// Bound on an H100 SXM: at the served widths (784 -> 256 -> 256 -> 10, bf16
// weights) the call moves x (B*784*4 bytes) + the weights (~0.5 MB) + the
// probabilities (B*10*4) and does 2*B*268,288 FLOPs, so it is bound by the
// bytes at 3.35 TB/s at every batch size (the FLOPs at 989 TFLOP/s stay
// below the byte time up to the ~295 FLOP/byte ridge, which this shape never
// reaches).  What the design does about it:
//   * activations never go to device memory: one block owns BM rows and
//     keeps their activation tile in shared memory for the whole chain,
//     double-buffered between layers (buffer 0 holds the even layers'
//     inputs, buffer 1 the odd layers');
//   * weights (0.5 MB at hidden 256, 1.3 MB at 512) stream from global
//     memory in KC-row chunks through shared memory; every block reads the
//     same weights, which therefore hit in the 50 MB L2 after the first;
//   * x is read once and the probabilities written once, masked at the
//     ragged batch edge.
// The matrix products use WMMA bf16 16x16x16 fragments with f32
// accumulators.  A simple kernel: no wgmma, TMA, cp.async pipelining or
// persistent blocks yet.
//
// Interface: a plain C function loaded with ctypes (no PyTorch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <cmath>
#include <cstdio>

using namespace nvcuda;

namespace {

constexpr int BM = 32;                     // batch rows per block
constexpr int MT = BM / 16;                // row tiles per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CT = 2;                      // column tiles per warp per pass
constexpr int PASS_N = NWARPS * CT * 16;   // output columns per pass (256)
constexpr int KC = 64;                     // weight rows staged per chunk
constexpr int PAD = 8;                     // bf16 row padding: spreads banks
constexpr int WLD = PASS_N + PAD;          // leading dim of the weight stage
constexpr int MAX_LAYERS = 8;
constexpr int SMEM_LIMIT = 232448;         // 227 KB opt-in per block on sm_90

struct Params {
  const float* x;
  float* out;
  int B;
  int n_layers;
  int dims[MAX_LAYERS + 1];
  const __nv_bfloat16* w[MAX_LAYERS];
  const __nv_bfloat16* b[MAX_LAYERS];
  int ld[2];        // leading dims (elements) of the two activation buffers
  int buf_off[2];   // byte offsets into dynamic shared memory
  int w_off;
  int scratch_off;
  int logits_off;
  int logits_ld;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
inline int align128(int v) { return (v + 127) & ~127; }

__global__ void __launch_bounds__(NTHREADS)
fused_mlp_softmax_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * BM;

  __nv_bfloat16* bufs[2] = {
      reinterpret_cast<__nv_bfloat16*>(smem + p.buf_off[0]),
      reinterpret_cast<__nv_bfloat16*>(smem + p.buf_off[1])};
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(smem + p.w_off);
  float* scratch = reinterpret_cast<float*>(smem + p.scratch_off) + warp * 256;
  float* logits = reinterpret_cast<float*>(smem + p.logits_off);

  // layer-0 input: the x tile cast to bf16; rows past B are zeros (their
  // results are never stored)
  const int in_dim = p.dims[0];
  for (int i = tid; i < BM * in_dim; i += NTHREADS) {
    const int r = i / in_dim;
    const int c = i - r * in_dim;
    const int gr = row0 + r;
    const float v = gr < p.B ? p.x[(size_t)gr * in_dim + c] : 0.f;
    bufs[0][r * p.ld[0] + c] = __float2bfloat16(v);
  }

  for (int l = 0; l < p.n_layers; ++l) {
    const int K = p.dims[l];
    const int N = p.dims[l + 1];
    const int Np = round16(N);
    const bool last = l == p.n_layers - 1;
    const __nv_bfloat16* A = bufs[l & 1];
    const int lda = p.ld[l & 1];
    __nv_bfloat16* H = bufs[(l + 1) & 1];
    const int ldh = p.ld[(l + 1) & 1];
    const __nv_bfloat16* W = p.w[l];
    const __nv_bfloat16* bias = p.b[l];

    for (int n0 = 0; n0 < Np; n0 += PASS_N) {
      const int pass_n = min(PASS_N, Np - n0);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][CT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[mt][j], 0.f);

      for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        // every warp is done reading the previous stage (and, on the first
        // chunk of a layer, every write of the layer's input is visible)
        __syncthreads();
        if ((N & 7) == 0) {
          // 16-byte loads: a row of W starts 16-byte aligned when N % 8 == 0
          const int vpr = pass_n / 8;
          for (int i = tid; i < kc * vpr; i += NTHREADS) {
            const int r = i / vpr;
            const int c = (i - r * vpr) * 8;
            const int gn = n0 + c;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (gn < N)
              v = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + gn);
            *reinterpret_cast<uint4*>(wst + r * WLD + c) = v;
          }
        } else {
          for (int i = tid; i < kc * pass_n; i += NTHREADS) {
            const int r = i / pass_n;
            const int c = i - r * pass_n;
            const int gn = n0 + c;
            wst[r * WLD + c] =
                gn < N ? W[(size_t)(k0 + r) * N + gn] : __float2bfloat16(0.f);
          }
        }
        __syncthreads();

        for (int kk = 0; kk < kc; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wmma::load_matrix_sync(a[mt], A + mt * 16 * lda + k0 + kk, lda);
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const int ct = warp * CT + j;
            if (ct * 16 < pass_n) {  // warp-uniform
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
              wmma::load_matrix_sync(bf, wst + kk * WLD + ct * 16, WLD);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                wmma::mma_sync(acc[mt][j], a[mt], bf, acc[mt][j]);
            }
          }
        }
      }

      // epilogue, one 16x16 tile at a time through the warp's scratch:
      // + bias (f32), relu, bf16 into the next layer's input buffer; the
      // last layer keeps its f32 logits for the softmax
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int ct = warp * CT + j;
        if (ct * 16 >= pass_n) continue;  // warp-uniform
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wmma::store_matrix_sync(scratch, acc[mt][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = mt * 16 + (e >> 4);
            const int n = n0 + ct * 16 + (e & 15);
            float v = scratch[e];
            if (n < N) v += __bfloat162float(bias[n]);
            if (last) {
              logits[r * p.logits_ld + n] = v;
            } else {
              // relu that keeps NaN, as jnp.maximum / torch.relu do
              H[r * ldh + n] = __float2bfloat16(v < 0.f ? 0.f : v);
            }
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // f32 max-shifted softmax over the out_dim real logits, one warp per row
  const int out_dim = p.dims[p.n_layers];
  for (int r = warp; r < BM; r += NWARPS) {
    const int gr = row0 + r;
    if (gr >= p.B) break;  // warp-uniform; later rows are past B too
    const float* lr = logits + r * p.logits_ld;
    float m = -INFINITY;
    for (int c = lane; c < out_dim; c += 32) m = fmaxf(m, lr[c]);
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int c = lane; c < out_dim; c += 32) s += expf(lr[c] - m);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int c = lane; c < out_dim; c += 32)
      p.out[(size_t)gr * out_dim + c] = expf(lr[c] - m) / s;
  }
}

// The one statement of which widths the kernel takes and of its shared-
// memory layout, for the launch and for fused_mlp_smem_bytes (which the
// Python wrapper asks before it picks the kernel).  Fills p.dims and the
// layout; returns the dynamic shared memory in bytes, or -1 with the reason
// in why (why may be null when why_len is 0).
int plan_layout(Params& p, int n_layers, const int* dims, char* why, int why_len) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) {
    snprintf(why, why_len, "%d layers (the kernel takes at least 1 and at most %d)", n_layers,
             MAX_LAYERS);
    return -1;
  }
  p.n_layers = n_layers;
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
  int ld0 = 0, ld1 = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    if (l & 1) ld1 = ld1 > p.dims[l] ? ld1 : p.dims[l];
    else ld0 = ld0 > p.dims[l] ? ld0 : p.dims[l];
  }
  p.ld[0] = ld0 + PAD;
  p.ld[1] = ld1 ? ld1 + PAD : 0;
  p.logits_ld = round16(p.dims[p.n_layers]);
  int off = 0;
  p.buf_off[0] = off;
  off = align128(off + BM * p.ld[0] * 2);
  p.buf_off[1] = off;
  off = align128(off + BM * p.ld[1] * 2);
  p.w_off = off;
  off = align128(off + KC * WLD * 2);
  p.scratch_off = off;
  off = align128(off + NWARPS * 256 * 4);
  p.logits_off = off;
  off = align128(off + BM * p.logits_ld * 4);
  if (off > SMEM_LIMIT) {
    snprintf(why, why_len, "fused MLP needs %d KiB shared memory (budget %d KiB)",
             off >> 10, SMEM_LIMIT >> 10);
    return -1;
  }
  return off;
}

// dynamic shared memory already granted to the kernel, per device
constexpr int MAX_DEVICES = 64;
std::atomic<int> g_smem_attr[MAX_DEVICES];

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for an MLP of n_layers layers
// with widths dims[0..n_layers], or -1 with the reason in why when it
// cannot take them.
int fused_mlp_smem_bytes(int n_layers, const int* dims, char* why, int why_len) {
  Params p;
  return plan_layout(p, n_layers, dims, why, why_len);
}

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  dims holds
// n_layers + 1 ints; w and b hold n_layers device pointers each (bf16,
// W[l] row-major [dims[l], dims[l+1]], b[l] [dims[l+1]]).  x is f32
// [B, dims[0]], out f32 [B, dims[n_layers]], both contiguous.
int fused_mlp_softmax_launch(const void* x, void* out, int B, int n_layers,
                             const int* dims, const void* const* w,
                             const void* const* b, void* stream) {
  Params p;
  const int smem = plan_layout(p, n_layers, dims, nullptr, 0);
  if (smem < 0 || B < 1) return (int)cudaErrorInvalidValue;
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.B = B;
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const __nv_bfloat16*>(w[l]);
    p.b[l] = static_cast<const __nv_bfloat16*>(b[l]);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::atomic<int>& granted = g_smem_attr[dev];
  int have = granted.load();
  if (smem > have) {
    e = cudaFuncSetAttribute(fused_mlp_softmax_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    while (have < smem && !granted.compare_exchange_weak(have, smem)) {
    }
  }
  const int grid = (B + BM - 1) / BM;
  fused_mlp_softmax_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
