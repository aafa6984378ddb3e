// In-place write of one decode step's K and V slot into a layer's caches,
// for Hopper (sm_90a): cache_k[:, :, pos] = k[:, :, 0] and cache_v[:, :,
// pos] = v[:, :, 0], in one launch, leaving every other slot untouched.
//
// Replaces the Pallas TPU kernel of scripts/probe_inplace.py (_pallas_write
// :68, kernel body _write_kernel :55, pallas_call :71): an aliased DMA of a
// [B, KV, 1, hd] slot into a [B, KV, C, hd] buffer at column pos.  On the
// TPU the aliasing was the point (XLA copies a mutated scan carry); here a
// PyTorch tensor is updated in place by any write, and the kernel's gain is
// one launch for both tensors of a layer where slice assignment takes two.
//
// Bound on an H100 SXM: the call moves 2 * 2 * B*KV*hd*elem bytes (k and v
// read, their slots written; 64 KiB at the served B=32, KV=4, hd=64 bf16),
// ~0.02 us at 3.35 TB/s, so its time is the launch and one round trip to
// memory: it is latency-bound.  What the design does about it: one launch,
// one thread per 16-byte unit where the layout allows it (else 8, 4, 2 or
// 1 bytes), no shared memory, no synchronisation.
//
// The copy is by bytes, so any dtype is taken; the source rows are read by
// strides (the RoPE'd head views of the decode step), with unit stride
// along hd.
//
// The paged variant (kv_write_paged_launch) serves the continuous lane's
// block pool (models/generate.py _paged_write; the reference scatters with
// XLA there, at W = 1 the slot write above): fresh K/V [B, KV, W, hd] go to
// pool[table[b, p // bs], :, p % bs] at per-row positions p = start[b] + i,
// block 0 (the scratch block) where valid[b, i] is false.  The table, the
// starts and the valid flags are device arrays that the kernel reads
// itself, so the host never learns a row's position.  Pools are [N, KV, bs,
// hd]; one thread per 16-byte unit (or 8, 4, 2, 1 bytes), as above, and the
// same bound: the bytes of the fresh rows, far below a launch's cost.
//
// The int8 paged variant (kv_write_paged_i8_launch) serves the int8 K/V
// cache's pools (kv_quant = "int8"): values int8 [N, KV, bs, hd] and scale
// planes f32 [N, KV, bs], the reference's _paged_write of an int8 pool
// (generate.py:1057-1073, which quantizes with _quantize_kv and scatters
// values and scales).  It quantizes in its own launch: each fresh bf16 row
// of hd values becomes hd int8 codes and one f32 scale (kv_int8.cuh, bit
// for bit the reference's quantizer), written through the table as above.
// A source that is int8 already (the shared prefix's cache, quantized when
// it was prefilled) comes with its scales [B, KV, W] and is copied as it
// is.  One group of lanes a (row, kv head, position): a lane takes 8 values
// of K and of V (16 bytes of bf16 in, 8 bytes of int8 out), the row's
// absmax is a shuffle reduction over the group, and its first lane writes
// both scales.  Bound: the bytes, 2 * (2 hd + hd + 4) a position and kv head
// at bf16 in (~0.80 MB at a 512-token prefill tick of the flagship's layer,
// ~0.24 us at 3.35 TB/s), below a launch's cost; the divisions (two per
// value, IEEE) are ~hd / 4 operations a byte, far below the card's rate.
//
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

#include "kv_int8.cuh"

namespace {

constexpr int NTHREADS = 256;

struct Params {
  char* dst[2];             // cache_k, cache_v
  const char* src[2];       // k, v
  long long ds[2][3];       // byte strides of b, kv head, slot of each cache
  long long ss[2][2];       // byte strides of b, kv head of each source
  long long pos;
  int B, KV;
  int units;                // units of the copy per row
  long long total;          // 2 * B * KV * units
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) kv_write_kernel(const Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  if (i >= p.total) return;
  long long r = i / p.units;
  const int u = static_cast<int>(i - r * p.units);
  const int kvh = static_cast<int>(r % p.KV);
  r /= p.KV;
  const int b = static_cast<int>(r % p.B);
  const int which = static_cast<int>(r / p.B);
  const char* s = p.src[which] + b * p.ss[which][0] + kvh * p.ss[which][1];
  char* d = p.dst[which] + b * p.ds[which][0] + kvh * p.ds[which][1] + p.pos * p.ds[which][2];
  reinterpret_cast<T*>(d)[u] = reinterpret_cast<const T*>(s)[u];
}

struct PagedParams {
  char* dst[2];             // pool_k, pool_v [N, KV, bs, hd]
  const char* src[2];       // k, v [B, KV, W, hd]
  long long ds[2][3];       // byte strides of block, kv head, row of each pool
  long long ss[2][3];       // byte strides of b, kv head, position of each source
  const int* table;         // [B, nblk] int32, contiguous
  const int* start;         // [B] int32
  const unsigned char* valid;  // [B, W] bool, contiguous
  int B, KV, W, nblk, bs, nblocks;
  int units;                // units of the copy per row
  long long total;          // 2 * B * KV * W * units
};

// floor division and the matching non-negative remainder (JAX's // and %)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) kv_write_paged_kernel(const PagedParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  if (i >= p.total) return;
  long long r = i / p.units;
  const int u = static_cast<int>(i - r * p.units);
  const int w = static_cast<int>(r % p.W);
  r /= p.W;
  const int kvh = static_cast<int>(r % p.KV);
  r /= p.KV;
  const int b = static_cast<int>(r % p.B);
  const int which = static_cast<int>(r / p.B);
  const int pos = p.start[b] + w;
  const int q = floor_div(pos, p.bs);
  const int off = pos - q * p.bs;
  const int idx = min(max(q, 0), p.nblk - 1);
  const int blk = p.valid[b * p.W + w] ? p.table[b * p.nblk + idx] : 0;
  if (blk < 0 || blk >= p.nblocks) return;  // out of the pool: dropped, as XLA's scatter drops it
  const char* s = p.src[which] + b * p.ss[which][0] + kvh * p.ss[which][1] + w * p.ss[which][2];
  char* d = p.dst[which] + blk * p.ds[which][0] + kvh * p.ds[which][1] + off * p.ds[which][2];
  reinterpret_cast<T*>(d)[u] = reinterpret_cast<const T*>(s)[u];
}

struct PagedI8Params {
  int8_t* dst[2];           // pool_k, pool_v int8 [N, KV, bs, hd]
  float* dsc[2];            // their scale planes f32 [N, KV, bs], contiguous
  const void* src[2];       // k, v [B, KV, W, hd]: bf16 (quantized here) or int8 (copied)
  const float* ssc[2];      // int8 sources: their scales [B, KV, W] f32, contiguous
  long long ds[2][3];       // element strides of block, kv head, row of each pool
  long long ss[2][3];       // element strides of b, kv head, position of each source
  const int* table;         // [B, nblk] int32, contiguous
  const int* start;         // [B] int32
  const unsigned char* valid;  // [B, W] bool, contiguous
  int B, KV, W, nblk, bs, nblocks, D;
  int lpr;                  // lanes a row: the power of two >= hd / 8
  long long rows;           // B * KV * W
};

// COPY: the sources are int8 with their scales; else bf16, quantized here.
// Every lane of a warp reaches the shuffles (a lane past the last row or
// the row's width takes part with nothing).
template <bool COPY>
__global__ void __launch_bounds__(NTHREADS) kv_write_paged_i8_kernel(const PagedI8Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  const long long r = t / p.lpr;
  const int c = static_cast<int>(t - r * p.lpr);  // this lane's 8 values of the row
  const bool live = r < p.rows;
  const bool lane_on = live && c * 8 < p.D;
  int b = 0, kvh = 0, w = 0, blk = 0, off = 0;
  if (live) {
    long long x = r;
    w = static_cast<int>(x % p.W);
    x /= p.W;
    kvh = static_cast<int>(x % p.KV);
    b = static_cast<int>(x / p.KV);
    const int pos = p.start[b] + w;
    const int q = floor_div(pos, p.bs);
    off = pos - q * p.bs;
    const int idx = min(max(q, 0), p.nblk - 1);
    blk = p.valid[b * p.W + w] ? p.table[b * p.nblk + idx] : 0;
  }
  const bool store = live && blk >= 0 && blk < p.nblocks;  // else dropped, as XLA's scatter
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    uint2 codes = make_uint2(0u, 0u);
    float scale = 0.f;
    if constexpr (COPY) {
      if (lane_on)
        codes = *reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(p.src[which]) + b * p.ss[which][0] +
            kvh * p.ss[which][1] + w * p.ss[which][2] + c * 8);
      if (live) scale = p.ssc[which][(static_cast<long long>(b) * p.KV + kvh) * p.W + w];
    } else {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (lane_on)
        kvq::bf16x8(*reinterpret_cast<const uint4*>(
                        static_cast<const __nv_bfloat16*>(p.src[which]) + b * p.ss[which][0] +
                        kvh * p.ss[which][1] + w * p.ss[which][2] + c * 8),
                    f);
      float a = kvq::absmax8(f);
      for (int o = 1; o < p.lpr; o <<= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      scale = kvq::row_scale(a);
      codes = kvq::quant8(f, scale);
    }
    if (!store) continue;
    if (lane_on)
      *reinterpret_cast<uint2*>(p.dst[which] + blk * p.ds[which][0] + kvh * p.ds[which][1] +
                                off * p.ds[which][2] + c * 8) = codes;
    if (c == 0) p.dsc[which][(static_cast<long long>(blk) * p.KV + kvh) * p.bs + off] = scale;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t as an integer handle) and returns
// cudaGetLastError() after the launch: 0 means launched.  Writes row_bytes
// bytes per (b, kv head) from k and v into slot pos of cache_k and cache_v.
// strides[10] = byte strides (b, kv, slot) of cache_k and cache_v, then
// (b, kv) of k and v.  unit (1, 2, 4, 8 or 16) divides row_bytes, every
// pointer and every stride.
int kv_write_launch(void* cache_k, void* cache_v, const void* k, const void* v, int B, int KV,
                    int row_bytes, long long pos, const long long* strides, int unit,
                    void* stream) {
  if (B < 1 || KV < 1 || row_bytes < 1 || pos < 0 || unit < 1 || row_bytes % unit != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.dst[0] = static_cast<char*>(cache_k);
  p.dst[1] = static_cast<char*>(cache_v);
  p.src[0] = static_cast<const char*>(k);
  p.src[1] = static_cast<const char*>(v);
  for (int i = 0; i < 3; ++i) {
    p.ds[0][i] = strides[i];
    p.ds[1][i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    p.ss[0][i] = strides[6 + i];
    p.ss[1][i] = strides[8 + i];
  }
  p.pos = pos;
  p.B = B;
  p.KV = KV;
  p.units = row_bytes / unit;
  p.total = 2LL * B * KV * p.units;
  const unsigned blocks = static_cast<unsigned>((p.total + NTHREADS - 1) / NTHREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: kv_write_kernel<uint4><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 8: kv_write_kernel<uint2><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 4: kv_write_kernel<uint32_t><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 2: kv_write_kernel<uint16_t><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 1: kv_write_kernel<uint8_t><<<blocks, NTHREADS, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError() after the launch: 0
// means launched.  Writes row_bytes bytes per (b, kv head, position i <
// W) from k and v into the pools at (table[b, clamp((start[b] + i) // bs,
// 0, nblk - 1)], start[b] + i mod bs), or block 0 where valid[b, i] is 0;
// a block id outside [0, nblocks) is dropped.  strides[12] = byte strides
// (block, kv, row) of pool_k and pool_v, then (b, kv, position) of k and
// v.  unit (1, 2, 4, 8 or 16) divides row_bytes, every pointer and every
// stride.
int kv_write_paged_launch(void* pool_k, void* pool_v, const void* k, const void* v,
                          const int* table, const int* start, const unsigned char* valid, int B,
                          int KV, int W, int nblk, int bs, int nblocks, int row_bytes,
                          const long long* strides, int unit, void* stream) {
  if (B < 1 || KV < 1 || W < 1 || nblk < 1 || bs < 1 || nblocks < 1 || row_bytes < 1 ||
      unit < 1 || row_bytes % unit != 0)
    return (int)cudaErrorInvalidValue;
  PagedParams p;
  p.dst[0] = static_cast<char*>(pool_k);
  p.dst[1] = static_cast<char*>(pool_v);
  p.src[0] = static_cast<const char*>(k);
  p.src[1] = static_cast<const char*>(v);
  for (int i = 0; i < 3; ++i) {
    p.ds[0][i] = strides[i];
    p.ds[1][i] = strides[3 + i];
    p.ss[0][i] = strides[6 + i];
    p.ss[1][i] = strides[9 + i];
  }
  p.table = table;
  p.start = start;
  p.valid = valid;
  p.B = B;
  p.KV = KV;
  p.W = W;
  p.nblk = nblk;
  p.bs = bs;
  p.nblocks = nblocks;
  p.units = row_bytes / unit;
  p.total = 2LL * B * KV * W * p.units;
  const unsigned blocks = static_cast<unsigned>((p.total + NTHREADS - 1) / NTHREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: kv_write_paged_kernel<uint4><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 8: kv_write_paged_kernel<uint2><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 4: kv_write_paged_kernel<uint32_t><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 2: kv_write_paged_kernel<uint16_t><<<blocks, NTHREADS, 0, s>>>(p); break;
    case 1: kv_write_paged_kernel<uint8_t><<<blocks, NTHREADS, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError() after the launch: 0
// means launched.  The int8 pools' write: per (b, kv head, position i < W)
// the fresh K and V rows of D values (bf16, quantized in the launch; or
// int8 with their scales k_s / v_s [B, KV, W] f32 contiguous, copied) go to
// the int8 pools at (table[b, clamp((start[b] + i) // bs, 0, nblk - 1)],
// start[b] + i mod bs), block 0 where valid[b, i] is 0, and their scales
// to the pools' scale planes pool_ks / pool_vs [nblocks, KV, bs] f32
// contiguous; a block id outside [0, nblocks) is dropped.  D is a multiple
// of 8 up to 256 and every row is 8-byte aligned (16-byte for bf16).
// strides[12] = element strides (block, kv, row) of pool_k and pool_v, then
// (b, kv, position) of k and v.
int kv_write_paged_i8_launch(void* pool_k, void* pool_v, void* pool_ks, void* pool_vs,
                             const void* k, const void* v, const void* k_s, const void* v_s,
                             const int* table, const int* start, const unsigned char* valid,
                             int B, int KV, int W, int nblk, int bs, int nblocks, int D,
                             const long long* strides, void* stream) {
  const bool copy = k_s != nullptr;
  if (B < 1 || KV < 1 || W < 1 || nblk < 1 || bs < 1 || nblocks < 1 || D < 8 || D > 256 ||
      D % 8 != 0 || copy != (v_s != nullptr))
    return (int)cudaErrorInvalidValue;
  PagedI8Params p;
  p.dst[0] = static_cast<int8_t*>(pool_k);
  p.dst[1] = static_cast<int8_t*>(pool_v);
  p.dsc[0] = static_cast<float*>(pool_ks);
  p.dsc[1] = static_cast<float*>(pool_vs);
  p.src[0] = k;
  p.src[1] = v;
  p.ssc[0] = static_cast<const float*>(k_s);
  p.ssc[1] = static_cast<const float*>(v_s);
  for (int i = 0; i < 3; ++i) {
    p.ds[0][i] = strides[i];
    p.ds[1][i] = strides[3 + i];
    p.ss[0][i] = strides[6 + i];
    p.ss[1][i] = strides[9 + i];
  }
  p.table = table;
  p.start = start;
  p.valid = valid;
  p.B = B;
  p.KV = KV;
  p.W = W;
  p.nblk = nblk;
  p.bs = bs;
  p.nblocks = nblocks;
  p.D = D;
  p.lpr = 1;
  while (p.lpr * 8 < D) p.lpr <<= 1;
  p.rows = static_cast<long long>(B) * KV * W;
  const unsigned blocks = static_cast<unsigned>((p.rows * p.lpr + NTHREADS - 1) / NTHREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (copy)
    kv_write_paged_i8_kernel<true><<<blocks, NTHREADS, 0, s>>>(p);
  else
    kv_write_paged_i8_kernel<false><<<blocks, NTHREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

const char* kv_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
