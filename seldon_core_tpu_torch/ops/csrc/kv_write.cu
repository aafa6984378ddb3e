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
// Interface: plain C functions loaded with ctypes (no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

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

const char* kv_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
