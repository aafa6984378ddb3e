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
// XLA there): fresh K/V [B, KV, W, hd] go to pool[table[b, clamp(p // bs,
// 0, nblk - 1)], :, p mod bs] at per-row positions p = start[b] + i, block
// 0 (the scratch block) where valid[b, i] is false; a block id outside [0,
// nblocks) is dropped.  The table, the starts and the valid flags are
// device arrays that the kernel reads itself, so the host never learns a
// row's position.  Pools are [N, KV, bs, hd], copied by bytes in units of
// 16 bytes (or 8, 4, 2, 1 where a pointer or stride is misaligned).
//
// Bound: the bytes, 2 * 2 * B*KV*W*hd*elem (the fresh rows read once and
// written once): 2.5 us at a 128-position prefill tick of the flagship's
// layer (B=32, KV=4, hd 64, bf16), 10 us at 512, 0.39 us at a speculative
// verify's W=5 of its 16 kv heads, under the ~2 us of an empty launch.  So
// a small write is latency-bound, and what it waits on is the chain of
// dependent loads before its first store, and the instructions of its
// index arithmetic.  What the design does about them:
//   - The launch plan (kv_write_paged_plan, mirrored by paged_write_plan in
//     ops/kv_write.py): blockIdx.y is the row b; a block takes P positions
//     of it (a power of two, at most the least one >= W) for every kv
//     head, P * KV * lanes <= 256 threads, and blockIdx.x the run of
//     positions; blockIdx.z splits a position's kv heads over blocks only
//     where one position holds more than 256 lanes.  A thread is (kv head,
//     position, lane), lanes innermost: `lanes` is the row's units padded
//     to a power of two, so every index is a shift and a mask of a 32-bit
//     thread number (no division; 64-bit only in the final pointer
//     offsets).  A warp stores consecutive positions' rows, one contiguous
//     run of the pool's [bs, hd] plane while they stay in one pool block.
//   - Each thread starts its K and V source loads (one unit of each: K and
//     V are one lane) before it touches the table.  Lanes 0..P-1 resolve the
//     block's P positions, one lookup a position: start[b], then the table
//     entry at the clamped index (always in bounds, so the load is
//     unconditional and valid[b, i] selects block 0 after it), into shared
//     memory; one __syncthreads, then the stores.  The chain before a store
//     is start -> table, with the source loads in flight beside it.
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
// is.  The same plan with a lane a row's 8 values (lanes = hd / 8, padded
// to a power of two <= 32, so a row's lanes are one aligned group of one
// warp): a lane loads 8 values of K and of V (16 bytes of bf16 each, both
// loads in flight before either reduction), the two absmax reductions are
// interleaved shuffles over the group, every value is divided once
// (__fdiv_rn) and rounded to its code with kvq::code's bits on the FMA
// and ALU pipes (code_alu: kvq::code's FRND and F2I run on the conversion
// pipe, at a quarter of their rate, and set the first version's time),
// and the group's first lane writes both scales.  The quantization runs while the
// slot lookup is in flight.  Bound: the bytes,
// 2 * (2 hd + hd + 4) a position and kv head at bf16 in (1.9 us at a
// 128-position tick of the flagship's layer, 7.7 us at 512); the divisions
// (two per value, IEEE) are ~hd / 4 operations a byte, far below the
// card's rate.
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

// The slot lookup's inputs, shared by both paged kernels.
struct Slots {
  const int* table;            // [B, nblk] int32, contiguous
  const int* start;            // [B] int32
  const unsigned char* valid;  // [B, W] bool, contiguous
  int W, nblk, nblocks;
  int bs, bs_shift;            // pool block size; its log2 where it is a power of two, else -1
};

// The launch plan (kv_write_paged_plan): a thread's (kv head, position,
// lane) are the bits of its number in the block's run, lanes lowest.
struct Plan {
  int lane_shift;              // log2 of the lanes a row (a power of two)
  int pos_shift;               // log2 of the positions a block (P)
  int threads;                 // threads a block, a multiple of 32, <= NTHREADS
  unsigned grid[3];            // runs of P positions, rows B, kv-head splits
};

struct PagedParams {
  char* dst[2];             // pool_k, pool_v [N, KV, bs, hd]
  const char* src[2];       // k, v [B, KV, W, hd]
  long long ds[2][3];       // byte strides of block, kv head, row of each pool
  long long ss[2][3];       // byte strides of b, kv head, position of each source
  Slots s;
  int KV;
  int units;                // units of the copy per row (<= 1 << lane_shift)
  int lane_shift, pos_shift;
};

// floor division and the matching non-negative remainder (JAX's // and %)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// An int32 load through the read-only path that the compiler may neither
// drop nor put under a branch.
__device__ __forceinline__ int load_nc(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The pool slot of position w of row b: (block, row); block -1 where the
// write is dropped (a block id outside [0, nblocks), as XLA's scatter drops
// it).  The table entry is loaded whatever valid says (the clamped index is
// always in bounds), and block 0 is selected after the load.
__device__ __forceinline__ int2 paged_slot(const Slots& s, int b, int w) {
  const int pos = load_nc(s.start + b) + w;
  int q, off;
  if (s.bs_shift >= 0) {  // an arithmetic shift is the floor division
    q = pos >> s.bs_shift;
    off = pos & (s.bs - 1);
  } else {
    q = floor_div(pos, s.bs);
    off = pos - q * s.bs;
  }
  const int idx = min(max(q, 0), s.nblk - 1);
  const int entry = load_nc(s.table + b * s.nblk + idx);
  const int blk = s.valid[b * s.W + w] ? entry : 0;
  return make_int2(blk >= 0 && blk < s.nblocks ? blk : -1, off);
}

// Lanes 0..P-1 of a block resolve its P positions (w0 + lane) into `slot`;
// the caller synchronises before reading it.
__device__ __forceinline__ bool looks_up(const Slots& s, int pos_shift, int w0) {
  return threadIdx.x < (1u << pos_shift) && w0 + static_cast<int>(threadIdx.x) < s.W;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) kv_write_paged_kernel(const PagedParams p) {
  __shared__ int2 slot[NTHREADS];
  const int b = blockIdx.y;
  const int i = blockIdx.z * blockDim.x + threadIdx.x;
  const int u = i & ((1 << p.lane_shift) - 1);
  const int pw = (i >> p.lane_shift) & ((1 << p.pos_shift) - 1);
  const int kvh = i >> (p.lane_shift + p.pos_shift);
  const int w0 = blockIdx.x << p.pos_shift;
  const int w = w0 + pw;
  const bool live = kvh < p.KV && u < p.units && w < p.s.W;
  T x[2] = {};
  if (live) {  // both source units in flight before the table is touched
#pragma unroll
    for (int h = 0; h < 2; ++h)
      x[h] = reinterpret_cast<const T*>(p.src[h] + b * p.ss[h][0] + kvh * p.ss[h][1] +
                                        w * p.ss[h][2])[u];
  }
  if (looks_up(p.s, p.pos_shift, w0)) slot[threadIdx.x] = paged_slot(p.s, b, w0 + threadIdx.x);
  __syncthreads();
  if (!live) return;
  const int2 at = slot[pw];
  if (at.x < 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    reinterpret_cast<T*>(p.dst[h] + at.x * p.ds[h][0] + kvh * p.ds[h][1] + at.y * p.ds[h][2])[u] =
        x[h];
}

// Nothing, at a paged write's grid and block: the launch's floor.
__global__ void __launch_bounds__(NTHREADS) kv_write_paged_empty_kernel(const PagedParams) {}

struct PagedI8Params {
  int8_t* dst[2];           // pool_k, pool_v int8 [N, KV, bs, hd]
  float* dsc[2];            // their scale planes f32 [N, KV, bs], contiguous
  const void* src[2];       // k, v [B, KV, W, hd]: bf16 (quantized here) or int8 (copied)
  const float* ssc[2];      // int8 sources: their scales [B, KV, W] f32, contiguous
  long long ds[2][3];       // element strides of block, kv head, row of each pool
  long long ss[2][3];       // element strides of b, kv head, position of each source
  Slots s;
  int KV, D;
  int lane_shift, pos_shift;  // lanes a row: the power of two >= D / 8
};

// kvq::code's bits, off the conversion pipe: the IEEE quotient clamped to
// [-127, 127] first (clamping to integer bounds commutes with rounding to
// an integer, and fmaxf sends NaN to -127 as kvq::code's does), then
// rounded half to even by adding 1.5 * 2^23, whose sum's low mantissa bits
// are the code in two's complement.  kvq::code takes an FRND and an F2I a
// value, both at a quarter of the FMA rate; this an FADD and two FMNMX.
__device__ __forceinline__ uint32_t code_alu(float x, float scale) {
  const float c = fminf(fmaxf(__fdiv_rn(x, scale), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f)) & 0xffu;
}

// kvq::quant8's bits through code_alu: 8 values to their codes, value i in
// byte i
__device__ __forceinline__ uint2 quant8_alu(const float (&f)[8], float scale) {
  uint2 u;
  u.x = code_alu(f[0], scale) | code_alu(f[1], scale) << 8 | code_alu(f[2], scale) << 16 |
        code_alu(f[3], scale) << 24;
  u.y = code_alu(f[4], scale) | code_alu(f[5], scale) << 8 | code_alu(f[6], scale) << 16 |
        code_alu(f[7], scale) << 24;
  return u;
}

// COPY: the sources are int8 with their scales; else bf16, quantized here.
// Every lane of a warp reaches the shuffles (a lane past the last row or
// the row's width takes part with nothing), and a row's lanes are one
// aligned group of at most 32 lanes of one warp.
template <bool COPY>
__global__ void __launch_bounds__(NTHREADS) kv_write_paged_i8_kernel(const PagedI8Params p) {
  __shared__ int2 slot[NTHREADS];
  const int b = blockIdx.y;
  const int i = blockIdx.z * blockDim.x + threadIdx.x;
  const int c = i & ((1 << p.lane_shift) - 1);  // this lane's 8 values of the row
  const int pw = (i >> p.lane_shift) & ((1 << p.pos_shift) - 1);
  const int kvh = i >> (p.lane_shift + p.pos_shift);
  const int w0 = blockIdx.x << p.pos_shift;
  const int w = w0 + pw;
  const bool live = kvh < p.KV && w < p.s.W;
  const bool lane_on = live && c * 8 < p.D;
  uint2 codes[2] = {};
  float scale[2] = {0.f, 0.f};
  uint4 raw[2] = {};
  if (lane_on) {  // K's and V's 8 values in flight before the table is touched
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long at = b * p.ss[h][0] + kvh * p.ss[h][1] + w * p.ss[h][2] + c * 8;
      if constexpr (COPY)
        codes[h] = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(p.src[h]) + at);
      else
        raw[h] = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.src[h]) + at);
    }
  }
  if constexpr (COPY) {
    if (live && c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        scale[h] = p.ssc[h][(static_cast<long long>(b) * p.KV + kvh) * p.s.W + w];
    }
  }
  const bool looker = looks_up(p.s, p.pos_shift, w0);
  int2 mine = make_int2(-1, 0);
  if (looker) mine = paged_slot(p.s, b, w0 + threadIdx.x);
  if constexpr (!COPY) {  // quantize while the lookup is in flight
    float f[2][8];
    kvq::bf16x8(raw[0], f[0]);
    kvq::bf16x8(raw[1], f[1]);
    float a0 = kvq::absmax8(f[0]), a1 = kvq::absmax8(f[1]);
    for (int o = 1; o < (1 << p.lane_shift); o <<= 1) {
      a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, o));
      a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, o));
    }
    scale[0] = kvq::row_scale(a0);
    scale[1] = kvq::row_scale(a1);
    codes[0] = quant8_alu(f[0], scale[0]);
    codes[1] = quant8_alu(f[1], scale[1]);
  }
  if (looker) slot[threadIdx.x] = mine;
  __syncthreads();
  if (!live) return;
  const int2 at = slot[pw];
  if (at.x < 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lane_on)
      *reinterpret_cast<uint2*>(p.dst[h] + at.x * p.ds[h][0] + kvh * p.ds[h][1] +
                                at.y * p.ds[h][2] + c * 8) = codes[h];
    if (c == 0) p.dsc[h][(static_cast<long long>(at.x) * p.KV + kvh) * p.s.bs + at.y] = scale[h];
  }
}

// The plan of a paged write of B rows of W positions, KV kv heads and
// `lanes` lanes a row (units of the copy, or a row's groups of 8 values):
// 0, or cudaErrorInvalidValue where the shape has no plan within CUDA's
// grid limits.
int make_plan(int B, int KV, int W, int lanes, Plan* pl) {
  if (B < 1 || KV < 1 || W < 1 || lanes < 1 || lanes > (1 << 30))
    return (int)cudaErrorInvalidValue;
  int ls = 0;
  while ((1 << ls) < lanes) ++ls;
  const long long row = static_cast<long long>(KV) << ls;  // lanes a position
  int ps = 0;
  while ((1LL << ps) < W && (row << (ps + 1)) <= NTHREADS) ++ps;
  const long long items = row << ps;  // lanes a run of P positions
  const long long threads = items < NTHREADS ? (items + 31) / 32 * 32 : NTHREADS;
  const long long splits = (items + threads - 1) / threads;
  const long long runs = (W + (1LL << ps) - 1) >> ps;
  if (B > 65535 || splits > 65535 || splits * threads > 0x7fffffffLL ||
      (runs << ps) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  pl->lane_shift = ls;
  pl->pos_shift = ps;
  pl->threads = static_cast<int>(threads);
  pl->grid[0] = static_cast<unsigned>(runs);
  pl->grid[1] = static_cast<unsigned>(B);
  pl->grid[2] = static_cast<unsigned>(splits);
  return 0;
}

// The slot lookup's fields, or cudaErrorInvalidValue where b * nblk or b *
// W would not fit in 32 bits.
int make_slots(const int* table, const int* start, const unsigned char* valid, int B, int W,
               int nblk, int bs, int nblocks, Slots* s) {
  if (static_cast<long long>(B) * nblk > 0x7fffffffLL ||
      static_cast<long long>(B) * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  s->table = table;
  s->start = start;
  s->valid = valid;
  s->W = W;
  s->nblk = nblk;
  s->nblocks = nblocks;
  s->bs = bs;
  s->bs_shift = -1;
  if ((bs & (bs - 1)) == 0)
    for (s->bs_shift = 0; (1 << s->bs_shift) < bs; ++s->bs_shift) {
    }
  return 0;
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

// The plan of a paged write (both variants) into out[6]: the log2 of the
// lanes a row, the log2 of the positions a block, the threads a block and
// the grid (x: runs of positions, y: rows, z: kv-head splits).  lanes is
// the units of the copy a row (row_bytes / unit), or the int8 variant's
// groups of 8 values (D / 8).  Returns 0, or cudaErrorInvalidValue where
// the shape has no plan within CUDA's grid limits.
int kv_write_paged_plan(int B, int KV, int W, int lanes, int* out) {
  Plan pl;
  const int rc = make_plan(B, KV, W, lanes, &pl);
  if (rc != 0) return rc;
  out[0] = pl.lane_shift;
  out[1] = pl.pos_shift;
  out[2] = pl.threads;
  for (int i = 0; i < 3; ++i) out[3 + i] = static_cast<int>(pl.grid[i]);
  return 0;
}

// Launches an empty kernel at the plan's grid and block (and the bf16
// kernel's parameter block) on `stream`: the floor under a paged write of
// that shape.  Returns cudaGetLastError() after the launch.
int kv_write_paged_empty_launch(int B, int KV, int W, int lanes, void* stream) {
  Plan pl;
  const int rc = make_plan(B, KV, W, lanes, &pl);
  if (rc != 0) return rc;
  PagedParams p = {};
  kv_write_paged_empty_kernel<<<dim3(pl.grid[0], pl.grid[1], pl.grid[2]), pl.threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
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
  Plan pl;
  int rc = make_plan(B, KV, W, row_bytes / unit, &pl);
  if (rc == 0) rc = make_slots(table, start, valid, B, W, nblk, bs, nblocks, &p.s);
  if (rc != 0) return rc;
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
  p.KV = KV;
  p.units = row_bytes / unit;
  p.lane_shift = pl.lane_shift;
  p.pos_shift = pl.pos_shift;
  const dim3 grid(pl.grid[0], pl.grid[1], pl.grid[2]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: kv_write_paged_kernel<uint4><<<grid, pl.threads, 0, s>>>(p); break;
    case 8: kv_write_paged_kernel<uint2><<<grid, pl.threads, 0, s>>>(p); break;
    case 4: kv_write_paged_kernel<uint32_t><<<grid, pl.threads, 0, s>>>(p); break;
    case 2: kv_write_paged_kernel<uint16_t><<<grid, pl.threads, 0, s>>>(p); break;
    case 1: kv_write_paged_kernel<uint8_t><<<grid, pl.threads, 0, s>>>(p); break;
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
  Plan pl;
  int rc = make_plan(B, KV, W, D / 8, &pl);
  if (rc == 0) rc = make_slots(table, start, valid, B, W, nblk, bs, nblocks, &p.s);
  if (rc != 0) return rc;
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
  p.KV = KV;
  p.D = D;
  p.lane_shift = pl.lane_shift;
  p.pos_shift = pl.pos_shift;
  const dim3 grid(pl.grid[0], pl.grid[1], pl.grid[2]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (copy)
    kv_write_paged_i8_kernel<true><<<grid, pl.threads, 0, s>>>(p);
  else
    kv_write_paged_i8_kernel<false><<<grid, pl.threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

const char* kv_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
