"""In-place KV-cache slot write on Hopper — each decode step's K/V.

    cache_k[:, :, pos] = k[:, :, 0];   cache_v[:, :, pos] = v[:, :, 0]

k/v ``[B, KV, 1, hd]`` (read by strides: the RoPE'd head views of a decode
step), caches ``[B, KV, C, hd]``; the caches stay the same tensors
(``data_ptr`` unchanged) and every other slot is untouched.

Replaces the Pallas TPU kernel of ``scripts/probe_inplace.py``
(``_pallas_write`` :68, kernel ``_write_kernel`` :55, ``pallas_call`` :71),
an aliased one-slot DMA into a KV buffer, with a hand-written CUDA kernel
for sm_90a (``ops/csrc/kv_write.cu``) that writes K and V of one layer in
one launch, by bytes (any dtype).  The plain version, ``kv_write_reference``,
is slice assignment, which is what the decode step did before; a CPU
tensor runs it, a CUDA tensor launches the kernel or raises.  ``LAUNCHES``
counts kernel launches and nothing else; ``probe_kv_write`` builds the
library and writes once.  The decode lane no longer launches it: its
write is fused into ``flash_decode_two_tier``'s launch
(``ops/flash_decode.py``), whose plain path is ``kv_write_reference``.

The paged variant serves the continuous lane's block pool
(``models/generate.py`` ``_paged_write``, the reference's
``seldon_core_tpu/models/generate.py:1057``, whose W = 1 case is the slot
write above):

    pool[table[b, (start[b] + i) // bs], :, (start[b] + i) % bs] = kv[b, :, i]

``kv_write_paged(pool_k, pool_v, k, v, tables, start, valid)`` with pools
``[N, KV, bs, hd]``, fresh k/v ``[B, KV, W, hd]``, ``tables`` [B, nblk]
int32, ``start`` [B] int32 and ``valid`` [B, W] bool, all on the device:
the kernel reads the table and the positions itself, so nothing is read
back on the host.  A position whose ``valid`` is False goes to block 0,
the scratch block.  ``kv_write_paged_reference`` is the plain version
(``index_put_``), ``PAGED_LAUNCHES`` its count and
``probe_kv_write_paged`` its probe.  ``paged_write_plan`` states the
launch's geometry as ``kv_write_paged_plan`` in the source computes it
(both paged kernels take it): a block of a row's positions for every kv
head, a thread a (kv head, position, lane), lanes lowest.

The int8 K/V cache (``kv_quant="int8"``): int8 pools ``[N, KV, bs, hd]``
carry scale planes f32 ``[N, KV, bs]`` (``scales=(pool_ks, pool_vs)``), and
``kv_write_paged`` quantizes fresh bf16 rows in its own launch (the int8
variant of ``ops/csrc/kv_write.cu``, ``kv_write_paged_i8_launch``) with
the reference's quantizer, ``quantize_kv`` here
(``seldon_core_tpu/models/generate.py:133``), bit for bit; rows that are
int8 already (the shared prefix's cache) come with their scales
(``k_s``/``v_s``) and are copied.  ``PAGED_I8_LAUNCHES`` counts those
launches (``PAGED_LAUNCHES`` counts them too).  The static caches' int8
write has no kernel: the decode step's is fused into
``flash_decode_two_tier``, and ``kv_write_reference`` with ``scales`` is
its plain version.
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library

__all__ = ["LAUNCHES", "PAGED_LAUNCHES", "PAGED_I8_LAUNCHES", "kv_write", "kv_write_reference",
           "probe_kv_write", "kv_write_paged", "kv_write_paged_reference", "probe_kv_write_paged",
           "paged_write_plan", "paged_write_lanes", "paged_write_inputs", "paged_write_expected",
           "quantize_kv", "int8_kv_rows"]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
#: the paged kernel's launches, counted the same way
PAGED_LAUNCHES = 0
#: those of them into int8 pools
PAGED_I8_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()
#: threads a block of the paged write at most (NTHREADS in the source)
PAGED_THREADS = 256


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t [..., hd] float -> (int8 codes [..., hd], f32 scales [...]): the
    reference's ``_quantize_kv`` (``generate.py:133``), symmetric per token
    and head.  The absmax over hd in f32, scale = max(absmax, 1e-12) / 127,
    q = clip(round(t / scale), -127, 127) with true divisions and
    ``torch.round``, which rounds half to even as ``jnp.round`` does.  The
    127 is a 0-dim tensor on t's device: CUDA torch turns a division by a
    Python number into a multiplication by its reciprocal, which rounds
    differently."""
    t32 = t.float()
    absmax = t32.abs().amax(dim=-1)
    scales = torch.clamp_min(absmax, 1e-12) / absmax.new_full((), 127.0)
    q = torch.clamp(torch.round(t32 / scales[..., None]), -127, 127).to(torch.int8)
    return q, scales


def int8_kv_rows(shape, gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random int8 K/V as a served cache holds them, for probes and kernel
    checks: bf16 rows ``shape`` [..., hd] of N(0, 1) drawn from ``gen`` on
    its own device, quantized by ``quantize_kv`` (codes filling +-127,
    scales absmax / 127), then moved to ``device``."""
    t = torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)
    codes, scales = quantize_kv(t)
    return codes.to(device), scales.to(device)


def _validate(cache_k, cache_v, k, v, pos: int) -> None:
    if cache_k.ndim != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"caches must be [B, KV, C, hd] of one shape, got "
                         f"{tuple(cache_k.shape)} {tuple(cache_v.shape)}")
    B, KV, C, hd = cache_k.shape
    if k.shape != (B, KV, 1, hd) or v.shape != (B, KV, 1, hd):
        raise ValueError(f"k/v must be {(B, KV, 1, hd)}, got {tuple(k.shape)} {tuple(v.shape)}")
    for name, t in (("cache_v", cache_v), ("k", k), ("v", v)):
        if t.device != cache_k.device or t.dtype != cache_k.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, cache_k {cache_k.dtype} on "
                             f"{cache_k.device}")
    if not 0 <= pos < C:
        raise ValueError(f"slot {pos} outside the cache's {C} slots")


def kv_write_reference(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, pos: int,
                       scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, on any device: slice assignment in place.  With
    ``scales`` (the int8 caches' planes [B, KV, C] f32) the float k/v are
    quantized (``quantize_kv``) and their scales go to slot ``pos`` of the
    planes too.  Returns the caches."""
    if scales is not None:
        (k, k_s), (v, v_s) = quantize_kv(k), quantize_kv(v)
        scales[0][:, :, pos:pos + 1] = k_s
        scales[1][:, :, pos:pos + 1] = v_s
    cache_k[:, :, pos:pos + 1] = k
    cache_v[:, :, pos:pos + 1] = v
    return cache_k, cache_v


_bind_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None


def _library() -> SimpleNamespace:
    """The kernel library's entry points, built and bound at first use."""
    global _lib
    with _bind_lock:
        if _lib is None:
            lib = load_library("kv_write")
            launch = lib.kv_write_launch
            launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                               + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p])
            launch.restype = ctypes.c_int
            paged = lib.kv_write_paged_launch
            paged.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                              + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
            paged.restype = ctypes.c_int
            paged_i8 = lib.kv_write_paged_i8_launch
            paged_i8.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p, ctypes.c_void_p])
            paged_i8.restype = ctypes.c_int
            plan = lib.kv_write_paged_plan
            plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
            plan.restype = ctypes.c_int
            err = lib.kv_write_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, paged=paged, paged_i8=paged_i8, plan=plan,
                                   error_string=err)
        return _lib


def _copy_unit(row_bytes: int, addresses) -> int:
    """The widest unit (16, 8, 4, 2 or 1 bytes) that divides the row and
    every pointer and byte stride."""
    for unit in (16, 8, 4, 2, 1):
        if row_bytes % unit == 0 and all(a % unit == 0 for a in addresses):
            return unit
    return 1


def _launch(cache_k, cache_v, k, v, pos: int) -> None:
    B, KV, _, hd = cache_k.shape
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride along hd, got strides {t.stride()}")
    k = k if k.stride(3) == 1 else k.contiguous()
    v = v if v.stride(3) == 1 else v.contiguous()
    if B == 0 or KV == 0 or hd == 0:
        return
    es = cache_k.element_size()
    byte_strides = ([s * es for s in cache_k.stride()[:3]] + [s * es for s in cache_v.stride()[:3]]
                    + [s * es for s in k.stride()[:2]] + [s * es for s in v.stride()[:2]])
    pointers = [cache_k.data_ptr(), cache_v.data_ptr(), k.data_ptr(), v.data_ptr()]
    row_bytes = hd * es
    unit = _copy_unit(row_bytes, pointers + byte_strides)
    strides = (ctypes.c_longlong * 10)(*byte_strides)
    lib = _library()
    rc = launch_on(cache_k.device, lib.launch, *pointers, B, KV, row_bytes, int(pos),
                   ctypes.addressof(strides), unit)
    if rc != 0:
        raise RuntimeError(f"kv_write kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1


def kv_write(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k/v [B, KV, 1, hd] into slot ``pos`` of cache_k/cache_v [B, KV,
    C, hd], in place; returns the caches (the same tensors).  ValueError for
    mismatched shapes, dtypes or devices and for a slot outside [0, C).  A
    CUDA cache launches the kernel or raises; a CPU cache runs
    ``kv_write_reference``."""
    pos = int(pos)
    _validate(cache_k, cache_v, k, v, pos)
    if cache_k.device.type == "cpu":
        return kv_write_reference(cache_k, cache_v, k, v, pos)
    if cache_k.device.type != "cuda":
        raise ValueError(f"kv_write takes cpu or cuda tensors, got {cache_k.device}")
    _launch(cache_k, cache_v, k, v, pos)
    return cache_k, cache_v


def probe_kv_write(n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   device: torch.device) -> None:
    """Build the library and write once, at the head shape, into slot 1 of
    zero caches with three slots on a CUDA ``device``: slot 1 must hold k
    (ones) and v (twos), slots 0 and 2 zeros, in the same tensors.  Raises
    if the build or the launch fails or the write is wrong."""
    ck = torch.zeros(1, n_kv_heads, 3, head_dim, dtype=dtype, device=device)
    cv = torch.zeros_like(ck)
    ptrs = (ck.data_ptr(), cv.data_ptr())
    k = torch.ones(1, n_kv_heads, 1, head_dim, dtype=dtype, device=device)
    kv_write(ck, cv, k, 2 * k, 1)
    want = torch.tensor([0.0, 1.0, 0.0], device=device)[None, None, :, None].expand_as(ck)
    if ((ck.data_ptr(), cv.data_ptr()) != ptrs or not bool((ck.float() == want).all().cpu())
            or not bool((cv.float() == 2 * want).all().cpu())):
        raise RuntimeError(f"kv_write probe at {n_kv_heads} kv heads, head dim {head_dim} "
                           f"wrote the wrong slots")


def _validate_paged(pool_k, pool_v, k, v, tables, start, valid, scales=None, k_s=None,
                    v_s=None) -> None:
    if pool_k.ndim != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"pools must be [N, KV, bs, hd] of one shape, got "
                         f"{tuple(pool_k.shape)} {tuple(pool_v.shape)}")
    N, KV, bs, hd = pool_k.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[1] != KV or k.shape[3] != hd:
        raise ValueError(f"k/v must be [B, {KV}, W, {hd}], got {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, _, W, _ = k.shape
    int8 = pool_k.dtype == torch.int8
    if int8 != (scales is not None):
        raise ValueError("int8 pools take their scale planes (scales=(pool_ks, pool_vs)), and "
                         "only int8 pools do")
    # int8 pools take float rows (quantized) or int8 rows with their scales
    if (k_s is None) != (v_s is None) or (k_s is not None) != (int8 and k.dtype == torch.int8):
        raise ValueError("int8 rows into int8 pools come with their scales k_s and v_s, and "
                         "nothing else does")
    row_dtype = k.dtype if int8 else pool_k.dtype
    for name, t in (("pool_v", pool_v), ("k", k), ("v", v)):
        want = pool_k.dtype if name == "pool_v" else row_dtype
        if t.device != pool_k.device or t.dtype != want:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, pool_k {pool_k.dtype} on "
                             f"{pool_k.device}")
    planes = []
    if int8:
        planes += [("pool_ks", scales[0], (N, KV, bs)), ("pool_vs", scales[1], (N, KV, bs))]
    if k_s is not None:
        planes += [("k_s", k_s, (B, KV, W)), ("v_s", v_s, (B, KV, W))]
    for name, t, shape in planes:
        if t.device != pool_k.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {pool_k.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t, dtype, shape in (("tables", tables, torch.int32, None),
                                  ("start", start, torch.int32, (B,)),
                                  ("valid", valid, torch.bool, (B, W))):
        if t.device != pool_k.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {pool_k.device}, got {t.dtype} on "
                             f"{t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if tables.ndim != 2 or tables.shape[0] != B or tables.shape[1] < 1:
        raise ValueError(f"tables must be [{B}, nblk >= 1], got {tuple(tables.shape)}")


def kv_write_paged_reference(pool_k: torch.Tensor, pool_v: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, tables: torch.Tensor, start: torch.Tensor,
                             valid: torch.Tensor,
                             scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             k_s: Optional[torch.Tensor] = None,
                             v_s: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, on any device: ``_paged_write``'s scatter
    (``index_put_``, in place).  Position ``start[b] + i`` of row b goes to
    block ``tables[b, clip(pos // bs, 0, nblk - 1)]`` (0 where ``valid`` is
    False), row ``pos % bs``.  Int8 pools (``scales`` their planes [N, KV,
    bs]) take float rows quantized by ``quantize_kv``, or int8 rows with
    their scales ``k_s``/``v_s`` [B, KV, W] as they are, and the scales
    scatter to the same (block, row).  Returns the pools."""
    bs, nblk, W = pool_k.shape[2], tables.shape[1], k.shape[2]
    pos = start.long()[:, None] + torch.arange(W, device=k.device)  # [B, W]
    idx = torch.clamp(torch.div(pos, bs, rounding_mode="floor"), 0, nblk - 1)
    blk = torch.where(valid, torch.gather(tables.long(), 1, idx), 0)
    off = torch.remainder(pos, bs)
    if scales is not None:
        if k_s is None:
            (k, k_s), (v, v_s) = quantize_kv(k), quantize_kv(v)
        scales[0][blk, :, off] = k_s.transpose(1, 2)  # [B, W, KV] at (blk, :, off)
        scales[1][blk, :, off] = v_s.transpose(1, 2)
    pool_k[blk, :, off] = k.transpose(1, 2)  # [B, W, KV, hd] at (blk, :, off)
    pool_v[blk, :, off] = v.transpose(1, 2)
    return pool_k, pool_v


def paged_write_plan(B: int, KV: int, W: int, lanes: int) -> Tuple[int, int, int, int, int, int]:
    """The paged write's launch plan, as ``kv_write_paged_plan`` in
    ``ops/csrc/kv_write.cu`` computes it: (lane_shift, pos_shift, threads,
    grid x, grid y, grid z) for B rows of W positions, KV kv heads and
    ``lanes`` lanes a row (the copy's units, row_bytes // unit, or the int8
    variant's groups of 8 values, hd // 8).  A row's lanes are padded to
    the power of two 1 << lane_shift; a block takes P = 1 << pos_shift
    positions of one row (grid y) for every kv head, P at most the power of
    two at or above W and P * KV * lanes at most PAGED_THREADS; grid x the
    runs of P positions, grid z the blocks one run's lanes need (more than
    one only where a position holds more than PAGED_THREADS lanes).  Thread
    t of block (x, y, z) is lane ``i & (L - 1)`` of position ``x * P + (i >>
    lane_shift) % P`` and kv head ``i >> (lane_shift + pos_shift)``, with i
    = z * threads + t: a live thread is one whose kv head, lane and
    position are in range.  ValueError where the shape has no plan within
    CUDA's grid limits (the launch refuses it too)."""
    if min(B, KV, W, lanes) < 1 or lanes > 1 << 30:
        raise ValueError(f"no paged write plan for B={B}, KV={KV}, W={W}, lanes={lanes}")
    ls = (lanes - 1).bit_length()
    row = KV << ls
    ps = 0
    while (1 << ps) < W and row << (ps + 1) <= PAGED_THREADS:
        ps += 1
    items = row << ps
    threads = -(-items // 32) * 32 if items < PAGED_THREADS else PAGED_THREADS
    splits = -(-items // threads)
    runs = (W + (1 << ps) - 1) >> ps
    if B > 65535 or splits > 65535 or splits * threads > 2**31 - 1 or runs << ps > 2**31 - 1:
        raise ValueError(f"no paged write plan within CUDA's grid limits for B={B}, KV={KV}, "
                         f"W={W}, lanes={lanes}")
    return ls, ps, threads, runs, B, splits


def paged_write_lanes(pool_k: torch.Tensor, pool_v: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> int:
    """The lanes a row that the launch plans with (``paged_write_plan``):
    the int8 pools' hd // 8, else the row's bytes over the copy's unit (16
    bytes where every pointer and byte stride allows it), as the launch
    picks it."""
    hd = pool_k.shape[3]
    if pool_k.dtype == torch.int8:
        return hd // 8
    k = k if k.stride(3) == 1 else k.contiguous()
    v = v if v.stride(3) == 1 else v.contiguous()
    es = pool_k.element_size()
    byte_strides = [s * es for t in (pool_k, pool_v, k, v) for s in t.stride()[:3]]
    pointers = [pool_k.data_ptr(), pool_v.data_ptr(), k.data_ptr(), v.data_ptr()]
    return hd * es // _copy_unit(hd * es, pointers + byte_strides)


def _launch_paged(pool_k, pool_v, k, v, tables, start, valid) -> None:
    N, KV, bs, hd = pool_k.shape
    B, _, W, _ = k.shape
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride along hd, got strides {t.stride()}")
    k = k if k.stride(3) == 1 else k.contiguous()
    v = v if v.stride(3) == 1 else v.contiguous()
    tables, start, valid = tables.contiguous(), start.contiguous(), valid.contiguous()
    if B == 0 or W == 0 or KV == 0 or hd == 0:
        return
    es = pool_k.element_size()
    byte_strides = [s * es for t in (pool_k, pool_v, k, v) for s in t.stride()[:3]]
    pointers = [pool_k.data_ptr(), pool_v.data_ptr(), k.data_ptr(), v.data_ptr()]
    row_bytes = hd * es
    unit = _copy_unit(row_bytes, pointers + byte_strides)
    strides = (ctypes.c_longlong * 12)(*byte_strides)
    lib = _library()
    rc = launch_on(pool_k.device, lib.paged, *pointers, tables.data_ptr(), start.data_ptr(),
                   valid.data_ptr(), B, KV, W, tables.shape[1], bs, N, row_bytes,
                   ctypes.addressof(strides), unit)
    if rc != 0:
        raise RuntimeError(f"kv_write_paged kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    global PAGED_LAUNCHES
    with _LAUNCH_LOCK:
        PAGED_LAUNCHES += 1


def _aligned(t: torch.Tensor, unit: int) -> bool:
    """Unit stride along hd, and the base and every byte stride a multiple
    of ``unit``."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % unit == 0
            and all(s * es % unit == 0 for s in t.stride()[:-1]))


def _launch_paged_i8(pool_k, pool_v, k, v, tables, start, valid, scales, k_s, v_s) -> None:
    N, KV, bs, hd = pool_k.shape
    B, _, W, _ = k.shape
    copy = k_s is not None
    if k.dtype != (torch.int8 if copy else torch.bfloat16):
        raise ValueError(f"the int8 pools' write takes bfloat16 rows (quantized in the launch) "
                         f"or int8 rows with their scales, got {k.dtype}")
    if hd % 8 != 0 or hd > 256:
        raise ValueError(f"head dim {hd}: the int8 pools' write takes a multiple of 8 up to 256")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if not _aligned(t, 8):  # written in place: no copy will do
            raise ValueError(f"{name} needs unit stride along hd and 8-byte aligned rows, got "
                             f"{t.stride()}")
    for name, t in (("pool_ks", scales[0]), ("pool_vs", scales[1])):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (written in place)")
    k, v = (t if _aligned(t, 16) else t.contiguous() for t in (k, v))
    if copy:
        k_s, v_s = k_s.contiguous(), v_s.contiguous()
    tables, start, valid = tables.contiguous(), start.contiguous(), valid.contiguous()
    if B == 0 or W == 0 or KV == 0:
        return
    strides = (ctypes.c_longlong * 12)(*(s for t in (pool_k, pool_v, k, v) for s in t.stride()[:3]))
    lib = _library()
    rc = launch_on(pool_k.device, lib.paged_i8, pool_k.data_ptr(), pool_v.data_ptr(),
                   scales[0].data_ptr(), scales[1].data_ptr(), k.data_ptr(), v.data_ptr(),
                   k_s.data_ptr() if copy else None, v_s.data_ptr() if copy else None,
                   tables.data_ptr(), start.data_ptr(), valid.data_ptr(), B, KV, W,
                   tables.shape[1], bs, N, hd, ctypes.addressof(strides))
    if rc != 0:
        raise RuntimeError(f"kv_write_paged int8 kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    global PAGED_LAUNCHES, PAGED_I8_LAUNCHES
    with _LAUNCH_LOCK:
        PAGED_LAUNCHES += 1
        PAGED_I8_LAUNCHES += 1


def kv_write_paged(pool_k: torch.Tensor, pool_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   tables: torch.Tensor, start: torch.Tensor, valid: torch.Tensor,
                   scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   k_s: Optional[torch.Tensor] = None,
                   v_s: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k/v [B, KV, W, hd] into pools [N, KV, bs, hd] at per-row
    positions ``start[b] + i`` through ``tables`` [B, nblk] (block 0 where
    ``valid`` [B, W] is False), in place; returns the pools (the same
    tensors).  Int8 pools come with ``scales`` = (pool_ks, pool_vs), their
    f32 planes [N, KV, bs], and take bf16 rows (quantized in the launch)
    or int8 rows with their scales ``k_s``/``v_s`` [B, KV, W] (copied).
    ValueError for mismatched shapes, dtypes or devices; the values of the
    tables and positions are the device's to read.  A CUDA pool launches
    the kernel (the int8 variant for int8 pools) or raises; a CPU pool
    runs ``kv_write_paged_reference``."""
    _validate_paged(pool_k, pool_v, k, v, tables, start, valid, scales, k_s, v_s)
    if pool_k.device.type == "cpu":
        return kv_write_paged_reference(pool_k, pool_v, k, v, tables, start, valid, scales, k_s,
                                        v_s)
    if pool_k.device.type != "cuda":
        raise ValueError(f"kv_write_paged takes cpu or cuda tensors, got {pool_k.device}")
    if scales is not None:
        _launch_paged_i8(pool_k, pool_v, k, v, tables, start, valid, scales, k_s, v_s)
    else:
        _launch_paged(pool_k, pool_v, k, v, tables, start, valid)
    return pool_k, pool_v


def probe_kv_write_paged(n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                         device: torch.device, kv_dtype: Optional[torch.dtype] = None) -> None:
    """Build the library and write once through a table on a CUDA
    ``device``: into zero pools of 4 blocks of 2 rows, row 0 takes
    positions 1 and 2 through table [3, 1] (block 3 row 1, block 1 row 0);
    row 1's two positions are not valid and go to the scratch block 0.
    Blocks 1 and 3 must hold exactly the written k (ones) and v (twos) at
    those rows, block 2 zeros.  With ``kv_dtype`` int8 the pools are int8
    with their scale planes and the rows ``dtype`` values drawn from a
    seed: blocks 1-3 and their scales must equal the plain version's
    (``quantize_kv``) bit for bit.  Raises if the build or the launch fails
    or the write is wrong."""
    if kv_dtype == torch.int8:
        gen = torch.Generator().manual_seed(0)
        k = torch.randn(2, n_kv_heads, 2, head_dim, generator=gen).to(device, dtype)
        v = 3 * torch.randn(2, n_kv_heads, 2, head_dim, generator=gen).to(device, dtype)
        tables = torch.tensor([[3, 1], [2, 2]], dtype=torch.int32, device=device)
        start = torch.tensor([1, 0], dtype=torch.int32, device=device)
        valid = torch.tensor([[True, True], [False, False]], device=device)
        pools = [torch.zeros(4, n_kv_heads, 2, head_dim, dtype=torch.int8, device=device)
                 for _ in range(2)]
        planes = [torch.zeros(4, n_kv_heads, 2, device=device) for _ in range(2)]
        want = [t.clone() for t in pools + planes]
        kv_write_paged(*pools, k, v, tables, start, valid, tuple(planes))
        kv_write_paged_reference(*want[:2], k, v, tables, start, valid, tuple(want[2:]))
        if not all(bool(torch.equal(a[1:], b[1:])) for a, b in zip(pools + planes, want)):
            raise RuntimeError(f"kv_write_paged int8 probe at {n_kv_heads} kv heads, head dim "
                               f"{head_dim} wrote other codes or scales than the plain version")
        return
    pk = torch.zeros(4, n_kv_heads, 2, head_dim, dtype=dtype, device=device)
    pv = torch.zeros_like(pk)
    k = torch.ones(2, n_kv_heads, 2, head_dim, dtype=dtype, device=device)
    tables = torch.tensor([[3, 1], [2, 2]], dtype=torch.int32, device=device)
    start = torch.tensor([1, 0], dtype=torch.int32, device=device)
    valid = torch.tensor([[True, True], [False, False]], device=device)
    kv_write_paged(pk, pv, k, 2 * k, tables, start, valid)
    want = torch.zeros(4, 2, device=device)
    want[3, 1] = want[1, 0] = 1.0
    want = want[:, None, :, None].expand(4, n_kv_heads, 2, head_dim)
    if (not bool((pk[1:].float() == want[1:]).all().cpu())
            or not bool((pv[1:].float() == 2 * want[1:]).all().cpu())):
        raise RuntimeError(f"kv_write_paged probe at {n_kv_heads} kv heads, head dim {head_dim} "
                           f"wrote the wrong rows")


def paged_write_inputs(B: int, KV: int, W: int, hd: int, nblk: int, gen: torch.Generator,
                       device, *, dtype: torch.dtype = torch.bfloat16, bs: int = 16,
                       misalign: int = 0, int8: bool = False, copy: bool = False
                       ) -> SimpleNamespace:
    """Inputs of a paged write through which a kernel check sees a wrong
    kernel, drawn from the CPU generator ``gen`` and moved to ``device``.
    Pools of N = B * nblk + 1 blocks of ``bs`` rows (int8 ones with their
    scale planes where ``int8``; ``planes`` None otherwise) and tables that
    hold their blocks in a shuffled order; B rows of W fresh positions of
    KV kv heads of ``hd`` values: strided head views of a qkv row as the
    served step makes them (``dtype``), starting ``misalign`` elements past
    an aligned address, so that the copy's unit falls below 16 bytes; or,
    with ``copy``, int8 rows with their scales (``int8_kv_rows``).  Every
    start is a multiple of neither bs nor W, and every row's positions stay
    inside its table, but row 0's cross into table entry 1 (its only entry
    at W = 1), which is N + 1, outside the pool: those writes are dropped.
    Row 1 has every position invalid (at W = 1 the last two rows too); the
    others a random number of valid positions from the first.
    ``paged_write_expected`` is the plain version's answer."""
    N = B * nblk + 1
    if nblk * bs < W + bs + 1:
        raise ValueError(f"{nblk} blocks of {bs} rows do not hold W={W} positions and a start")
    planes = None
    if int8:
        (pk, pks), (pv, pvs) = (int8_kv_rows((N, KV, bs, hd), gen, device) for _ in range(2))
        planes = [pks, pvs]
    else:
        pk, pv = (torch.randn(N, KV, bs, hd, generator=gen).to(dtype).to(device)
                  for _ in range(2))
    tables = (torch.randperm(N - 1, generator=gen)[: B * nblk] + 1).reshape(B, nblk)
    tables[0, 1 if W > 1 else 0] = N + 1
    starts = []
    for x in torch.randint(1, nblk * bs - W + 1, (B,), generator=gen).tolist():
        while x % bs == 0 or (W > 1 and x % W == 0):
            x = x + 1 if x < nblk * bs - W else 1
        starts.append(x)
    starts[0] = bs - 2 if W > 1 else 1
    valid = torch.arange(W)[None, :] < torch.randint(1, W + 1, (B, 1), generator=gen)
    valid[0] = True
    if B > 1:
        valid[1] = False
    if W == 1:  # the decode round's write: its empty slots too
        valid[-2:] = False
    k_s = v_s = None
    if copy:
        (k, k_s), (v, v_s) = (int8_kv_rows((B, KV, W, hd), gen, device) for _ in range(2))
    else:
        qkv = torch.randn(B, W, 6 * KV * hd + 16, generator=gen).to(dtype).to(device)
        lo = 4 * KV * hd + misalign
        k = qkv[..., lo:lo + KV * hd].reshape(B, W, KV, hd).transpose(1, 2)
        v = qkv[..., lo + KV * hd:lo + 2 * KV * hd].reshape(B, W, KV, hd).transpose(1, 2)
    return SimpleNamespace(pools=[pk, pv], planes=planes, k=k, v=v, k_s=k_s, v_s=v_s,
                           tables=tables.to(torch.int32).to(device),
                           start=torch.tensor(starts, dtype=torch.int32).to(device),
                           valid=valid.to(device), N=N)


def paged_write_expected(x: SimpleNamespace) -> list:
    """The plain version's pools (then scale planes) for
    ``paged_write_inputs`` x, written into copies with two blocks past the
    pool's end, where the out-of-pool entry's writes land (the kernel drops
    them).  A kernel's pools are right when their blocks 1..N-1 equal
    these copies': block 0 takes several scratch writes, in no order."""
    def padded(t):
        return torch.cat([t, t.new_zeros((2,) + tuple(t.shape[1:]))])

    want = [padded(t) for t in x.pools + (x.planes or [])]
    kv_write_paged_reference(want[0], want[1], x.k, x.v, x.tables, x.start, x.valid,
                             tuple(want[2:]) if x.planes else None, x.k_s, x.v_s)
    return want
