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
``probe_kv_write_paged`` its probe.
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library

__all__ = ["LAUNCHES", "PAGED_LAUNCHES", "kv_write", "kv_write_reference", "probe_kv_write",
           "kv_write_paged", "kv_write_paged_reference", "probe_kv_write_paged"]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
#: the paged kernel's launches, counted the same way
PAGED_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


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
                       v: torch.Tensor, pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, on any device: slice assignment in place.
    Returns the caches."""
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
            err = lib.kv_write_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, paged=paged, error_string=err)
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


def _validate_paged(pool_k, pool_v, k, v, tables, start, valid) -> None:
    if pool_k.ndim != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"pools must be [N, KV, bs, hd] of one shape, got "
                         f"{tuple(pool_k.shape)} {tuple(pool_v.shape)}")
    _, KV, _, hd = pool_k.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[1] != KV or k.shape[3] != hd:
        raise ValueError(f"k/v must be [B, {KV}, W, {hd}], got {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, _, W, _ = k.shape
    for name, t in (("pool_v", pool_v), ("k", k), ("v", v)):
        if t.device != pool_k.device or t.dtype != pool_k.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, pool_k {pool_k.dtype} on "
                             f"{pool_k.device}")
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
                             valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, on any device: ``_paged_write``'s scatter for
    float pools (``index_put_``, in place).  Position ``start[b] + i`` of
    row b goes to block ``tables[b, clip(pos // bs, 0, nblk - 1)]`` (0
    where ``valid`` is False), row ``pos % bs``.  Returns the pools."""
    bs, nblk, W = pool_k.shape[2], tables.shape[1], k.shape[2]
    pos = start.long()[:, None] + torch.arange(W, device=k.device)  # [B, W]
    idx = torch.clamp(torch.div(pos, bs, rounding_mode="floor"), 0, nblk - 1)
    blk = torch.where(valid, torch.gather(tables.long(), 1, idx), 0)
    off = torch.remainder(pos, bs)
    pool_k[blk, :, off] = k.transpose(1, 2)  # [B, W, KV, hd] at (blk, :, off)
    pool_v[blk, :, off] = v.transpose(1, 2)
    return pool_k, pool_v


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


def kv_write_paged(pool_k: torch.Tensor, pool_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   tables: torch.Tensor, start: torch.Tensor,
                   valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k/v [B, KV, W, hd] into pools [N, KV, bs, hd] at per-row
    positions ``start[b] + i`` through ``tables`` [B, nblk] (block 0 where
    ``valid`` [B, W] is False), in place; returns the pools (the same
    tensors).  ValueError for mismatched shapes, dtypes or devices; the
    values of the tables and positions are the device's to read.  A CUDA
    pool launches the kernel or raises; a CPU pool runs
    ``kv_write_paged_reference``."""
    _validate_paged(pool_k, pool_v, k, v, tables, start, valid)
    if pool_k.device.type == "cpu":
        return kv_write_paged_reference(pool_k, pool_v, k, v, tables, start, valid)
    if pool_k.device.type != "cuda":
        raise ValueError(f"kv_write_paged takes cpu or cuda tensors, got {pool_k.device}")
    _launch_paged(pool_k, pool_v, k, v, tables, start, valid)
    return pool_k, pool_v


def probe_kv_write_paged(n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                         device: torch.device) -> None:
    """Build the library and write once through a table on a CUDA
    ``device``: into zero pools of 4 blocks of 2 rows, row 0 takes
    positions 1 and 2 through table [3, 1] (block 3 row 1, block 1 row 0);
    row 1's two positions are not valid and go to the scratch block 0.
    Blocks 1 and 3 must hold exactly the written k (ones) and v (twos) at
    those rows, block 2 zeros.  Raises if the build or the launch fails or
    the write is wrong."""
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
