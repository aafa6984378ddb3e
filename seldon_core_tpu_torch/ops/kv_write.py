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
library and writes once, so a generator finds a missing compiler or a
failing build at construction.
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library

__all__ = ["LAUNCHES", "kv_write", "kv_write_reference", "probe_kv_write"]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
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
            err = lib.kv_write_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, error_string=err)
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
