"""Flash decode on Hopper — the attention of every cached decode step.

    o = softmax(q k^T / sqrt(hd)) v   over the valid cache positions

q ``[B, KV, G, hd]`` (the G query heads of a kv head folded onto rows, one
token each), k/v ``[B, KV, L, hd]`` at their stored (grouped) size, o
``[B, KV, G, hd]`` in q's dtype: the layout of the JAX package.

Replaces the Pallas TPU kernel of ``seldon_core_tpu/ops/flash_decode.py``
(``flash_decode`` :87, kernel ``_decode_kernel`` :47, ``pallas_call`` :125)
with a hand-written CUDA kernel for sm_90a (``ops/csrc/flash_decode.cu``)
that computes the same arithmetic: f32 scores times 1/sqrt(hd), an online
softmax, ``p`` cast to the cache dtype before an f32 PV product, ``acc /
max(l, 1e-30)`` cast to q's dtype.  Its probe ``flash_decode_supported``
(:136, which reaches the kernel through ``flash_decode`` at :148) has as
its counterpart ``probe_decode_kernel``, which raises where the JAX probe
answers False.

Two entry points share the kernel:

  ``flash_decode(q, k, v, n_valid)``   one cache, positions >= n_valid
                                        masked; keeps the JAX shape
                                        contract and messages (L % 128,
                                        hd <= 256);
  ``flash_decode_two_tier(q, main_k, main_v, n_main, chunk_k, chunk_v,
  n_chunk, k_new=None, v_new=None)``    the same function over
                                        main[:n_main] ++ chunk[:n_chunk]:
                                        what the decode lane's two-tier
                                        cache attends over
                                        (``models/generate.py``); with
                                        k_new/v_new [B, KV, 1, hd] the
                                        same launch first writes the
                                        step's K/V into the last of those
                                        positions (chunk slot n_chunk - 1,
                                        or main slot n_main - 1 when the
                                        chunk is empty) and attends with
                                        it: the decode step's write
                                        (``kv_write``) folded in.

The kernel reads only the valid positions of each segment and masks its
own ragged edge, so the two-tier function has no length rule: the served
100-token prompt and a 63-slot chunk buffer take the kernel.  The kernel
reads q/k/v by strides (unit stride along hd), so the sliced main cache
of ``generate`` reaches it without a copy.

The kernel splits each (batch, kv head)'s positions across the blocks of
one thread-block cluster; ``decode_split_plan`` picks the cluster size
and each block's share from the shapes and the total position count
alone, so the split never depends on where main ends.

A CUDA tensor launches the kernel or raises: what it cannot take (a dtype
other than bf16, a head dim that is not a multiple of 8 up to 256, no
valid position) is a ``ValueError`` from a static check before any launch;
the dtype and head-dim rules are the source's to state
(``flash_decode_smem_bytes``, asked through ``decode_kernel_shape_error``).
A CPU tensor runs the plain PyTorch versions, ``flash_decode_reference``
(the arithmetic of ``_attend_cached``, ``generate.py:369``) and
``flash_decode_two_tier_reference`` (``_attend_two_tier``,
``generate.py:230``), which the tests and ``chip_smoke.py`` hold the kernel
against and which the decode lane runs with ``use_flash`` off.
``LAUNCHES`` counts kernel launches and nothing else.

The continuous lane's block pool has a kernel of its own
(``ops/csrc/flash_decode_paged.cu``; the reference writes the step's K/V
with ``_paged_write``, ``generate.py:1057``, then gathers the pages and
attends in plain XLA, ``_attend_paged`` at W = 1, ``generate.py:1086``):

  ``flash_decode_paged(q, pool_k, pool_v, tables, lens, k_new=None,
  v_new=None, valid=None)``
        q [B, KV, G, hd] over row b's positions [0, lens[b]), position j
        at row j % bs of pool block tables[b, j // bs]; pools [N, KV, bs,
        hd], tables [B, nblk] and lens [B] int32 on the device.  With
        k_new/v_new [B, KV, 1, hd] the same launch first stores each
        valid row's fresh K/V at position lens[b] - 1 (the decode step's
        write) and attends with it; a row whose ``valid`` [B] is False
        writes nothing (the reference sends it to the scratch block 0).
        bfloat16 takes the tensor cores; float32 (an f32 model's pools,
        such as a speculative unit's f32 draft) takes a path of f32 FMAs
        on the CUDA cores, never TF32, in the same source: each warp walks
        tiles of 8 positions through its own TMA ring
        (``paged_f32_layout`` states its plan).

The kernel reads the table and the lengths itself: nothing is read back
on the host.  The host picks the cluster size from the table's width
(``decode_split_plan``) and each block takes its share of the row's own
length (``paged_shares``).  ``flash_decode_paged_reference`` is its plain
version (the write, then the gather ``paged_view`` and ``attend_paged``),
``PAGED_LAUNCHES`` its count (``PAGED_F32_LAUNCHES`` those on the
float32 path) and ``probe_paged_decode_kernel`` its probe.

The int8 K/V cache (``kv_quant="int8"``): both kernels have an int8-K/V
variant (``flash_decode_i8_launch`` in ``flash_decode.cu``,
``flash_decode_paged_i8_launch`` in ``flash_decode_paged.cu``) that takes
int8 caches with their f32 scale planes, ``scales=(k_s, v_s, ...)``:
[B, KV, L] for the two-tier segments (main's, then the chunk's), [N, KV,
bs] for the pools.  q, the fresh rows and o stay bf16; each launch
quantizes the step's fresh K/V with the reference's quantizer
(``kv_write.quantize_kv``, bit for bit) into the written slot and attends
with the codes and scales, as the reference writes and then reads them.
Their plain versions are the reference's arithmetic with scales
(``_grouped_qk``: scores times ``k_s``; ``_pv_f32`` / ``_grouped_pv``: p
times ``v_s`` before its cast).  A kernel's dtype code 2 names the int8
cache (``decode_kernel_shape_error(..., kv_dtype=torch.int8)``,
``paged_kernel_shape_error`` likewise); ``I8_LAUNCHES`` and
``PAGED_I8_LAUNCHES`` count the int8 variants' launches, which
``LAUNCHES`` and ``PAGED_LAUNCHES`` count too.  Both variants take one
tile walk (``ops/csrc/int8_walk.cuh``), whose plan this module states:
its shared memory (``i8_walk_layout``), its staged tile's swizzle
(``i8_stage_offset``), q's k order and V's n order (``i8_k_dims``,
``i8_v_dims``), and the clusters (``i8_split_plan`` for the two-tier
variant, ``i8_paged_cluster`` for the paged one).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library
from seldon_core_tpu_torch.ops.flash_attention import (_kernel_view, _same_device_and_dtype,
                                                       _tma_aligned)
from seldon_core_tpu_torch.ops.kv_write import (int8_kv_rows, kv_write_paged_reference,
                                               kv_write_reference)

__all__ = [
    "LAUNCHES",
    "I8_LAUNCHES",
    "PAGED_I8_LAUNCHES",
    "paged_scale_view",
    "i8_walk_layout",
    "i8_split_plan",
    "i8_paged_cluster",
    "i8_stage_offset",
    "i8_k_dims",
    "i8_v_dims",
    "flash_decode",
    "flash_decode_two_tier",
    "flash_decode_reference",
    "flash_decode_two_tier_reference",
    "decode_contract_error",
    "decode_kernel_shape_error",
    "decode_split_plan",
    "probe_decode_kernel",
    "PAGED_LAUNCHES",
    "PAGED_F32_LAUNCHES",
    "flash_decode_paged",
    "flash_decode_paged_reference",
    "paged_cluster",
    "paged_f32_layout",
    "paged_kernel_shape_error",
    "paged_shares",
    "paged_view",
    "attend_paged",
    "probe_paged_decode_kernel",
]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
#: the paged variant's launches, counted the same way
PAGED_LAUNCHES = 0
#: those of them that took its float32 path
PAGED_F32_LAUNCHES = 0
#: the int8-K/V variants' launches (counted in LAUNCHES / PAGED_LAUNCHES too)
I8_LAUNCHES = 0
PAGED_I8_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

_BLOCK = 128       # the JAX contract of flash_decode: L divisible by 128
_NEG_INF = -1e30
_MAX_GT = 8        # query rows per block of the kernel (MAX_GT in flash_decode.cu)
_SPLITS = (1, 2, 4, 8)   # cluster sizes: the portable ones
_MIN_SPAN = 64     # the fewest positions a block of a split cluster reads
_PAGED_GT = 16     # query rows per block of the paged kernel (one m16 tile)
_TILE = 16         # positions a warp's tile, the bf16 and int8 paged walks (TILE in the .cu)
# the paged kernel's 8-warp blocks fill an SM each, and a cluster's combine
# costs more than the split gains until the grid is short of ~one per SM
_PAGED_BLOCKS_PER_SM = 0.9
_BLOCKS_PER_SM = 1.5     # what the split aims the grid at (see decode_split_plan)
# the paged kernel's float32 walk (flash_decode_paged.cu: F32_TILE,
# F32_BOX_COLS, F32_RING_BUDGET, F32_MAX_DEPTH, MAX_SPLIT): positions a
# warp's tile (a TMA box's rows), f32 columns a box, the ring's aim in bytes
# a block, the deepest ring, and the most blocks a cluster
_F32_TILE = 8
_F32_BOX_COLS = 32
_F32_RING_BUDGET = 64 * 1024
_F32_MAX_DEPTH = 4
_MAX_SPLIT = 8
_I8 = 2  # the sources' dtype code of an int8 cache (bf16 q and o)
# the int8 walk (ops/csrc/int8_walk.cuh: RING_BUDGET, MAX_DEPTH): a block's
# aim in bytes of stages, and the deepest ring a warp
_I8_RING_BUDGET = 64 * 1024
_I8_MAX_DEPTH = 4
# the int8 walk's long rows (both variants' cluster rule): blocks of 8
# warps resident on an SM at once, and the fewest positions a block keeps
# when a row is split further for them
_I8_RESIDENT = 2
_I8_LONG = 2048


def _shapes_error(q, k, v) -> Optional[str]:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        return f"bad shapes: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
    B, KV, _, hd = q.shape
    if k.shape[0] != B or k.shape[1] != KV or k.shape[3] != hd:
        return f"q/k mismatch: q{tuple(q.shape)} k{tuple(k.shape)}"
    return None


def decode_contract_error(q, k, v) -> Optional[str]:
    """Why q/k/v break the JAX package's ``flash_decode`` contract
    (``flash_decode.py:96-105``), with its messages, or None.  Static:
    ``decode_step`` asks it to pick the plain path."""
    why = _shapes_error(q, k, v)
    if why is not None:
        return why
    if k.shape[2] % _BLOCK != 0:
        return f"cache len {k.shape[2]} not divisible by {_BLOCK}"
    if q.shape[3] > 256:
        return f"head dim {q.shape[3]} > 256"
    return None


def _scores(q, k):
    """q [B,KV,G,hd] x k [B,KV,L,hd] -> [B,KV,G,L] f32 scores: f32 products
    of the upcast inputs (JAX's ``preferred_element_type=f32``), scaled."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / (q.shape[-1] ** 0.5))


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_valid: int, k_s: Optional[torch.Tensor] = None,
                           v_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version, on any device, with ``_attend_cached``'s
    arithmetic: positions >= n_valid set to -1e30, a softmax over the whole
    row, p cast to q's dtype before an f32 PV product, o in q's dtype.  An
    int8 cache's scales [B, KV, L] multiply the scores (``k_s``) and p
    before its cast (``v_s``)."""
    s = _scores(q, k)
    if k_s is not None:
        s = s * k_s[:, :, None, :]
    valid = torch.arange(k.shape[2], device=q.device) < n_valid
    p = torch.softmax(s.masked_fill(~valid, _NEG_INF), dim=-1)
    if v_s is not None:
        p = p * v_s[:, :, None, :]
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def _pv_dtype(v: torch.Tensor) -> torch.dtype:
    """The PV product's input dtype of ``_pv_f32``: bf16 for bf16 and int8
    caches, else the cache's own."""
    return torch.bfloat16 if v.dtype in (torch.int8, torch.bfloat16) else v.dtype


def flash_decode_two_tier_reference(q: torch.Tensor, main_k: torch.Tensor, main_v: torch.Tensor,
                                    n_main: int, chunk_k: torch.Tensor, chunk_v: torch.Tensor,
                                    n_chunk: int, k_new: Optional[torch.Tensor] = None,
                                    v_new: Optional[torch.Tensor] = None,
                                    scales: Optional[Tuple[torch.Tensor, ...]] = None
                                    ) -> torch.Tensor:
    """The plain PyTorch version of the two-tier attention, on any device,
    with ``_attend_two_tier``'s arithmetic: one softmax over the
    concatenated scores, masks added (0 / -1e30) to a segment only where
    its n is short of its length (JAX's ``main_full``), the partial PV
    products of p cast to the cache dtype summed in f32 and normalised
    after them.  A segment of 0 slots drops out: ``_attend_cached`` passes
    an empty chunk.  With ``k_new``/``v_new``, first ``kv_write_reference``
    into the slot of position n_main + n_chunk - 1 (chunk slot n_chunk - 1,
    or main slot n_main - 1 when n_chunk is 0), in place.  Int8 caches come
    with ``scales`` = (main k_s, main v_s, chunk k_s, chunk v_s), each [B,
    KV, L] f32: the write quantizes (``quantize_kv``), the scores are
    multiplied by k_s, and p by v_s before its cast to bf16 (``_pv_f32``)."""
    ms, cs = (None, None) if scales is None else (tuple(scales[:2]), tuple(scales[2:]))
    if k_new is not None:
        if n_chunk > 0:
            kv_write_reference(chunk_k, chunk_v, k_new, v_new, n_chunk - 1, cs)
        else:
            kv_write_reference(main_k, main_v, k_new, v_new, n_main - 1, ms)
    segments = [(k, v, n, sc) for k, v, n, sc in ((main_k, main_v, n_main, ms),
                                                   (chunk_k, chunk_v, n_chunk, cs))
                if k.shape[2] > 0]
    scores = []
    for k, _, n, sc in segments:
        s = _scores(q, k)
        if sc is not None:
            s = s * sc[0][:, :, None, :]
        if n < k.shape[2]:
            s = s + torch.where(torch.arange(k.shape[2], device=q.device) < n, 0.0, _NEG_INF)
        scores.append(s)
    m = scores[0].amax(dim=-1)
    for s in scores[1:]:
        m = torch.maximum(m, s.amax(dim=-1))
    es = [torch.exp(s - m[..., None]) for s in scores]
    # reduce, not sum(): sum's 0 + tensor would be one more launch each
    l = functools.reduce(torch.add, (e.sum(dim=-1) for e in es))
    o = functools.reduce(torch.add, (
        torch.matmul((e if sc is None else e * sc[1][:, :, None, :]).to(_pv_dtype(v)).float(),
                     v.float())
        for e, (_, v, _, sc) in zip(es, segments)))
    return (o / l[..., None]).to(q.dtype)


@functools.lru_cache(maxsize=4096)
def decode_split_plan(B: int, KV: int, G: int, n_total: int, sm_count: int,
                      row_tile: int = _MAX_GT,
                      blocks_per_sm: float = _BLOCKS_PER_SM) -> Tuple[int, int]:
    """(C, span): how the kernel splits the ``n_total`` positions of each
    (b, kv head, row tile) across the C blocks of one cluster.  C is the
    smallest of 1, 2, 4, 8 whose grid holds at least 1.5 blocks per SM (at B=32, KV=4, G=4: C=2, 256 blocks,
    which the kernel's two resident blocks per SM take in one wave), as
    long as every block keeps at least 64 positions: below that a block's
    fixed cost (q, the combine) outweighs its share of the reads.  Block r
    takes positions [r*span, min((r+1)*span, n_total)) by their global
    index over both segments, so neither C nor the boundaries depend on
    where main ends.  ``row_tile`` is the most query rows a block takes
    and ``blocks_per_sm`` the grid's aim (the paged kernel's are 16 and
    0.9).  Cached: the decode lane asks it 12 times a step."""
    if n_total < 1:
        raise ValueError("the flash-decode kernel needs at least one valid cache position")
    gt = 1
    while gt < G and gt < row_tile:
        gt *= 2
    groups = B * KV * -(-G // gt)
    split = 1
    for c in _SPLITS[1:]:
        if groups * split >= blocks_per_sm * sm_count or -(-n_total // c) < _MIN_SPAN:
            break
        split = c
    return split, -(-n_total // split)


def _i8_long(split: int, B: int, KV: int, G: int, n: int, sm_count: int) -> int:
    """The int8 walk's cluster for long rows: ``split`` doubled while two
    blocks an SM (``_I8_RESIDENT``) hold the grid and each block still
    walks at least ``_I8_LONG`` of n positions: a block's warps wait on
    their copies, and a second block an SM keeps twice the copies in
    flight."""
    groups = B * KV * -(-G // _PAGED_GT)
    while (split < _MAX_SPLIT and groups * split * 2 <= _I8_RESIDENT * sm_count
           and -(-n // (2 * split)) >= _I8_LONG):
        split *= 2
    return split


@functools.lru_cache(maxsize=4096)
def i8_split_plan(B: int, KV: int, G: int, n_total: int, sm_count: int) -> Tuple[int, int]:
    """(C, span) of the two-tier kernel's int8 variant: ``decode_split_plan``
    at the int8 walk's row tile (16) and grid aim (the paged kernel's 0.9:
    its blocks have the paged walk's 8 warps), doubled for long rows
    (``_i8_long``: B=32 at 4,160 positions takes C = 2, 256 blocks), with a
    span that is a multiple of the tile (16), so a row's bits depend on
    n_total and C only."""
    split, _ = decode_split_plan(B, KV, G, n_total, sm_count, _PAGED_GT, _PAGED_BLOCKS_PER_SM)
    split = _i8_long(split, B, KV, G, n_total, sm_count)
    return split, -(-n_total // (split * _TILE)) * _TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_bind_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None


def _library() -> SimpleNamespace:
    """The kernel library's entry points, built and bound at first use."""
    global _lib
    with _bind_lock:
        if _lib is None:
            lib = load_library("flash_decode")
            launch = lib.flash_decode_launch
            launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                               + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p, ctypes.c_void_p])
            launch.restype = ctypes.c_int
            launch_i8 = lib.flash_decode_i8_launch
            launch_i8.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                                  + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p] * 3)
            launch_i8.restype = ctypes.c_int
            smem = lib.flash_decode_smem_bytes
            smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int]
            smem.restype = ctypes.c_int
            err = lib.flash_decode_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, launch_i8=launch_i8, smem_bytes=smem,
                                   error_string=err)
        return _lib


def _dtype_code(dtype: torch.dtype, kv_dtype: Optional[torch.dtype], float32: bool) -> int:
    """The kernel sources' code for q's dtype and the cache's: 0 bf16, 1
    float32 (the paged kernel only: ``float32``), 2 an int8 cache with bf16
    q; -1 for anything else."""
    if kv_dtype == torch.int8:
        return _I8 if dtype == torch.bfloat16 else -1
    if kv_dtype is not None and kv_dtype != dtype:
        return -1
    return {torch.bfloat16: 0, **({torch.float32: 1} if float32 else {})}.get(dtype, -1)


@functools.lru_cache(maxsize=None)
def _smem_bytes(head_dim: int, group: int, dtype: torch.dtype,
                kv_dtype: Optional[torch.dtype] = None):
    """(dynamic shared memory the kernel asks for, None), or (-1, why not),
    from ``flash_decode_smem_bytes`` in the source: asked once per head
    dim, group and dtypes (q's; the cache's when it differs: int8), not at
    every launch."""
    why = ctypes.create_string_buffer(256)
    n = _library().smem_bytes(int(head_dim), int(group), _dtype_code(dtype, kv_dtype, False),
                              ctypes.addressof(why), len(why))
    return n, (why.value.decode() if n < 0 else None)


def decode_kernel_shape_error(head_dim: int, dtype: torch.dtype, group: int = 1,
                              kv_dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Why the kernel cannot take this head dim, dtype and group (query
    heads per kv head), or None; ``kv_dtype`` int8 asks the int8-K/V
    variant (q in ``dtype``).  Asks the kernel source (nvcc needed);
    ``resolve_flash`` calls it at a generator's construction."""
    return _smem_bytes(head_dim, group, dtype, kv_dtype)[1]


def _launch(q, k0, v0, n0: int, k1, v1, n1: int, k_new=None, v_new=None,
            scales=None) -> torch.Tensor:
    B, KV, G, hd = q.shape
    int8 = scales is not None
    if int8:
        _same_device_and_dtype(k0, v=v0, chunk_k=k1, chunk_v=v1)
        _same_device_and_dtype(q, **({} if k_new is None else {"k_new": k_new, "v_new": v_new}))
        if k0.device != q.device:
            raise ValueError(f"main_k is on {k0.device}, q on {q.device}")
    else:
        _same_device_and_dtype(q, k=k0, v=v0, chunk_k=k1, chunk_v=v1)
    why = decode_kernel_shape_error(hd, q.dtype, G, k0.dtype if int8 else None)
    if why is not None:
        raise ValueError(why)
    if n0 + n1 < 1:
        raise ValueError("the flash-decode kernel needs at least one valid cache position")
    if k_new is not None:
        written = (("chunk_k", k1), ("chunk_v", v1)) if n1 > 0 else (("main_k", k0), ("main_v", v0))
        for name, t in written:
            if not _tma_aligned(t):  # written in place: no copy will do
                raise ValueError(f"{name} takes the fused write in place, so it needs unit "
                                 f"stride along hd and 16-byte aligned rows, got {t.stride()}")
        if int8:
            for name, t in zip(("k_s", "v_s"), scales[2:] if n1 > 0 else scales[:2]):
                if t.stride(2) != 1:
                    raise ValueError(f"the written segment's {name} takes the fused write in "
                                     f"place, so it needs unit stride along the positions")
        k_new, v_new = (_kernel_view(t) for t in (k_new, v_new))
    q = q if q.stride(3) == 1 else q.contiguous()
    k0, v0, k1, v1 = (_kernel_view(t) for t in (k0, v0, k1, v1))
    o = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    if B == 0 or KV == 0 or G == 0:
        return o
    fresh = (0,) * 4 if k_new is None else (*k_new.stride()[:2], *v_new.stride()[:2])
    strides = (ctypes.c_longlong * 19)(*q.stride()[:3], *k0.stride()[:3], *v0.stride()[:3],
                                       *k1.stride()[:3], *v1.stride()[:3], *fresh)
    lib = _library()
    index = torch.cuda.current_device() if q.device.index is None else q.device.index
    plan = i8_split_plan if int8 else decode_split_plan
    split, span = plan(B, KV, G, int(n0) + int(n1), _sm_count(index))
    fresh_ptrs = (None if k_new is None else k_new.data_ptr(),
                  None if v_new is None else v_new.data_ptr())
    if int8:
        sc = [t if t.stride(2) == 1 else t.contiguous() for t in scales]
        for t in sc:
            if t.device != q.device or t.dtype != torch.float32:
                raise ValueError(f"int8 cache scales must be float32 on {q.device}, got "
                                 f"{t.dtype} on {t.device}")
        scale_strides = (ctypes.c_longlong * 8)(*(st for t in sc for st in t.stride()[:2]))
        rc = launch_on(q.device, lib.launch_i8, q.data_ptr(), k0.data_ptr(), v0.data_ptr(),
                       sc[0].data_ptr(), sc[1].data_ptr(), int(n0), k1.data_ptr(),
                       v1.data_ptr(), sc[2].data_ptr(), sc[3].data_ptr(), int(n1),
                       *fresh_ptrs, o.data_ptr(), B, KV, G, hd, split, span,
                       ctypes.addressof(strides), ctypes.addressof(scale_strides))
    else:
        rc = launch_on(q.device, lib.launch, q.data_ptr(), k0.data_ptr(), v0.data_ptr(), int(n0),
                       k1.data_ptr(), v1.data_ptr(), int(n1), *fresh_ptrs, o.data_ptr(), B, KV,
                       G, hd, split, span, ctypes.addressof(strides))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    global LAUNCHES, I8_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
        if int8:
            I8_LAUNCHES += 1
    return o


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_decode takes cpu or cuda tensors, got {q.device}")
    return q.device.type


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int) -> torch.Tensor:
    """q [B, KV, G, hd] x cache k/v [B, KV, L, hd] -> [B, KV, G, hd]; cache
    positions >= ``n_valid`` are masked.  Constraints (ValueError, the JAX
    messages): L divisible by 128, hd <= 256; on CUDA also what the kernel
    takes.  A CUDA q launches the kernel (over the first ``n_valid``
    positions) or raises; a CPU q runs ``flash_decode_reference``."""
    why = decode_contract_error(q, k, v)
    if why is not None:
        raise ValueError(why)
    if _device_kind(q) == "cpu":
        return flash_decode_reference(q, k, v, n_valid)
    n = min(max(int(n_valid), 0), k.shape[2])
    return _launch(q, k, v, n, k, v, 0)


def _fresh_error(q, main_k, n_main: int, n_chunk: int, k_new, v_new) -> Optional[str]:
    if (k_new is None) != (v_new is None):
        return "k_new and v_new go together"
    if k_new is None:
        return None
    B, KV, _, hd = q.shape
    want = q.dtype if main_k.dtype == torch.int8 else main_k.dtype  # int8: quantized in
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, KV, 1, hd) or t.dtype != want:
            return (f"{name} must be {want} {(B, KV, 1, hd)}, got {t.dtype} "
                    f"{tuple(t.shape)}")
        if t.device != q.device:
            return f"{name} is on {t.device}, q on {q.device}"
    if int(n_main) + int(n_chunk) < 1:
        return "the fused write needs a position: n_main + n_chunk >= 1"
    return None


def _scales_error(q, main_k, chunk_k, scales) -> Optional[str]:
    """Why ``scales`` do not fit the caches: int8 caches take (main k_s,
    main v_s, chunk k_s, chunk v_s), f32 [B, KV, L] each; float caches
    none."""
    int8 = main_k.dtype == torch.int8
    if int8 != (scales is not None):
        return (f"int8 caches take their scales (main k_s, main v_s, chunk k_s, chunk v_s), "
                f"and only int8 caches do; got {main_k.dtype} caches and "
                f"{'no' if scales is None else len(scales)} scales")
    if scales is None:
        return None
    if chunk_k.dtype != torch.int8 or len(scales) != 4:
        return "an int8 main cache takes an int8 chunk and four scale planes"
    B, KV = q.shape[:2]
    for name, t, L in zip(("main k_s", "main v_s", "chunk k_s", "chunk v_s"), scales,
                          (main_k.shape[2],) * 2 + (chunk_k.shape[2],) * 2):
        if tuple(t.shape) != (B, KV, L) or t.dtype != torch.float32 or t.device != q.device:
            return (f"{name} must be float32 {(B, KV, L)} on {q.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return None


def flash_decode_two_tier(q: torch.Tensor, main_k: torch.Tensor, main_v: torch.Tensor,
                          n_main: int, chunk_k: torch.Tensor, chunk_v: torch.Tensor,
                          n_chunk: int, k_new: Optional[torch.Tensor] = None,
                          v_new: Optional[torch.Tensor] = None,
                          scales: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """q [B, KV, G, hd] over main[:n_main] ++ chunk[:n_chunk] (each [B, KV,
    *, hd]) -> [B, KV, G, hd]: ``flash_decode``'s function over the two
    segments, with no length rule.  With ``k_new``/``v_new`` [B, KV, 1, hd]
    (in the caches' dtype; strided views will do) the decode step's write is
    fused in: the step's K/V go into the slot of position n_main + n_chunk
    - 1 (chunk slot n_chunk - 1, or main slot n_main - 1 when n_chunk is
    0), in place, and the attention takes them.  Int8 caches come with
    ``scales`` (main k_s, main v_s, chunk k_s, chunk v_s; f32 [B, KV, L])
    and bf16 fresh rows, quantized into the slot.  A CUDA q launches the
    kernel (one launch, write included; the int8-K/V variant for int8
    caches) or raises; a CPU q runs ``flash_decode_two_tier_reference``."""
    for kk, vv, n, what in ((main_k, main_v, n_main, "n_main"),
                            (chunk_k, chunk_v, n_chunk, "n_chunk")):
        why = _shapes_error(q, kk, vv)
        if why is not None:
            raise ValueError(why)
        if not 0 <= int(n) <= kk.shape[2]:
            raise ValueError(f"{what}={n} outside [0, {kk.shape[2]}]")
    why = (_fresh_error(q, main_k, n_main, n_chunk, k_new, v_new)
           or _scales_error(q, main_k, chunk_k, scales))
    if why is not None:
        raise ValueError(why)
    if _device_kind(q) == "cpu":
        return flash_decode_two_tier_reference(q, main_k, main_v, n_main, chunk_k, chunk_v,
                                               n_chunk, k_new, v_new, scales)
    return _launch(q, main_k, main_v, int(n_main), chunk_k, chunk_v, int(n_chunk), k_new,
                   v_new, scales)


def _probe_int8_two_tier(n_kv_heads: int, group: int, head_dim: int, dtype: torch.dtype,
                         device: torch.device) -> None:
    """The int8-K/V variant's probe: quantized random rows
    (``int8_kv_rows``), q and fresh rows (from a seed), both segments and
    the fused write as every decode step calls it, against the plain
    version on copies: o within 0.05 (a few bf16 ulps of |o| < 4; a wrong
    scale or position moves it by O(1)) and the written codes and scales
    bit for bit."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, n_kv_heads, group, head_dim, generator=gen).to(device, dtype)
    mk, mks = int8_kv_rows((1, n_kv_heads, 3, head_dim), gen, device)
    mv, mvs = int8_kv_rows((1, n_kv_heads, 3, head_dim), gen, device)
    ck, cks = int8_kv_rows((1, n_kv_heads, 3, head_dim), gen, device)
    cv, cvs = int8_kv_rows((1, n_kv_heads, 3, head_dim), gen, device)
    k_new = (4 * torch.randn(1, n_kv_heads, 1, head_dim, generator=gen)).to(device, dtype)
    v_new = torch.randn(1, n_kv_heads, 1, head_dim, generator=gen).to(device, dtype)
    ref = [t.clone() for t in (ck, cv, cks, cvs)]
    o = flash_decode_two_tier(q, mk, mv, 3, ck, cv, 2, k_new, v_new, (mks, mvs, cks, cvs))
    o_ref = flash_decode_two_tier_reference(q, mk, mv, 3, ref[0], ref[1], 2, k_new, v_new,
                                            (mks, mvs, ref[2], ref[3]))
    err = float((o.float() - o_ref.float()).abs().max().cpu())
    if err > 0.05 or not all(bool(torch.equal(a, b)) for a, b in zip((ck, cv, cks, cvs), ref)):
        raise RuntimeError(
            f"flash_decode int8 probe at {n_kv_heads} kv heads x {group}, head dim {head_dim}: "
            f"max |o - plain| {err:.3g}, or the fresh row's codes or scales differ")


def probe_decode_kernel(n_kv_heads: int, group: int, head_dim: int, dtype: torch.dtype,
                        device: torch.device, kv_dtype: Optional[torch.dtype] = None) -> None:
    """Build the library and launch the kernel once at the head shape
    (``n_kv_heads``, ``group`` query heads each, ``head_dim``) on a CUDA
    ``device``, over both segments and with the write fused in, as every
    decode step calls it: zero queries and keys give a uniform softmax over
    values 1, 2, 3 in main, 4 in chunk slot 0 and the fresh row's 5 bound
    for chunk slot 1, where the chunk holds a stale key of 7 and value of
    100 (slot 2, 100, is past n_chunk): the answer is exactly 3, and
    chunk slot 1 must hold the fresh key and value afterwards.  Raises if
    the build or the launch fails or the answer differs.  The counterpart
    of ``flash_decode_supported``, except that it raises where that one
    answers False.  ``kv_dtype`` int8 probes the int8-K/V variant
    (``_probe_int8_two_tier``)."""
    if kv_dtype == torch.int8:
        return _probe_int8_two_tier(n_kv_heads, group, head_dim, dtype, device)
    q = torch.zeros(1, n_kv_heads, group, head_dim, dtype=dtype, device=device)
    main_k = torch.zeros(1, n_kv_heads, 3, head_dim, dtype=dtype, device=device)
    rows = torch.tensor([1.0, 2.0, 3.0], device=device)
    main_v = rows[None, None, :, None].expand_as(main_k).to(dtype).contiguous()
    chunk_k = torch.zeros(1, n_kv_heads, 3, head_dim, dtype=dtype, device=device)
    chunk_k[:, :, 1] = 7.0
    chunk_v = torch.tensor([4.0, 100.0, 100.0], device=device)[None, None, :, None].expand_as(
        chunk_k).to(dtype).contiguous()
    k_new = torch.zeros(1, n_kv_heads, 1, head_dim, dtype=dtype, device=device)
    o = flash_decode_two_tier(q, main_k, main_v, 3, chunk_k, chunk_v, 2, k_new, k_new + 5.0)
    if (not bool((o.float() == 3.0).all().cpu()) or not bool((chunk_k[:, :, 1] == 0).all().cpu())
            or not bool((chunk_v[:, :, 1].float() == 5.0).all().cpu())):
        raise RuntimeError(
            f"flash_decode probe at {n_kv_heads} kv heads x {group}, head dim {head_dim} "
            f"answered {o.float().flatten()[:4].tolist()}..., not 3, or did not write the "
            f"fresh row")


def paged_view(pool_k: torch.Tensor, pool_v: torch.Tensor, tables: torch.Tensor):
    """Gather one layer's blocks into dense position-ordered views: pools
    [N, KV, bs, hd] + tables [B, nblk] -> (k, v), each [B, KV, nblk*bs, hd]
    (``_paged_view``, ``generate.py:1039``, for the port's pool layout)."""
    B, nblk = tables.shape
    _, KV, bs, hd = pool_k.shape
    idx = tables.long()
    return tuple(pool[idx].permute(0, 2, 1, 3, 4).reshape(B, KV, nblk * bs, hd)
                 for pool in (pool_k, pool_v))


def paged_scale_view(plane: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """An int8 pool's scale plane [N, KV, bs] gathered like ``paged_view``:
    [B, KV, nblk*bs], the reference's view of its [N, bs, KV] plane."""
    B, nblk = tables.shape
    _, KV, bs = plane.shape
    return plane[tables.long()].permute(0, 2, 1, 3).reshape(B, KV, nblk * bs)


def attend_paged(q: torch.Tensor, view_k: torch.Tensor, view_v: torch.Tensor,
                 start: torch.Tensor, view_ks: Optional[torch.Tensor] = None,
                 view_vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, W, hd] over dense paged views [B, KV, L, hd]: query i of row
    b sees positions <= start[b] + i (``_attend_paged``, ``generate.py:1086``,
    with ``_grouped_qk`` / ``_grouped_pv``'s arithmetic): f32 scores of the
    inputs times 1/sqrt(hd), masked to -1e30, a softmax, p cast to q's
    dtype before an f32 PV product, o in q's dtype.  An int8 view's scale
    views [B, KV, L] multiply the scores (``view_ks``) and p before its
    cast (``view_vs``)."""
    B, H, W, hd = q.shape
    KV, L = view_k.shape[1], view_k.shape[2]
    g = H // KV
    s = torch.matmul(q.reshape(B, KV, g * W, hd).float(), view_k.float().transpose(-1, -2))
    s = (s * (1.0 / (hd ** 0.5))).reshape(B, KV, g, W, L)
    if view_ks is not None:
        s = s * view_ks[:, :, None, None, :]
    qpos = start.long()[:, None] + torch.arange(W, device=q.device)  # [B, W]
    allowed = torch.arange(L, device=q.device)[None, None, :] <= qpos[:, :, None]  # [B, W, L]
    s = s.masked_fill(~allowed[:, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if view_vs is not None:
        p = p * view_vs[:, :, None, None, :]
    out = torch.matmul(p.to(q.dtype).reshape(B, KV, g * W, L).float(), view_v.float())
    return out.to(q.dtype).reshape(B, H, W, hd)


def paged_shares(n: int, C: int, bs: int):
    """Each of the C blocks' share [p0, p1) of a row's n positions, in
    pool blocks of bs rows: k ranks take the ceil(n / bs) blocks, q or q
    + 1 each (the extra ones last, with the partial block), where k is
    the largest count <= C that leaves every share at least ``_MIN_SPAN``
    positions; ranks >= k are empty, [n, n).  ``share_of`` in
    ``ops/csrc/flash_decode_paged.cu`` is the same rule: the paged kernel's
    blocks compute it from the row's own length on the device, so the
    table's width never enters."""
    nb = -(-n // bs)
    k = C
    while k > 1:
        q, rem = divmod(nb, k)
        if q * bs >= _MIN_SPAN and n - (nb - q - (rem > 0)) * bs >= _MIN_SPAN:
            break
        k -= 1
    q, rem = divmod(nb, k)
    shares = []
    for r in range(C):
        if r >= k:
            shares.append((n, n))
            continue
        start = r * q + max(0, r - (k - rem))
        end = start + q + (r >= k - rem)
        shares.append((min(n, start * bs), min(n, end * bs)))
    return shares


def paged_cluster(B: int, KV: int, G: int, width: int, sm_count: int) -> int:
    """C, the blocks of the paged kernel's cluster for each (row, kv head,
    row tile), from the shapes and the table's width (``width`` = nblk *
    bs) alone: ``decode_split_plan`` at the paged kernel's row tile and
    grid aim."""
    return decode_split_plan(B, KV, G, width, sm_count, _PAGED_GT, _PAGED_BLOCKS_PER_SM)[0]


def i8_paged_cluster(B: int, KV: int, G: int, width: int, sm_count: int) -> int:
    """C of the paged kernel's int8 variant: ``paged_cluster``, doubled for
    long rows by the two-tier variant's rule (``_i8_long``) on the table's
    width (the host's bound on every row's length)."""
    return _i8_long(paged_cluster(B, KV, G, width, sm_count), B, KV, G, width, sm_count)


def paged_f32_layout(head_dim: int, group: int) -> dict:
    """The float32 walk's plan at this head dim and group (query heads per
    kv head), ``layout_f32`` in ``ops/csrc/flash_decode_paged.cu`` step by
    step (the card holds the two to each other): ``rows`` query rows a
    block (the group rounded up to 1, 2, 4 or 8), ``warps`` a block (8 up
    to hd 128, else 4), ``tile`` positions a warp takes at a time,
    ``depth`` stages of each warp's TMA ring (as many as the ring's aim
    holds, 2 to 4), ``stage`` bytes a stage (a tile's K and V in boxes of
    32 columns) and ``bytes`` of dynamic shared memory.  Warp w walks tiles
    w, w + warps, ... of its block's share, so a share of ``_MIN_SPAN``
    positions gives each of 8 warps a tile."""
    cols = next(c for c in (1, 2, 4, 8) if head_dim <= _F32_BOX_COLS * c)
    rows = next(r for r in (1, 2, 4, 8) if group <= r or r == 8)
    warps = 8 if head_dim <= 128 else 4
    stage = 2 * cols * _F32_TILE * 128
    depth = min(max(_F32_RING_BUDGET // (warps * stage), 2), _F32_MAX_DEPTH)
    ring = warps * depth * stage
    # after the walk, in the ring's space: m and l [warps][rows], acc
    # [warps][rows][hd], the weights [MAX_SPLIT + 2][rows] and rank 0's
    # gather [MAX_SPLIT][rows * (hd + 2)], f32
    end = 4 * (2 * warps * rows + warps * rows * head_dim + (_MAX_SPLIT + 2) * rows
               + _MAX_SPLIT * rows * (head_dim + 2))
    q = -(-max(ring, end) // 16) * 16
    bars = -(-(q + rows * _F32_BOX_COLS * cols * 4) // 8) * 8
    return {"rows": rows, "warps": warps, "tile": _F32_TILE, "depth": depth, "stage": stage,
            "bytes": bars + 8 * warps * depth + 1024}


def i8_walk_layout(head_dim: int, group: int) -> dict:
    """The int8 walk's plan at this head dim and group, both kernels' int8
    variants (``layout`` in ``ops/csrc/int8_walk.cuh`` step by step; the card
    holds the two to each other): ``rows`` query rows a block (8, or 16
    past 8), ``warps`` (8 up to hd 128, else 4), ``cols`` bytes a staged
    row (64, 128 or 256), a ``stage`` of a tile's K and V codes (``_TILE``
    rows of ``cols`` each) and its k_s and v_s (16 f32 each), ``depth``
    stages a warp (as many as 64 KB a block holds, 2 to 4), and the
    float32 walk's scratch after it; ``bytes`` of dynamic shared memory."""
    rows = 16 if group > 8 else 8
    warps = 8 if head_dim <= 128 else 4
    cols = 64 if head_dim <= 64 else (128 if head_dim <= 128 else 256)
    stage = 2 * _TILE * cols + 2 * _TILE * 4
    depth = min(max(_I8_RING_BUDGET // (warps * stage), 2), _I8_MAX_DEPTH)
    ring = warps * depth * stage
    end = 4 * (2 * warps * rows + warps * rows * head_dim + (_MAX_SPLIT + 2) * rows
               + _MAX_SPLIT * rows * (head_dim + 2))
    bars = -(-max(ring, end) // 8) * 8
    return {"rows": rows, "warps": warps, "cols": cols, "tile": _TILE, "depth": depth,
            "stage": stage, "bytes": bars + 8 * warps * depth + 128}


def i8_stage_offset(cols: int, r: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of row r in a staged int8 tile of
    ``_TILE`` rows of ``cols`` bytes (``chunk_off`` in int8_walk.cuh): at 64
    columns chunk (4 (r & 1) + c) ^ (2 ((r >> 1) & 3)) of the 128-byte line r
    >> 1; at 128, c ^ (r & 7) of row r; at 256, c ^ (r & 7) ^ (2 (c >> 3))."""
    if cols == 64:
        return (r >> 1) * 128 + 16 * ((((r & 1) << 2) | c) ^ (((r >> 1) & 3) << 1))
    if cols == 128:
        return r * 128 + 16 * (c ^ (r & 7))
    return r * 256 + 16 * (c ^ ((r & 7) ^ ((c >> 3) << 1)))


def i8_k_dims(cols: int) -> np.ndarray:
    """q's k order in the int8 walk: [4, cols / 16, 4] -> the dim that k
    slot (2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9) of k-step ks holds for
    lane tig of a quad.  Lane tig's K codes of a position are the cols / 4
    neighbouring dims from cols / 4 tig; step ks's four codes are bytes 4
    ks .. 4 ks + 3 of that run, bytes 0 and 2 the low B register's pair,
    1 and 3 the high one's."""
    tig, ks = np.meshgrid(np.arange(4), np.arange(cols // 16), indexing="ij")
    base = (cols // 4) * tig + 4 * ks
    return np.stack([base, base + 2, base + 1, base + 3], axis=-1)


def i8_v_dims(cols: int) -> np.ndarray:
    """V's n order in the int8 walk: [8, cols / 8] -> the dim that column
    gid of PV n-tile j holds: cols / 8 * gid + j, so a lane's codes of a
    position for all its n-tiles are cols / 8 neighbouring bytes; the store
    writes acc[j][e] (columns 2 tig + e) back to dim cols / 8 (2 tig + e) +
    j."""
    nt = cols // 8
    return nt * np.arange(8)[:, None] + np.arange(nt)[None, :]


def flash_decode_paged_reference(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                                 tables: torch.Tensor, lens: torch.Tensor,
                                 k_new: Optional[torch.Tensor] = None,
                                 v_new: Optional[torch.Tensor] = None,
                                 valid: Optional[torch.Tensor] = None,
                                 scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                                 ) -> torch.Tensor:
    """The plain version, on any device.  With ``k_new``/``v_new``, first
    ``kv_write_paged_reference`` at position lens[b] - 1 of the rows that
    write (valid, with a length in [1, nblk * bs]; the others write
    nothing), in place.  Then ``paged_view`` and ``attend_paged`` at W = 1
    with start = lens - 1, q [B, KV, G, hd] -> o [B, KV, G, hd] in q's
    dtype.  Int8 pools come with ``scales`` (their planes [N, KV, bs]):
    the write quantizes, and the attention takes the scale views."""
    B, KV, G, hd = q.shape
    if k_new is not None:
        writes = (lens >= 1) & (lens <= tables.shape[1] * pool_k.shape[2])
        idx = torch.nonzero(writes if valid is None else writes & valid)[:, 0]
        kv_write_paged_reference(pool_k, pool_v, k_new[idx], v_new[idx], tables[idx],
                                 lens[idx] - 1,
                                 torch.ones(idx.numel(), 1, dtype=torch.bool, device=q.device),
                                 scales)
    k, v = paged_view(pool_k, pool_v, tables)
    ks = vs = None
    if scales is not None:
        ks, vs = (paged_scale_view(t, tables) for t in scales)
    o = attend_paged(q.reshape(B, KV * G, 1, hd), k, v, lens - 1, ks, vs)
    return o.reshape(B, KV, G, hd)


def _paged_error(q, pool_k, pool_v, tables, lens, k_new, v_new, valid,
                 scales=None) -> Optional[str]:
    if q.ndim != 4 or pool_k.ndim != 4 or pool_k.shape != pool_v.shape:
        return (f"bad shapes: q{tuple(q.shape)} pool_k{tuple(pool_k.shape)} "
                f"pool_v{tuple(pool_v.shape)}")
    B, KV, _, hd = q.shape
    if pool_k.shape[1] != KV or pool_k.shape[3] != hd:
        return f"q/pool mismatch: q{tuple(q.shape)} pool{tuple(pool_k.shape)}"
    if tables.ndim != 2 or tables.shape[0] != B or tables.shape[1] < 1 \
            or tables.dtype != torch.int32:
        return f"tables must be int32 [{B}, nblk >= 1], got {tables.dtype} {tuple(tables.shape)}"
    if tuple(lens.shape) != (B,) or lens.dtype != torch.int32:
        return f"lens must be int32 [{B}], got {lens.dtype} {tuple(lens.shape)}"
    if (k_new is None) != (v_new is None) or (k_new is None and valid is not None):
        return "k_new and v_new go together, and valid goes with them"
    int8 = pool_k.dtype == torch.int8
    if int8 != (scales is not None):
        return "int8 pools take their scale planes (scales=(pool_ks, pool_vs)), and only they do"
    if int8:
        N, _, bs, _ = pool_k.shape
        for name, t in zip(("pool_ks", "pool_vs"), scales):
            if tuple(t.shape) != (N, KV, bs) or t.dtype != torch.float32:
                return (f"{name} must be float32 {(N, KV, bs)}, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if k_new is not None:
        want = q.dtype if int8 else pool_k.dtype  # int8: quantized in
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if tuple(t.shape) != (B, KV, 1, hd) or t.dtype != want:
                return (f"{name} must be {want} {(B, KV, 1, hd)}, got {t.dtype} "
                        f"{tuple(t.shape)}")
        if valid is not None and (tuple(valid.shape) != (B,) or valid.dtype != torch.bool):
            return f"valid must be bool [{B}], got {valid.dtype} {tuple(valid.shape)}"
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v), ("tables", tables), ("lens", lens),
                    ("k_new", k_new), ("v_new", v_new), ("valid", valid),
                    *zip(("pool_ks", "pool_vs"), scales or ())):
        if t is not None and t.device != q.device:
            return f"{name} is on {t.device}, q on {q.device}"
    return None


_paged_bind_lock = threading.Lock()
_paged_lib: Optional[SimpleNamespace] = None


def _paged_library() -> SimpleNamespace:
    """The paged kernel library's entry points, built and bound at first
    use."""
    global _paged_lib
    with _paged_bind_lock:
        if _paged_lib is None:
            lib = load_library("flash_decode_paged")
            launch = lib.flash_decode_paged_launch
            launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                               + [ctypes.c_void_p, ctypes.c_void_p])
            launch.restype = ctypes.c_int
            launch_i8 = lib.flash_decode_paged_i8_launch
            launch_i8.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p, ctypes.c_void_p])
            launch_i8.restype = ctypes.c_int
            smem = lib.flash_decode_paged_smem_bytes
            smem.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
            smem.restype = ctypes.c_int
            err = lib.flash_decode_paged_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _paged_lib = SimpleNamespace(launch=launch, launch_i8=launch_i8, smem_bytes=smem,
                                         error_string=err)
        return _paged_lib


@functools.lru_cache(maxsize=None)
def _paged_smem_bytes(head_dim: int, group: int, block_size: int, dtype: torch.dtype,
                      kv_dtype: Optional[torch.dtype] = None):
    """(dynamic shared memory the paged kernel asks for, None), or (-1, why
    not), from ``flash_decode_paged_smem_bytes`` in its source; code 2 (an
    int8 pool with bf16 q) where ``kv_dtype`` is int8."""
    why = ctypes.create_string_buffer(256)
    n = _paged_library().smem_bytes(int(head_dim), int(group), int(block_size),
                                    _dtype_code(dtype, kv_dtype, True),
                                    ctypes.addressof(why), len(why))
    return n, (why.value.decode() if n < 0 else None)


def paged_kernel_shape_error(head_dim: int, dtype: torch.dtype, group: int = 1,
                             block_size: int = 16,
                             kv_dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Why the paged kernel cannot take this head dim, dtype, group and
    pool block size, or None; ``kv_dtype`` int8 asks the int8-K/V variant
    (q in ``dtype``).  Asks the kernel source (nvcc needed)."""
    return _paged_smem_bytes(head_dim, group, block_size, dtype, kv_dtype)[1]


def _launch_paged(q, pool_k, pool_v, tables, lens, k_new, v_new, valid,
                  scales=None) -> torch.Tensor:
    B, KV, G, hd = q.shape
    N, _, bs, _ = pool_k.shape
    int8 = scales is not None
    if int8:
        _same_device_and_dtype(pool_k, pool_v=pool_v)
    else:
        _same_device_and_dtype(q, pool_k=pool_k, pool_v=pool_v)
    why = paged_kernel_shape_error(hd, q.dtype, G, bs, pool_k.dtype if int8 else None)
    if why is not None:
        raise ValueError(why)
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if not _tma_aligned(t):  # read by TMA or 16-byte loads, written in place: no copy
            raise ValueError(f"{name} needs unit stride along hd, a 16-byte aligned base and "
                             f"strides that are multiples of 16 bytes, got {t.stride()}")
        if int8 and t.stride(2) != hd:  # a tile's rows are one bulk copy
            raise ValueError(f"int8 {name} needs contiguous rows (a row stride of {hd}), got "
                             f"{t.stride()}")
    for name, t in zip(("pool_ks", "pool_vs"), scales or ()):
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:  # read by bulk copies, written in place
            raise ValueError(f"{name} must be contiguous with a 16-byte aligned base")
    q = q if q.stride(3) == 1 else q.contiguous()
    tables, lens = tables.contiguous(), lens.contiguous()
    if k_new is not None:
        k_new, v_new = (_kernel_view(t) for t in (k_new, v_new))
        valid = None if valid is None else valid.contiguous()
    o = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    if B == 0 or KV == 0 or G == 0:
        return o
    fresh = (0, 0) if k_new is None else (*k_new.stride()[:2], *v_new.stride()[:2])
    strides = (ctypes.c_longlong * 13)(*q.stride()[:3], *pool_k.stride()[:3],
                                       *pool_v.stride()[:3], *fresh)
    lib = _paged_library()
    index = torch.cuda.current_device() if q.device.index is None else q.device.index
    split = (i8_paged_cluster if int8 else paged_cluster)(B, KV, G, tables.shape[1] * bs,
                                                          _sm_count(index))
    fresh_ptrs = (None if k_new is None else k_new.data_ptr(),
                  None if v_new is None else v_new.data_ptr(),
                  None if valid is None else valid.data_ptr())
    if int8:
        rc = launch_on(q.device, lib.launch_i8, q.data_ptr(), pool_k.data_ptr(),
                       pool_v.data_ptr(), scales[0].data_ptr(), scales[1].data_ptr(),
                       tables.data_ptr(), lens.data_ptr(), *fresh_ptrs, o.data_ptr(), N,
                       tables.shape[1], bs, B, KV, G, hd, split, ctypes.addressof(strides))
    else:
        rc = launch_on(q.device, lib.launch, q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                       tables.data_ptr(), lens.data_ptr(), *fresh_ptrs, o.data_ptr(), N,
                       tables.shape[1], bs, B, KV, G, hd, split,
                       _dtype_code(q.dtype, None, True), ctypes.addressof(strides))
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    global PAGED_LAUNCHES, PAGED_F32_LAUNCHES, PAGED_I8_LAUNCHES
    with _LAUNCH_LOCK:
        PAGED_LAUNCHES += 1
        if int8:
            PAGED_I8_LAUNCHES += 1
        elif q.dtype == torch.float32:
            PAGED_F32_LAUNCHES += 1
    return o


def flash_decode_paged(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                       tables: torch.Tensor, lens: torch.Tensor,
                       k_new: Optional[torch.Tensor] = None, v_new: Optional[torch.Tensor] = None,
                       valid: Optional[torch.Tensor] = None,
                       scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """q [B, KV, G, hd] over each row's positions [0, lens[b]) of the paged
    pools [N, KV, bs, hd] through ``tables`` [B, nblk] -> o [B, KV, G,
    hd].  ``tables`` and ``lens`` are int32 on q's device and are read by
    the device only (a length is clamped to [0, nblk*bs], a block id to
    the pool).  With ``k_new``/``v_new`` [B, KV, 1, hd] (and ``valid`` [B]
    bool, default all True) the decode step's write is fused in: each
    valid row with a length in [1, nblk*bs] first stores its fresh K/V at
    position lens[b] - 1 of the pools, in place; the other rows write
    nothing.  Int8 pools come with ``scales`` (their f32 planes [N, KV,
    bs]) and bf16 fresh rows, quantized into the pools.  A CUDA q launches
    the kernel (one launch, write included; the int8-K/V variant for int8
    pools) or raises; a CPU q runs ``flash_decode_paged_reference``."""
    why = _paged_error(q, pool_k, pool_v, tables, lens, k_new, v_new, valid, scales)
    if why is not None:
        raise ValueError(why)
    if _device_kind(q) == "cpu":
        return flash_decode_paged_reference(q, pool_k, pool_v, tables, lens, k_new, v_new, valid,
                                            scales)
    return _launch_paged(q, pool_k, pool_v, tables, lens, k_new, v_new, valid, scales)


def _probe_int8_paged(n_kv_heads: int, group: int, head_dim: int, dtype: torch.dtype,
                      device: torch.device, block_size: int) -> None:
    """The int8-K/V variant's probe: quantized random rows
    (``int8_kv_rows``), q and fresh rows (from a seed) in a pool of 4
    blocks, row 0 over block_size + 1 positions through table [3, 1, 2]
    with the fused write, against the plain version on copies: o within
    0.05 and the pools and planes bit for bit outside the scratch block
    0."""
    gen = torch.Generator().manual_seed(0)
    shape = (4, n_kv_heads, block_size, head_dim)
    pk, pks = int8_kv_rows(shape, gen, device)
    pv, pvs = int8_kv_rows(shape, gen, device)
    q = torch.randn(1, n_kv_heads, group, head_dim, generator=gen).to(device, dtype)
    k_new = (4 * torch.randn(1, n_kv_heads, 1, head_dim, generator=gen)).to(device, dtype)
    v_new = torch.randn(1, n_kv_heads, 1, head_dim, generator=gen).to(device, dtype)
    tables = torch.tensor([[3, 1, 2]], dtype=torch.int32, device=device)
    lens = torch.tensor([block_size + 1], dtype=torch.int32, device=device)
    ref = [t.clone() for t in (pk, pv, pks, pvs)]
    o = flash_decode_paged(q, pk, pv, tables, lens, k_new, v_new, None, (pks, pvs))
    o_ref = flash_decode_paged_reference(q, ref[0], ref[1], tables, lens, k_new, v_new, None,
                                         (ref[2], ref[3]))
    err = float((o.float() - o_ref.float()).abs().max().cpu())
    if err > 0.05 or not all(bool(torch.equal(a[1:], b[1:]))
                             for a, b in zip((pk, pv, pks, pvs), ref)):
        raise RuntimeError(
            f"flash_decode_paged int8 probe at {n_kv_heads} kv heads x {group}, head dim "
            f"{head_dim}, blocks of {block_size}: max |o - plain| {err:.3g}, or the fresh "
            f"row's codes or scales differ")


def probe_paged_decode_kernel(n_kv_heads: int, group: int, head_dim: int, dtype: torch.dtype,
                              device: torch.device, block_size: int = 16,
                              kv_dtype: Optional[torch.dtype] = None) -> None:
    """Build the library and launch the paged kernel once at the head shape
    and pool block size on a CUDA ``device``, with the fused write: zero
    queries and keys give a uniform softmax over row 0's block_size + 1
    positions, the first block_size in pool block 3 (values 2 and 4 in
    turn), the last the fresh row (value 3) bound for block 1, row 0,
    where the pool holds a stale key of 7 and value of 100 (so do blocks
    0 and 2, past the row's length): the answer is exactly 3, and block 1
    row 0 must hold the fresh key and value afterwards.  Raises if the
    build or the launch fails or the answer differs.  The paged
    counterpart of ``probe_decode_kernel``; ``kv_dtype`` int8 probes the
    int8-K/V variant (``_probe_int8_paged``)."""
    if kv_dtype == torch.int8:
        return _probe_int8_paged(n_kv_heads, group, head_dim, dtype, device, block_size)
    shape = (4, n_kv_heads, block_size, head_dim)
    pool_k = torch.zeros(shape, dtype=dtype, device=device)
    pool_k[1, :, 0] = 7.0
    vals = torch.full((4, block_size), 100.0, device=device)
    vals[3] = torch.tensor([2.0, 4.0], device=device).repeat(block_size // 2 + 1)[:block_size]
    pool_v = vals[:, None, :, None].expand(shape).to(dtype).contiguous()
    q = torch.zeros(1, n_kv_heads, group, head_dim, dtype=dtype, device=device)
    k_new = torch.zeros(1, n_kv_heads, 1, head_dim, dtype=dtype, device=device)
    tables = torch.tensor([[3, 1, 2]], dtype=torch.int32, device=device)
    lens = torch.tensor([block_size + 1], dtype=torch.int32, device=device)
    o = flash_decode_paged(q, pool_k, pool_v, tables, lens, k_new, k_new + 3.0)
    if (not bool((o.float() == 3.0).all().cpu()) or not bool((pool_k[1, :, 0] == 0).all().cpu())
            or not bool((pool_v[1, :, 0].float() == 3.0).all().cpu())):
        raise RuntimeError(
            f"flash_decode_paged probe at {n_kv_heads} kv heads x {group}, head dim {head_dim}, "
            f"blocks of {block_size} answered {o.float().flatten()[:4].tolist()}..., not 3, or "
            f"did not write the fresh row")
