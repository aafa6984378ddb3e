"""KV-block streaming: the prefill-to-decode hand-off's wire format — the
port's copy of ``seldon_core_tpu/runtime/kvstream.py``, byte for byte.

A prefill replica that finished a sequence's prefill holds what a decode
replica needs: the sequence's KV blocks and its sampling state (pending
token, emitted tokens, PRNG key).  These frames carry them over the relay
lane (``runtime/udsrelay.py`` ``OP_KVSTREAM``)::

    payload := sub_op(u8) | handoff_id(16s) | body

    KV_BEGIN   header struct + prompt/emitted/key tensors + tier utf8
               -> the decode replica reserves the blocks (typed 503 when
                  its pool cannot hold them)
    KV_BLOCKS  first_block(u32) n(u32) | per layer, per tensor:
               len(u32) | raw bytes  (k, v [, k_s, v_s]: int8 pools ship
               their scale planes; shapes [n, bs, KV, hd], scales
               [n, bs, KV])  -> staged on the host, not yet in the pool
    KV_COMMIT  empty -> the staged blocks go into the pool, the sequence
               joins the decode loop, and the answer is its finished
               tokens: n(u32) | int32 raw
    KV_ABORT   empty -> the reservation is reclaimed (a torn hand-off)
    KV_STATS   empty -> free(u32) total(u32) waiting(u32) inflight(u32),
               the free-block score the prefill side's p2c reads

Dtype codes: float32 0, bfloat16 1, float16 2, int8 3.  bf16 travels by
its bit pattern: on the host a bf16 tensor is a ``uint16`` array of the
same bits (``ml_dtypes`` is never imported), so a frame from either
package decodes in the other into the same bits.

The port's pools are laid out ``[num_blocks, KV, block_size, hd]``
(scales ``[num_blocks, KV, block_size]``), where the reference's are
``[num_blocks, block_size, KV, hd]``: ``export_blocks`` transposes to the
wire's layout on the way out and ``scatter_staged`` back on the way in,
so the bytes on the wire are the reference's.  The hand-off is chunked
(``SELDON_TPU_KV_CHUNK_BLOCKS`` blocks a KV_BLOCKS frame, default 4).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "KV_BEGIN", "KV_BLOCKS", "KV_COMMIT", "KV_ABORT", "KV_STATS",
    "KV_WIRE_VERSION", "KvBeginMeta", "KvExport", "KvWireError",
    "export_blocks", "begin_frame", "block_frames", "commit_frame",
    "abort_frame", "stats_frame", "parse_frame", "parse_begin",
    "parse_blocks", "pack_stats", "unpack_stats", "pack_tokens",
    "unpack_tokens", "chunk_blocks_default", "scatter_staged",
    "validate_against_pool", "dtype_name", "host_dtype",
]

KV_BEGIN = 1
KV_BLOCKS = 2
KV_COMMIT = 3
KV_ABORT = 4
KV_STATS = 5

KV_WIRE_VERSION = 1

_SUB_HEAD = struct.Struct("!B16s")
#: version, n_layers, block_size, kv_heads, head_dim, dtype_code,
#: n_blocks, n_valid, pending, max_new, prompt_len, prefix_len,
#: emitted_len, key_words
_BEGIN_HEAD = struct.Struct("!BHHHHBIIiIIIHH")
_BLOCKS_HEAD = struct.Struct("!II")
_TENSOR_HEAD = struct.Struct("!I")
_STATS_BODY = struct.Struct("!IIII")
_TOKENS_HEAD = struct.Struct("!I")

#: dtype wire codes; int8 pools also carry k_s/v_s f32 planes
_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_TORCH_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


class KvWireError(ValueError):
    """A malformed or incompatible KV-stream frame: a typed 4xx/5xx on the
    relay, never a crash."""


def host_dtype(name: str) -> np.dtype:
    """The host array dtype of a pool dtype name: bf16 as its bits."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


def chunk_blocks_default() -> int:
    try:
        return max(1, int(os.environ.get("SELDON_TPU_KV_CHUNK_BLOCKS", "") or 4))
    except ValueError:
        return 4


@dataclass
class KvBeginMeta:
    """What a decode replica needs to reserve and admit, off a KV_BEGIN
    frame."""

    n_layers: int
    block_size: int
    kv_heads: int
    head_dim: int
    dtype: str          # pool dtype name ("float32"|"bfloat16"|"int8"...)
    n_blocks: int       # private blocks streamed (prefix blocks excluded)
    n_valid: int        # cache positions already written (global)
    pending: int        # sampled, not yet cached
    max_new: int        # the whole generation budget, emitted tokens included
    prefix_len: int     # the shared prefix the receiver must match
    prompt: np.ndarray  # int32 prompt (the suffix with a prefix)
    emitted: List[int]  # tokens already emitted (the prefill's first)
    key_data: Optional[np.ndarray]  # the sequence's PRNG key words
    tier: str = "interactive"


@dataclass
class KvExport:
    """A finished prefill read back to the host: per-layer block arrays in
    the wire's layout, and the sequence's sampling state.  ``trace_ctx``
    is the hand-off span's context (its traceparent rides the relay's
    metadata sidecar, not this format); ``tenant`` rides the sidecar too."""

    meta: KvBeginMeta
    layers: List[Dict[str, np.ndarray]] = field(default_factory=list)
    trace_ctx: Any = None
    parent_span_id: str = ""
    tenant: str = ""
    puid: str = ""


def _layer_names(dtype: str) -> List[str]:
    return ["k", "v", "k_s", "v_s"] if dtype == "int8" else ["k", "v"]


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def export_blocks(pool, blocks: List[int], kv_heads: int,
                  n_heads: int) -> List[Dict[str, np.ndarray]]:
    """``blocks`` of every layer of a port pool, read back to host arrays
    in the wire's layout: ``[n, bs, KV, hd]``, scales ``[n, bs, KV]``.  A
    ``ShardedTree`` pool (a generator over a mesh) answers the same arrays
    at the whole pool's ``kv_heads``: each kv head read once, from the
    first shard that holds it along ``tp`` (every other coordinate 0;
    ``models/transformer.py`` ``kv_heads_held`` at the model's
    ``n_heads``), the heads concatenated in order; no whole pool is built
    on a device."""
    from seldon_core_tpu_torch.models.transformer import kv_heads_held
    from seldon_core_tpu_torch.parallel.mesh import ShardedTree, lead_shards

    if not isinstance(pool, ShardedTree):
        return _export_layers(pool, blocks, 0, pool["l0"]["k"].shape[1])
    reads, nxt = [], 0
    for i in lead_shards(pool.mesh, ("tp",)):
        lo, hi = kv_heads_held(kv_heads, pool.mesh, i, n_heads)
        if hi > nxt:  # heads not read yet: nxt..hi-1, all on this shard
            reads.append((i, nxt - lo, hi - lo))
            nxt = hi
    parts = [_export_layers(pool.shards[i], blocks, a, b) for i, a, b in reads]
    return [{name: np.concatenate([p[li][name] for p in parts], axis=2)
             for name in parts[0][li]} for li in range(len(parts[0]))]


def _export_layers(pool, blocks: List[int], a: int, b: int) -> List[Dict[str, np.ndarray]]:
    """One device's pool: ``blocks`` of its local kv heads [a, b), in the
    wire's layout."""
    idx = torch.as_tensor(blocks, dtype=torch.long, device=pool["l0"]["k"].device)
    return [{name: _to_host(t[idx].narrow(1, a, b - a).transpose(1, 2))
             for name, t in pool[f"l{li}"].items()} for li in range(len(pool))]


def scatter_staged(pool, local_blocks: List[int], staged: List[Dict[str, np.ndarray]],
                   n_heads: int):
    """Write a fully staged import (wire layout, the whole pool's kv heads)
    into the pool's blocks ``local_blocks``, in place.  A ``ShardedTree``
    pool takes each kv head into every shard that holds it
    (``kv_heads_held``, with the model's ``n_heads``), int8 scale planes
    too.  Runs on the scheduler thread only: the pool has one owner."""
    from seldon_core_tpu_torch.models.transformer import kv_heads_held
    from seldon_core_tpu_torch.parallel.mesh import ShardedTree

    kv = staged[0]["k"].shape[2]
    if not isinstance(pool, ShardedTree):
        _scatter_layers(pool, local_blocks, staged, 0, kv)
        return pool
    for i in pool.mesh.owned:
        _scatter_layers(pool.shards[i], local_blocks, staged,
                        *kv_heads_held(kv, pool.mesh, i, n_heads))
    return pool


def _scatter_layers(pool, local_blocks: List[int], staged, lo: int, hi: int) -> None:
    """One device's pool: kv heads [lo, hi) of the staged arrays into its
    blocks ``local_blocks``."""
    idx = torch.as_tensor(local_blocks, dtype=torch.long, device=pool["l0"]["k"].device)
    for li, layer in enumerate(staged):
        dst = pool[f"l{li}"]
        for name, arr in layer.items():
            t = _from_host(arr[:, :, lo:hi], dst[name].dtype).to(dst[name].device)
            dst[name][idx] = t.transpose(1, 2)


# -- frame building (the sender) ------------------------------------------

def begin_frame(export: KvExport, hid: bytes) -> bytes:
    m = export.meta
    code = _DTYPE_CODES.get(m.dtype)
    if code is None:
        raise KvWireError(f"unsupported pool dtype {m.dtype!r}")
    emitted = np.asarray(m.emitted, np.int32)
    key = (np.asarray(m.key_data, np.uint32).reshape(-1)
           if m.key_data is not None else np.zeros((0,), np.uint32))
    prompt = np.asarray(m.prompt, np.int32).reshape(-1)
    head = _BEGIN_HEAD.pack(
        KV_WIRE_VERSION, m.n_layers, m.block_size, m.kv_heads, m.head_dim, code,
        m.n_blocks, m.n_valid, m.pending, m.max_new, len(prompt), m.prefix_len,
        len(emitted), len(key))
    return (_SUB_HEAD.pack(KV_BEGIN, hid) + head + prompt.tobytes() + emitted.tobytes()
            + key.tobytes() + m.tier.encode("utf-8", "replace"))


def block_frames(export: KvExport, hid: bytes, chunk_blocks: Optional[int] = None):
    """KV_BLOCKS frames, ``chunk_blocks`` blocks a frame."""
    C = chunk_blocks or chunk_blocks_default()
    names = _layer_names(export.meta.dtype)
    n = export.meta.n_blocks
    for first in range(0, n, C):
        hi = min(first + C, n)
        parts = [_SUB_HEAD.pack(KV_BLOCKS, hid), _BLOCKS_HEAD.pack(first, hi - first)]
        for layer in export.layers:
            for name in names:
                raw = np.ascontiguousarray(layer[name][first:hi]).tobytes()
                parts.append(_TENSOR_HEAD.pack(len(raw)))
                parts.append(raw)
        yield b"".join(parts)


def commit_frame(hid: bytes) -> bytes:
    return _SUB_HEAD.pack(KV_COMMIT, hid)


def abort_frame(hid: bytes) -> bytes:
    return _SUB_HEAD.pack(KV_ABORT, hid)


def stats_frame() -> bytes:
    return _SUB_HEAD.pack(KV_STATS, b"\0" * 16)


def pack_stats(free: int, total: int, waiting: int, inflight: int) -> bytes:
    return _STATS_BODY.pack(max(0, free), max(0, total), max(0, waiting), max(0, inflight))


def unpack_stats(body: bytes) -> Dict[str, int]:
    if len(body) < _STATS_BODY.size:
        raise KvWireError("short KV_STATS response")
    free, total, waiting, inflight = _STATS_BODY.unpack_from(body, 0)
    return {"free": free, "total": total, "waiting": waiting, "inflight": inflight}


def pack_tokens(tokens: np.ndarray) -> bytes:
    t = np.asarray(tokens, np.int32).reshape(-1)
    return _TOKENS_HEAD.pack(t.size) + t.tobytes()


def unpack_tokens(body: bytes) -> np.ndarray:
    if len(body) < _TOKENS_HEAD.size:
        raise KvWireError("short KV_COMMIT token response")
    (n,) = _TOKENS_HEAD.unpack_from(body, 0)
    raw = memoryview(body)[_TOKENS_HEAD.size:_TOKENS_HEAD.size + 4 * n]
    if len(raw) != 4 * n:
        raise KvWireError("truncated KV_COMMIT token response")
    return np.frombuffer(raw, np.int32).copy()


# -- frame parsing (the receiver) -------------------------------------------

def parse_frame(payload: bytes) -> "tuple[int, bytes, memoryview]":
    """``(sub_op, handoff_id, body_view)`` of an OP_KVSTREAM payload."""
    if len(payload) < _SUB_HEAD.size:
        raise KvWireError("short KV-stream frame")
    sub_op, hid = _SUB_HEAD.unpack_from(payload, 0)
    return sub_op, hid, memoryview(payload)[_SUB_HEAD.size:]


def parse_begin(body: memoryview) -> KvBeginMeta:
    if len(body) < _BEGIN_HEAD.size:
        raise KvWireError("short KV_BEGIN header")
    (version, n_layers, block_size, kv_heads, head_dim, code, n_blocks, n_valid, pending,
     max_new, prompt_len, prefix_len, emitted_len, key_words) = _BEGIN_HEAD.unpack_from(body, 0)
    if version != KV_WIRE_VERSION:
        raise KvWireError(f"KV wire version {version} not supported")
    dtype = _CODE_DTYPES.get(code)
    if dtype is None:
        raise KvWireError(f"unknown pool dtype code {code}")
    off = _BEGIN_HEAD.size
    if len(body) < off + 4 * (prompt_len + emitted_len + key_words):
        raise KvWireError("truncated KV_BEGIN tensors")
    prompt = np.frombuffer(body[off:off + 4 * prompt_len], np.int32).copy()
    off += 4 * prompt_len
    emitted = np.frombuffer(body[off:off + 4 * emitted_len], np.int32)
    off += 4 * emitted_len
    key = None
    if key_words:
        key = np.frombuffer(body[off:off + 4 * key_words], np.uint32).copy()
        off += 4 * key_words
    tier = bytes(body[off:]).decode("utf-8", "replace") or "interactive"
    return KvBeginMeta(
        n_layers=n_layers, block_size=block_size, kv_heads=kv_heads, head_dim=head_dim,
        dtype=dtype, n_blocks=n_blocks, n_valid=n_valid, pending=pending, max_new=max_new,
        prefix_len=prefix_len, prompt=prompt, emitted=[int(t) for t in emitted],
        key_data=key, tier=tier)


def parse_blocks(body: memoryview, meta: KvBeginMeta) -> "tuple[int, List[Dict[str, np.ndarray]]]":
    """``(first block, per-layer arrays)`` of a KV_BLOCKS body, one
    ``np.frombuffer`` a tensor (the caller copies it into its staging)."""
    if len(body) < _BLOCKS_HEAD.size:
        raise KvWireError("short KV_BLOCKS header")
    first, n = _BLOCKS_HEAD.unpack_from(body, 0)
    off = _BLOCKS_HEAD.size
    dt = np.dtype(np.int8) if meta.dtype == "int8" else host_dtype(meta.dtype)
    kv_shape = (n, meta.block_size, meta.kv_heads, meta.head_dim)
    shapes = {"k": kv_shape, "v": kv_shape, "k_s": kv_shape[:3], "v_s": kv_shape[:3]}
    dtypes = {"k": dt, "v": dt, "k_s": np.dtype(np.float32), "v_s": np.dtype(np.float32)}
    layers: List[Dict[str, np.ndarray]] = []
    for _ in range(meta.n_layers):
        layer = {}
        for name in _layer_names(meta.dtype):
            if len(body) < off + _TENSOR_HEAD.size:
                raise KvWireError("truncated KV_BLOCKS frame")
            (nbytes,) = _TENSOR_HEAD.unpack_from(body, off)
            off += _TENSOR_HEAD.size
            raw = body[off:off + nbytes]
            if len(raw) != nbytes:
                raise KvWireError("truncated KV_BLOCKS tensor")
            shape = shapes[name]
            want = int(np.prod(shape)) * dtypes[name].itemsize
            if nbytes != want:
                raise KvWireError(f"KV_BLOCKS tensor {name} carries {nbytes} bytes, "
                                  f"expected {want} for shape {shape}")
            layer[name] = np.frombuffer(raw, dtypes[name]).reshape(shape)
            off += nbytes
        layers.append(layer)
    return first, layers


# -- the pool's side ----------------------------------------------------------

def dtype_name(dtype: torch.dtype, kv_quant: str = "none") -> str:
    """The wire's name of a pool's dtype: ``int8`` for an int8 cache."""
    return "int8" if kv_quant == "int8" else _TORCH_NAMES[dtype]


def validate_against_pool(meta: KvBeginMeta, geometry, prefix_len: int) -> None:
    """Refuse a hand-off up front, before any block is reserved, whose
    layer count, geometry, dtype or shared prefix differ from the pool's:
    ``geometry`` is (n_layers, block_size, kv_heads, head_dim, dtype name).
    The reference's messages."""
    n_layers, block_size, kv, hd, dtype = geometry
    if (meta.n_layers, meta.block_size, meta.kv_heads, meta.head_dim) != \
            (n_layers, block_size, kv, hd):
        raise KvWireError(
            f"handoff geometry (layers={meta.n_layers} bs={meta.block_size} "
            f"kv={meta.kv_heads} hd={meta.head_dim}) does not match this pool "
            f"(layers={n_layers} bs={block_size} kv={kv} hd={hd})")
    if meta.dtype != dtype:
        raise KvWireError(f"handoff pool dtype {meta.dtype} != local {dtype}")
    if meta.prefix_len != prefix_len:
        raise KvWireError(
            f"handoff shared-prefix length {meta.prefix_len} != local {prefix_len} — prefill "
            "and decode replicas must serve the same deployment spec")
