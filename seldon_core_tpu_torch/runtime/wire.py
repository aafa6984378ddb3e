"""Binary tensor wire — the port's copy of ``seldon_core_tpu/runtime/wire.py``.

A length-delimited frame whose tensor payload is the raw row-major bytes,
so a request parses with one ``np.frombuffer`` view and a response is
framed straight from the dispatch's readback buffer, with no JSON on
either side.

Frame layout (all integers big-endian)::

    offset  size      field
    0       4         magic  b"SLDT"
    4       1         version (currently 1)
    5       1         flags  (bit0 RESPONSE, bit1 SCALES, bit2 MULTI)
    6       1         dtype code (0 = no tensor payload)
    7       1         ndim  (<= 8)
    8       2         status (response frames; sub-frame COUNT for MULTI;
                      0 on requests)
    10      4         meta_len (sidecar bytes)
    14      4*ndim    shape dims (u32 each)
    ...     meta_len  sidecar (below)
    [flags&SCALES]    u32 scale_len + f32 scale plane, one entry per row
                      (int8/uint8 payloads: value = q * scale[row])
    pad               zeros to the next 8-byte boundary from frame start
    ...               payload: prod(shape) * itemsize raw row-major bytes

The payload length is implied by dtype x shape and validated strictly:
a frame whose byte count disagrees with its header is a typed 400
(``WireError``), and a declared size beyond the lane cap a typed 413
(``WireFrameTooLarge``) before any allocation.

Sidecar (``meta_len`` bytes)::

    !Bd              sidecar version, deadline_ms (<= 0 = absent)
    uvarint+utf8 x5  puid, traceparent, tenant, tier, extra_json

``extra_json`` carries the cold envelope fields (``names``, ``kind``,
``tags``, ``routing``, ``requestPath``, ``error``).  An unknown sidecar
version degrades to "no metadata"; an unknown frame version is a 400.

Multi-tensor frames (``FLAG_MULTI``): ``status`` carries the sub-frame
count and the body is ``count x (u32 len + complete single frame)``.

dtype codes: 1 float32, 2 float64, 3 int8, 4 int16, 5 int32, 6 int64,
7 uint8, 8 bool, 9 float16 and 10 bfloat16.  The port reads and writes
code 10 by bit pattern (uint16 <-> ``torch.bfloat16``, as ``convert.py``
reads checkpoints), so it needs no ``ml_dtypes``: a decoded bf16 frame
holds the bits as a uint16 view (``WireFrame.bf16``) and ``rows()``
widens them to float32 exactly; ``encode_frame`` takes a
``torch.bfloat16`` tensor, or a numpy array whose dtype is named
"bfloat16", by its bits.  Any other dtype without a code (a plain uint16
array among them) is the reference's ``WireError``.

The sidecar carries the calling context's deadline
(``runtime/resilience.py``), W3C ``traceparent`` (``utils/tracing.py``),
tenant and tier (``runtime/qos.py``; the default tier is left empty).
Host-side byte copies the codec or a lane feeding it makes are counted by
the flight recorder (``RECORDER.record_wire_copy``: the
``seldon_tpu_wire_bytes_copied_total`` family, ``bytes_copied()``, the
engine's ``/stats``) and, with the cost ledger on, billed to the bound
tenant (lane ``wire_copy``; a dispatch-thread copy with no tenant bound
books under the anonymous one, so lane totals stay complete).

Content negotiation: HTTP lanes carry frames under ``Content-Type:
application/x-seldon-tensor``; the framed relay (``runtime/udsrelay.py``)
as ``OP_WIRE`` payloads.  ``SELDON_TPU_WIRE=0`` is the kill switch:
binary ingress answers a typed 415 and client lanes speak JSON.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from seldon_core_tpu_torch.messages import (
    DefaultData,
    Meta,
    SeldonMessage,
    SeldonMessageError,
    Status,
)
from seldon_core_tpu_torch.runtime.qos import current_tenant, current_tier
from seldon_core_tpu_torch.runtime.resilience import remaining_s
from seldon_core_tpu_torch.utils.costledger import LEDGER, costledger_enabled
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import traceparent_header_value

__all__ = [
    "WIRE_CONTENT_TYPE",
    "WIRE_MAGIC",
    "WIRE_VERSION",
    "FLAG_RESPONSE",
    "FLAG_SCALES",
    "FLAG_MULTI",
    "BF16_CODE",
    "MAX_FRAME_BYTES",
    "WireError",
    "WireFrameTooLarge",
    "WireFrame",
    "wire_enabled",
    "coalesce_window_s",
    "coalesce_max",
    "encode_frame",
    "encode_multi",
    "decode_frame",
    "join_parts",
    "parts_nbytes",
    "pack_wire_meta",
    "unpack_wire_meta",
    "frame_from_message",
    "message_from_frame",
    "frame_eligible",
    "current_wire_sidecar",
    "quantize_rows",
    "account_copy",
    "bytes_copied",
    "uvarint",
    "read_uvarint",
    "pack_str",
]

WIRE_CONTENT_TYPE = "application/x-seldon-tensor"
WIRE_MAGIC = b"SLDT"
WIRE_VERSION = 1
SIDECAR_VERSION = 1

FLAG_RESPONSE = 0x01
FLAG_SCALES = 0x02
FLAG_MULTI = 0x04

_HEAD = struct.Struct("!4sBBBBHI")  # magic, version, flags, dtype, ndim, status, meta_len
_META_HEAD = struct.Struct("!Bd")   # sidecar version, deadline_ms
_SUB_LEN = struct.Struct("!I")
_MAX_NDIM = 8
#: the HTTP lanes' body cap (``runtime/rest.py`` ``_MAX_BODY``)
MAX_FRAME_BYTES = 256 * 1024 * 1024
#: sub-frame count cap in a MULTI frame
MAX_MULTI = 4096

_CODE_TO_DTYPE = {
    1: np.dtype(np.float32),
    2: np.dtype(np.float64),
    3: np.dtype(np.int8),
    4: np.dtype(np.int16),
    5: np.dtype(np.int32),
    6: np.dtype(np.int64),
    7: np.dtype(np.uint8),
    8: np.dtype(np.bool_),
    9: np.dtype(np.float16),
}
_DTYPE_TO_CODE = {dt: code for code, dt in _CODE_TO_DTYPE.items()}
#: bfloat16, carried by bit pattern (a little-endian uint16 view)
BF16_CODE = 10
_BF16_BITS = np.dtype("<u2")
_TORCH_CODED = frozenset(("float32", "float64", "int8", "int16", "int32", "int64", "uint8",
                          "bool", "float16", "bfloat16"))


class WireError(SeldonMessageError):
    """Malformed binary frame (bad magic/version/dtype/shape/truncation):
    400 at the edge; the bytes cannot be trusted, the connection can."""

    http_code = 400


class WireFrameTooLarge(WireError):
    """Declared frame size beyond the lane cap: a typed 413 before any
    allocation."""

    http_code = 413


def wire_enabled() -> bool:
    """Kill switch: ``SELDON_TPU_WIRE=0`` answers binary ingress with 415
    and keeps client lanes on JSON."""
    return os.environ.get("SELDON_TPU_WIRE", "1") != "0"


def coalesce_window_s() -> float:
    """The gateway's coalesce window (``SELDON_TPU_WIRE_COALESCE_US``,
    default 200 us; 0 disables): binary predicts for one engine socket that
    arrive within it ride one multi-tensor relay frame."""
    try:
        us = float(os.environ.get("SELDON_TPU_WIRE_COALESCE_US", "") or 200.0)
    except ValueError:
        us = 200.0
    return max(0.0, us) / 1e6


def coalesce_max() -> int:
    """Sub-frames per coalesced frame (``SELDON_TPU_WIRE_COALESCE_MAX``,
    default 16, clamped to 2..``MAX_MULTI``)."""
    try:
        n = int(os.environ.get("SELDON_TPU_WIRE_COALESCE_MAX", "") or 16)
    except ValueError:
        n = 16
    return max(2, min(n, MAX_MULTI))


# ---------------------------------------------------------------------------
# copy accounting
# ---------------------------------------------------------------------------

def account_copy(nbytes: int) -> None:
    """One host-side byte copy of ``nbytes`` made by the codec or a lane
    feeding it (a receive buffer materialized, parts joined), into the
    flight recorder and, with the cost ledger on, billed to the bound
    tenant."""
    if nbytes > 0:
        RECORDER.record_wire_copy(nbytes)
        if costledger_enabled():
            LEDGER.note_bytes(current_tenant() or "", "", "wire_copy", int(nbytes))


def bytes_copied() -> int:
    """Host-side bytes copied by the wire lanes since the process began
    (or the recorder's last reset)."""
    return RECORDER.wire_bytes_copied


# ---------------------------------------------------------------------------
# framing helpers shared with the relay (runtime/udsrelay.py)
# ---------------------------------------------------------------------------


def uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def read_uvarint(view, off: int) -> "tuple[int, int]":
    shift = 0
    val = 0
    while True:
        if off >= len(view):
            raise ValueError("truncated varint")
        b = view[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7
        if shift > 35:
            raise ValueError("varint too long")


def pack_str(s: "str | None") -> bytes:
    raw = (s or "").encode("utf-8", "replace")
    return uvarint(len(raw)) + raw


# ---------------------------------------------------------------------------
# sidecar
# ---------------------------------------------------------------------------


def pack_wire_meta(puid: "str | None" = None,
                   deadline_ms: "float | None" = None,
                   traceparent: "str | None" = None,
                   tenant: "str | None" = None,
                   tier: "str | None" = None,
                   extra: "dict | None" = None) -> bytes:
    """The per-request sidecar: deadline/trace/tenant/tier plus the cold
    envelope fields (``extra``) as one small JSON object."""
    extra_json = json.dumps(extra, separators=(",", ":")) if extra else ""
    return (
        _META_HEAD.pack(SIDECAR_VERSION, float(deadline_ms) if deadline_ms else -1.0)
        + pack_str(puid) + pack_str(traceparent) + pack_str(tenant)
        + pack_str(tier) + pack_str(extra_json)
    )


_EMPTY_META = {"puid": None, "deadline_ms": None, "traceparent": None,
               "tenant": None, "tier": None, "extra": None}


def unpack_wire_meta(view) -> dict:
    """Sidecar parse.  A future sidecar version degrades to 'no metadata';
    a structurally torn sidecar raises ``WireError``."""
    if len(view) == 0:
        return dict(_EMPTY_META)
    out = dict(_EMPTY_META)
    try:
        version, deadline_ms = _META_HEAD.unpack_from(view, 0)
        if version != SIDECAR_VERSION:
            return dict(_EMPTY_META)
        if deadline_ms > 0:
            out["deadline_ms"] = float(deadline_ms)
        off = _META_HEAD.size
        vals = []
        for _ in range(5):
            n, off = read_uvarint(view, off)
            if off + n > len(view):
                raise ValueError("truncated sidecar string")
            raw = bytes(view[off:off + n])
            off += n
            vals.append(raw.decode("utf-8", "replace") if raw else None)
    except (struct.error, ValueError) as e:
        raise WireError(f"torn wire sidecar: {e}") from e
    out["puid"], out["traceparent"], out["tenant"], out["tier"] = vals[:4]
    if vals[4]:
        try:
            extra = json.loads(vals[4])
        except ValueError as e:
            raise WireError(f"malformed wire sidecar extra: {e}") from e
        if not isinstance(extra, dict):
            raise WireError("wire sidecar extra must be a JSON object")
        out["extra"] = extra
    return out


def current_wire_sidecar(extra: "dict | None" = None, puid: "str | None" = None) -> bytes:
    """The calling context's deadline, trace context, tenant and tier as
    sidecar bytes: what the JSON lanes forward as headers, for frames that
    hop node to node."""
    rem = remaining_s()
    tier = current_tier()
    return pack_wire_meta(
        puid=puid,
        deadline_ms=max(rem * 1e3, 1.0) if rem is not None else None,
        traceparent=traceparent_header_value(),
        tenant=current_tenant(),
        tier=None if tier == "interactive" else tier,
        extra=extra,
    )


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@dataclass
class WireFrame:
    """A decoded frame.  ``array`` is a zero-copy, read-only
    ``np.frombuffer`` view over the wire buffer unless the decoder was
    asked to copy; for a bf16 frame (``bf16``) it holds the bits as
    uint16."""

    array: Optional[np.ndarray] = None
    scales: Optional[np.ndarray] = None
    status: int = 0
    flags: int = 0
    meta: dict = field(default_factory=lambda: dict(_EMPTY_META))
    subframes: List[Any] = field(default_factory=list)  # memoryviews
    bf16: bool = False

    @property
    def is_response(self) -> bool:
        return bool(self.flags & FLAG_RESPONSE)

    @property
    def is_multi(self) -> bool:
        return bool(self.flags & FLAG_MULTI)

    def extra(self) -> dict:
        return self.meta.get("extra") or {}

    def values(self) -> Optional[np.ndarray]:
        """The tensor as numpy values in its own shape: the view itself,
        a bf16 frame's bits widened to float32 (exact), or an 8-bit
        payload dequantized through its scale plane."""
        if self.array is None:
            return None
        if self.bf16:
            return (self.array.astype(np.uint32) << 16).view(np.float32)
        if self.scales is not None:
            a = self.array if self.array.ndim else self.array.reshape(1)
            return a.astype(np.float32) * self.scales.reshape((-1,) + (1,) * (a.ndim - 1))
        return self.array

    def rows(self) -> np.ndarray:
        """The tensor as 2D rows for the batcher (a 1-D payload is one
        row; a reshaped view, never written to)."""
        a = self.values()
        if a is None:
            raise WireError("wire frame has no tensor payload")
        if a.ndim < 2:
            a = a.reshape(1, -1)
        return a


def _dims_nbytes(itemsize: int, shape: "tuple[int, ...]") -> int:
    n = itemsize
    for d in shape:
        n *= int(d)
    return n


def _pad_to(off: int, align: int = 8) -> int:
    return (-off) % align


def _payload_array(array):
    """(contiguous numpy payload, dtype code) of a numpy array or a torch
    tensor (read back to the host); bf16 by its bits."""
    if hasattr(array, "detach"):  # a torch tensor
        t = array.detach()
        if str(t.dtype) == "torch.bfloat16":
            import torch

            return t.contiguous().view(torch.int16).cpu().numpy().view(_BF16_BITS), BF16_CODE
        array = t.cpu().numpy()
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        return a.view(_BF16_BITS), BF16_CODE
    code = _DTYPE_TO_CODE.get(a.dtype)
    if code is None:
        raise WireError(f"dtype {a.dtype} has no wire code")
    return a, code


def encode_frame(array=None, *, status: int = 0, response: bool = False,
                 meta_bytes: "bytes | None" = None, scales=None) -> List[Any]:
    """One frame as buffer parts ``[header_block, payload_view]`` for the
    caller to write in turn, so a response is framed from the readback
    buffer with no concatenation.  ``meta_bytes`` is a packed sidecar
    (``pack_wire_meta``)."""
    flags = FLAG_RESPONSE if response else 0
    meta_bytes = meta_bytes or b""
    if array is None:
        head = _HEAD.pack(WIRE_MAGIC, WIRE_VERSION, flags, 0, 0, status & 0xFFFF,
                          len(meta_bytes))
        return [head + meta_bytes]
    a, code = _payload_array(array)
    if a.ndim > _MAX_NDIM:
        raise WireError(f"ndim {a.ndim} > wire max {_MAX_NDIM}")
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
        account_copy(a.nbytes)
    scale_block = b""
    if scales is not None:
        # scale planes, like payloads, are little-endian on the wire
        s = np.ascontiguousarray(np.asarray(scales, dtype="<f4"))
        flags |= FLAG_SCALES
        scale_block = _SUB_LEN.pack(s.nbytes) + s.tobytes()
    head = _HEAD.pack(WIRE_MAGIC, WIRE_VERSION, flags, code, a.ndim, status & 0xFFFF,
                      len(meta_bytes))
    shape = struct.pack("!%dI" % a.ndim, *(int(d) for d in a.shape))
    off = len(head) + len(shape) + len(meta_bytes) + len(scale_block)
    pad = b"\x00" * _pad_to(off)
    # the payload rides as a memoryview of the array: the transport writes
    # it straight out (an empty array has no bytes to view)
    return [head + shape + meta_bytes + scale_block + pad,
            memoryview(a).cast("B") if a.size else b""]


def encode_multi(frames: List[bytes]) -> List[Any]:
    """Complete single-frame byte strings packed into one MULTI frame's
    parts."""
    if not frames:
        raise WireError("empty multi frame")
    if len(frames) > MAX_MULTI:
        raise WireError(f"multi frame count {len(frames)} > {MAX_MULTI}")
    parts: List[Any] = [_HEAD.pack(WIRE_MAGIC, WIRE_VERSION, FLAG_MULTI, 0, 0, len(frames), 0)]
    for f in frames:
        parts.append(_SUB_LEN.pack(len(f)))
        parts.append(f)
    return parts


def parts_nbytes(parts: List[Any]) -> int:
    return sum(len(p) for p in parts)


def join_parts(parts: List[Any]) -> bytes:
    """Frame parts as one bytes (lanes that need a single body).  This is
    a copy, and counted."""
    if len(parts) == 1:
        p = parts[0]
        return p if isinstance(p, bytes) else bytes(p)
    out = b"".join(parts)
    account_copy(len(out))
    return out


def decode_frame(buf, *, copy: bool = False, max_bytes: int = MAX_FRAME_BYTES) -> WireFrame:
    """Strict decode of one frame.  Tensor payloads come back as zero-copy
    views unless ``copy=True`` (then the one copy is accounted).

    Bad magic, version or dtype, a truncated header or payload, or a byte
    count that disagrees with dtype x shape raise ``WireError`` (400); a
    declared size beyond ``max_bytes`` raises ``WireFrameTooLarge`` (413)."""
    view = memoryview(buf)
    if len(view) > max_bytes:
        raise WireFrameTooLarge(f"wire frame {len(view)}B exceeds cap {max_bytes}B")
    if len(view) < _HEAD.size:
        raise WireError("truncated wire header")
    magic, version, flags, dcode, ndim, status, meta_len = _HEAD.unpack_from(view, 0)
    if magic != WIRE_MAGIC:
        raise WireError("bad wire magic")
    if version != WIRE_VERSION:
        raise WireError(f"unsupported wire version {version}")
    off = _HEAD.size
    if flags & FLAG_MULTI:
        count = status
        if count == 0 or count > MAX_MULTI:
            raise WireError(f"bad multi frame count {count}")
        subs = []
        for _ in range(count):
            if off + _SUB_LEN.size > len(view):
                raise WireError("truncated multi frame")
            (sub_len,) = _SUB_LEN.unpack_from(view, off)
            off += _SUB_LEN.size
            if sub_len > max_bytes:
                raise WireFrameTooLarge(f"wire sub-frame {sub_len}B exceeds cap {max_bytes}B")
            if off + sub_len > len(view):
                raise WireError("truncated multi frame")
            subs.append(view[off:off + sub_len])
            off += sub_len
        if off != len(view):
            raise WireError("trailing bytes after multi frame")
        return WireFrame(flags=flags, status=0, subframes=subs)
    if ndim > _MAX_NDIM:
        raise WireError(f"ndim {ndim} > wire max {_MAX_NDIM}")
    shape_len = 4 * ndim
    if off + shape_len + meta_len > len(view):
        raise WireError("truncated wire frame")
    shape = struct.unpack_from("!%dI" % ndim, view, off) if ndim else ()
    off += shape_len
    meta = unpack_wire_meta(view[off:off + meta_len])
    off += meta_len
    if dcode == 0:
        if off != len(view):
            raise WireError("trailing bytes after payload-less frame")
        return WireFrame(array=None, status=status, flags=flags, meta=meta)
    bf16 = dcode == BF16_CODE
    dtype = _BF16_BITS if bf16 else _CODE_TO_DTYPE.get(dcode)
    if dtype is None:
        raise WireError(f"unknown wire dtype code {dcode}")
    scales = None
    if flags & FLAG_SCALES:
        if dtype.itemsize != 1:
            raise WireError("scale plane on a non-8-bit payload")
        if off + _SUB_LEN.size > len(view):
            raise WireError("truncated scale plane")
        (scale_len,) = _SUB_LEN.unpack_from(view, off)
        off += _SUB_LEN.size
        rows = int(shape[0]) if ndim else 1
        if scale_len != 4 * rows or off + scale_len > len(view):
            raise WireError("scale plane disagrees with shape")
        scales = np.frombuffer(view[off:off + scale_len], dtype="<f4")
        off += scale_len
    off += _pad_to(off)
    nbytes = _dims_nbytes(dtype.itemsize, shape)
    if nbytes > max_bytes:
        raise WireFrameTooLarge(f"declared tensor {nbytes}B exceeds cap {max_bytes}B")
    if off + nbytes != len(view):
        raise WireError(
            f"payload is {max(0, len(view) - off)}B but dtype x shape "
            f"{tuple(int(d) for d in shape)} implies {nbytes}B")
    arr = np.frombuffer(view[off:off + nbytes], dtype=dtype).reshape(shape)
    if copy:
        arr = arr.copy()
        account_copy(arr.nbytes)
    return WireFrame(array=arr, scales=scales, status=status, flags=flags, meta=meta, bf16=bf16)


# ---------------------------------------------------------------------------
# SeldonMessage bridges
# ---------------------------------------------------------------------------


def frame_eligible(msg: SeldonMessage) -> bool:
    """Can this message ride the binary lane?  A numeric DefaultData
    payload only (a bf16 tensor included); strData, binData and object
    payloads stay on JSON."""
    if msg.data is None or msg.data.array is None:
        return False
    a = msg.data.array
    if hasattr(a, "detach"):  # a torch tensor: the dtypes with a code
        return str(a.dtype).removeprefix("torch.") in _TORCH_CODED
    a = np.asarray(a)
    return a.dtype in _DTYPE_TO_CODE or a.dtype.name == "bfloat16"


def frame_from_message(msg: SeldonMessage, *, response: bool = False,
                       sidecar: bool = True) -> List[Any]:
    """A SeldonMessage as frame parts.  ``sidecar=True`` also packs the
    ambient deadline (client lanes: the binary analogue of forwarding the
    deadline header)."""
    extra: dict = {}
    if msg.data is not None:
        if msg.data.names:
            extra["names"] = list(msg.data.names)
        if msg.data.kind != "tensor":
            extra["kind"] = msg.data.kind
    if msg.meta.tags:
        extra["tags"] = dict(msg.meta.tags)
    if msg.meta.routing:
        extra["routing"] = {k: int(v) for k, v in msg.meta.routing.items()}
    if msg.meta.requestPath:
        extra["requestPath"] = dict(msg.meta.requestPath)
    status = 0
    if msg.status is not None:
        status = int(msg.status.code or (200 if msg.status.status == "SUCCESS" else 500))
        if msg.status.status == "FAILURE":
            extra["error"] = msg.status.info or "FAILURE"
    elif response:
        status = 200
    if sidecar:
        meta_bytes = current_wire_sidecar(extra=extra or None, puid=msg.meta.puid or None)
    else:
        meta_bytes = pack_wire_meta(puid=msg.meta.puid or None, extra=extra or None)
    arr = msg.data.array if msg.data is not None else None
    return encode_frame(arr, status=status, response=response, meta_bytes=meta_bytes)


def message_from_frame(frame: WireFrame) -> SeldonMessage:
    """A decoded frame as a SeldonMessage (the payload a numpy view, bf16
    widened to float32, an 8-bit payload with a scale plane
    dequantized)."""
    extra = frame.extra()
    meta = Meta(
        puid=frame.meta.get("puid") or "",
        tags=dict(extra.get("tags") or {}),
        routing={k: int(v) for k, v in (extra.get("routing") or {}).items()},
        requestPath=dict(extra.get("requestPath") or {}),
    )
    status = None
    if frame.is_response:
        if frame.status and frame.status != 200:
            status = Status.failure(str(extra.get("error") or f"wire status {frame.status}"),
                                    code=int(frame.status))
        else:
            status = Status()
    data = None
    if frame.array is not None:
        data = DefaultData(array=frame.values(), names=list(extra.get("names") or []),
                           kind=str(extra.get("kind") or "tensor"))
    return SeldonMessage(data=data, meta=meta, status=status)


def quantize_rows(rows: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Symmetric per-row int8 quantization for the scale-plane payload:
    ``(q, scales)`` with ``value ~= q * scales[row]``, within half a step
    (``scales[row] / 2``).  Lossy by construction."""
    rows = np.asarray(rows)
    if rows.ndim < 2:
        rows = rows.reshape(1, -1)
    amax = np.max(np.abs(rows), axis=1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(rows / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales
