"""Wire-level protobuf codec for the gRPC hot path — the port's copy of
``seldon_core_tpu/native/protowire.py``.

On the wire a tensor's values are one packed-doubles LEN field, so
scanning the few enclosing tags by hand and ``np.frombuffer``-ing the
payload reads a request without building a message object, zero-copy.
A fast lane for the common message shape, with ``None`` returned for
anything unusual so callers fall back to the full decode
(``seldon_core_tpu_torch/protoconv.py``) — wire semantics never diverge.

The varint, tag and length helpers here (``read_varint``, ``skip_field``,
``read_len``, ``varint``, ``len_field``) are the ones ``protoconv`` builds
its full codec on.

Handled request shape: ``SeldonMessage{meta{puid?}, data{names*,
tensor{shape packed, values packed}}}``.  Any other field (binData,
strData, status, meta tags/routing/requestPath, ndarray) declines.

Layout constants come from proto/prediction.proto field numbers:
  SeldonMessage: status=1 meta=2 data=3 binData=4 strData=5
  Meta:          puid=1 tags=2 routing=3 requestPath=4
  DefaultData:   names=1 tensor=2 ndarray=3
  Tensor:        shape=1 (packed varint) values=2 (packed double)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "parse_tensor_request",
    "build_tensor_response",
    "names_fragment",
    "read_varint",
    "skip_field",
    "read_len",
    "varint",
    "len_field",
]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = read_varint(buf, pos)
    elif wire_type == 1:  # fixed64
        pos += 8
    elif wire_type == 2:  # LEN
        n, pos = read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # fixed32
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    if pos > len(buf):
        # truncated message: real protobuf raises DecodeError here, so the
        # fast lane must decline rather than accept what upb would reject
        raise ValueError("field overruns buffer")
    return pos


def read_len(buf: bytes, pos: int) -> Tuple[int, int]:
    """LEN prefix with overrun check (python slicing would silently
    truncate where real protobuf raises DecodeError)."""
    n, pos = read_varint(buf, pos)
    if pos + n > len(buf):
        raise ValueError("length-delimited field overruns buffer")
    return n, pos


def _scan_meta(buf: bytes) -> Optional[str]:
    """Return puid if meta contains ONLY a puid (or nothing); None = decline."""
    pos = 0
    puid = ""
    end = len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == 2:  # puid
            n, pos = read_len(buf, pos)
            puid = buf[pos : pos + n].decode("utf-8")
            pos += n
        else:
            return None  # tags/routing/requestPath present -> object path
    return puid


def _scan_tensor(buf: bytes):
    """-> (shape tuple, values ndarray) or None."""
    pos = 0
    end = len(buf)
    shape: Tuple[int, ...] = ()
    values = None
    while pos < end:
        key, pos = read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 1:  # shape: packed varints (or repeated varint)
            if wt == 2:
                n, pos = read_len(buf, pos)
                sub_end = pos + n
                dims = []
                while pos < sub_end:
                    d, pos = read_varint(buf, pos)
                    dims.append(d)
                shape = shape + tuple(dims)
            elif wt == 0:
                d, pos = read_varint(buf, pos)
                shape = shape + (d,)
            else:
                return None
        elif field == 2:  # values
            if wt != 2 or values is not None:
                # unpacked (wt 1) elements or a split packed field: protobuf
                # merge semantics concatenate — decline so the full parser
                # (and its shape validation) handles the message
                return None
            n, pos = read_len(buf, pos)
            if n % 8:
                return None
            values = np.frombuffer(buf, dtype="<f8", count=n // 8, offset=pos)
            pos += n
        else:
            pos = skip_field(buf, pos, wt)
    if values is None:
        return None
    return shape, values


def parse_tensor_request(wire: bytes):
    """SeldonMessage wire bytes -> (puid, rows ndarray) or None (decline).

    rows is at least 2-D; the values array is a zero-copy view of ``wire``
    (read-only — callers must not mutate in place).
    """
    try:
        pos = 0
        end = len(wire)
        puid = ""
        tensor = None
        seen_meta = False
        while pos < end:
            key, pos = read_varint(wire, pos)
            field, wt = key >> 3, key & 7
            if field == 2 and wt == 2:  # meta
                if seen_meta:
                    return None  # repeated field -> protobuf merges; decline
                seen_meta = True
                n, pos = read_len(wire, pos)
                meta_puid = _scan_meta(wire[pos : pos + n])
                if meta_puid is None:
                    return None
                puid = meta_puid
                pos += n
            elif field == 3 and wt == 2:  # data
                if tensor is not None:
                    return None  # repeated data -> merge semantics; decline
                n, pos = read_len(wire, pos)
                sub = wire[pos : pos + n]
                pos += n
                spos, send = 0, len(sub)
                while spos < send:
                    skey, spos = read_varint(sub, spos)
                    sfield, swt = skey >> 3, skey & 7
                    if sfield == 2 and swt == 2:  # tensor
                        if tensor is not None:
                            return None  # repeated tensor: merge; decline
                        sn, spos = read_len(sub, spos)
                        tensor = _scan_tensor(sub[spos : spos + sn])
                        if tensor is None:
                            return None
                        spos += sn
                    elif sfield == 1 and swt == 2:  # names: ignore on input
                        spos = skip_field(sub, spos, swt)
                    else:
                        return None  # ndarray -> object path
            elif field in (1, 4, 5):  # status / binData / strData
                return None
            else:
                pos = skip_field(wire, pos, wt)
        if tensor is None:
            return None
        shape, values = tensor
        shape = shape or (values.size,)
        if int(np.prod(shape)) != values.size:
            return None
        rows = values.reshape(shape)
        if rows.ndim < 2:
            rows = rows.reshape(1, -1)
        return puid, rows
    except (IndexError, ValueError):
        return None


def len_field(field: int, payload: bytes) -> bytes:
    key = (field << 3) | 2
    return bytes([key]) + varint(len(payload)) + payload


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def names_fragment(names: Sequence[str]) -> bytes:
    """Precomputable DefaultData.names fields (field 1, repeated string)."""
    out = b""
    for nm in names:
        out += len_field(1, nm.encode("utf-8"))
    return out


# Status{code=200, status=SUCCESS(0)}: field1 varint 200 (SUCCESS is the
# zero enum — omitted on the wire, same bytes upb produces)
_STATUS_OK = len_field(1, bytes([0x08]) + varint(200))


def build_tensor_response(
    puid: str, y: np.ndarray, names_frag: bytes = b""
) -> bytes:
    """SUCCESS SeldonMessage with a tensor payload, as wire bytes."""
    y = np.ascontiguousarray(y, dtype="<f8")
    tensor = (
        len_field(1, b"".join(varint(int(s)) for s in y.shape))
        + len_field(2, y.tobytes())
    )
    data = names_frag + len_field(2, tensor)
    meta = len_field(1, puid.encode("utf-8"))
    return _STATUS_OK + len_field(2, meta) + len_field(3, data)
