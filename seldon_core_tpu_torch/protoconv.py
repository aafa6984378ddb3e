"""Protobuf <-> dataclass conversion for the data plane — the port's
counterpart of ``seldon_core_tpu/protoconv.py``, on a stdlib codec.

The six functions keep the reference's names and data-kind rules (a
tensor stays a tensor, an ndarray stays an ndarray, strData and binData
are kept; engine PredictorUtils.java:127-166), but the proto side is the
message's wire **bytes** of ``proto/prediction.proto``: ``msg_to_proto``
returns bytes, ``msg_from_proto`` takes them.  The codec is written on
``native/protowire.py``'s varint and tag helpers and covers SeldonMessage,
Status, Meta (its three maps), DefaultData, Tensor (packed), SeldonMessageList
and Feedback (``reward`` a fixed32 float), plus ``google/protobuf/struct.proto``'s
Struct, ListValue and Value, which Meta.tags and ndarray use.  It imports
no ``google.protobuf``: the machines the port serves on need not have it.

Encoding follows proto3 as the reference's upb runtime writes it: fields
in number order, scalars at their default omitted, a set oneof member and
every map entry's key and value always written, ``meta`` always present.
Decoding follows protobuf's merge rules: a repeated singular field keeps
its last scalar, a repeated message field merges (parsing the concatenated
occurrences), the last oneof member set wins, packed and unpacked repeated
numbers both read, unknown fields are skipped.  Bytes that do not parse
raise ``ProtoDecodeError`` (a 400 ``SeldonMessageError``), which the gRPC
lanes answer as a FAILURE SeldonMessage.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from seldon_core_tpu_torch.messages import (
    DefaultData,
    Feedback,
    Meta,
    SeldonMessage,
    SeldonMessageError,
    SeldonMessageList,
    Status,
)
from seldon_core_tpu_torch.native.protowire import read_varint, skip_field, varint

__all__ = [
    "ProtoDecodeError",
    "msg_to_proto",
    "msg_from_proto",
    "feedback_to_proto",
    "feedback_from_proto",
    "msg_list_to_proto",
    "msg_list_from_proto",
    "status_field",
]

_F64 = struct.Struct("<d")
_F32 = struct.Struct("<f")


class ProtoDecodeError(SeldonMessageError):
    """Bytes that are not a valid message of the expected type."""

    http_code = 400


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _tag(field: int, wire_type: int) -> bytes:
    return varint((field << 3) | wire_type)


def _len(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + varint(len(payload)) + payload


def _int_varint(n: int) -> bytes:
    """An int32/int64/enum as a varint: negatives as 10-byte two's
    complement, as protobuf writes them."""
    return varint(int(n) & 0xFFFFFFFFFFFFFFFF)


def _str(field: int, s: str) -> bytes:
    return _len(field, s.encode("utf-8")) if s else b""


def value_to_proto(x: Any) -> bytes:
    """A Python value as ``google.protobuf.Value`` bytes, by the JSON
    mapping ``json_format.ParseDict`` uses (dict -> struct, list/tuple ->
    list, None -> null, bool, str, int/float -> number)."""
    if isinstance(x, dict):
        return _len(5, _struct_bytes(x))
    if isinstance(x, (list, tuple)):
        return _len(6, _list_bytes(x))
    if x is None:
        return _tag(1, 0) + b"\x00"
    if isinstance(x, bool):
        return _tag(4, 0) + (b"\x01" if x else b"\x00")
    if isinstance(x, str):
        return _len(3, x.encode("utf-8"))
    if isinstance(x, (int, float)):
        return _tag(2, 1) + _F64.pack(float(x))
    raise SeldonMessageError(f"value {x!r} has unexpected type {type(x).__name__} for a "
                             f"protobuf Value")


def _struct_bytes(d: dict) -> bytes:
    out = bytearray()
    for k, v in d.items():
        out += _len(1, _len(1, str(k).encode("utf-8")) + _len(2, value_to_proto(v)))
    return bytes(out)


def _list_bytes(xs) -> bytes:
    return b"".join(_len(1, value_to_proto(x)) for x in xs)


# a number in a ListValue: values(1) LEN 9 { number_value(2) fixed64 }
_NUMBER_ENTRY = b"\x0a\x09\x11"


def _numbers_bytes(a: np.ndarray) -> bytes:
    """A numeric array as nested ListValue bytes, the rows of numbers laid
    out at once: the bytes ``_list_bytes(a.tolist())`` writes."""
    if a.ndim > 1:
        return b"".join(_len(1, _len(6, _numbers_bytes(row))) for row in a)
    out = np.empty((a.size, 11), dtype=np.uint8)
    out[:, :3] = np.frombuffer(_NUMBER_ENTRY, dtype=np.uint8)
    out[:, 3:] = np.ascontiguousarray(a, dtype="<f8").view(np.uint8).reshape(-1, 8)
    return out.tobytes()


def _status_bytes(st: Status) -> bytes:
    out = b""
    if st.code:
        out += _tag(1, 0) + _int_varint(st.code)
    out += _str(2, st.info) + _str(3, st.reason)
    if st.status == "FAILURE":
        out += _tag(4, 0) + b"\x01"
    return out


def status_field(st: Status) -> bytes:
    """A SeldonMessage's ``status`` field (field 1, tag included): what a
    message with this status and nothing else starts with."""
    return _len(1, _status_bytes(st))


def _meta_bytes(meta: Meta) -> bytes:
    out = bytearray(_str(1, meta.puid))
    for k, v in meta.tags.items():
        out += _len(2, _len(1, str(k).encode("utf-8")) + _len(2, value_to_proto(v)))
    for k, v in meta.routing.items():
        out += _len(3, _len(1, str(k).encode("utf-8")) + _tag(2, 0) + _int_varint(int(v)))
    for k, v in meta.requestPath.items():
        out += _len(4, _len(1, str(k).encode("utf-8")) + _len(2, str(v).encode("utf-8")))
    return bytes(out)


def _data_bytes(data: DefaultData) -> bytes:
    out = bytearray()
    for name in data.names:
        out += _len(1, str(name).encode("utf-8"))
    a = data.numpy()
    if data.kind == "ndarray":
        numeric = a.dtype.kind in "fiu" and a.ndim > 0
        out += _len(3, _numbers_bytes(a) if numeric else _list_bytes(a.tolist()))
    else:
        # packed doubles are little-endian on the wire, whatever the host
        vals = np.ascontiguousarray(np.asarray(a, dtype=np.float64).reshape(-1), dtype="<f8")
        tensor = b""
        if a.ndim:
            tensor += _len(1, b"".join(_int_varint(int(s)) for s in a.shape))
        if vals.size:
            tensor += _len(2, vals.tobytes())
        out += _len(2, tensor)
    return bytes(out)


def msg_to_proto(msg: SeldonMessage) -> bytes:
    """A SeldonMessage as ``seldon.protos.SeldonMessage`` bytes."""
    out = bytearray()
    if msg.status is not None:
        out += status_field(msg.status)
    out += _len(2, _meta_bytes(msg.meta))
    if msg.data is not None:
        out += _len(3, _data_bytes(msg.data))
    elif msg.bin_data is not None:
        out += _len(4, bytes(msg.bin_data))
    elif msg.str_data is not None:
        out += _len(5, msg.str_data.encode("utf-8"))
    return bytes(out)


def feedback_to_proto(fb: Feedback) -> bytes:
    """A Feedback as ``seldon.protos.Feedback`` bytes (``reward`` a
    float32, omitted when its bits are zero)."""
    out = bytearray()
    if fb.request is not None:
        out += _len(1, msg_to_proto(fb.request))
    if fb.response is not None:
        out += _len(2, msg_to_proto(fb.response))
    reward = _F32.pack(float(fb.reward))
    if reward != b"\x00\x00\x00\x00":
        out += _tag(3, 5) + reward
    if fb.truth is not None:
        out += _len(4, msg_to_proto(fb.truth))
    return bytes(out)


def msg_list_to_proto(ml: SeldonMessageList) -> bytes:
    return b"".join(_len(1, msg_to_proto(m)) for m in ml.messages)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _fields(buf) -> List[Tuple[int, int, Any]]:
    """(field, wire type, value) of each field: an int for a varint, the
    raw 8 or 4 bytes of a fixed64/fixed32, a bytes slice of a LEN field."""
    out = []
    pos, end = 0, len(buf)
    try:
        while pos < end:
            key, pos = read_varint(buf, pos)
            field, wt = key >> 3, key & 7
            if field == 0:
                raise ValueError("field number 0")
            if wt == 0:
                val, pos = read_varint(buf, pos)
            elif wt == 1:
                val = bytes(buf[pos:pos + 8])
                pos = skip_field(buf, pos, wt)
            elif wt == 2:
                n, start = read_varint(buf, pos)
                pos = skip_field(buf, pos, wt)
                val = bytes(buf[start:start + n])
            elif wt == 5:
                val = bytes(buf[pos:pos + 4])
                pos = skip_field(buf, pos, wt)
            else:
                raise ValueError(f"unsupported wire type {wt}")
            out.append((field, wt, val))
    except IndexError:
        raise ProtoDecodeError("malformed protobuf message: truncated") from None
    except ValueError as e:
        raise ProtoDecodeError(f"malformed protobuf message: {e}") from None
    return out


def _text(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ProtoDecodeError(f"invalid UTF-8 in a string field: {e}") from None


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


class _Merged:
    """A message's fields by number: singular scalars keep their last
    value, singular messages their occurrences (merged on read), repeated
    fields every value; ``oneof`` tracks the last member set."""

    def __init__(self, buf, oneof: Tuple[int, ...] = ()):
        self.last: Dict[int, Tuple[int, Any]] = {}
        self.all: Dict[int, List[Tuple[int, Any]]] = {}
        self.which: Optional[int] = None
        for field, wt, val in _fields(buf):
            self.last[field] = (wt, val)
            self.all.setdefault(field, []).append((wt, val))
            if field in oneof:
                if self.which is not None and self.which != field:
                    self.all[self.which] = []  # setting one member clears another
                self.which = field

    def message(self, field: int) -> Optional[bytes]:
        """The field's LEN occurrences concatenated (protobuf merges them),
        None when it is absent."""
        parts = [v for wt, v in self.all.get(field, ()) if wt == 2]
        return b"".join(parts) if parts else None

    def string(self, field: int) -> str:
        wt, v = self.last.get(field, (None, None))
        return _text(v) if wt == 2 else ""

    def raw(self, field: int) -> Optional[bytes]:
        wt, v = self.last.get(field, (None, None))
        return v if wt == 2 else None

    def varint(self, field: int) -> int:
        wt, v = self.last.get(field, (None, None))
        return v if wt == 0 else 0

    def strings(self, field: int) -> List[str]:
        return [_text(v) for wt, v in self.all.get(field, ()) if wt == 2]

    def entries(self, field: int) -> List[bytes]:
        return [v for wt, v in self.all.get(field, ()) if wt == 2]


def value_from_proto(raw: bytes) -> Any:
    """``google.protobuf.Value`` bytes as a Python value, by
    ``json_format.MessageToDict``'s mapping (an unset Value is None; a
    number is a float; a non-finite number raises, as MessageToDict
    does)."""
    m = _Merged(raw, oneof=(1, 2, 3, 4, 5, 6))
    kind = m.which
    if kind is None or kind == 1:
        return None
    if kind == 2:
        wt, v = m.last[2]
        if wt != 1:  # not a double: protobuf keeps it as an unknown field
            return None
        x = _F64.unpack(v)[0]
        if math.isinf(x) or math.isnan(x):
            raise ProtoDecodeError(f"a non-finite Value.number_value ({x}) has no JSON value")
        return x
    if kind == 3:
        return m.string(3)
    if kind == 4:
        return bool(m.varint(4))
    if kind == 5:
        return _struct_from(m.message(5) or b"")
    return _list_from(m.message(6) or b"")


def _struct_from(raw: bytes) -> dict:
    out = {}
    for entry in _Merged(raw).entries(1):
        e = _Merged(entry)
        out[e.string(1)] = value_from_proto(e.message(2) or b"")
    return out


def _list_from(raw: bytes) -> list:
    numbers = _numbers_from(raw)
    if numbers is not None:
        return numbers
    return [value_from_proto(v) for v in _Merged(raw).entries(1)]


def _numbers_from(raw: bytes) -> Optional[list]:
    """A ListValue of finite numbers only, in the layout ``_numbers_bytes``
    writes, read at once (as floats); None for any other ListValue."""
    if not raw or len(raw) % 11:
        return None
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 11)
    if not (rows[:, :3] == np.frombuffer(_NUMBER_ENTRY, dtype=np.uint8)).all():
        return None
    values = rows[:, 3:].copy().view("<f8").reshape(-1)
    if not np.isfinite(values).all():
        return None  # the general path raises as MessageToDict does
    return values.tolist()


def _packed(m: _Merged, field: int, fixed: Optional[struct.Struct]) -> list:
    """A repeated number field, packed (LEN) or not, in wire order."""
    out: list = []
    for wt, v in m.all.get(field, ()):
        if wt == 2:
            if fixed is None:
                pos = 0
                try:
                    while pos < len(v):
                        n, pos = read_varint(v, pos)
                        out.append(n)
                except (IndexError, ValueError) as e:
                    raise ProtoDecodeError(f"malformed packed varints: {e}") from None
            else:
                if len(v) % fixed.size:
                    raise ProtoDecodeError("packed fixed-width field of a partial element")
                out.append(np.frombuffer(v, dtype="<f8" if fixed.size == 8 else "<f4"))
        elif fixed is None and wt == 0:
            out.append(v)
        elif fixed is not None and wt == (1 if fixed.size == 8 else 5):
            out.append(np.frombuffer(v, dtype="<f8" if fixed.size == 8 else "<f4"))
    return out


def _data_from(raw: bytes, dtype) -> DefaultData:
    m = _Merged(raw, oneof=(2, 3))
    names = m.strings(1)
    if m.which == 2:
        t = _Merged(m.message(2) or b"")
        shape = [_int32(s) for s in _packed(t, 1, None)]
        parts = _packed(t, 2, _F64)
        values = (np.concatenate(parts) if parts else np.zeros(0)).astype(dtype)
        shape = shape or [values.size]
        try:
            arr = values.reshape(shape)
        except ValueError as e:
            raise SeldonMessageError(f"tensor shape {shape} != #values {values.size}") from e
        return DefaultData(array=arr, names=names, kind="tensor")
    if m.which == 3:
        nested = _list_from(m.message(3) or b"")
        try:
            arr = np.asarray(nested, dtype=dtype)
        except (ValueError, TypeError):
            arr = np.asarray(nested, dtype=object)
        return DefaultData(array=arr, names=names, kind="ndarray")
    raise SeldonMessageError("DefaultData missing tensor/ndarray")


def _meta_from(raw: Optional[bytes]) -> Meta:
    if raw is None:
        return Meta()
    m = _Merged(raw)
    tags, routing, request_path = {}, {}, {}
    for entry in m.entries(2):
        e = _Merged(entry)
        tags[e.string(1)] = value_from_proto(e.message(2) or b"")
    for entry in m.entries(3):
        e = _Merged(entry)
        routing[e.string(1)] = _int32(e.varint(2))
    for entry in m.entries(4):
        e = _Merged(entry)
        request_path[e.string(1)] = e.string(2)
    return Meta(puid=m.string(1), tags=tags, routing=routing, requestPath=request_path)


def msg_from_proto(wire, dtype=np.float64) -> SeldonMessage:
    """``seldon.protos.SeldonMessage`` bytes as a SeldonMessage."""
    m = _Merged(wire, oneof=(3, 4, 5))
    msg = SeldonMessage(meta=_meta_from(m.message(2)))
    status = m.message(1)
    if status is not None:
        s = _Merged(status)
        msg.status = Status(code=_int32(s.varint(1)), info=s.string(2), reason=s.string(3),
                            status="FAILURE" if s.varint(4) == 1 else "SUCCESS")
    if m.which == 3:
        msg.data = _data_from(m.message(3) or b"", dtype)
    elif m.which == 4:
        msg.bin_data = m.raw(4)
    elif m.which == 5:
        msg.str_data = m.string(5)
    return msg


def feedback_from_proto(wire, dtype=np.float64) -> Feedback:
    """``seldon.protos.Feedback`` bytes as a Feedback."""
    m = _Merged(wire)

    def sub(field):
        raw = m.message(field)
        return None if raw is None else msg_from_proto(raw, dtype)

    wt, v = m.last.get(3, (None, None))
    reward = float(_F32.unpack(v)[0]) if wt == 5 else 0.0
    return Feedback(request=sub(1), response=sub(2), reward=reward, truth=sub(4))


def msg_list_from_proto(wire, dtype=np.float64) -> SeldonMessageList:
    """``seldon.protos.SeldonMessageList`` bytes as a SeldonMessageList."""
    return SeldonMessageList(messages=[msg_from_proto(raw, dtype)
                                       for raw in _Merged(wire).entries(1)])
