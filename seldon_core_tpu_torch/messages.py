"""Core data-plane messages — the port's copy of ``seldon_core_tpu/messages.py``.

The wire contract of the reference (proto/prediction.proto:12-69) as
dataclasses: ``SeldonMessage{status, meta, data|binData|strData}``,
``Feedback{request, response, reward, truth}``,
``SeldonMessageList{seldonMessages}`` (a COMBINER's ``/aggregate`` body),
``DefaultData{names, tensor|ndarray}`` whose wire kind a response keeps
from its request, ``Meta{puid, tags, routing, requestPath}`` and
``Status``.  JSON field names are camelCase, so clients of the JAX
package talk to the port unchanged.

The payload array may be a numpy array or a torch tensor (on any device);
it becomes numpy only at a serialization edge.  ``to_json`` and
``from_json`` take the native codec (``native/fastcodec.py``, the
reference's ``messages.py:405-427,492-500``) where it applies and plain
``json`` otherwise; both write the same document, NaN and the infinities
as ``json``'s ``NaN`` / ``Infinity`` literals.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np

__all__ = [
    "Status",
    "Meta",
    "DefaultData",
    "SeldonMessage",
    "SeldonMessageList",
    "Feedback",
    "SeldonMessageError",
    "DispatchTimeoutError",
    "DeadlineExceededError",
    "LoadShedError",
    "new_puid",
    "prediction_delta",
]

ArrayLike = Any  # np.ndarray | torch.Tensor | nested lists


class SeldonMessageError(ValueError):
    """Malformed message payload (maps to a FAILURE Status at the edge).
    ``http_code`` drives the FAILURE status code."""

    http_code = 400


class DispatchTimeoutError(SeldonMessageError):
    """Device dispatch exceeded the engine's per-dispatch deadline."""

    http_code = 504


class DeadlineExceededError(SeldonMessageError):
    """The caller's request-level deadline budget ran out."""

    http_code = 504


class LoadShedError(SeldonMessageError):
    """A deliberate refusal under overload (the generation lane's bounded
    admission queue): 503 at the edge, retryable downstream."""

    http_code = 503


# ---------------------------------------------------------------------------
# puid
# ---------------------------------------------------------------------------

_BASE32 = "abcdefghijklmnopqrstuvwxyz234567"
# byte -> base32 char of its low 5 bits (uniform: 256 = 8 * 32)
_B32_TABLE = bytes(ord(_BASE32[b & 31]) for b in range(256))
_PUID_LOCAL = threading.local()
_PUID_BATCH = 26 * 1024  # one urandom read per 1024 ids

# a forked child inherits the parent's buffer and would replay the same ids
os.register_at_fork(after_in_child=lambda: _PUID_LOCAL.__dict__.clear())


def new_puid() -> str:
    """130-bit random id: 26 chars of [a-z2-7] (the reference's
    ``PuidGenerator`` shape), drawn from per-thread ``os.urandom`` blocks."""
    loc = _PUID_LOCAL
    pos = getattr(loc, "pos", _PUID_BATCH)
    if pos >= _PUID_BATCH:
        loc.buf = os.urandom(_PUID_BATCH)
        pos = 0
    chunk = loc.buf[pos: pos + 26]
    loc.pos = pos + 26
    return chunk.translate(_B32_TABLE).decode("ascii")


# ---------------------------------------------------------------------------
# Status / Meta
# ---------------------------------------------------------------------------


@dataclass
class Status:
    """``Status{code, info, reason, status}`` (proto/prediction.proto:24-29)."""

    code: int = 200
    info: str = ""
    reason: str = ""
    status: str = "SUCCESS"  # SUCCESS | FAILURE

    @staticmethod
    def failure(info: str, code: int = 400, reason: str = "") -> "Status":
        return Status(code=code, info=info, reason=reason, status="FAILURE")

    def to_json_dict(self) -> dict:
        out: dict = {"code": self.code, "status": self.status}
        if self.info:
            out["info"] = self.info
        if self.reason:
            out["reason"] = self.reason
        return out

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Status":
        try:
            return Status(
                code=int(d.get("code", 0) or 0),
                info=str(d.get("info", "") or ""),
                reason=str(d.get("reason", "") or ""),
                status=str(d.get("status", "SUCCESS") or "SUCCESS"),
            )
        except (TypeError, ValueError, AttributeError) as e:
            raise SeldonMessageError(f"malformed status: {e}") from e


@dataclass
class Meta:
    """Request metadata carried across every graph hop: tags merge across
    nodes (later writers win), ``routing`` maps router name -> branch."""

    puid: str = ""
    tags: dict = field(default_factory=dict)
    routing: dict = field(default_factory=dict)
    requestPath: dict = field(default_factory=dict)

    def merged_with(self, other: "Meta") -> "Meta":
        """A child's meta merged into its parent's, the other's entries
        winning (engine PredictiveUnitBean.java:252-264)."""
        return Meta(
            puid=other.puid or self.puid,
            tags={**self.tags, **other.tags},
            routing={**self.routing, **other.routing},
            requestPath={**self.requestPath, **other.requestPath},
        )

    def to_json_dict(self) -> dict:
        out: dict = {"puid": self.puid}
        if self.tags:
            out["tags"] = dict(self.tags)
        if self.routing:
            out["routing"] = {k: int(v) for k, v in self.routing.items()}
        if self.requestPath:
            out["requestPath"] = dict(self.requestPath)
        return out

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Meta":
        try:
            return Meta(
                puid=str(d.get("puid", "") or ""),
                tags=dict(d.get("tags", {}) or {}),
                routing={k: int(v) for k, v in (d.get("routing", {}) or {}).items()},
                requestPath=dict(d.get("requestPath", {}) or {}),
            )
        except (TypeError, ValueError, AttributeError) as e:
            raise SeldonMessageError(f"malformed meta: {e}") from e


# ---------------------------------------------------------------------------
# DefaultData — the tensor payload
# ---------------------------------------------------------------------------


def _to_numpy(arr: ArrayLike) -> np.ndarray:
    """Host numpy view of a payload (serialization edges only); a torch
    tensor is read back from its device."""
    if isinstance(arr, np.ndarray):
        return arr
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


@dataclass
class DefaultData:
    """Named tensor payload.  ``kind`` is "tensor" (flat values + shape) or
    "ndarray" (nested lists); it only controls the wire form and is kept
    from request to response."""

    array: ArrayLike = None
    names: list = field(default_factory=list)
    kind: str = "tensor"  # "tensor" | "ndarray"

    @staticmethod
    def from_array(
        arr: ArrayLike, names: Optional[Sequence[str]] = None, kind: str = "tensor"
    ) -> "DefaultData":
        return DefaultData(array=arr, names=list(names or []), kind=kind)

    def numpy(self) -> np.ndarray:
        if self.array is None:
            raise SeldonMessageError("DefaultData has no array payload")
        return _to_numpy(self.array)

    def with_array(self, arr: ArrayLike, names: Optional[Sequence[str]] = None) -> "DefaultData":
        """New payload keeping this payload's wire kind (and names unless
        overridden)."""
        return DefaultData(
            array=arr,
            names=list(names) if names is not None else list(self.names),
            kind=self.kind,
        )

    def to_json_dict(self) -> dict:
        out: dict = {}
        if self.names:
            out["names"] = list(self.names)
        a = self.numpy()
        if self.kind == "ndarray":
            out["ndarray"] = a.tolist()
        else:
            out["tensor"] = {
                "shape": [int(s) for s in a.shape],
                "values": a.reshape(-1).astype(np.float64).tolist(),
            }
        return out

    @staticmethod
    def from_json_dict(d: Mapping[str, Any], dtype=np.float64) -> "DefaultData":
        names = list(d.get("names", []) or [])
        if "tensor" in d:
            t = d["tensor"]
            if not isinstance(t, Mapping) or "values" not in t:
                raise SeldonMessageError("data.tensor must have 'shape' and 'values'")
            try:
                values = np.asarray(t.get("values", []), dtype=dtype)
            except (ValueError, TypeError) as e:
                raise SeldonMessageError(f"data.tensor values: {e}") from e
            shape = [int(s) for s in t.get("shape", [values.size])]
            try:
                arr = values.reshape(shape)
            except ValueError as e:
                raise SeldonMessageError(f"tensor shape {shape} != #values {values.size}") from e
            return DefaultData(array=arr, names=names, kind="tensor")
        if "ndarray" in d:
            try:
                arr = np.asarray(d["ndarray"], dtype=dtype)
            except (ValueError, TypeError):
                # ragged / mixed-type ndarray: kept as an object array (the
                # reference's ListValue permits heterogenous entries)
                arr = np.asarray(d["ndarray"], dtype=object)
            return DefaultData(array=arr, names=names, kind="ndarray")
        raise SeldonMessageError("data must contain 'tensor' or 'ndarray'")


# ---------------------------------------------------------------------------
# SeldonMessage
# ---------------------------------------------------------------------------


@dataclass
class SeldonMessage:
    """The unit of exchange on every graph hop (proto/prediction.proto:12-22).
    At most one of ``data`` / ``bin_data`` / ``str_data`` is set."""

    data: Optional[DefaultData] = None
    bin_data: Optional[bytes] = None
    str_data: Optional[str] = None
    meta: Meta = field(default_factory=Meta)
    status: Optional[Status] = None

    @staticmethod
    def from_array(arr: ArrayLike, names: Optional[Sequence[str]] = None, kind: str = "tensor",
                   meta: Optional[Meta] = None) -> "SeldonMessage":
        return SeldonMessage(data=DefaultData.from_array(arr, names, kind), meta=meta or Meta())

    @staticmethod
    def failure(info: str, code: int = 400, meta: Optional[Meta] = None) -> "SeldonMessage":
        return SeldonMessage(status=Status.failure(info, code=code), meta=meta or Meta())

    @property
    def data_kind(self) -> str:
        """Which payload the message carries: ``data``, ``binData``,
        ``strData`` or ``empty``."""
        if self.data is not None:
            return "data"
        if self.bin_data is not None:
            return "binData"
        if self.str_data is not None:
            return "strData"
        return "empty"

    def array(self) -> np.ndarray:
        if self.data is None:
            raise SeldonMessageError("message has no DefaultData payload")
        return self.data.numpy()

    def names(self) -> list:
        return list(self.data.names) if self.data is not None else []

    def with_array(self, arr: ArrayLike, names: Optional[Sequence[str]] = None) -> "SeldonMessage":
        """Response builder: new array, preserved payload kind/meta."""
        if self.data is not None:
            new_data = self.data.with_array(arr, names)
        else:
            new_data = DefaultData.from_array(arr, names)
        return SeldonMessage(data=new_data, meta=self.meta, status=self.status)

    def to_json_dict(self) -> dict:
        out: dict = {"meta": self.meta.to_json_dict()}
        if self.status is not None:
            out["status"] = self.status.to_json_dict()
        if self.data is not None:
            out["data"] = self.data.to_json_dict()
        elif self.bin_data is not None:
            import base64

            out["binData"] = base64.b64encode(self.bin_data).decode("ascii")
        elif self.str_data is not None:
            out["strData"] = self.str_data
        return out

    def to_json(self) -> str:
        fast = self._to_json_fast()
        if fast is not None:
            return fast
        return json.dumps(self.to_json_dict(), separators=(",", ":"))

    def _to_json_fast(self) -> Optional[str]:
        """The native codec's document: the numeric payload formatted in
        C++ and spliced into the (small) rest, which ``json`` writes.  None
        (the caller writes it all with ``json``) for a small or non-numeric
        payload and for an integer or bool ndarray, which ``json`` writes
        as integers."""
        if self.data is None or self.data.array is None:
            return None
        a = _to_numpy(self.data.array)
        if a.dtype == object or a.dtype.kind not in "fiub" or a.size < 32:
            return None  # a small payload: json.dumps costs less than the call
        if self.data.kind == "ndarray" and a.dtype.kind != "f":
            return None
        from seldon_core_tpu_torch.native.fastcodec import format_data_fragment

        frag = format_data_fragment(a, self.data.kind)
        if frag is None:
            return None
        out: dict = {"meta": self.meta.to_json_dict()}
        if self.status is not None:
            out["status"] = self.status.to_json_dict()
        data_obj: dict = {}
        if self.data.names:
            data_obj["names"] = list(self.data.names)
        data_obj["__payload__"] = 0
        out["data"] = data_obj
        s = json.dumps(out, separators=(",", ":"))
        # the marker inside "data", the last member, is the last occurrence:
        # a tag KEY of that name is written earlier, and a string value
        # cannot match (its quotes are escaped)
        marker = '"__payload__":0'
        idx = s.rfind(marker)
        return s[:idx] + frag.decode("ascii") + s[idx + len(marker):]

    @staticmethod
    def from_json_dict(d: Mapping[str, Any], dtype=np.float64) -> "SeldonMessage":
        if not isinstance(d, Mapping):
            raise SeldonMessageError("SeldonMessage JSON must be an object")
        # protobuf JsonFormat treats explicit nulls as absent fields
        meta = d.get("meta") or {}
        if not isinstance(meta, Mapping):
            raise SeldonMessageError("meta must be an object")
        status = d.get("status")
        if status is not None and not isinstance(status, Mapping):
            raise SeldonMessageError("status must be an object")
        msg = SeldonMessage(
            meta=Meta.from_json_dict(meta),
            status=Status.from_json_dict(status) if status is not None else None,
        )
        if d.get("data") is not None:
            data = d["data"]
            if not isinstance(data, Mapping):
                raise SeldonMessageError("data must be an object")
            msg.data = DefaultData.from_json_dict(data, dtype=dtype)
        elif d.get("binData") is not None:
            import base64
            import binascii

            try:
                msg.bin_data = base64.b64decode(d["binData"], validate=True)
            except (binascii.Error, TypeError, ValueError) as e:
                raise SeldonMessageError(f"binData is not valid base64: {e}") from e
        elif d.get("strData") is not None:
            msg.str_data = str(d["strData"])
        return msg

    @staticmethod
    def from_json(s: Union[str, bytes], dtype=np.float64) -> "SeldonMessage":
        fast = SeldonMessage._from_json_fast(s, dtype)
        if fast is not None:
            return fast
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise SeldonMessageError(f"invalid JSON: {e}") from e
        return SeldonMessage.from_json_dict(d, dtype=dtype)

    @staticmethod
    def _from_json_fast(s: Union[str, bytes], dtype) -> Optional["SeldonMessage"]:
        """The native codec's parse: the envelope (the message without its
        numeric payload) through ``from_json_dict``, the payload as one
        float64 buffer.  None for whatever the codec declines, invalid
        JSON included, so the ``json`` path owns every error."""
        from seldon_core_tpu_torch.native.fastcodec import parse_message_fast

        fast = parse_message_fast(s)
        if fast is None:
            return None
        envelope, kind, arr = fast
        data_env = envelope.pop("data", None)
        msg = SeldonMessage.from_json_dict(envelope, dtype=dtype)
        if kind is not None:
            names = list((data_env or {}).get("names", []) or [])
            msg.data = DefaultData(array=arr if np.dtype(dtype) == arr.dtype
                                   else arr.astype(dtype), names=names, kind=kind)
        elif data_env is not None:
            # a data object with no payload member fails as the json path's
            raise SeldonMessageError("data must contain 'tensor' or 'ndarray'")
        return msg


@dataclass
class SeldonMessageList:
    """A COMBINER's input: one message per child branch
    (proto/prediction.proto:51-53)."""

    messages: list = field(default_factory=list)

    def to_json_dict(self) -> dict:
        return {"seldonMessages": [m.to_json_dict() for m in self.messages]}

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), separators=(",", ":"))

    @staticmethod
    def from_json_dict(d: Mapping[str, Any], dtype=np.float64) -> "SeldonMessageList":
        if not isinstance(d, Mapping):
            raise SeldonMessageError("SeldonMessageList JSON must be an object")
        return SeldonMessageList(messages=[SeldonMessage.from_json_dict(m, dtype=dtype)
                                           for m in d.get("seldonMessages", []) or []])

    @staticmethod
    def from_json(s: Union[str, bytes], dtype=np.float64) -> "SeldonMessageList":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise SeldonMessageError(f"invalid JSON: {e}") from e
        return SeldonMessageList.from_json_dict(d, dtype=dtype)


@dataclass
class Feedback:
    """Online-learning signal (proto/prediction.proto:55-60): the original
    request/response pair plus a scalar reward and optional ground truth."""

    request: Optional[SeldonMessage] = None
    response: Optional[SeldonMessage] = None
    reward: float = 0.0
    truth: Optional[SeldonMessage] = None

    def puid(self) -> str:
        """Correlation id of this feedback: the served response's puid when
        present, else the original request's."""
        if self.response is not None and self.response.meta.puid:
            return self.response.meta.puid
        if self.request is not None and self.request.meta.puid:
            return self.request.meta.puid
        return ""

    def prediction_array(self) -> Optional[np.ndarray]:
        """The served prediction tensor (``response.data``) as numpy, or
        None: what the quality observatory compares the truth with."""
        if self.response is not None and self.response.data is not None:
            return np.asarray(self.response.array())
        return None

    def truth_array(self) -> Optional[np.ndarray]:
        """The ground-truth tensor (``truth.data``) as numpy, or None."""
        if self.truth is not None and self.truth.data is not None:
            return np.asarray(self.truth.array())
        return None

    def to_json_dict(self) -> dict:
        out: dict = {"reward": float(self.reward)}
        if self.request is not None:
            out["request"] = self.request.to_json_dict()
        if self.response is not None:
            out["response"] = self.response.to_json_dict()
        if self.truth is not None:
            out["truth"] = self.truth.to_json_dict()
        return out

    @staticmethod
    def from_json_dict(d: Mapping[str, Any], dtype=np.float64) -> "Feedback":
        if not isinstance(d, Mapping):
            raise SeldonMessageError("Feedback JSON must be an object")

        def _msg(key: str) -> Optional[SeldonMessage]:
            v = d.get(key)
            return SeldonMessage.from_json_dict(v, dtype=dtype) if v is not None else None

        try:
            reward = float(d.get("reward", 0.0) or 0.0)
        except (TypeError, ValueError) as e:
            raise SeldonMessageError(f"malformed reward: {e}") from e
        return Feedback(request=_msg("request"), response=_msg("response"), reward=reward,
                        truth=_msg("truth"))

    @staticmethod
    def from_json(s: Union[str, bytes], dtype=np.float64) -> "Feedback":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise SeldonMessageError(f"invalid JSON: {e}") from e
        return Feedback.from_json_dict(d, dtype=dtype)

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), separators=(",", ":"))


def prediction_delta(live: Optional["SeldonMessage"], other: Optional["SeldonMessage"],
                     atol: float = 1e-6) -> dict:
    """How far two answers to one request disagree — the rule of the shadow
    mirror (``gateway/shadow.py``), as ``messages.prediction_delta`` of the
    JAX package states it.  Returns ``{"comparable", "disagree",
    "mean_abs_delta"}``:

      * both failed: they agree (``disagree`` 0.0, not comparable);
      * one failed, the payload kinds or the shapes differ, or the tensor is
        empty: ``disagree`` 1.0, not comparable;
      * strData / binData: 0.0 when the bytes are equal, else 1.0;
      * a [rows, classes > 1] tensor: the fraction of rows whose argmax
        differs; any other tensor: the fraction of elements further apart
        than ``atol``.

    Both answers are host messages: their arrays are numpy."""
    full = {"comparable": False, "disagree": 1.0, "mean_abs_delta": None}

    def failed(m: Optional["SeldonMessage"]) -> bool:
        return m is None or (m.status is not None and m.status.status == "FAILURE")

    if failed(live) and failed(other):
        return {"comparable": False, "disagree": 0.0, "mean_abs_delta": None}
    if failed(live) or failed(other) or live.data_kind != other.data_kind:
        return full
    if live.data_kind != "data":
        same = live.str_data == other.str_data and live.bin_data == other.bin_data
        return {"comparable": True, "disagree": 0.0 if same else 1.0, "mean_abs_delta": None}
    a = np.asarray(live.array(), dtype=np.float64)
    b = np.asarray(other.array(), dtype=np.float64)
    if a.shape != b.shape or a.size == 0:
        return full
    mean_abs = float(np.mean(np.abs(a - b)))
    if a.ndim == 2 and a.shape[1] > 1:
        disagree = float(np.mean(np.argmax(a, axis=1) != np.argmax(b, axis=1)))
    else:
        disagree = float(np.mean(np.abs(a - b) > atol))
    return {"comparable": True, "disagree": disagree, "mean_abs_delta": round(mean_abs, 9)}
