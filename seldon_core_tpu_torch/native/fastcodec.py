"""Bindings of the native SeldonMessage JSON codec (``csrc/fastcodec.cpp``).

The C++ side splits a message into a small verbatim "envelope" (the
message without its numeric payload) and a contiguous float64 buffer, so
parsing a 784-feature request costs one copy instead of ~800 Python
objects; the formatter writes a payload fragment whose every double reads
back exactly, NaN and the infinities spelled as Python's ``json`` spells
them (``NaN``, ``Infinity``, ``-Infinity``).

Loading order, as the reference's: the CPython extension
(``csrc/fastcodec_pymod.cpp``, the cheapest call), else the plain-C library
through ctypes, else ``native_available() == False`` and callers use the
pure-Python codec.  Both are built with g++ at first use into
``build/native/`` (``native/_build.py``); a build that fails is recorded
with the compiler's stderr (``codec_status()``), never dropped silently.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from seldon_core_tpu_torch.native import _build

__all__ = ["native_available", "parse_message_fast", "format_data_fragment",
           "codec_status"]

_lock = threading.Lock()
_lib = None
_ext = None
_attempted = False
#: library name -> the error its build or load raised
_ERRORS: Dict[str, str] = {}

SM_OK = 0
KIND_NONE, KIND_TENSOR, KIND_NDARRAY = 0, 1, 2


class _SMView(ctypes.Structure):
    _fields_ = [
        ("status", ctypes.c_int32),
        ("kind", ctypes.c_int32),
        ("ndim", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
        ("nvalues", ctypes.c_longlong),
        ("envelope_len", ctypes.c_longlong),
        ("envelope", ctypes.c_void_p),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("shape", ctypes.POINTER(ctypes.c_longlong)),
    ]


def _load_ext():
    path = _build.build("fastcodec_pymod")
    spec = importlib.util.spec_from_file_location("_fastcodec", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_lib():
    lib = ctypes.CDLL(str(_build.build("fastcodec")))
    lib.sm_parse_view.restype = ctypes.c_void_p
    lib.sm_parse_view.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                  ctypes.POINTER(_SMView)]
    lib.sm_free.restype = None
    lib.sm_free.argtypes = [ctypes.c_void_p]
    lib.sm_format.restype = ctypes.c_void_p  # malloc'd; freed by sm_buf_free
    lib.sm_format.argtypes = [ctypes.POINTER(ctypes.c_double),
                              ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_longlong)]
    lib.sm_buf_free.restype = None
    lib.sm_buf_free.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> None:
    """Build and load the extension, else the ctypes library, once."""
    global _lib, _ext, _attempted
    with _lock:
        if _attempted:
            return
        _attempted = True
        try:
            _ext = _load_ext()
            return
        except Exception as e:  # noqa: BLE001 - recorded, and the library tried next
            _ERRORS["fastcodec_pymod"] = f"{type(e).__name__}: {e}"
        try:
            _lib = _load_lib()
        except Exception as e:  # noqa: BLE001 - recorded; the Python codec serves
            _ERRORS["fastcodec"] = f"{type(e).__name__}: {e}"


def native_available() -> bool:
    """Whether either binding loaded (building it at the first call)."""
    _load()
    return _ext is not None or _lib is not None


def codec_status() -> dict:
    """Which binding serves (``"extension"``, ``"ctypes"`` or None) and the
    error of each one that failed to build or load."""
    _load()
    binding = "extension" if _ext is not None else "ctypes" if _lib is not None else None
    return {"binding": binding, "errors": dict(_ERRORS)}


def parse_message_fast(raw) -> Optional[Tuple[dict, Optional[str], Optional[np.ndarray]]]:
    """``(envelope dict, kind, array)``: ``kind`` is "tensor", "ndarray" or
    None (no numeric payload) and ``array`` the float64 payload; or None
    when no binding loaded or the codec declines the message (the caller
    takes the Python parser, invalid JSON included, so error text is the
    same either way)."""
    _load()
    if _ext is not None:
        r = _ext.parse(raw)
        if r is None:
            return None
        env_bytes, kind_code, arr = r
        envelope = _envelope(env_bytes)
        if envelope is None:
            return None
        if kind_code == KIND_NONE:
            return envelope, None, None
        return envelope, ("tensor" if kind_code == KIND_TENSOR else "ndarray"), arr
    if _lib is None:
        return None
    if isinstance(raw, str):
        raw = raw.encode("utf-8")
    view = _SMView()
    h = _lib.sm_parse_view(raw, len(raw), ctypes.byref(view))
    if not h:
        return None
    try:
        if view.status != SM_OK:
            return None
        envelope = _envelope(ctypes.string_at(view.envelope, view.envelope_len)
                             if view.envelope else b"{}")
        if envelope is None:
            return None
        if view.kind == KIND_NONE:
            return envelope, None, None
        shape = tuple(view.shape[i] for i in range(view.ndim))
        arr = np.empty((view.nvalues,), dtype=np.float64)
        if view.nvalues:
            ctypes.memmove(arr.ctypes.data, view.values, view.nvalues * 8)
        kind = "tensor" if view.kind == KIND_TENSOR else "ndarray"
        return envelope, kind, arr.reshape(shape)
    finally:
        _lib.sm_free(h)


def _envelope(env_bytes: bytes) -> Optional[dict]:
    if not env_bytes or env_bytes == b"{}":
        return {}  # a bare-data message: no parse
    try:
        return json.loads(env_bytes)
    except ValueError:  # the envelope is always valid JSON; be safe
        return None


def format_data_fragment(arr, kind: str) -> Optional[bytes]:
    """``arr`` as the JSON fragment ``"tensor":{...}`` or ``"ndarray":[...]``
    (no braces around it), or None when no binding loaded."""
    a = np.ascontiguousarray(arr, dtype=np.float64)
    if a.ndim == 0:
        a = a.reshape(1)
    kind_code = KIND_TENSOR if kind == "tensor" else KIND_NDARRAY
    _load()
    if _ext is not None:
        return _ext.format(a, kind_code)
    if _lib is None:
        return None
    shape = (ctypes.c_longlong * a.ndim)(*a.shape)
    out_len = ctypes.c_longlong(0)
    buf = _lib.sm_format(a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), shape, a.ndim,
                         kind_code, ctypes.byref(out_len))
    if not buf:
        return None
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        _lib.sm_buf_free(buf)
