"""Device choice for the port: CUDA unless the caller asks for the CPU.

Every entry point (engine, unit, converter) resolves its ``device``
argument here, and every unit its ``dtype`` parameter.  The default is ``cuda``; asking for CUDA on a machine
without it raises instead of quietly serving on the CPU, so a run that
was meant for the card can never report CPU numbers as if they were
the card's.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "parse_dtype", "launch_on"]

DeviceLike = Union[str, torch.device, None]

#: the ``dtype`` values a deployment may give a unit
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def parse_dtype(dtype: str) -> torch.dtype:
    """A unit's ``dtype`` parameter ("bfloat16", ...) as a torch dtype."""
    if str(dtype) not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not one of {sorted(DTYPES)}")
    return DTYPES[str(dtype)]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises ``RuntimeError`` when a CUDA device
    is asked for and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            f"(torch.cuda.is_available() is False); pass device='cpu' "
            f"(--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


#: the devices whose context each thread has made current (``launch_on``)
_THREAD = threading.local()


def _context_current(index: int) -> None:
    """Make device ``index``'s primary context current on this thread, once
    a thread.  A thread whose current device already is ``index`` and that
    has made no CUDA call of its own (a mesh shard's thread whose tensors
    already lie on its card) has no context current; a kernel library's
    launch there fails its TMA encode with "invalid argument".  A stream
    query is a runtime call that makes the context current, and waits on
    nothing."""
    seen = getattr(_THREAD, "devices", None)
    if seen is None:
        seen = _THREAD.devices = set()
    if index not in seen:
        with torch.cuda.device(index):
            torch.cuda.current_stream(index).query()
        seen.add(index)


def launch_on(device: torch.device, launch, *args) -> int:
    """``launch(*args, stream)``: a kernel's ctypes launch on ``device``'s
    current CUDA stream, with ``device`` current while it runs (and its
    context current on this thread, ``_context_current``); returns its
    code.  Reads the raw stream handle, and enters a device context only
    when ``device`` is not current already: the ``torch.cuda.device``
    context and ``current_stream(device).cuda_stream`` cost the host more
    than the rest of a decode wrapper, which runs 24 times per step."""
    index = torch.cuda.current_device() if device.index is None else device.index
    _context_current(index)
    if torch.cuda.current_device() == index:
        return launch(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return launch(*args, torch._C._cuda_getCurrentRawStream(index))
