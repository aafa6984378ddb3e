"""Device choice for the port: CUDA unless the caller asks for the CPU.

Every entry point (engine, unit, converter) resolves its ``device``
argument here, and every unit its ``dtype`` parameter.  The default is ``cuda``; asking for CUDA on a machine
without it raises instead of quietly serving on the CPU, so a run that
was meant for the card can never report CPU numbers as if they were
the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "parse_dtype"]

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
