"""Device choice for the port: CUDA unless the caller asks for the CPU.

Every entry point (engine, unit, converter) resolves its ``device``
argument here.  The default is ``cuda``; asking for CUDA on a machine
without it raises instead of quietly serving on the CPU, so a run that
was meant for the card can never report CPU numbers as if they were
the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


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
