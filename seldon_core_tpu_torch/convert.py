"""Carry weights across from the JAX package.

``params_from_jax`` takes a unit's state as the JAX package holds it
(``CompiledGraph(...).states["mnist"]`` after ``np.asarray`` on each
array) and returns the port's param dict on a device, ready for
``EngineService.load_states({"mnist": ...})``.

bf16 arrays arrive with an ``ml_dtypes`` dtype whose name is "bfloat16".
They are taken by bit pattern (uint16 view -> torch -> bfloat16 view), so
the values are identical and ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(arrays: Mapping[str, np.ndarray], device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in arrays.items():
        # a private, writable copy: np.asarray of a jax array is read-only,
        # and the returned tensor must not alias the caller's buffer
        a = np.array(arr, order="C", copy=True)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(dev)
    return out
