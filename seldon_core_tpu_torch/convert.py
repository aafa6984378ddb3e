"""Carry weights across from the JAX package.

``params_from_jax`` takes a unit's state as the JAX package holds it
(``CompiledGraph(...).states["mnist"]``, or a generator's nested
``{"params": {"embed", "l0": {...}, ..., "ln_f"}, "requests"}``, after
``np.asarray`` on each array) and returns the port's state, with the same
nesting, on a device, ready for ``EngineService.load_states({name: ...})``.

Every unit's state carries this way: the MLP and the convnet (whose conv
weights keep the JAX package's HWIO layout in the port's state), the
generators, the tabular and iris units, the outlier's running statistics
and a router's ``success`` / ``tries``.  A router's key cannot carry: the
port's keys (``models/prng.py``) are not ``jax.random``'s, so keep the
port's own, ``{**port_state, **params_from_jax({"success": ..., "tries":
...})}``.

A state the reference holds over a mesh (a ``mesh_axes`` unit's params
sharded by ``param_shardings``, a ``SharedEnsembleUnit``'s stacked member
states split over ``ens``) carries the same way: ``np.array`` of a sharded
``jax.Array`` gathers it whole, and ``layout`` (the port unit's
``shard_state``) then splits it over the port unit's mesh by the port's
layout, which is the reference's.  The reference's pipeline tree
(``lm_pipeline_params``: ``{embed, ln_f, stages}``, the stages stacked
``[pp, layers_per_stage, ...]``) carries with ``layout=lambda t:
shard_pipeline_params(t, mesh)`` (``models/transformer.py``): each ``pp``
shard then holds its stage.

bf16 arrays arrive with an ``ml_dtypes`` dtype whose name is "bfloat16".
They are taken by bit pattern (uint16 view -> torch -> bfloat16 view), so
the values are identical and ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(arrays: Mapping[str, Any], device: DeviceLike = None,
                    layout: Optional[Callable[[Any], Any]] = None) -> Any:
    dev = resolve_device(device)
    state = {name: _convert(arr, dev) for name, arr in arrays.items()}
    return state if layout is None else layout(state)


def _convert(arr, dev: torch.device):
    if isinstance(arr, Mapping):
        return {name: _convert(a, dev) for name, a in arr.items()}
    # a private, writable copy: np.asarray of a jax array is read-only,
    # and the returned tensor must not alias the caller's buffer
    a = np.array(arr, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)
