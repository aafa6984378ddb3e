"""The flat-pytree ``.npz`` format of ``seldon_core_tpu/runtime/persistence.py``
over nested dicts of tensors: the train -> serve checkpoint hand-off.

A file is one ``.npz`` whose member names are the leaves'
``jax.tree_util.keystr`` paths (``"['l0']['wqkv']"``), so a file written by
either package loads in the other.  bfloat16 leaves are written as the
``|V2`` bit pattern the JAX package writes for them (numpy has no
bfloat16; no ``ml_dtypes`` is needed here).  On load, a ``|V2`` leaf is
taken as bfloat16 bits and every leaf is cast to the serving leaf's dtype
(round to nearest even, as ``astype`` does), on the serving leaf's device.

The JAX package cannot cast a ``|V2`` leaf back (its ``state_from_host``
raises "No cast function available"), so a bf16 checkpoint, from either
package, reloads in the port only; f32 checkpoints cross both ways.

Unit-state persistence (``save_state``, ``load_state``,
``restore_runtime``, ``persist_loop``) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from seldon_core_tpu_torch.tree import leaves_with_paths, tree_unflatten

__all__ = ["state_to_host", "state_from_host", "save_state_to_path"]


def _to_host(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def state_to_host(state) -> Dict[str, np.ndarray]:
    """Flatten a tree to ``{keystr path: ndarray}`` (npz-safe)."""
    return {key: _to_host(leaf) for key, leaf in leaves_with_paths(state)}


def _from_host(arr: np.ndarray, like):
    if not torch.is_tensor(like):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def state_from_host(flat: Dict[str, np.ndarray], like) -> Any:
    """A tree with the structure of ``like`` from a flat dict; a leaf the
    dict lacks keeps its current value."""
    leaves = [_from_host(flat[key], leaf) if key in flat else leaf
              for key, leaf in leaves_with_paths(like)]
    return tree_unflatten(like, leaves)


def save_state_to_path(path: str, state) -> str:
    """Atomic npz snapshot of a tree (tmp-write + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **state_to_host(state))
    os.replace(tmp, path)
    return path
