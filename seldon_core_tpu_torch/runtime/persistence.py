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

A PRNG key (``models/prng.py``: an int64 tensor ``[..., 2]`` of two 32-bit
words, the only int64 leaves of that shape in the port's states) is
written under the reference's ``__prngkey__:`` prefix as ``uint32`` words,
as ``jax.random.key_data`` writes a key, so a bandit's file crosses both
ways: counters exactly, a key as its two words (the stream drawn from them
is each package's own; a port -> port restore continues the same stream
bit for bit).

Unit-state persistence (reference ``:75-121``): ``checkpoint_path`` is
``$SELDON_TPU_STATE_DIR/{SELDON_DEPLOYMENT_ID}_{PREDICTOR_ID}_{unit}.ckpt.npz``
(defaults ``~/.seldon_tpu_state``, ``local``, ``default``), ``save_state`` /
``load_state`` write and read a unit's state there, ``restore_runtime``
loads it into a node runtime at boot, and ``persist_loop`` saves every
``PERSISTENCE_FREQUENCY`` seconds (60) on a worker thread, so a large
state's ``np.savez`` never holds the event loop.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.tree import leaves_with_paths, tree_unflatten

__all__ = ["state_to_host", "state_from_host", "save_state_to_path", "checkpoint_path",
           "save_state", "load_state", "restore_runtime", "persist_loop"]

logger = logging.getLogger(__name__)

_KEY_PREFIX = "__prngkey__:"


def _is_key(leaf) -> bool:
    """A ``models/prng.py`` key: an int64 tensor ``[..., 2]``."""
    return (torch.is_tensor(leaf) and leaf.dtype == torch.int64 and leaf.ndim >= 1
            and leaf.shape[-1] == 2)


def _to_host(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def state_to_host(state) -> Dict[str, np.ndarray]:
    """Flatten a tree to ``{keystr path: ndarray}`` (npz-safe); a PRNG key
    goes under ``__prngkey__:`` as its uint32 words."""
    return {(_KEY_PREFIX + key if _is_key(leaf) else key):
            (_to_host(leaf).astype(np.uint32) if _is_key(leaf) else _to_host(leaf))
            for key, leaf in leaves_with_paths(state)}


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
    leaves = []
    for key, leaf in leaves_with_paths(like):
        if _KEY_PREFIX + key in flat:  # a key's words, from either package
            leaf = _from_host(np.asarray(flat[_KEY_PREFIX + key]).astype(np.int64), leaf)
        elif key in flat:
            leaf = _from_host(flat[key], leaf)
        leaves.append(leaf)
    return tree_unflatten(like, leaves)


def save_state_to_path(path: str, state) -> str:
    """Atomic npz snapshot of a tree (tmp-write + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **state_to_host(state))
    os.replace(tmp, path)
    return path


def checkpoint_path(unit_name: str) -> str:
    """The unit's checkpoint file (its directory made if missing)."""
    base = os.environ.get("SELDON_TPU_STATE_DIR", os.path.expanduser("~/.seldon_tpu_state"))
    dep = os.environ.get("SELDON_DEPLOYMENT_ID", "local")
    pred = os.environ.get("PREDICTOR_ID", "default")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"{dep}_{pred}_{unit_name}.ckpt.npz")


def save_state(unit_name: str, state) -> Optional[str]:
    """Snapshot a unit's state to its checkpoint (None for a stateless
    unit)."""
    if state is None:
        return None
    return save_state_to_path(checkpoint_path(unit_name), state)


def load_state(unit_name: str, like) -> Any:
    """The unit's checkpointed state in the structure (and on the devices)
    of ``like``, or ``like`` when there is no checkpoint."""
    path = checkpoint_path(unit_name)
    if not os.path.exists(path):
        return like
    with np.load(path) as data:
        return state_from_host(dict(data), like)


def restore_runtime(runtime) -> None:
    """Restore on boot (``microservice.py:157-159`` of the reference's
    wrapper): a node runtime's state from its checkpoint."""
    runtime.state = load_state(runtime.node.name, runtime.state)


async def persist_loop(runtime, frequency_s: Optional[float] = None) -> None:
    """Save the runtime's state every ``frequency_s`` seconds
    (``PERSISTENCE_FREQUENCY``, 60) until cancelled; each save runs on a
    worker thread, and a failed one is logged and serving goes on."""
    freq = frequency_s or float(os.environ.get("PERSISTENCE_FREQUENCY", "60"))
    while True:
        await asyncio.sleep(freq)
        try:
            await asyncio.to_thread(save_state, runtime.node.name, runtime.state)
        except Exception:  # noqa: BLE001 - keep serving if a checkpoint fails
            logger.exception("state checkpoint failed")
