"""Graph-walk helpers shared by the executors — the port's counterpart of
``seldon_core_tpu/graph/interpreter.py:66-133``.

Only the helpers live here so far: the method-dispatch table
(engine PredictorConfigBean.java:33-82), tag conversion, and the per-unit
random generators.  The host-mode ``GraphExecutor`` (routers, remote
nodes, quorum and fallback) is not ported yet.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.graph.spec import (
    PredictiveUnit,
    UnitImplementation,
    UnitMethod,
    UnitType,
)

__all__ = ["effective_type", "methods_for", "pythonize_tags", "unit_rngs"]


def unit_rngs(names: Iterable[str], seed: Optional[int] = None) -> Dict[str, torch.Generator]:
    """One CPU ``torch.Generator`` per unit, seeded from the graph seed and
    the crc32 of the unit's NAME (the JAX package folds the same crc32 into
    its key), so a unit's state never depends on which other units share
    its graph.  torch and ``jax.random`` draw different numbers from the
    same seed: carry weights across with ``convert.params_from_jax`` where
    the two must agree."""
    base = 0 if seed is None else int(seed)
    out = {}
    for name in names:
        g = torch.Generator(device="cpu")
        g.manual_seed(((base & 0xFFFFFFFF) << 32) | zlib.crc32(name.encode()))
        out[name] = g
    return out


_TYPE_METHODS = {
    UnitType.MODEL: [UnitMethod.TRANSFORM_INPUT],
    UnitType.ROUTER: [UnitMethod.ROUTE, UnitMethod.SEND_FEEDBACK],
    UnitType.COMBINER: [UnitMethod.AGGREGATE],
    UnitType.TRANSFORMER: [UnitMethod.TRANSFORM_INPUT],
    UnitType.OUTPUT_TRANSFORMER: [UnitMethod.TRANSFORM_OUTPUT],
}

_IMPL_TYPES = {
    UnitImplementation.SIMPLE_MODEL: UnitType.MODEL,
    UnitImplementation.SIMPLE_ROUTER: UnitType.ROUTER,
    UnitImplementation.RANDOM_ABTEST: UnitType.ROUTER,
    UnitImplementation.AVERAGE_COMBINER: UnitType.COMBINER,
}


def effective_type(node: PredictiveUnit) -> Optional[UnitType]:
    if node.type is not None:
        return node.type
    return _IMPL_TYPES.get(node.implementation)


def methods_for(node: PredictiveUnit) -> List[UnitMethod]:
    """Explicit ``methods`` win; otherwise the type's default set."""
    if node.methods is not None:
        return list(node.methods)
    return list(_TYPE_METHODS.get(effective_type(node), []))


def pythonize_tags(tags: Dict[str, Any]) -> Dict[str, Any]:
    """Tag values (tensors on any device, numpy, scalars) -> JSON-safe
    python values."""
    out: Dict[str, Any] = {}
    for k, v in (tags or {}).items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        out[k] = a.item() if a.ndim == 0 else a.tolist()
    return out
