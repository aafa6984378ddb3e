"""Adam, the one ``optax`` transform the JAX package trains with.

``adam(lr)`` computes what ``optax.adam(lr)`` computes, step for step:
``scale_by_adam`` then ``scale_by_learning_rate``, over nested dicts of
tensors.  The moments ``mu`` and ``nu`` are kept in the params' dtype (bf16
params keep bf16 moments, as optax does), the step count is int32, the
bias correction ``1 - b**t`` is taken in f32 and cast to the moment's dtype
before the division, and ``update = mu_hat / (sqrt(nu_hat + eps_root) +
eps)`` with ``eps_root = 0``, times ``-lr``.  Each elementwise operation
rounds in the moment's dtype where optax's does.  Plain torch operations:
an optimizer update is a few passes over the parameters, with no kernel of
the JAX package behind it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from seldon_core_tpu_torch.tree import tree_leaves, tree_map

__all__ = ["GradientTransformation", "adam"]

_INT32_MAX = 2 ** 31 - 1


class GradientTransformation(NamedTuple):
    """``optax.GradientTransformation``: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(learning_rate, b1, b2, eps)`` (``eps_root`` 0, no
    Nesterov momentum, moments in the params' dtype).  The state is
    ``{"count": int32 [], "mu": tree, "nu": tree}``."""

    def init(params) -> Dict[str, Any]:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        del params
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state["nu"])
        count = state["count"]
        count = torch.where(count < _INT32_MAX, count + 1, count)  # optax's safe_increment
        t = count.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t

        def step(m, v):
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            return (m_hat / (torch.sqrt(v_hat) + eps)) * (-learning_rate)  # eps_root 0

        return tree_map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)
