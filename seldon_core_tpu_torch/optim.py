"""Adam, the one ``optax`` transform the JAX package trains with, and the
functional step every trainer of the port takes (``grad_update``).

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

from seldon_core_tpu_torch.parallel.mesh import ShardedTree, sum_replicas
from seldon_core_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["GradientTransformation", "adam", "grad_update"]

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
    ``{"count": int32 [], "mu": tree, "nu": tree}``; over a ``ShardedTree``
    of params, a ``ShardedTree`` of such states, one a shard, and
    ``update`` takes and returns them shard by shard."""

    def init(params) -> Dict[str, Any]:
        if isinstance(params, ShardedTree):
            return ShardedTree(params.mesh, [None if p is None else init(p)
                                             for p in params.shards])
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        if isinstance(grads, ShardedTree):
            pairs = [(None, None) if g is None else update(g, st)
                     for g, st in zip(grads.shards, state.shards)]
            return (ShardedTree(grads.mesh, [u for u, _ in pairs], grads.specs),
                    ShardedTree(grads.mesh, [st for _, st in pairs]))
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


def grad_update(loss_fn: Callable, params, opt_state, batch, optimizer):
    """(params', opt_state', loss): the loss and its gradient over every
    leaf, the optimizer's updates, ``p + u`` in each param's dtype.
    Functional, as in JAX: the inputs are not changed.

    Over a ``ShardedTree`` (``loss_fn`` runs the forward over its mesh and
    returns one scalar whose graph reaches every shard's leaves): the
    backward is taken once, here, outside any shard, over the run's one
    autograd graph (``parallel/mesh.py``, Autograd), so the collectives'
    adjoints are the graph's copy edges; a leaf a shard's loss never reads
    gets a zero gradient; each replicated leaf's gradient is summed over
    its copies (``sum_replicas``, by the params' specs), so every copy takes
    the same update and the copies stay bit-identical; then the optimizer
    runs shard by shard.  Over a mesh that spans processes each process
    does all of this for its own shards: the forward under the mesh's tape
    and the backward over its part of the graph, seeded on the process
    that owns shard 0 (``DeviceMesh.value_and_grad``), the exchanges'
    adjoints carrying the gradients between processes."""
    if not isinstance(params, ShardedTree):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(live)))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tree_map(lambda p, u: p + u.to(p.dtype), params, updates), opt_state, loss.detach()
    mesh = params.mesh
    live = ShardedTree(mesh, [None if s is None else
                              tree_map(lambda p: p.detach().requires_grad_(True), s)
                              for s in params.shards], params.specs)
    flat = {i: tree_leaves(live.shards[i]) for i in mesh.owned}
    loss, got = mesh.value_and_grad(lambda: loss_fn(live, batch),
                                    [t for f in flat.values() for t in f])
    got = iter(got)
    grads = [tree_unflatten(live.shards[i],
                            [g if (g := next(got)) is not None else torch.zeros_like(t)
                             for t in flat[i]]) if i in flat else None
             for i in range(mesh.size)]
    grads = sum_replicas(ShardedTree(mesh, grads, params.specs))
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return (ShardedTree(mesh, [None if p is None else tree_map(lambda p, u: p + u.to(p.dtype), p, u)
                               for p, u in zip(params.shards, updates.shards)], params.specs),
            opt_state, loss)
