"""Mixture-of-experts layer on one device — the port's counterpart of
``seldon_core_tpu/parallel/moe.py:32-173``.

The arithmetic is the reference's: a router in f32 (``wg`` is an f32
leaf, the logits ``xt.float() @ wg``), ``k`` argmax rounds over the gate
probabilities with the experts already taken masked to ``-inf``, a fixed
per-expert capacity ``C = max(1, ceil(k * T * capacity_factor / E))``
over the whole flattened token stream (``T = B * S``, rows row-major,
earlier tokens win slots, later rounds queue behind the slots that
earlier rounds used), combine weights renormalised over the kept choices
for ``k > 1`` (the raw gate for ``k == 1``) and cast to the activation
dtype before the combine product, a token with no kept choice passing its
input through, and the Switch-style load-balance loss ``E * sum_e f_e *
p_e`` with ``f_e`` the top-1 argmax density.

The representation differs: the reference builds one-hot dispatch and
combine tensors ``[T, E, C]`` and contracts them with einsums; the port
carries the routing as index tensors (``Routing``: expert, slot, weight
and kept, each ``[T, k]``), gathers the kept tokens into ``[E, C, D]``
and gathers the expert outputs back.  Each ``(expert, slot)`` holds at
most one token, so the gather is the einsum's exact value; at a training
shape (T = 8,192, C = 2,560, E = 8) a one-hot tensor would be 168 M f32
elements a layer.  The expert FFN is two batched matmuls (``torch.bmm``)
with ``gelu(approximate="tanh")`` between them, as ``jax.nn.gelu``.  The
layer has no Pallas kernel in the reference, so it has no hand-written
kernel here.  Gradients reach ``wg`` through the combine weights and
through the load-balance loss's mean gates, as under ``jax.grad``.  No
step reads a device value back to the host (no boolean-mask indexing, no
``one_hot`` or ``bincount``, whose CUDA versions sync), so a decode
step's MoE layers enqueue without waiting on the card.

Expert parallelism (``moe.py:60-79``, ``:129-173``): ``moe_leaf_spec`` is
the one source of the MoE layout (the expert stacks ``w1``/``w2`` split
along their expert axis over ``ep``, the router replicated), used here
and by the LM's ``param_shardings``; ``moe_param_shardings`` is it over a
tree.  On an ``ep`` shard (``parallel/mesh.py``) the routing is computed
on every shard (the router and the tokens are replicated), each shard
runs its ``E / ep`` experts' products on its slice of the ``[E, C, D]``
dispatch, and ``all_gather`` over ``ep`` joins the slices before the
combine: the all-to-all GSPMD inserts in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.parallel.mesh import (ShardedTree, all_gather, axis_index, axis_size,
                                                 spmd_call)

__all__ = ["MoEConfig", "Routing", "moe_init", "moe_apply", "moe_leaf_spec",
           "moe_param_shardings"]


@dataclass(frozen=True)
class MoEConfig:
    """``moe.py:32-39`` with a torch dtype."""

    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 8
    k: int = 2                    # top-k routing (1 = Switch)
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def moe_init(rng: torch.Generator, cfg: MoEConfig, device=None) -> Dict[str, Any]:
    """The router ``wg`` [D, E] in f32 and the expert stacks ``w1`` [E, D,
    F] and ``w2`` [E, F, D] in ``cfg.dtype``, drawn from ``rng`` (a CPU
    generator) in that order with the reference's scales."""
    def normal(shape, fan_in):
        return torch.randn(shape, generator=rng, dtype=torch.float32).mul_(fan_in ** -0.5)

    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "wg": normal((D, E), D).to(device),
        "w1": normal((E, D, Fd), D).to(device=device, dtype=cfg.dtype),
        "w2": normal((E, Fd, D), Fd).to(device=device, dtype=cfg.dtype),
    }


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    return max(1, math.ceil(cfg.k * n_tokens * cfg.capacity_factor / cfg.n_experts))


class Routing(NamedTuple):
    """A token's ``k`` choices, each ``[T, k]``: the expert, its queue slot
    (meaningful where kept), the combine weight (f32, 0 where dropped) and
    whether the choice was kept under capacity."""

    expert: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    kept: torch.Tensor


def _route(gates: torch.Tensor, cfg: MoEConfig, capacity: int) -> Routing:
    """Top-k routing with capacity from gates [T, E] (``moe.py:86-126``)."""
    T, E = gates.shape
    if cfg.k > E:
        # argmax over an all -inf row would silently re-pick expert 0 and
        # double-consume its capacity slots
        raise ValueError(f"k={cfg.k} > n_experts={E}")
    taken = torch.zeros((T, E), dtype=torch.bool, device=gates.device)
    used = torch.zeros((E,), dtype=torch.int64, device=gates.device)
    rows = torch.arange(T, device=gates.device)
    ids = torch.arange(E, device=gates.device)
    experts, slots, vals, keeps = [], [], [], []
    g = gates.detach()
    for _ in range(cfg.k):
        idx = torch.argmax(g.masked_fill(taken, -torch.inf), dim=1)       # [T]
        onehot = (idx[:, None] == ids).long()                            # [T, E]
        # queue position: earlier tokens of this round, after earlier rounds
        pos = (torch.cumsum(onehot, dim=0) - 1)[rows, idx] + used[idx]
        keep = pos < capacity
        experts.append(idx)
        slots.append(pos)
        vals.append(gates[rows, idx])
        keeps.append(keep)
        taken |= onehot.bool()
        used += (onehot * keep[:, None]).sum(0)
    expert, slot, kept = (torch.stack(t, dim=1) for t in (experts, slots, keeps))
    weight = torch.stack(vals, dim=1) * kept
    if cfg.k > 1:
        # renormalised over the kept choices; k == 1 keeps the raw gate, so
        # the router learns through the output's scale
        weight = weight / torch.clamp(weight.sum(dim=1, keepdim=True), min=1e-9)
    return Routing(expert, slot, weight, kept)


def moe_leaf_spec(name: str, leaf, mesh, axis: str = "ep") -> Tuple:
    """The partition spec of one MoE leaf (a tuple of mesh axis names or
    None per dimension, ``()`` replicated): the expert stacks split over
    ``axis``, the router replicated."""
    if name in ("w1", "w2") and axis in mesh.shape:
        return (axis,) + (None,) * (leaf.ndim - 1)
    return ()


def moe_param_shardings(mesh, params, axis: str = "ep") -> Dict[str, Tuple]:
    """``moe_leaf_spec`` of every leaf of one MoE layer's params."""
    return {name: moe_leaf_spec(name, leaf, mesh, axis) for name, leaf in params.items()}


def _experts(params: Dict[str, Any], xin: torch.Tensor, axis: str = "ep") -> torch.Tensor:
    """The expert FFN over the dispatch ``[E, C, D]`` -> ``[E*C, D]``.  On
    an ``ep`` shard ``w1``/``w2`` hold its experts: it multiplies their
    slice of the dispatch, and the slices are gathered in expert order."""
    E, C, D = xin.shape
    n = axis_size(axis)
    if n > 1:
        el = params["w1"].shape[0]
        xin = xin.narrow(0, axis_index(axis) * el, el)
    h = F.gelu(torch.bmm(xin, params["w1"]), approximate="tanh")
    out = torch.bmm(h, params["w2"])                                     # [E_l, C, D]
    if n > 1:
        out = all_gather(out, axis, 0)
    return out.reshape(E * C, D)


def moe_apply(params: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig, mesh=None,
              axis: str = "ep") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [..., D] -> (y [..., D], {"lb_loss", "overflow"}), as
    ``moe_apply`` (``moe.py:129-173``); on an ``axis`` shard its experts'
    products only (``_experts``).  ``params`` a ``ShardedTree`` (laid out
    by ``moe_param_shardings``) runs over its mesh, which ``mesh`` (if
    given) must be, and answers on its first device."""
    if isinstance(params, ShardedTree):
        if mesh is not None and mesh is not params.mesh:
            raise ValueError("moe_apply: mesh differs from the params' mesh")
        return spmd_call(moe_apply, params, x, cfg, axis=axis)
    orig_shape = x.shape
    D = orig_shape[-1]
    xt = x.reshape(-1, D)                                                 # [T, D]
    T = xt.shape[0]
    E, C = cfg.n_experts, _capacity(cfg, T)

    gates = torch.softmax(xt.float() @ params["wg"], dim=-1)              # [T, E]
    r = _route(gates, cfg, C)

    # dispatch: the token of each (expert, slot), T (a zero row) where empty;
    # a dropped choice writes the spare slot E*C, which is cut off
    flat = r.expert * C + r.slot.clamp(max=C - 1)                         # [T, k]
    src = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    tok = torch.arange(T, device=x.device)[:, None].expand_as(flat)
    src.scatter_(0, torch.where(r.kept, flat, E * C).flatten(), tok.flatten())
    xin = torch.cat([xt, xt.new_zeros(1, D)])[src[:E * C]].view(E, C, D)
    out = _experts(params, xin, axis)                                        # [E*C, D]

    # combine in the activation dtype, accumulated in f32 as the einsum
    w = r.weight.to(x.dtype).float()[..., None]
    picked = torch.where(r.kept[..., None], out[flat].float() * w, 0.0)
    y = picked.sum(dim=1).to(x.dtype)
    got = r.kept.sum(dim=1)
    y = torch.where((got > 0)[:, None], y, xt)                            # overflow passes

    density = (torch.argmax(gates.detach(), dim=1)[:, None]
               == torch.arange(E, device=x.device)).float().mean(dim=0)
    lb_loss = E * torch.sum(density * gates.mean(dim=0))
    overflow = 1.0 - got.sum().float() / (cfg.k * T)
    return y.reshape(orig_shape), {"lb_loss": lb_loss, "overflow": overflow}
