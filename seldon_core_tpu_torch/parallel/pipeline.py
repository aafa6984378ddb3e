"""GPipe pipeline over the ``pp`` mesh axis — the port's counterpart of
``seldon_core_tpu/parallel/pipeline.py:47-151``.

A layer stack splits into ``pp`` stages, one stage's weights a shard: the
stage parameters are stacked on a leading stage axis and split over
``pp`` (``stage_param_shardings``, ``parallel/mesh.py`` ``place_tree``),
so shard s holds exactly stage s's slice.  The batch is cut into
microbatches (``split_microbatches``).  At tick t stage s runs microbatch
t - s when there is one and hands its output to stage s + 1
(``ring_shift``, the counterpart of ``lax.ppermute``), so the schedule
runs ``n_micro + pp - 1`` ticks and the last stage finishes microbatch j
at tick j + pp - 1.  The reference computes its bubble ticks on zeros and
drops them; the port skips them (a stage with nothing to run sends None),
which changes no answer.  The reference then ``psum``s the last stage's
emits over ``pp``; the port reads them from the last stage's shards
(``pipeline_map``), the only ones that hold them.

Composes with ``dp``: the microbatch's rows split over ``dp``
(``x_micro`` [n_micro, mb, ...] split along mb), each ``dp`` group its own
pipeline.  A stage sees only the ``pp`` and ``dp`` axes (``only_axes``),
as the reference's stages run with ``mesh=None`` inside its
``shard_map``: on any other axis every shard computes the same.

Gradients: a forward with grad enabled records one autograd graph across
the stages (their hand-offs are its copy edges), so a train step takes
its backward once, over that graph (``optim.grad_update``); the backward
replays the schedule in reverse as the reference's transposed
``ppermute`` does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from seldon_core_tpu_torch.parallel.mesh import (DeviceMesh, ShardedTree, axis_index, axis_size,
                                                 lead_shards, only_axes, place_tree, ring_shift)
from seldon_core_tpu_torch.tree import tree_leaves, tree_map

__all__ = ["stack_stage_params", "stage_param_shardings", "split_microbatches",
           "merge_microbatches", "pipeline_apply", "pipeline_map", "pipeline_run", "stage_count"]


def stack_stage_params(per_stage_params) -> Any:
    """Per-stage param trees stacked along a new leading stage axis."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0), *per_stage_params)


def stage_param_shardings(mesh: DeviceMesh, stacked_params, axis: str = "pp") -> Any:
    """``(axis, None, ...)`` on every leaf of a stacked stage-param tree."""
    del mesh
    return tree_map(lambda leaf: (axis,) + (None,) * (leaf.ndim - 1), stacked_params)


def split_microbatches(x, n_micro: int):
    """[B, ...] -> [n_micro, B // n_micro, ...] (leading-dim split)."""
    if x.shape[0] % n_micro != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible into {n_micro} microbatches"
        )
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def merge_microbatches(y):
    """Inverse of split_microbatches."""
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))


def stage_count(mesh: DeviceMesh, shard_stages, axis: str = "pp") -> int:
    """The mesh's ``axis`` size, refused unless it equals the stacked stage
    dim of a placed stage tree (``shard_stages``, one shard's: its leading
    dim times the mesh's ``axis``) in the reference's words: a shard
    holding more than one stage would silently drop all but its first."""
    n_stages = mesh.shape[axis]
    stacked_dim = tree_leaves(shard_stages)[0].shape[0] * n_stages
    if stacked_dim != n_stages:
        raise ValueError(
            f"stacked stage dim {stacked_dim} != mesh {axis!r} size {n_stages}"
        )
    return n_stages


def pipeline_run(stage_fn: Callable[[Any, Any], Any], params_local, x_local, n_micro: int,
                 axis: str = "pp") -> Optional[torch.Tensor]:
    """The schedule, called inside a shard: ``params_local`` this stage's
    params (leading stage dim of 1 dropped), ``x_local`` [n_micro, mb, ...]
    the microbatches entering stage 0 (read only there).  Returns the last
    stage's outputs [n_micro, mb, ...] on the last stage, None elsewhere."""
    n, s = axis_size(axis), axis_index(axis)
    if n == 1:
        # degenerate pipeline: single stage, no rotation
        return torch.stack([stage_fn(params_local, x_local[m]) for m in range(n_micro)])
    outs = []
    carry = None
    for t in range(n_micro + n - 1):
        m = t - s
        y = None
        if 0 <= m < n_micro:
            y = stage_fn(params_local, x_local[m] if s == 0 else carry)
            if s == n - 1:
                outs.append(y)
        if t < n_micro + n - 2:  # the last tick hands nothing on
            carry = ring_shift(y, axis)
    return torch.stack(outs) if outs else None


def pipeline_map(stage_fn: Callable[[Any, Any], Any], params: ShardedTree, x_micro, *,
                 axis: str = "pp", batch_axis: Optional[str] = "dp",
                 stages: Callable[[Any], Any] = lambda p: p,
                 enter: Callable[[Any, Any], Any] = lambda p, x: x,
                 leave: Callable[[Any, Any, Callable], Any] = lambda p, y, rows: y) -> List[Any]:
    """The microbatched pipeline over ``params``' mesh, one pipeline for
    each ``batch_axis`` group, on global ``x_micro`` [n_micro, mb, ...]
    split along mb over ``batch_axis``.  ``stages(p)`` is a shard's placed
    stage tree (its leading stage dim 1), ``enter(p, x)`` maps the group's
    rows to stage 0's input, ``leave(p, y, rows)`` the last stage's outputs
    y [n_micro, mb / groups, ...] to the answer (``rows`` slices a
    [n_micro, mb, ...] tensor to the group's rows).  Returns ``leave``'s
    answers, one a group, in ``batch_axis`` order.  Differentiable: the
    graph runs through every stage."""
    mesh = params.mesh
    mesh.refuse_spanning(mesh.axis_names, "the pipeline")
    n = stage_count(mesh, stages(params.shards[0]), axis)
    n_micro = x_micro.shape[0]
    dp = mesh.shape.get(batch_axis, 1) if batch_axis is not None else 1
    if x_micro.shape[1] % dp:
        raise ValueError(f"microbatch of {x_micro.shape[1]} rows not divisible over "
                         f"{batch_axis!r} of size {dp}")
    mbl = x_micro.shape[1] // dp
    keep = (axis,) + ((batch_axis,) if dp > 1 else ())
    leads = [i for i in lead_shards(mesh, keep) if mesh.coords(i)[axis] == n - 1]

    def body(shard):
        p = params.shards[shard.index]
        d = shard.coords[batch_axis] if dp > 1 else 0

        def rows(t):
            return t[:, d * mbl:(d + 1) * mbl]

        x = enter(p, rows(x_micro).to(shard.device)) if shard.coords[axis] == 0 else None
        with only_axes(*keep):
            y = pipeline_run(stage_fn, tree_map(lambda v: v[0], stages(p)), x, n_micro, axis)
        return leave(p, y, rows) if shard.index in leads else None

    outs = mesh.run(body)
    return [outs[i] for i in leads]


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stacked_params, x_micro, *,
                   mesh: DeviceMesh, axis: str = "pp", batch_axis: Optional[str] = "dp"):
    """The microbatched pipeline on global ``x_micro`` [n_micro, mb, ...];
    returns outputs shaped like it, on the mesh's first device.
    ``stacked_params`` is a stacked stage tree (placed here by
    ``stage_param_shardings``) or a ``ShardedTree`` already placed so.
    Differentiable: the graph runs through every stage."""
    if not isinstance(stacked_params, ShardedTree):
        stacked_params = place_tree(stacked_params, mesh,
                                    stage_param_shardings(mesh, stacked_params, axis))
    outs = pipeline_map(stage_fn, stacked_params, x_micro, axis=axis, batch_axis=batch_axis)
    dev = mesh.device_list[0]
    return torch.cat([o.to(dev) for o in outs], dim=1)
