"""An ensemble sharded over a device mesh — the port's counterpart of
``seldon_core_tpu/parallel/ensemble.py``.

The reference engine broadcasts a request to N child microservices and
averages their answers; ``SharedEnsembleUnit`` is the same graph as one
MODEL unit: the members' parameters stacked on a leading ``ens`` axis and
split over the mesh's ``ens`` devices.  It runs as every sharded program
of the port does (``parallel/mesh.py`` ``DeviceMesh.run``): each shard
runs its local members on the batch on its own device (an
``MnistClassifier`` member through its fused-MLP kernel path) and sums
them in member order, and the mean is one ``all_reduce`` over ``ens`` (the
shards' sums added in shard order) divided by ``n_members``.  Every shard
of any other axis computes the same mean, as the reference's
``shard_map`` does; the caller gets the first shard's.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Sequence

import torch

from seldon_core_tpu_torch.graph.spec import GraphSpecError
from seldon_core_tpu_torch.graph.units import Unit, register_unit, resolve_unit_class
from seldon_core_tpu_torch.parallel.mesh import (DeviceMesh, Shard, ShardedTree, all_reduce,
                                                 build_mesh)
from seldon_core_tpu_torch.tree import tree_leaves, tree_map

__all__ = ["SharedEnsembleUnit", "stack_member_states", "ensemble_mean_fn"]


def stack_member_states(member_states: Sequence[Any]):
    """Per-member state trees stacked along a new leading ``ens`` axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *member_states)


def _split(stacked, mesh: DeviceMesh, axis: str) -> ShardedTree:
    """The stacked states split along their member axis over ``axis``:
    each device holds its slice (replicated along any other axis; this
    process's devices only, over a mesh that spans processes)."""
    n = mesh.shape[axis]

    def block(i):
        c = mesh.coords(i)[axis]
        dev = mesh.device_list[i]

        def take(a):
            per = a.shape[0] // n
            return a[c * per:(c + 1) * per].to(dev)

        return tree_map(take, stacked)

    return ShardedTree(mesh, [block(i) if mesh.owns(i) else None for i in range(mesh.size)])


def ensemble_mean_fn(member_apply: Callable, mesh: DeviceMesh, n_members: int,
                     axis: str = "ens") -> Callable:
    """fn(sharded_states, X) -> the members' mean prediction, on the mesh's
    first device.  ``member_apply(state, X) -> Y`` is one member's forward;
    ``sharded_states`` the stacked states split over ``axis``
    (``SharedEnsembleUnit.init_state``).  Every shard runs its local
    members in order on its own device and sums them (``DeviceMesh.run``);
    one ``all_reduce`` over ``axis`` adds the shards' sums in shard order,
    divided by ``n_members``, as the reference's ``psum``."""

    def fn(sharded_states: ShardedTree, X: torch.Tensor) -> torch.Tensor:
        def body(shard: Shard) -> torch.Tensor:
            local = sharded_states.shards[shard.index]
            xs = X.to(shard.device)
            y = None
            for m in range(tree_leaves(local)[0].shape[0]):
                ym = member_apply(tree_map(lambda a: a[m], local), xs)
                y = ym if y is None else y + ym
            return all_reduce(y, axis) / n_members

        return mesh.run(body)[mesh.owned[0]]

    return fn


@register_unit("SharedEnsembleUnit")
class SharedEnsembleUnit(Unit):
    """An N-member ensemble as a single MODEL unit, members sharded over the
    mesh's ``ens`` axis.

    Parameters (graph spec):
      member      — registered unit name / module:Class of the member model
      n_members   — ensemble size
      mesh_axis   — mesh axis to shard members over (default "ens")
    plus any member parameters prefixed ``member_`` (e.g. ``member_hidden``).
    Without a mesh the unit takes every local device of its platform along
    ``mesh_axis``, as the reference does."""

    def __init__(self, member: str = "MnistClassifier", n_members: int = 4,
                 mesh_axis: str = "ens", mesh: Optional[DeviceMesh] = None,
                 device=None, **member_kwargs):
        self.n = int(n_members)
        self.axis = mesh_axis
        member_cls = resolve_unit_class(member)
        self.member_kwargs = {k.removeprefix("member_"): v for k, v in member_kwargs.items()}
        base_seed = int(self.member_kwargs.pop("seed", 0))
        if mesh is None:
            platform = "cpu" if device is not None and torch.device(device).type == "cpu" \
                else "cuda"
            mesh = build_mesh({mesh_axis: -1}, platform=platform)
        self.mesh = mesh
        if self.axis not in mesh.shape:
            raise GraphSpecError(f"ensemble mesh {mesh.shape} has no axis {self.axis!r}")
        if self.n % mesh.shape[self.axis] != 0:
            raise GraphSpecError(
                f"ensemble of {self.n} members not divisible over mesh axis "
                f"{self.axis!r} of size {mesh.shape[self.axis]}"
            )
        self.device = mesh.first_device
        takes_device = "device" in inspect.signature(member_cls.__init__).parameters
        extra = {"device": self.device} if takes_device else {}
        self.members = [member_cls(**{**self.member_kwargs, "seed": base_seed + i, **extra})
                        for i in range(self.n)]
        if takes_device and self.device.type == "cuda":
            # every card of the mesh builds and launches the member's kernel
            # now, as the member's own constructor did on the first
            for dev in mesh.distinct_devices[1:]:
                member_cls(**{**self.member_kwargs, "seed": base_seed, "device": dev})
        self.class_names = self.members[0].class_names
        member = self.members[0]
        self._fn = ensemble_mean_fn(lambda state, X: member.predict(state, X), self.mesh,
                                    self.n, self.axis)

    def init_state(self, rng):
        stacked = stack_member_states([m.init_state(rng) for m in self.members])
        return self.shard_state(stacked)

    def shard_state(self, stacked):
        """The stacked member states (``stack_member_states``, or
        ``convert.params_from_jax`` of the reference unit's gathered state)
        split over the mesh's ``ens`` axis."""
        return _split(stacked, self.mesh, self.axis)

    def predict(self, state, X):
        return self._fn(state, X)
