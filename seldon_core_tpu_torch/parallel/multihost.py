"""Processes that run one sharded program together — the port's counterpart
of ``seldon_core_tpu/parallel/multihost.py``.

The reference joins JAX's multi-controller runtime: every host runs the
same program under ``jit`` over a global mesh.  The port runs one process
a card (``CUDA_VISIBLE_DEVICES`` set by the launcher), joined by
``torch.distributed``: ``initialize`` reads the same ``SELDON_*`` env
contract, so the same image runs alone (no-op) and with others.  Every
process then builds the same ``global_mesh`` and runs the same program over
it; each runs its own shards, and a collective whose group spans processes
crosses between them (``parallel/mesh.py``).

The backend is chosen before the process group exists, from the cards the
processes see: before joining, each process writes its cards' UUIDs to a
``TCPStore`` at the coordinator's address and reads the others'.  NCCL
when every process has a card and no card is seen by two processes; gloo
otherwise: on the CPU, and where processes share a card (NCCL refuses two
ranks on one device).  Under gloo a CUDA tensor crosses through the host;
the kernels still run on the card.  No failure of one backend falls back
to the other.

A process's local devices are what it sees: ``local_devices("cuda")``, or
``set_cpu_device_count`` entries on the CPU (every process sets the same
count), or an explicit ``devices=`` list, which may repeat a card.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from seldon_core_tpu_torch.parallel.mesh import (TURN_TIMEOUT_S, DeviceMesh, MeshSpec,
                                                 ShardedTree, build_mesh, local_devices)

__all__ = [
    "initialize",
    "is_distributed",
    "process_info",
    "global_mesh",
    "host_local_to_global",
    "global_to_host_local",
    "barrier",
    "backend",
]

ENV_COORDINATOR = "SELDON_COORDINATOR_ADDRESS"   # host:port of process 0
ENV_NUM_PROCESSES = "SELDON_NUM_PROCESSES"
ENV_PROCESS_ID = "SELDON_PROCESS_ID"

_initialized = False


def _card_uuids() -> str:
    if not torch.cuda.is_available():
        return ""
    return ",".join(str(torch.cuda.get_device_properties(i).uuid)
                    for i in range(torch.cuda.device_count()))


def choose_backend(cards: Sequence[str]) -> str:
    """``cards`` (each process's card UUIDs, comma-joined) -> "nccl" when
    every process has a card and none is seen by two, else "gloo"."""
    seen = [set(c.split(",")) if c else set() for c in cards]
    if not all(seen):
        return "gloo"
    every = [u for s in seen for u in s]
    return "nccl" if len(every) == len(set(every)) else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the other processes.  Arguments fall back to the ``SELDON_*``
    env contract.  Without a coordinator address this is a no-op returning
    False (one process); after a join, True (and again on a repeat call).
    The store and the process group wait ``TURN_TIMEOUT_S`` for a process
    that does not come, so a diverged process fails rather than hangs."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=TURN_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0, timeout=timeout)
    store.set(f"seldon/cards/{process_id}", _card_uuids())
    cards = [store.get(f"seldon/cards/{p}").decode() for p in range(num_processes)]
    chosen = choose_backend(cards)
    if chosen == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(chosen, store=store, world_size=num_processes, rank=process_id,
                            timeout=timeout)
    _initialized = True
    return True


def backend() -> Optional[str]:
    """"nccl" or "gloo" once joined, else None."""
    return dist.get_backend() if dist.is_initialized() else None


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _world() -> tuple:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_info(platform: str = "cuda") -> Dict[str, int]:
    """The reference's four keys; the global count is every process's
    local count (each process takes as many)."""
    rank, world = _world()
    local = len(local_devices(platform))
    return {
        "process_index": rank,
        "process_count": world,
        "local_device_count": local,
        "global_device_count": local * world,
    }


def global_mesh(
    axes: Dict[str, int],
    dcn_axes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence] = None,
    platform: str = "cuda",
) -> DeviceMesh:
    """A mesh over every process's devices: ``dcn_axes`` (e.g. ``{"dp":
    n_processes}``) outermost, over processes, the ``axes`` inside.  The
    flat shard order is process-major: process p holds shards [p * m,
    (p + 1) * m), on its first m local devices (``devices`` or every local
    device of ``platform``).  One process: ``build_mesh`` of the combined
    axes."""
    dcn_axes = dict(dcn_axes or {})
    overlap = set(dcn_axes) & set(axes)
    if overlap:
        raise ValueError(
            f"axis names {sorted(overlap)} appear in both dcn_axes and axes; "
            f"an axis lives on exactly one link layer"
        )
    combined = {**dcn_axes, **dict(axes)}
    local = ([torch.device(d) for d in devices] if devices is not None
             else local_devices(platform))
    rank, world = _world()
    if world == 1:
        return build_mesh(combined, devices=local)
    total = len(local) * world
    resolved = MeshSpec(combined).resolve(total) if local else None
    if resolved is None:
        raise ValueError(f"mesh {combined} needs "
                         f"{int(np.prod([v for v in combined.values() if v != -1]))} "
                         f"devices, have 0")
    names = tuple(resolved)
    shape = tuple(resolved[n] for n in names)
    size = int(np.prod(shape))
    if size % world:
        raise ValueError(f"mesh {resolved} of {size} devices does not split evenly over "
                         f"{world} processes")
    m = size // world
    devs = np.empty(size, dtype=object)
    devs[rank * m:(rank + 1) * m] = local[:m]
    owners = np.repeat(np.arange(world), m)
    return DeviceMesh(devs.reshape(shape), names, process_of=owners.reshape(shape))


def _blocks(mesh: DeviceMesh, spec, ndim: int):
    """For each dimension, the split axes' (this process's first
    coordinate, its count of coordinates) along that dimension."""
    out = []
    for dim in range(ndim):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None or mesh.shape.get(axis, 1) == 1:
            out.append(None)
            continue
        cs = sorted({mesh.coords(i)[axis] for i in mesh.owned})
        out.append((axis, cs[0], len(cs)))
    return out


def host_local_to_global(mesh: DeviceMesh, spec, local_array) -> ShardedTree:
    """This process's part of a global array (along each split dimension,
    the blocks of the coordinates its shards hold) -> a ``ShardedTree`` of
    each of its shards' blocks, as ``place_tree`` lays a whole array out
    (``spec``: a mesh axis name or None per dimension).  One process: the
    local array is the global one."""
    t = torch.as_tensor(np.asarray(local_array))
    dims = _blocks(mesh, spec, t.ndim)
    shards = []
    for i in range(mesh.size):
        if not mesh.owns(i):
            shards.append(None)
            continue
        block = t
        for dim, split in enumerate(dims):
            if split is None:
                continue
            axis, first, count = split
            w = t.shape[dim] // count
            block = block.narrow(dim, (mesh.coords(i)[axis] - first) * w, w)
        shards.append(block.to(mesh.device_list[i], copy=True,
                               memory_format=torch.contiguous_format))
    return ShardedTree(mesh, shards, tuple(spec))


def global_to_host_local(mesh: DeviceMesh, spec, tree: ShardedTree) -> torch.Tensor:
    """The inverse: this process's blocks of a ``ShardedTree`` of one array
    put together (a block its shards hold twice taken once), on its first
    device."""
    like = tree.shards[mesh.owned[0]]
    dims = _blocks(mesh, spec, like.ndim)
    shape = [like.shape[d] * (1 if s is None else s[2]) for d, s in enumerate(dims)]
    out = like.new_empty(shape, device=mesh.first_device)
    for i in mesh.owned:
        view = out
        for dim, split in enumerate(dims):
            if split is not None:
                axis, first, _ = split
                w = like.shape[dim]
                view = view.narrow(dim, (mesh.coords(i)[axis] - first) * w, w)
        view.copy_(tree.shards[i])
    return out


def barrier(name: str = "seldon_barrier") -> None:
    """Block until every process arrives (the pre-serve warm-up sync); a
    no-op for one process.  ``name`` names the sync point, as the
    reference's does."""
    del name
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
