"""Device meshes held by one process — the port's counterpart of
``seldon_core_tpu/parallel/mesh.py:66-108``.

Axis conventions are the reference's: ``dp`` (data parallel: rows),
``tp`` (tensor parallel: weight matrices split, activations reduced),
``sp`` (sequence parallel: ring attention, ``ring_attention.py``), ``pp``
(pipeline stages, ``pipeline.py``), ``ens`` (ensemble members), ``ep``
(MoE experts).

The reference is single-controller: one engine owns a ``jax.sharding.Mesh``
and GSPMD partitions each jitted program across it.  The port has no
GSPMD, so a mesh here is an explicit list of torch devices arranged in the
axes' shape, and a sharded program runs SPMD on threads: ``DeviceMesh.run``
calls one function once per shard, each call on a thread of its own
(shard 0 on the caller's, the others on the mesh's shard threads, which
live across runs), with that shard's device current and the caller's CUDA
stream of that device, its grad and inference modes.  The threads take
turns, passing one baton around the ring of shards: a shard runs until its
next collective, deposits its tensor there and hands the baton on, so one
shard enqueues at a time (the GIL allows no more) and no thread waits on
another for the interpreter's switch interval.  When the baton comes back
every shard has deposited, and the shard reads the others' tensors onto
its own device in a fixed shard order (``all_reduce``, ``all_gather``,
``gather_slices``, ``ring_shift`` over its group: the
shards that differ only along the axis), so every shard of a group holds
the same bits.  The slots of a round are kept until the next round's are
written, which no shard reaches before every other has read them.  Outside
a shard (no mesh, or an axis of size 1, or an axis hidden by
``only_axes``) every collective is the identity, so the single-device code
paths run unchanged.  No process group is used: that is ``multihost``
([6b]).

Autograd: a collective is plain tensor operations on the deposited
tensors (a copy onto the reader's device, a sum, a concatenation), so a
forward run with grad enabled records ONE autograd graph across all the
shards of a run, whose edges between shards are those copies.  The
backward of a sharded program is taken once, by the caller, outside any
shard, over that graph (``optim.grad_update``): it needs no collective of
its own, since each collective's adjoint is already in the graph (the
copy's adjoint carries a gradient back to the shard that deposited the
tensor).  Calling ``torch.autograd.grad`` inside a shard would be wrong on
CUDA: PyTorch runs a CUDA backward on its own per-device threads, where
``current_shard()`` is None.  A leaf that several shards hold (a
replicated parameter) is one leaf per shard; its gradient is the sum over
its copies (``sum_replicas``), the all-reduce that GSPMD inserts.

A sharded state is a ``ShardedTree``: one tree per mesh device, in the
mesh's flat device order, with the partition specs it was placed by
(``place_tree``) when it has them.  ``spmd`` wraps a function so that a
``ShardedTree`` argument runs it over the tree's mesh: each shard gets its
own tree, every tensor argument copied to its device, and every argument
with a ``for_shard`` method (``LMConfig``) that method's answer; the
caller gets shard 0's result, with each of shard 0's trees that was passed
in (a pool or cache changed in place) handed back as its ``ShardedTree``.

Devices: on ``cuda`` the mesh takes ``cuda:0..n-1`` with ``n =
torch.cuda.device_count()``, and a mesh larger than that raises the
reference's "needs N devices, have M"; it never shrinks.  On the CPU the
count is ``set_cpu_device_count`` (the counterpart of the reference's
``jax_num_cpu_devices``; tests set 8), every entry ``cpu``.  An explicit
``devices=`` list may repeat a device: that puts several shards on one
card.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.tree import tree_leaves, tree_unflatten

__all__ = ["MeshSpec", "DeviceMesh", "Shard", "ShardedTree", "build_mesh",
           "local_device_count", "local_devices", "set_cpu_device_count",
           "shard_batch", "current_shard", "axis_size", "axis_index",
           "all_reduce", "all_gather", "gather_slices", "ring_shift",
           "only_axes", "place_tree", "sum_replicas", "sum_onto", "lead_shards", "spmd",
           "spmd_call",
           "first_shard"]

_CPU_DEVICES = 1
#: how long a shard waits for its turn before the run fails (a shard that
#: diverged from the others' collectives never passes the baton on)
TURN_TIMEOUT_S = 600.0
#: how long an idle shard thread waits for a mesh's next run before it exits
WORKER_IDLE_S = 60.0
_TLS = threading.local()


def set_cpu_device_count(n: int) -> None:
    """How many devices a CPU mesh may take (default 1)."""
    global _CPU_DEVICES
    if int(n) < 1:
        raise ValueError(f"cpu device count must be >= 1, got {n}")
    _CPU_DEVICES = int(n)


def local_devices(platform: str = "cuda") -> List[torch.device]:
    """The devices a mesh on ``platform`` may take: ``cuda:0..n-1`` (none
    without CUDA), or ``set_cpu_device_count`` entries of ``cpu``."""
    if platform == "cpu":
        return [torch.device("cpu")] * _CPU_DEVICES
    if platform != "cuda":
        raise ValueError(f"unsupported mesh platform {platform!r} (cuda or cpu)")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def local_device_count(platform: str = "cuda") -> int:
    return len(local_devices(platform))


@dataclass
class MeshSpec:
    """Declarative mesh request, e.g. ``MeshSpec({'dp': 2, 'ens': 4})``.
    A -1 axis absorbs the remaining devices (like a reshape wildcard)."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolve(self, n_devices: Optional[int] = None) -> Dict[str, int]:
        n = n_devices or local_device_count()
        axes = dict(self.axes) or {"dp": -1}
        wildcards = [k for k, v in axes.items() if v == -1]
        if len(wildcards) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wildcards}")
        fixed = int(np.prod([v for v in axes.values() if v != -1]))
        if wildcards:
            if n % fixed != 0:
                raise ValueError(
                    f"cannot fill axis {wildcards[0]!r}: {n} devices not "
                    f"divisible by {fixed}"
                )
            axes[wildcards[0]] = n // fixed
            fixed = n
        if fixed > n:
            raise ValueError(f"mesh {axes} needs {fixed} devices, have {n}")
        return axes


class _Group:
    """The slots of the shards that differ only along one axis: two rounds'
    worth, the round's parity picking one."""

    def __init__(self, n: int):
        self.slots: List[List[Any]] = [[None] * n, [None] * n]


class _Worker:
    """The thread that runs one shard's part of each of a mesh's runs.  It
    lives across runs, so a run starts no thread and a shard's thread
    makes its CUDA context current once, not once a run; it holds no
    reference to the mesh between runs, and exits after ``WORKER_IDLE_S``
    without one (``DeviceMesh.run`` then starts another)."""

    def __init__(self, index: int):
        self.index = index
        self._go = threading.Semaphore(0)
        self._lock = threading.Lock()
        self._job: Optional[Callable[[int], None]] = None
        self._alive = True
        threading.Thread(target=self._loop, name=f"mesh-shard-{index}", daemon=True).start()

    def hand(self, job: Callable[[int], None]) -> bool:
        """Give the worker a run's ``job(index)``; False if it has exited."""
        with self._lock:
            if not self._alive:
                return False
            self._job = job
            self._go.release()
            return True

    def _loop(self) -> None:
        while True:
            if not self._go.acquire(timeout=WORKER_IDLE_S):
                with self._lock:
                    if not self._go.acquire(blocking=False):
                        self._alive = False
                        return
            job, self._job = self._job, None
            job(self.index)
            job = None


class _Aborted(RuntimeError):
    """Another shard of the run failed: this one stops at its collective."""


@dataclass(frozen=True)
class Shard:
    """One position of a mesh: its flat index, coordinates and device."""

    mesh: "DeviceMesh"
    index: int

    @property
    def device(self) -> torch.device:
        return self.mesh.device_list[self.index]

    @property
    def coords(self) -> Dict[str, int]:
        return self.mesh.coords(self.index)


class DeviceMesh:
    """Devices arranged in named axes.  ``shape`` is the axis dict (as the
    reference's ``Mesh.shape``), ``devices`` an object array of that shape,
    ``device_list`` the flat order that ``ShardedTree`` follows."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.device_list: List[torch.device] = list(devices.flat)
        self._coords = [{a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(i, devices.shape))} for i in range(self.size)]
        self._lock = threading.Lock()
        self._workers: List[Optional[_Worker]] = [None] * self.size
        self._groups: Dict[Tuple[str, Tuple[int, ...]], _Group] = {}
        self._shard_groups: Dict[Tuple[str, int], _Group] = {}
        for axis in self.axis_names:
            for i in range(self.size):
                key = self._group_key(axis, i)
                if key not in self._groups:
                    self._groups[key] = _Group(self.shape[axis])
                self._shard_groups[axis, i] = self._groups[key]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, devices={[str(d) for d in self.device_list]})"

    def coords(self, index: int) -> Dict[str, int]:
        return dict(self._coords[index])

    def _group_key(self, axis: str, index: int) -> Tuple[str, Tuple[int, ...]]:
        c = self.coords(index)
        return axis, tuple(int(v) for k, v in c.items() if k != axis)

    def group(self, axis: str, index: int) -> _Group:
        return self._shard_groups[axis, index]

    @property
    def distinct_devices(self) -> List[torch.device]:
        seen: List[torch.device] = []
        for d in self.device_list:
            if d not in seen:
                seen.append(d)
        return seen

    def run(self, fn: Callable[[Shard], Any]) -> List[Any]:
        """``fn(shard)`` once per shard (shard 0 on this thread), each with
        its device current, the caller's CUDA stream of that device and the
        caller's grad and inference modes, taking turns at the collectives
        (module docstring); returns the results in shard order.  A shard
        that raises wakes the others, which stop at their next collective;
        the first error raises here.  One run at a time per mesh."""
        if current_shard() is not None:
            raise RuntimeError("DeviceMesh.run called from inside a shard")
        with self._lock:
            n = self.size
            self._batons = [threading.Semaphore(0) for _ in range(n)]
            self._rounds = [0] * n
            self._aborted = False
            grad = torch.is_grad_enabled()
            inference = torch.is_inference_mode_enabled()
            streams = {d.index: torch.cuda.current_stream(d)
                       for d in self.distinct_devices if d.type == "cuda"}
            results: List[Any] = [None] * n
            errors: List[Optional[BaseException]] = [None] * n

            def work(i: int) -> None:
                shard = Shard(self, i)
                _TLS.shard = shard
                try:
                    if i:
                        self._take(i)
                    with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                            _on_device(shard.device, streams):
                        results[i] = fn(shard)
                except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                    errors[i] = e
                    self._aborted = True
                    for b in self._batons:
                        b.release(n)
                finally:
                    _TLS.shard = None
                    self._batons[(i + 1) % n].release()  # the rest run on

            done = threading.Semaphore(0)

            def job(i: int) -> None:
                try:
                    work(i)
                finally:
                    done.release()

            for i in range(1, n):
                w = self._workers[i]
                if w is None or not w.hand(job):
                    self._workers[i] = w = _Worker(i)
                    w.hand(job)
            work(0)
            for _ in range(1, n):
                done.acquire()
            real = [e for e in errors if e is not None and not isinstance(e, _Aborted)]
            first = real[0] if real else next((e for e in errors if e is not None), None)
            if first is not None:
                raise first
            return results

    def _take(self, i: int) -> None:
        """Wait for shard ``i``'s turn."""
        if not self._batons[i].acquire(timeout=TURN_TIMEOUT_S):
            raise _Aborted(f"shard {i} waited {TURN_TIMEOUT_S:.0f} s for its turn")
        if self._aborted:
            raise _Aborted(f"shard {i} stopped: another shard of the run failed")

    def _exchange(self, shard: "Shard", group: _Group, rank: int, t) -> List[Any]:
        """Deposit ``t`` in this round's slots, pass the baton round the
        ring and take it back: then every shard has deposited."""
        i = shard.index
        r = self._rounds[i]
        self._rounds[i] = r + 1
        slots = group.slots[r % 2]
        slots[rank] = t
        self._batons[(i + 1) % self.size].release()
        self._take(i)
        return slots

    def map_shards(self, fn: Callable[[Shard], Any]) -> "ShardedTree":
        """``run`` whose per-shard results form a ``ShardedTree``."""
        return ShardedTree(self, self.run(fn))


def _on_device(device: torch.device, streams: Dict[int, Any]):
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device.index))
    stack.enter_context(torch.cuda.stream(streams[device.index]))
    return stack


def build_mesh(spec: "MeshSpec | Dict[str, int] | None" = None,
               devices: Optional[Sequence] = None, platform: str = "cuda") -> DeviceMesh:
    """A mesh over (a prefix of) ``devices``, default every local device of
    ``platform``; too few devices raise ``MeshSpec.resolve``'s error."""
    if isinstance(spec, dict):
        spec = MeshSpec(spec)
    spec = spec or MeshSpec()
    devs = [torch.device(d) for d in devices] if devices is not None else local_devices(platform)
    if not devs:
        # resolve() reads 0 as "count the local devices"; none is none
        need = int(np.prod([v for v in spec.axes.values() if v != -1]))
        raise ValueError(f"mesh {dict(spec.axes)} needs {need} devices, have 0")
    axes = spec.resolve(len(devs))
    names = tuple(axes)
    shape = tuple(axes[n] for n in names)
    n_used = int(np.prod(shape))
    arr = np.empty(n_used, dtype=object)
    for i, d in enumerate(devs[:n_used]):
        arr[i] = d
    return DeviceMesh(arr.reshape(shape), names)


class ShardedTree:
    """A state split over a mesh: ``shards[i]`` is the tree that flat
    device ``i`` holds (a dict of tensors, or a tensor).  ``specs``, when
    known, is the tree of partition specs it was placed by (``place_tree``):
    which mesh axes split each leaf, so which shards hold copies of it."""

    def __init__(self, mesh: DeviceMesh, shards: Sequence[Any], specs: Any = None):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} devices")
        self.mesh = mesh
        self.shards = list(shards)
        self.specs = specs

    def __repr__(self) -> str:
        return f"ShardedTree({self.mesh.shape}, {len(self.shards)} shards)"


def first_shard(tree):
    """Shard 0's tree of a ``ShardedTree``, else the tree itself."""
    return tree.shards[0] if isinstance(tree, ShardedTree) else tree


def shard_batch(mesh: DeviceMesh, x, axis: str = "dp") -> ShardedTree:
    """A host batch split along its leading axis over ``axis`` (each
    shard's rows on its device), or replicated when the mesh has no such
    axis."""
    t = torch.as_tensor(np.asarray(x))
    if axis not in mesh.shape:
        return ShardedTree(mesh, [t.to(d) for d in mesh.device_list])
    n = mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"batch of {t.shape[0]} rows not divisible over {axis!r} of size {n}")
    rows = t.shape[0] // n
    return ShardedTree(mesh, [t[mesh.coords(i)[axis] * rows:(mesh.coords(i)[axis] + 1) * rows]
                              .to(d) for i, d in enumerate(mesh.device_list)])


def _place(leaf: torch.Tensor, spec, coords: Dict[str, int], mesh: DeviceMesh,
           device: torch.device) -> torch.Tensor:
    """One device's block of ``leaf`` under ``spec`` (the contiguous slice
    that the reference's ``NamedSharding`` gives that device).  A split
    leaf is always a copy of its own, also on the whole leaf's device: a
    view would keep the whole leaf's storage alive there."""
    t = leaf
    split = False
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape.get(axis, 1) == 1:
            continue
        n = mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} not divisible over "
                             f"{axis!r} of size {n}")
        w = t.shape[dim] // n
        t = t.narrow(dim, coords[axis] * w, w)
        split = True
    if split:
        return t.to(device, copy=True, memory_format=torch.contiguous_format)
    t = t.to(device)
    return t if t.is_contiguous() else t.contiguous()


def _replicated_specs(tree):
    if isinstance(tree, dict):
        return {k: _replicated_specs(v) for k, v in tree.items()}
    return ()


def place_tree(tree, mesh: DeviceMesh, specs=None) -> ShardedTree:
    """``tree`` (one device's whole tree) placed over ``mesh`` by ``specs``
    (a tree of partition specs: a tuple of mesh axis names or None per
    dimension, ``()`` replicated; default every leaf replicated): each
    device's tree holds its blocks.  A replicated leaf whose device is the
    shard's is shared, not copied."""
    specs = _replicated_specs(tree) if specs is None else specs

    def walk(t, spec, i):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k], i) for k in t}
        return _place(t, spec, mesh.coords(i), mesh, mesh.device_list[i])

    return ShardedTree(mesh, [walk(tree, specs, i) for i in range(mesh.size)], specs)


def sum_replicas(tree: ShardedTree) -> ShardedTree:
    """Each leaf replaced, on every shard, by the sum of the copies of that
    leaf over the shards that hold the same block of it (those that agree
    on every axis its spec in ``tree.specs`` splits by; no specs: every
    leaf replicated), added in flat shard order: the same bits on every
    copy.  The gradient of a replicated parameter is that sum (the
    all-reduce GSPMD inserts)."""
    mesh = tree.mesh
    specs = tree_leaves(_replicated_specs(tree.shards[0]) if tree.specs is None else tree.specs)
    flat = [tree_leaves(s) for s in tree.shards]
    out = [list(f) for f in flat]
    for n, spec in enumerate(specs):
        axes = [a for a in spec if a is not None and mesh.shape.get(a, 1) > 1]
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i in range(mesh.size):
            groups.setdefault(tuple(mesh.coords(i)[a] for a in axes), []).append(i)
        for members in groups.values():
            sums: Dict[torch.device, torch.Tensor] = {}
            for i in members:
                dev = flat[i][n].device
                if dev not in sums:
                    sums[dev] = sum_onto([flat[j][n] for j in members], dev)
                out[i][n] = sums[dev]
    return ShardedTree(mesh, [tree_unflatten(s, o) for s, o in zip(tree.shards, out)],
                       tree.specs)


def sum_onto(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The tensors (a sharded program's per-shard partial sums) read onto
    ``device`` and added there in order: differentiable, so a loss built so
    reaches every shard's graph."""
    out = tensors[0].to(device)
    for t in tensors[1:]:
        out = out + t.to(device)
    return out


def lead_shards(mesh: DeviceMesh, split: Sequence[str] = ()) -> List[int]:
    """The flat indices of the shards whose coordinate is 0 on every axis
    not in ``split``: one shard for each block of a result split over
    ``split`` and replicated over the rest (the shards whose answers a
    sharded program gathers, or whose losses it counts).  Ordered by their
    coordinates along ``split``, the first axis slowest, whatever order the
    mesh's axes were given in."""
    leads = [i for i in range(mesh.size)
             if all(v == 0 for k, v in mesh.coords(i).items() if k not in split)]
    return sorted(leads, key=lambda i: tuple(mesh.coords(i).get(a, 0) for a in split))


# -- collectives, read from the calling shard ------------------------------

def current_shard() -> Optional[Shard]:
    return getattr(_TLS, "shard", None)


def _hidden(axis: str) -> bool:
    keep = getattr(_TLS, "only", None)
    return keep is not None and axis not in keep


@contextlib.contextmanager
def only_axes(*axes: str):
    """Inside it, the calling shard sees only ``axes``: every other axis
    reads as size 1 (``axis_size``, ``axis_index``) and its collectives are
    the identity, as code the reference runs with ``mesh=None`` inside a
    ``shard_map`` over ``axes`` (a pipeline stage) sees no other axis."""
    prev = getattr(_TLS, "only", None)
    _TLS.only = frozenset(axes) if prev is None else frozenset(axes) & prev
    try:
        yield
    finally:
        _TLS.only = prev


def _exchange(t, axis: str) -> Optional[List[Any]]:
    """The group's tensors of this round along ``axis``, in shard order
    (None outside a shard or on an axis of size 1)."""
    shard = current_shard()
    if shard is None or shard.mesh.shape.get(axis, 1) == 1 or _hidden(axis):
        return None
    mesh = shard.mesh
    return mesh._exchange(shard, mesh.group(axis, shard.index), mesh._coords[shard.index][axis], t)


def axis_size(axis: str) -> int:
    """The calling shard's mesh size along ``axis`` (1 outside a shard)."""
    shard = current_shard()
    return 1 if shard is None or _hidden(axis) else shard.mesh.shape.get(axis, 1)


def axis_index(axis: str) -> int:
    """The calling shard's coordinate along ``axis`` (0 outside a shard)."""
    shard = current_shard()
    return 0 if shard is None or axis not in shard.mesh.shape or _hidden(axis) else \
        shard.mesh._coords[shard.index][axis]


def all_reduce(t: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of the group's tensors, added in shard order on the calling
    shard's device: the same bits on every shard of the group."""
    slots = _exchange(t, axis)
    if slots is None:
        return t
    out = slots[0].to(t.device)
    for other in slots[1:]:
        out = out + other.to(t.device)
    return out


def all_gather(t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in shard order."""
    slots = _exchange(t, axis)
    if slots is None:
        return t
    return torch.cat([s.to(t.device) for s in slots], dim=dim)


def gather_slices(t: torch.Tensor, axis: str, dim: int,
                  ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Column ranges [lo, hi) of the group's tensors concatenated along
    ``dim`` (each shard's part the same width), taken without building the
    whole: only the overlapping pieces are read onto this device."""
    slots = _exchange(t, axis)
    if slots is None:
        return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim=dim)
    w = t.shape[dim]
    pieces = []
    for lo, hi in ranges:
        for j in range(lo // w, (hi - 1) // w + 1):
            a, b = max(lo, j * w) - j * w, min(hi, (j + 1) * w) - j * w
            pieces.append(slots[j].narrow(dim, a, b - a).to(t.device))
    return torch.cat(pieces, dim=dim)


def _onto(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_onto(e, device) for e in x)
    return x.to(device)


def ring_shift(t, axis: str):
    """``lax.ppermute`` over ``axis`` with the permutation i -> i + 1: the
    calling shard gets the ``t`` of its predecessor along ``axis``
    (cyclically), read onto its device, in one baton round.  ``t`` is a
    tensor, a tuple of tensors (moved together in that one round), or None
    (a shard with nothing to send; its successor gets None)."""
    slots = _exchange(t, axis)
    if slots is None:
        return t
    return _onto(slots[(axis_index(axis) - 1) % len(slots)], current_shard().device)


# -- running single-device code over a ShardedTree -------------------------

def _find_mesh(args, kwargs) -> Optional[DeviceMesh]:
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, ShardedTree):
            return a.mesh
    return None


def _local(x, shard: Shard):
    if isinstance(x, ShardedTree):
        return x.shards[shard.index]
    if isinstance(x, torch.Tensor):
        return x if x.device == shard.device else x.to(shard.device)
    if hasattr(x, "for_shard"):
        return x.for_shard(shard)
    if isinstance(x, (tuple, list)) and any(isinstance(e, (ShardedTree, torch.Tensor))
                                            for e in x):
        return type(x)(_local(e, shard) for e in x)
    return x


def spmd_call(fn: Callable, *args, **kwargs):
    """``fn`` over the mesh of its ``ShardedTree`` arguments (module
    docstring); called from inside a shard, ``fn`` runs on that shard."""
    mesh = _find_mesh(args, kwargs)
    if mesh is None:
        return fn(*args, **kwargs)

    def body(shard: Shard):
        return fn(*(_local(a, shard) for a in args),
                  **{k: _local(v, shard) for k, v in kwargs.items()})

    shard = current_shard()
    if shard is not None and shard.mesh is mesh:
        return body(shard)
    out = mesh.run(body)[0]
    lifted = {id(a.shards[0]): a for a in list(args) + list(kwargs.values())
              if isinstance(a, ShardedTree)}

    def lift(r):
        return lifted.get(id(r), r)

    return tuple(lift(r) for r in out) if isinstance(out, tuple) else lift(out)


def spmd(fn: Callable) -> Callable:
    """``fn`` that runs over a mesh when an argument is a ``ShardedTree``
    (``spmd_call``), and as it is otherwise."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _find_mesh(args, kwargs) is None:
            return fn(*args, **kwargs)
        return spmd_call(fn, *args, **kwargs)

    return wrapper


def spmd_stream(fn: Callable, *args, **kwargs):
    """A generator ``fn`` over the mesh: every shard's generator advanced
    in lockstep, one ``run`` an item; yields shard 0's items."""
    mesh = _find_mesh(args, kwargs)
    gens = mesh.run(lambda s: fn(*(_local(a, s) for a in args),
                                 **{k: _local(v, s) for k, v in kwargs.items()}))
    end = object()
    while True:
        items = mesh.run(lambda s: next(gens[s.index], end))
        if items[0] is end:
            return
        yield items[0]
