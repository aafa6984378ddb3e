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
paths run unchanged.

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
caller gets shard 0's result (over processes, its own first shard's),
with each of that shard's trees that was passed in (a pool or cache
changed in place) handed back as its ``ShardedTree``.

Devices: on ``cuda`` the mesh takes ``cuda:0..n-1`` with ``n =
torch.cuda.device_count()``, and a mesh larger than that raises the
reference's "needs N devices, have M"; it never shrinks.  On the CPU the
count is ``set_cpu_device_count`` (the counterpart of the reference's
``jax_num_cpu_devices``; tests set 8), every entry ``cpu``.  An explicit
``devices=`` list may repeat a device: that puts several shards on one
card.

Meshes that span processes (``multihost.global_mesh``, one process a
card): each shard belongs to one process (``process_of``), which runs it
(``owned``); ``run`` runs only this process's shards, and a
``ShardedTree`` of such a mesh holds only this process's trees (None for
the others').  A collective whose group lies inside this process is the
baton exchange above.  A group that spans processes takes the baton round
too, then the first of this process's shards to take the baton back
exchanges this process's deposits for every such group of the axis with
the other processes (``_SharePlan``: one ``all_gather`` of the deposits'
bytes over the group's ``torch.distributed`` group, the groups in one
fixed order), so every member reads the whole slot list and computes the
collective from it in flat shard order, exactly as above: the same bits
as the one-process mesh of the same shape.  The process groups are made
once, when the mesh is built, in one order on every process.  Every
member's deposit in a group has the same shapes and dtypes; a round where
some members deposit None (a pipeline's bubble ticks) names its senders
and their deposit's shapes in a ``RoundPlan``, which every process knows
from its static schedule, and exchanges only the senders' deposits.
``crossed_bytes`` counts what this process received.

Autograd across processes: the graph is cut at every exchange between
processes.  Each becomes a ``torch.autograd.Function`` whose backward is
the adjoint: every process's gradients for the other processes' deposits
summed onto their owners (one ``all_reduce`` over the group).  So that
every process enters every adjoint, in one order, the exchanges of a
forward are chained by a token (``open_tape``): each takes the previous
one's token and gives the next, and the backward starts from the last
token as well as from the result and asks for the first token's gradient
too, so it runs every exchange's adjoint one after another, last first,
on every process, whichever results the process's own loss reads and
whether or not this process's deposits reach a parameter.  Every process
holds a copy of a replicated result (``collect``); the backward seeds it
with 1 on the process that owns shard 0 and with 0 on the others
(``value_and_grad``), so the gradients equal the one-process mesh's:
seeding every copy with 1 would count the result once per process.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from seldon_core_tpu_torch.tree import tree_leaves, tree_unflatten

__all__ = ["MeshSpec", "DeviceMesh", "Shard", "ShardedTree", "RoundPlan", "build_mesh",
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


# -- exchanges between processes ----------------------------------------------

#: bytes: every tensor of an exchange's buffer starts at a multiple of this,
#: so its bytes view back as its dtype
_ALIGN = 16
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def _process_group(procs: Tuple[int, ...]):
    """The ``torch.distributed`` group of the processes ``procs`` (None, the
    default group, when they are all of them), made at its first use: every
    process asks for every group in one order (``DeviceMesh``)."""
    if len(procs) == dist.get_world_size():
        return None
    if procs not in _GROUPS:
        _GROUPS[procs] = dist.new_group(list(procs))
    return _GROUPS[procs]


def _comm_device() -> torch.device:
    """Where a tensor crosses processes: this process's card under NCCL,
    the host under gloo (a CUDA tensor goes through the host there, and
    the kernels still run on the card)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = _numel(shape) * dtype.itemsize
    return -(-n // _ALIGN) * _ALIGN


class _SharePlan:
    """One exchange of ``entries`` [(owner process, shape, dtype)] among the
    processes ``procs``, each holding the entries it owns: ``gather`` hands
    every process the others' entries (one ``all_gather`` of each process's
    entries as bytes, onto ``device``); ``reduce`` sums every process's
    gradients for each entry onto its owner (one ``all_reduce`` a float
    dtype), the adjoint of ``gather``.  ``moved`` is the size of the
    gathered buffer this process received (its own part included)."""

    def __init__(self, procs: Tuple[int, ...], me: int, entries, device: torch.device):
        self.group = _process_group(procs)
        self.procs, self.me, self.entries, self.device = procs, me, entries, device
        self.comm = _comm_device()
        self.moved = 0

    def gather(self, mine: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """The entries in order, None for this process's own (``mine``, in
        the order of ``entries``)."""
        sizes = dict.fromkeys(self.procs, 0)
        offsets = []
        for owner, shape, dtype in self.entries:
            offsets.append(sizes[owner])
            sizes[owner] += _nbytes(shape, dtype)
        width = max(sizes.values())
        parts = []
        for t in mine:
            b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(self.comm)
            parts.append(b)
            if _nbytes(t.shape, t.dtype) > b.numel():
                parts.append(b.new_zeros(_nbytes(t.shape, t.dtype) - b.numel()))
        if width > sizes[self.me]:
            parts.append(torch.zeros(width - sizes[self.me], dtype=torch.uint8,
                                     device=self.comm))
        out = torch.empty(len(self.procs) * width, dtype=torch.uint8, device=self.comm)
        dist.all_gather(list(out.split(width)), torch.cat(parts), group=self.group)
        self.moved = out.numel()
        out = out.to(self.device)
        got: List[Optional[torch.Tensor]] = []
        for (owner, shape, dtype), off in zip(self.entries, offsets):
            if owner == self.me:
                got.append(None)
                continue
            at = self.procs.index(owner) * width + off
            got.append(out[at:at + _numel(shape) * dtype.itemsize].view(dtype).reshape(shape))
        return got

    def reduce(self, grads: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        """``grads`` (one an entry, this process's gradient for each of the
        other processes' entries; None is zero) -> the gradients of this
        process's own entries summed over every process, in their order
        (None for a dtype that takes none)."""
        mine: Dict[int, torch.Tensor] = {}
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for j, (_, _, dtype) in enumerate(self.entries):
            if dtype.is_floating_point:
                by_dtype.setdefault(dtype, []).append(j)
        for dtype, idx in by_dtype.items():
            flat = torch.cat([
                grads[j].reshape(-1).to(self.comm, dtype)
                if self.entries[j][0] != self.me and grads[j] is not None
                else torch.zeros(_numel(self.entries[j][1]), dtype=dtype, device=self.comm)
                for j in idx])
            dist.all_reduce(flat, group=self.group)
            flat = flat.to(self.device)
            off = 0
            for j in idx:
                n = _numel(self.entries[j][1])
                if self.entries[j][0] == self.me:
                    mine[j] = flat[off:off + n].reshape(self.entries[j][1])
                off += n
        return [mine.get(j) for j, e in enumerate(self.entries) if e[0] == self.me]


class _ShareFn(torch.autograd.Function):
    """``_SharePlan.gather`` in the graph, its backward ``reduce``; the
    token chains the exchanges of a forward (module docstring)."""

    @staticmethod
    def forward(ctx, plan: _SharePlan, token, *mine):
        ctx.plan = plan
        ctx.devices = [t.device for t in mine]
        got = [t for t in plan.gather(mine) if t is not None]
        ctx.mark_non_differentiable(*[t for t in got if not t.is_floating_point()])
        return (token.clone(), *got)

    @staticmethod
    @once_differentiable
    def backward(ctx, dtoken, *dgot):
        plan = ctx.plan
        it = iter(dgot)
        grads = [None if owner == plan.me else next(it) for owner, _, _ in plan.entries]
        mine = plan.reduce(grads)
        return (None, torch.zeros_like(dtoken),
                *[None if g is None else g.to(d) for g, d in zip(mine, ctx.devices)])


def _flat(deposit) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]], Any]]:
    """A deposit (a tensor or a tuple of them) as its tensors and the way
    back."""
    if isinstance(deposit, torch.Tensor):
        return [deposit], lambda ts: ts[0]
    if isinstance(deposit, tuple) and deposit and all(isinstance(t, torch.Tensor)
                                                       for t in deposit):
        return list(deposit), tuple
    raise ValueError("a collective across processes needs a tensor (or a tuple of tensors) "
                     f"from every shard, got {type(deposit).__name__}")


@dataclass(frozen=True)
class RoundPlan:
    """What every member of a group deposits in one round, known to every
    process without asking (a static schedule's): ``sends[r]`` whether the
    member of rank ``r`` along the axis deposits a tensor (the others
    deposit None), ``like`` that tensor's (shape, dtype).  A round across
    processes then exchanges only the senders' tensors, and a process none
    of whose members sends still knows what it receives."""

    sends: Tuple[bool, ...]
    like: Tuple[Tuple[int, ...], torch.dtype]


@dataclass
class _CrossGroup:
    """A group of one axis that spans processes: its slots, its members in
    rank order, its processes and the ranks of this process's members."""

    group: "_Group"
    members: List[int]
    procs: Tuple[int, ...]
    local_ranks: List[int]


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
    ``device_list`` the flat order that ``ShardedTree`` follows.
    ``process_of`` (an array of that shape, default every shard this
    process's) names the process that holds each shard; ``owned`` are this
    process's shards, whose entries of ``devices`` are its devices (the
    others' are None)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], process_of=None):
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
        self.process_of = ([0] * self.size if process_of is None
                           else [int(p) for p in np.asarray(process_of).flat])
        self.process = 0 if process_of is None else dist.get_rank()
        self.owned = [i for i in range(self.size) if self.process_of[i] == self.process]
        if not self.owned:
            raise ValueError(f"mesh {self.shape} gives process {self.process} no shard")
        self._next = {i: self.owned[(k + 1) % len(self.owned)] for k, i in enumerate(self.owned)}
        self.spans_processes = len(set(self.process_of)) > 1
        self._spans = dict.fromkeys(self.axis_names, False)
        self._cross: Dict[str, List[_CrossGroup]] = {a: [] for a in self.axis_names}
        self._token: Optional[torch.Tensor] = None
        #: bytes this process received from the exchanges between processes
        #: (``_SharePlan.moved``) since the mesh was built, by the axis whose
        #: collective exchanged them ("collect" for ``collect``)
        self.crossed_bytes: Dict[str, int] = {}
        if self.spans_processes:
            self._join_processes()

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, devices={[str(d) for d in self.device_list]})"

    def coords(self, index: int) -> Dict[str, int]:
        return dict(self._coords[index])

    def _group_key(self, axis: str, index: int) -> Tuple[str, Tuple[int, ...]]:
        c = self.coords(index)
        return axis, tuple(int(v) for k, v in c.items() if k != axis)

    def group(self, axis: str, index: int) -> _Group:
        return self._shard_groups[axis, index]

    def owns(self, index: int) -> bool:
        return self.process_of[index] == self.process

    @property
    def first_device(self) -> torch.device:
        """This process's first shard's device: where a sharded program's
        gathered answer lands."""
        return self.device_list[self.owned[0]]

    def replica_groups(self, split: Sequence[str]) -> List[List[int]]:
        """The shards grouped by their coordinates along ``split``: the
        shards of a group hold the same block of a leaf split by ``split``."""
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i in range(self.size):
            groups.setdefault(tuple(self._coords[i][a] for a in split), []).append(i)
        return list(groups.values())

    def _procs(self, members: Sequence[int]) -> Tuple[int, ...]:
        return tuple(sorted({self.process_of[i] for i in members}))

    def _join_processes(self) -> None:
        """Every process group the mesh's exchanges may take (an axis's
        groups, ``sum_replicas``' groups by any split axes, ``collect``'s
        whole mesh), made in one sorted order on every process; and this
        process's groups of each axis that span processes."""
        sets = {self._procs(range(self.size))}
        for r in range(len(self.axis_names) + 1):
            for split in itertools.combinations(self.axis_names, r):
                sets.update(p for p in map(self._procs, self.replica_groups(split)) if len(p) > 1)
        for procs in sorted(sets):
            _process_group(procs)
        for axis in self.axis_names:
            others = [a for a in self.axis_names if a != axis]
            for members in sorted(self.replica_groups(others),
                                  key=lambda m: self._group_key(axis, m[0])):
                members = sorted(members, key=lambda i: self._coords[i][axis])
                procs = self._procs(members)
                if len(procs) < 2:
                    continue
                self._spans[axis] = True
                counts = {p: sum(self.process_of[i] == p for i in members) for p in procs}
                if len(set(counts.values())) > 1:
                    raise ValueError(f"mesh {self.shape}: a group along {axis!r} holds "
                                     f"{counts} shards on its processes; every process of "
                                     f"a group needs as many")
                if self.process in procs:
                    self._cross[axis].append(_CrossGroup(
                        self.group(axis, members[0]), members, procs,
                        [r for r, i in enumerate(members) if self.owns(i)]))

    def spans(self, axis: str) -> bool:
        """Whether ``axis``'s groups cross processes."""
        return self._spans.get(axis, False)

    @property
    def distinct_devices(self) -> List[torch.device]:
        """This process's devices, each once."""
        seen: List[torch.device] = []
        for i in self.owned:
            if self.device_list[i] not in seen:
                seen.append(self.device_list[i])
        return seen

    def run(self, fn: Callable[[Shard], Any]) -> List[Any]:
        """``fn(shard)`` once per shard of this process (the first on this
        thread), each with its device current, the caller's CUDA stream of
        that device and the caller's grad and inference modes, taking turns
        at the collectives (module docstring); returns the results in shard
        order (None for the other processes' shards).  A shard that raises
        wakes the others, which stop at their next collective; the first
        error raises here.  One run at a time per mesh."""
        if current_shard() is not None:
            raise RuntimeError("DeviceMesh.run called from inside a shard")
        with self._lock:
            own = self.owned
            n = len(own)
            self._batons = {i: threading.Semaphore(0) for i in own}
            self._rounds = dict.fromkeys(own, 0)
            self._crossed = -1
            self._aborted = False
            grad = torch.is_grad_enabled()
            inference = torch.is_inference_mode_enabled()
            streams = {d.index: torch.cuda.current_stream(d)
                       for d in self.distinct_devices if d.type == "cuda"}
            results: List[Any] = [None] * self.size
            errors: List[Optional[BaseException]] = [None] * self.size

            def work(i: int) -> None:
                shard = Shard(self, i)
                _TLS.shard = shard
                try:
                    if i != own[0]:
                        self._take(i)
                    with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                            _on_device(shard.device, streams):
                        results[i] = fn(shard)
                except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                    errors[i] = e
                    self._aborted = True
                    for b in self._batons.values():
                        b.release(n)
                finally:
                    _TLS.shard = None
                    self._batons[self._next[i]].release()  # the rest run on

            done = threading.Semaphore(0)

            def job(i: int) -> None:
                try:
                    work(i)
                finally:
                    done.release()

            for i in own[1:]:
                w = self._workers[i]
                if w is None or not w.hand(job):
                    self._workers[i] = w = _Worker(i)
                    w.hand(job)
            work(own[0])
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

    def _exchange(self, shard: "Shard", axis: str, t,
                  plan: Optional[RoundPlan] = None) -> List[Any]:
        """Deposit ``t`` in this round's slots of the shard's group along
        ``axis``, pass the baton round the ring and take it back: then every
        shard of this process has deposited.  The first shard back fills in
        the other processes' deposits of every group of the axis that spans
        processes (``_cross_round``, by ``plan`` when the round has one:
        every shard of the round passes the same)."""
        i = shard.index
        r = self._rounds[i]
        self._rounds[i] = r + 1
        slots = self.group(axis, i).slots[r % 2]
        slots[self._coords[i][axis]] = t
        self._batons[self._next[i]].release()
        self._take(i)
        if self._cross[axis] and self._crossed < r:
            self._crossed = r
            self._cross_round(axis, r % 2, plan)
        return slots

    def _cross_round(self, axis: str, parity: int, plan: Optional[RoundPlan] = None) -> None:
        """The other processes' deposits into every group of ``axis`` that
        spans processes: every member's without a ``plan`` (each deposit
        shaped like this process's first), else the senders' only (None in
        the others' slots)."""
        for cg in self._cross[axis]:
            slots = cg.group.slots[parity]
            if plan is None:
                sends = [True] * len(cg.members)
                first, rebuild = _flat(slots[cg.local_ranks[0]])
                like = [(tuple(t.shape), t.dtype) for t in first]
            else:
                sends, like, rebuild = plan.sends, [plan.like], lambda ts: ts[0]
            mine = []
            for r in cg.local_ranks:
                if sends[r]:
                    ts = _flat(slots[r])[0]
                    if [(tuple(t.shape), t.dtype) for t in ts] != list(like):
                        raise ValueError(f"a deposit along {axis!r} across processes is "
                                         f"{[(tuple(t.shape), t.dtype) for t in ts]}, the round "
                                         f"expects {list(like)}")
                    mine += ts
            entries = [(self.process_of[m], shape, dtype)
                       for r, m in enumerate(cg.members) if sends[r] for shape, dtype in like]
            got = iter(self._share(cg.procs, entries, mine,
                                   self.device_list[cg.members[cg.local_ranks[0]]], axis)
                       if entries else ())
            for r, m in enumerate(cg.members):
                part = [next(got) for _ in like] if sends[r] else None
                if not self.owns(m):
                    slots[r] = None if part is None else rebuild(part)

    def _share(self, procs: Tuple[int, ...], entries, mine: Sequence[torch.Tensor],
               device: torch.device, what: str) -> List[Optional[torch.Tensor]]:
        """``_SharePlan.gather``, in the graph (``_ShareFn``, chained by the
        token) while a tape is open and grad is enabled; its bytes counted
        under ``what``."""
        plan = _SharePlan(procs, self.process, entries, device)
        if torch.is_grad_enabled() and self._token is not None:
            self._token, *got = _ShareFn.apply(plan, self._token, *mine)
            self.crossed_bytes[what] = self.crossed_bytes.get(what, 0) + plan.moved
            it = iter(got)
            return [None if owner == self.process else next(it) for owner, _, _ in entries]
        if torch.is_grad_enabled() and any(t.requires_grad for t in mine):
            raise RuntimeError("a differentiable collective across processes runs under "
                               "DeviceMesh.value_and_grad (or open_tape): without the "
                               "tape its adjoint would not run on every process")
        got = plan.gather(mine)
        self.crossed_bytes[what] = self.crossed_bytes.get(what, 0) + plan.moved
        return got

    def collect(self, values: Sequence[Any], indices: Sequence[int]) -> List[torch.Tensor]:
        """``values[i]`` (a run's per-shard results) of the shards
        ``indices``, in that order, on this process's first device: the
        other processes' read across (differentiable under the tape), so
        every process holds the same bits."""
        dev = self.first_device
        if not self.spans_processes:
            return [values[i].to(dev) for i in indices]
        procs = self._procs(range(self.size))
        meta: List[Any] = [None] * len(procs)
        dist.all_gather_object(meta, {i: (tuple(values[i].shape), values[i].dtype)
                                      for i in indices if self.owns(i)},
                               group=_process_group(procs))
        known = {i: m for part in meta for i, m in part.items()}
        got = self._share(procs, [(self.process_of[i], *known[i]) for i in indices],
                          [values[i] for i in indices if self.owns(i)], dev, "collect")
        return [values[i].to(dev) if g is None else g for i, g in zip(indices, got)]

    def open_tape(self) -> None:
        """Start chaining this process's exchanges between processes (module
        docstring): a forward whose gradient is taken runs after this."""
        self._token = torch.zeros((), requires_grad=True) if self.spans_processes else None

    def close_tape(self) -> Optional[torch.Tensor]:
        """The chain's last token (None on a one-process mesh): the second
        root of the backward."""
        token, self._token = self._token, None
        return token

    def value_and_grad(self, forward: Callable[[], torch.Tensor], inputs: Sequence[torch.Tensor],
                       grad_output: Optional[torch.Tensor] = None):
        """(``forward()`` detached, its gradient at each of ``inputs``, None
        where it does not reach): ``torch.autograd.grad`` on a one-process
        mesh.  Across processes the forward runs under the tape and the
        backward starts from its result, seeded with ``grad_output`` (default
        ones) on the process that owns shard 0 and zeros on the others, and
        from the tape's token (module docstring)."""
        if not self.spans_processes:
            out = forward()
            return out.detach(), torch.autograd.grad(out, inputs, grad_output, allow_unused=True)
        self.open_tape()
        start = self._token
        try:
            out = forward()
        finally:
            token = self.close_tape()
        seed = torch.ones_like(out) if grad_output is None else grad_output
        if not self.owns(0):
            seed = torch.zeros_like(seed)
        # the chain's first token is asked for too: autograd runs only the
        # nodes on a path to an input, and an exchange whose deposits here
        # reach no parameter (a pipeline stage's bubble tick) would be
        # skipped on this process and run on the others
        grads = torch.autograd.grad([out, token], [*inputs, start],
                                    [seed, torch.zeros_like(token)], allow_unused=True)
        return out.detach(), grads[:-1]

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
    device ``i`` holds (a dict of tensors, or a tensor; None for a shard of
    another process, ``DeviceMesh.owned``).  ``specs``, when
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
    """This process's first shard's tree of a ``ShardedTree`` (shard 0's on
    a one-process mesh), else the tree itself."""
    return tree.shards[tree.mesh.owned[0]] if isinstance(tree, ShardedTree) else tree


def shard_batch(mesh: DeviceMesh, x, axis: str = "dp") -> ShardedTree:
    """A host batch split along its leading axis over ``axis`` (each
    shard's rows on its device), or replicated when the mesh has no such
    axis."""
    t = torch.as_tensor(np.asarray(x))
    if axis not in mesh.shape:
        return ShardedTree(mesh, [t.to(d) if mesh.owns(i) else None
                                  for i, d in enumerate(mesh.device_list)])
    n = mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"batch of {t.shape[0]} rows not divisible over {axis!r} of size {n}")
    rows = t.shape[0] // n
    return ShardedTree(mesh, [t[mesh.coords(i)[axis] * rows:(mesh.coords(i)[axis] + 1) * rows]
                              .to(d) if mesh.owns(i) else None
                              for i, d in enumerate(mesh.device_list)])


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
    device's tree holds its blocks (this process's devices only).  A
    replicated leaf whose device is the shard's is shared, not copied."""
    specs = _replicated_specs(tree) if specs is None else specs

    def walk(t, spec, i):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k], i) for k in t}
        return _place(t, spec, mesh.coords(i), mesh, mesh.device_list[i])

    return ShardedTree(mesh, [walk(tree, specs, i) if mesh.owns(i) else None
                              for i in range(mesh.size)], specs)


def sum_replicas(tree: ShardedTree) -> ShardedTree:
    """Each leaf replaced, on every shard, by the sum of the copies of that
    leaf over the shards that hold the same block of it (those that agree
    on every axis its spec in ``tree.specs`` splits by; no specs: every
    leaf replicated), added in flat shard order: the same bits on every
    copy, on every process (the other processes' copies read across).  The
    gradient of a replicated parameter is that sum (the all-reduce GSPMD
    inserts)."""
    mesh = tree.mesh
    own = mesh.owned
    specs = tree_leaves(_replicated_specs(tree.shards[own[0]]) if tree.specs is None
                        else tree.specs)
    flat = {i: tree_leaves(tree.shards[i]) for i in own}
    out = {i: list(f) for i, f in flat.items()}
    plan = []
    for n, spec in enumerate(specs):
        axes = [a for a in spec if a is not None and mesh.shape.get(a, 1) > 1]
        plan += [(n, m) for m in mesh.replica_groups(axes) if any(map(mesh.owns, m))]
    remote = _remote_copies(mesh, flat, plan)
    for n, members in plan:
        sums: Dict[torch.device, torch.Tensor] = {}
        for i in members:
            if not mesh.owns(i):
                continue
            dev = flat[i][n].device
            if dev not in sums:
                sums[dev] = sum_onto([flat[j][n] if mesh.owns(j) else remote[n, j]
                                      for j in members], dev)
            out[i][n] = sums[dev]
    return ShardedTree(mesh, [tree_unflatten(tree.shards[i], out[i]) if mesh.owns(i) else None
                              for i in range(mesh.size)], tree.specs)


def _remote_copies(mesh: DeviceMesh, flat: Dict[int, List[torch.Tensor]], plan):
    """{(leaf n, shard j): the copy of leaf n that shard j of another process
    holds} for every group of ``plan`` [(n, members)] that spans processes:
    one exchange a set of processes, in one order on every process."""
    by_procs: Dict[Tuple[int, ...], list] = {}
    for n, members in plan:
        procs = mesh._procs(members)
        if len(procs) > 1:
            by_procs.setdefault(procs, []).append((n, members))
    remote = {}
    for procs in sorted(by_procs):
        entries, keys, mine = [], [], []
        for n, members in by_procs[procs]:
            like = flat[next(i for i in members if mesh.owns(i))][n]
            for j in members:
                entries.append((mesh.process_of[j], tuple(like.shape), like.dtype))
                keys.append((n, j))
                if mesh.owns(j):
                    mine.append(flat[j][n])
        got = _SharePlan(procs, mesh.process, entries, mesh.first_device).gather(mine)
        remote.update({k: g for k, g in zip(keys, got) if g is not None})
    return remote


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


def _exchange(t, axis: str, plan: Optional[RoundPlan] = None) -> Optional[List[Any]]:
    """The group's tensors of this round along ``axis``, in shard order
    (None outside a shard or on an axis of size 1)."""
    shard = current_shard()
    if shard is None or shard.mesh.shape.get(axis, 1) == 1 or _hidden(axis):
        return None
    return shard.mesh._exchange(shard, axis, t, plan)


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


def ring_shift(t, axis: str, plan: Optional[RoundPlan] = None):
    """``lax.ppermute`` over ``axis`` with the permutation i -> i + 1: the
    calling shard gets the ``t`` of its predecessor along ``axis``
    (cyclically), read onto its device, in one baton round.  ``t`` is a
    tensor, a tuple of tensors (moved together in that one round), or None
    (a shard with nothing to send; its successor gets None).  Across
    processes a round where some shards send None needs its ``plan``
    (``RoundPlan``: who sends, and what), the same on every shard."""
    slots = _exchange(t, axis, plan)
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
    docstring); called from inside a shard, ``fn`` runs on that shard.
    The caller gets this process's first shard's result (shard 0's on a
    one-process mesh)."""
    mesh = _find_mesh(args, kwargs)
    if mesh is None:
        return fn(*args, **kwargs)

    def body(shard: Shard):
        return fn(*(_local(a, shard) for a in args),
                  **{k: _local(v, shard) for k, v in kwargs.items()})

    shard = current_shard()
    if shard is not None and shard.mesh is mesh:
        return body(shard)
    lead = mesh.owned[0]
    out = mesh.run(body)[lead]
    lifted = {id(a.shards[lead]): a for a in list(args) + list(kwargs.values())
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
    in lockstep, one ``run`` an item; yields this process's first shard's
    items."""
    mesh = _find_mesh(args, kwargs)
    lead = mesh.owned[0]
    gens = mesh.run(lambda s: fn(*(_local(a, s) for a in args),
                                 **{k: _local(v, s) for k, v in kwargs.items()}))
    end = object()
    while True:
        items = mesh.run(lambda s: next(gens[s.index], end))
        if items[lead] is end:
            return
        yield items[lead]
