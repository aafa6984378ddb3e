"""Continuous-batching generation server over a paged KV pool — the port's
counterpart of ``seldon_core_tpu/runtime/genserver.py`` (float and int8
pools, the unified role).

The static lane runs ``generate`` once per request: the request's batch
holds the device for its whole life, and a late arrival waits for it.
Here every row of every request is a sequence of its own, scheduled step
by step on one worker thread:

  * **Paged KV pool**: one pool of fixed-size blocks per layer
    (``models/generate.py`` ``init_block_pool``; block 0 is the scratch
    block), a block table per sequence; ``BlockAllocator`` hands out and
    takes back block ids on the host.  An int8 cache's pools carry their
    scale planes; the allocator, preemption and the prefix tails are the
    same, the kernels their int8-K/V variants.
  * **Per-tick admission**: each tick admits waiting sequences into free
    slots, the highest latency tier first and FIFO within a tier, runs one prefill tick (one ``prefill_chunk`` piece of
    every prefilling sequence's prompt, batched) and one decode round
    (``span`` steps of every running sequence,
    ``paged_decode_round``), retires finished rows and hands their tokens
    to the requests' futures and stream queues.
  * **Preemption**: when the pool runs dry a sequence of the lowest tier
    present, the youngest of that tier (running or prefilling), gives its
    blocks back and waits at the front of the
    queue; it re-prefills its prompt and the tokens it already emitted,
    and resumes with the token it had pending, never re-sampled.

Row and table shapes are bucketed to powers of two, and a round's
positions live in device tensors, so the round is the static-shape
program a CUDA graph can capture.  All device work runs on the scheduler
thread, under ``torch.inference_mode``, on the unit's device and, on
CUDA, on a stream of its own; the round's one host sync is its [B, span]
token readback (with the rows' keys when sampling), a prefill tick's the
[B] first tokens.  On CUDA with ``use_flash`` the constructor builds and
probes the lane's two kernels (``flash_decode_paged``, which also takes
each decode step's K/V write and is probed at the pool's block size and
the head shape it decodes, the draft's in speculative mode, and
``kv_write_paged``, the prefill tick's, the prefix's and the verify's
write) and raises if either fails: the engine never falls back to the
static lane quietly.  A unit over a device mesh hands its mesh over
(``continuous_spec``): the pool's KV heads lie over its ``tp`` axis
(``runtime/servingmesh.py`` ``shard_gen_pool``), every tick's paged
program runs on every shard from the scheduler thread (its tables and
tokens copied to each shard's device), both kernels are probed on every
device of the mesh at one shard's head shape, and ``snapshot()["mesh"]``
is the mesh's axes.

Three serving modes beside greedy decoding, as the reference composes
them:

  * **Sampling** (``temperature > 0``, ``top_k``, ``top_p``): each
    sequence carries its own key, ``fold_in(key(seed), sequence counter)``
    (``models/prng.py``), split once a step on the device inside the round
    (``paged_decode_round``'s per-row keys, written back after the
    round's one readback), so a row's draws never depend on the rows it is
    batched with.  The first token after prefill spends one split too.
  * **Shared prefix** (a unit's ``prefix_tokens``: ``prefix_cache``, B=1,
    P positions): its full blocks are written once at start-up
    (``paged_write_prefix_blocks``) and pinned, and every sequence's table
    starts with them; the partial last block is private, copied into each
    admitted sequence's first block (``paged_write_prefix_tail``, again
    after a preemption), and the suffix prefills from position P.
  * **Speculative** (``draft_params``, ``draft_cfg``, ``spec_k``): a draft
    pool with an allocator of its own; every prefill tick also prefills
    the draft, and each round is ``paged_spec_round`` (k + 1 draft steps
    through ``flash_decode_paged``, one (k + 1)-wide target verify through
    ``kv_write_paged`` and the plain attention, greedy acceptance).  As in
    the reference it is greedy, float pools, no prefix.

Greedy output is token-identical to ``generate`` (the tests pin it
against the JAX package on the CPU), with and without a prefix, and the
speculative lane's is the target's greedy decoding.

Tuning knobs, the reference's names and defaults:
``SELDON_TPU_GEN_BLOCK_SIZE`` (16), ``SELDON_TPU_GEN_POOL_BLOCKS``
(1024), ``SELDON_TPU_GEN_SLOTS`` (64), ``SELDON_TPU_GEN_SPAN`` (8),
``SELDON_TPU_GEN_PREFILL_CHUNK`` (128, the interleave floor),
``SELDON_TPU_GEN_PREFILL_CHUNK_MAX`` (512, the adaptive chunk's ceiling)
and ``SELDON_TPU_GEN_MAX_WAITING`` (4096 sequences queued before a typed
503).  ``SELDON_TPU_GEN_CONTINUOUS=0`` keeps the static lane
(``runtime/engine.py``).

Telemetry (``genserver.py:792``, ``:915-1000``, ``:1984-2141`` there):
the scheduler registers the decode step's analytic cost features
(``gen_decode_step``) with the perf observatory at device init, and every
tick writes ONE telemetry-spine record carrying its decomposition: the
host wall of each phase (admit, prefill, decode, retire), the device
seconds of the prefill and decode phases, real and padded rows, the
device steps the decode rounds ran, the cache positions they streamed,
the blocks the tables covered and the KV blocks released with their age,
and the bubble before it (the gap since the previous tick, by how that
tick ended: host, admission stall, pool exhaustion or idle).  The
``/genperf`` recorder (``utils/genperf.py``) folds it off-path.  A
phase's device seconds run from its first launch to the end of the
readback the phase already makes (the round reads its tokens back once,
a prefill tick its first tokens): wall to readback, not kernel time, with
no sync added to measure.  The recorder's gauges and counters move per
tick (in-flight and waiting sequences, KV blocks, steps by kind,
admissions, retirements by reason), a stream's TTFT and decode rate per
stream, the speculative accept ratio per round; a sampled request's
sequences each leave a ``gen_sequence`` span with their lifecycle as
events.

Cost attribution (``genserver.py:457-463``, ``:987-1000``, ``:1104-1130``
there): each request carries its submitter's tenant and tier
(``runtime/qos.py``); with the cost ledger on (``SELDON_TPU_COSTLEDGER``)
each tick's record carries per-phase tenant splits (prefill: the chunk's
real prompt tokens against the B x C capacity; decode: one unit a live
sequence against the B rows; the first token and the served tokens noted
besides) and the KV-block-seconds of the blocks released at retire and
preempt, for ``utils/costledger.py`` to fold.  A sequence under postmortem
tail capture (a sampled-out trace whose ``pm`` bit is set) keeps its
lifecycle events and leaves its ``gen_sequence`` span ``pm_only``.

The policies (``genserver.py:466-620``, ``:1059-1150``, ``:1250-1254``
there): ``submit`` and ``stream`` take the request's ``tier`` (the bound
one by default); the brownout ladder (``runtime/brownout.py``) sheds a tier
it sheds at admission with a typed 503, scales ``max_new`` at stage 2 and
above (so the answer's ``[B, max_new]`` shape follows the scaled length),
and holds the prefill chunk at its floor (the adaptive probe pauses); the
waiting queue is one of the ladder's depth signals, registered through a
weak reference and unregistered at ``stop``; a full queue's shed counts in
``seldon_tpu_autopilot_shed_total{where="gen_queue"}``; ``prewarm`` runs
one probe request a width end to end before the server binds, and the
snapshot counts sequences by tier.

The disaggregated roles (``genserver.py:99-160``, ``:225-290``,
``:333-360``, ``:521-531``, ``:1385-1391``, ``:1615-1900`` there; ``role``,
``coordinator``): a ``prefill`` scheduler hands each sequence whose
prompt it consumed to its ``DisaggCoordinator`` (``runtime/servingmesh.py``)
instead of decoding it: the blocks are read back in the wire's layout
(``runtime/kvstream.py`` ``export_blocks``) and go straight back to the
pool, and the decode peer's tokens finish the request when they come
back (``_drain_handoff_done``).  A ``decode`` scheduler serves hand-offs
only (a client generation answers a typed 503): the relay's handlers
reserve blocks (``kv_reserve``: RESERVED in the allocator, out of the
free list and refused by ``free``), stage the streamed blocks on the host
(``kv_receive``) and queue the sequence at commit (``kv_commit``); the
scheduler thread scatters the staged blocks into its pool
(``_import_admit``) and the sequence joins the decode loop where a local
prefill would have put it.  A reservation not committed within
``SELDON_TPU_KV_HANDOFF_TTL_S`` (30 s), an abort, or a commit before every
block arrived gives its blocks back.  Speculative mode under a role is
refused with the reference's words.  Prefill ticks launch
``kv_write_paged``, decode rounds ``flash_decode_paged`` (with the step's
write fused in), so a decode replica launches no ``kv_write_paged``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
import queue
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.messages import LoadShedError, SeldonMessageError
from seldon_core_tpu_torch.models import prng
from seldon_core_tpu_torch.models.generate import (
    init_block_pool,
    paged_decode_round,
    paged_forward,
    paged_spec_round,
    paged_write_prefix_blocks,
    paged_write_prefix_tail,
    sample_token,
)
from seldon_core_tpu_torch.ops.flash_decode import probe_paged_decode_kernel
from seldon_core_tpu_torch.parallel.mesh import first_shard
from seldon_core_tpu_torch.ops.kv_write import probe_kv_write_paged
from seldon_core_tpu_torch.runtime import kvstream
from seldon_core_tpu_torch.runtime.autopilot import SHED_INFO_PREFIX
from seldon_core_tpu_torch.runtime.brownout import BROWNOUT, BROWNOUT_INFO_PREFIX
from seldon_core_tpu_torch.runtime.qos import current_tenant, current_tier, tier_rank
from seldon_core_tpu_torch.utils.costledger import costledger_enabled
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.perf import OBSERVATORY
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import TRACER, Span, current_trace_context, new_span_id

__all__ = ["BlockAllocator", "GenRequest", "GenServer"]

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _kv_dtype(cfg):
    """The pools' dtype when it is not the model's: int8 for ``kv_quant``."""
    return torch.int8 if cfg.kv_quant == "int8" else None


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


class BlockAllocator:
    """Host-side free list over the device block pool.

    Block 0 is the scratch block and is never handed out.  Freed ids go
    back on the list FIFO; any free block serves any sequence (the table
    adds the indirection), so the pool cannot fragment.  ``pin`` marks
    blocks that ``free`` must never take back (the shared prefix's full
    blocks).  ``reserve`` puts blocks in a RESERVED state for an in-flight
    KV import: out of the free list, owned by no sequence (so no eviction
    can take them), refused by ``free`` until ``commit_reserved`` makes
    them a sequence's or ``release_reserved`` gives them back.  Every
    mutation takes the lock: the relay's handlers reserve while the
    scheduler thread allocates."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs at least 2 blocks (1 is scratch)")
        self.num_blocks = int(num_blocks)
        self._free: deque = deque(range(1, self.num_blocks))
        self._pinned: set = set()
        self._reserved: set = set()
        self._lock = threading.Lock()
        self.high_water = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1  # scratch excluded

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None: the caller queues on a full pool, it never
        crashes."""
        with self._lock:
            return self._alloc_locked(n)

    def _alloc_locked(self, n: int) -> Optional[List[int]]:
        if n < 0 or len(self._free) < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        self.high_water = max(self.high_water, self.used)
        return out

    def reserve(self, n: int) -> Optional[List[int]]:
        """n blocks in the RESERVED state, or None."""
        with self._lock:
            blocks = self._alloc_locked(n)
            if blocks is not None:
                self._reserved.update(blocks)
            return blocks

    def commit_reserved(self, blocks: List[int]) -> None:
        """Reserved -> owned: the import committed into a live sequence."""
        with self._lock:
            self._reserved.difference_update(blocks)

    def release_reserved(self, blocks: List[int]) -> None:
        """A torn hand-off's reservation back to the free list (a block not
        reserved is left alone: a double release is harmless)."""
        with self._lock:
            for b in blocks:
                if b in self._reserved:
                    self._reserved.discard(b)
                    self._free.append(b)

    def pin(self, blocks: List[int]) -> None:
        with self._lock:
            self._pinned.update(blocks)

    def free(self, blocks: List[int]) -> None:
        with self._lock:
            for b in blocks:
                if b not in self._pinned and b not in self._reserved:
                    self._free.append(b)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"total": self.capacity, "used": self.used, "pinned": len(self._pinned),
                    "reserved": len(self._reserved), "high_water": self.high_water}


class _Sequence:
    """One row of one request riding the scheduler."""

    __slots__ = ("sid", "request", "prompt", "prompt0", "max_new", "n_valid", "blocks",
                 "draft_blocks", "pending", "prefill_pos", "emitted", "done", "key",
                 "admit_order", "retire_reason", "t_start", "events", "retired")

    def __init__(self, sid: int, request: "GenRequest", prompt: np.ndarray, max_new: int):
        self.sid = sid                  # arrival order: a round's row order
        self.request = request
        self.prompt = prompt            # int32 [S] (the suffix with a prefix): what
        self.prompt0 = prompt           # the next prefill consumes; as submitted
        self.max_new = int(max_new)
        self.n_valid = 0                # cache positions written (the prefix's too)
        self.blocks: List[int] = []     # private blocks only
        self.draft_blocks: List[int] = []  # speculative mode: the draft pool's
        self.pending: Optional[int] = None  # emitted, not yet in the cache
        self.prefill_pos = 0            # prompt tokens consumed
        self.emitted: List[int] = []
        self.done = False
        self.key: Optional[np.ndarray] = None  # sampling: int64 [2] (models/prng.py)
        self.admit_order = -1
        self.retire_reason = ""
        self.retired = False            # its blocks freed, its timeline emitted
        self.t_start = 0.0              # epoch at admission: KV-block age
        self.events: List[dict] = []    # a sampled sequence's lifecycle


class _KvImport:
    """One in-flight KV import at a decode replica: its reserved blocks and
    host staging arrays (the wire's layout), keyed by hand-off id.
    Reserve, receive, commit; a torn hand-off gives every block back."""

    __slots__ = ("hid", "meta", "blocks", "staged", "received", "created", "created_epoch",
                 "seq", "trace_ctx")

    def __init__(self, hid: bytes, meta, blocks: List[int], staged):
        self.hid = hid
        self.meta = meta
        self.blocks = blocks
        self.staged = staged          # per-layer host arrays [n, bs, ...]
        self.received = np.zeros((meta.n_blocks,), bool)
        self.created = time.monotonic()
        self.created_epoch = time.time()
        self.seq: Optional[_Sequence] = None
        #: the hand-off span's context off the BEGIN frame's sidecar
        self.trace_ctx = None

    def receive(self, first: int, layers) -> None:
        n = layers[0]["k"].shape[0] if layers else 0
        if first < 0 or first + n > self.meta.n_blocks:
            raise kvstream.KvWireError(f"block chunk [{first}, {first + n}) outside the "
                                       f"announced {self.meta.n_blocks} blocks")
        for stage, chunk in zip(self.staged, layers):
            for name, arr in chunk.items():
                stage[name][first:first + n] = arr
        self.received[first:first + n] = True

    def complete(self) -> bool:
        return bool(self.received.all())


class GenRequest:
    """One client request: its sequences and how they are delivered, a
    future holding the eos-padded ``[B, max_new]`` int32 tokens (unary) or
    a queue of ``[B, <=chunk]`` arrays ending in None (streaming)."""

    def __init__(self, chunk: Optional[int], max_new: int, tier: Optional[str] = None,
                 tenant: Optional[str] = None):
        self.chunk = chunk              # None: unary
        self.max_new = int(max_new)
        # the submitter's QoS identity, captured on ITS thread (contextvars
        # do not cross into the scheduler thread): the cost ledger bills it
        self.tier = tier or current_tier()
        self.tenant = (tenant if tenant is not None else current_tenant()) or ""
        self.seqs: List[_Sequence] = []
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        # unbounded on purpose: a stream buffers at most max_new tokens a
        # row, and a bounded queue could block the scheduler on a slow reader
        self.queue: "queue.Queue" = queue.Queue()
        self.delivered = 0              # stream tokens handed out per row
        self.cancelled = False
        self.finished = False           # every row retired: answered at tick end
        self.t_submit = time.perf_counter()
        self.ttft_recorded = False
        # the submitter's trace context: the sequences' spans join its tree
        self.trace_ctx = current_trace_context()

    def cancel(self) -> None:
        self.cancelled = True


class GenServer:
    """The continuous-batching scheduler of one generator deployment.

    ``params`` and ``cfg`` are the unit's (``continuous_spec``); the pool
    lives on the params' device.  The worker thread starts at the first
    submit; callers reach it through thread-safe queues and futures."""

    def __init__(self, params, cfg, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_token: int = -1, max_new_tokens: int = 32,
                 prefix_cache=None, draft_params=None, draft_cfg=None, spec_k: int = 4,
                 seed: int = 0, use_flash: bool = False, block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None, slots: Optional[int] = None,
                 span: Optional[int] = None, prefill_chunk: Optional[int] = None,
                 role: str = "unified", coordinator=None, mesh=None):
        self.params = params
        self.cfg = cfg
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token = int(eos_token)
        self.max_new_tokens = int(max_new_tokens)
        self.prefix_cache = prefix_cache
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec = draft_params is not None
        self.spec_k = int(spec_k)
        self.seed = int(seed)
        if self.spec and (self.temperature > 0.0 or cfg.kv_quant == "int8"
                          or prefix_cache is not None):
            # speculative_generate's guards: greedy, float KV
            raise ValueError("speculative continuous mode is greedy/float-KV only")
        if self.spec and role in ("prefill", "decode"):
            # a hand-off would need the draft pool streamed too
            raise ValueError("speculative decoding does not compose with disaggregated "
                             "prefill/decode roles")
        #: the unit's device mesh (``params`` a ShardedTree over it): the
        #: pool's K/V heads lie over its ``tp`` axis (``shard_gen_pool``)
        #: and every paged call runs on every shard
        self.mesh = mesh
        if mesh is not None and mesh.spans_processes:
            # the JAX package runs no scheduler multi-controller either
            raise ValueError("the continuous lane over a mesh that spans processes is not "
                             "supported: serve the static lane (SELDON_TPU_GEN_CONTINUOUS=0)")
        if mesh is not None and (self.spec or role in ("prefill", "decode")):
            raise ValueError("a generator over a device mesh serves unified and "
                             "non-speculative on the continuous lane (ROADMAP item [6b])")
        self.role = role if role in ("unified", "prefill", "decode") else "unified"
        #: what runs the prefill role's hand-offs (runtime/servingmesh.py)
        self.coordinator = coordinator
        #: finished hand-offs back from the coordinator's thread: (seq,
        #: tokens or exception), drained on the scheduler thread
        self._handoff_done: deque = deque()
        #: sequences whose hand-off is in flight: in no scheduler list, so
        #: _fail_all fails them from here
        self._handoff_seqs: Dict[_Sequence, bool] = {}
        self._handoff_inflight = 0
        #: the decode role's in-flight imports by hand-off id, and the
        #: committed ones awaiting admission
        self._imports: Dict[bytes, _KvImport] = {}
        self._remote_arrivals: deque = deque()
        self._import_ttl_s = float(_env_int("SELDON_TPU_KV_HANDOFF_TTL_S", 30))
        self.imports_committed_total = 0
        self.imports_reclaimed_total = 0
        self.use_flash = bool(use_flash)
        self.device = first_shard(params)["embed"].device
        self.block_size = block_size or _env_int("SELDON_TPU_GEN_BLOCK_SIZE", 16)
        self.num_blocks = num_blocks or _env_int("SELDON_TPU_GEN_POOL_BLOCKS", 1024)
        self.slots = slots or _env_int("SELDON_TPU_GEN_SLOTS", 64)
        self.span = span or _env_int("SELDON_TPU_GEN_SPAN", 8)
        self.prefill_chunk = prefill_chunk or _env_int("SELDON_TPU_GEN_PREFILL_CHUNK", 128)
        # a bounded admission queue: sustained overload fails typed (503)
        # with flat memory instead of growing the waiting deques
        self.max_waiting = _env_int("SELDON_TPU_GEN_MAX_WAITING", 4096)
        # the adaptive prefill chunk: prefill_chunk is the floor; while a
        # doubled chunk leaves a tick's wall nearly flat (dispatch-bound)
        # the chunk probes up towards the ceiling, and it backs off and
        # latches the first time doubling makes the tick much slower
        self.prefill_chunk_max = max(_env_int("SELDON_TPU_GEN_PREFILL_CHUNK_MAX", 512),
                                     self.prefill_chunk)
        self._chunk_eff = self.prefill_chunk
        self._chunk_wall: Dict[int, List[float]] = {}  # C -> [ema_s, ticks]
        self._chunk_latched = self._chunk_eff >= self.prefill_chunk_max
        if self.device.type == "cuda" and self.use_flash:
            # the lane's two kernels, built and launched once here: a
            # missing compiler or a failing build raises at construction.
            # The decode kernel at the head shape the lane decodes (the
            # draft's in speculative mode), the write at every pool's
            # (int8 pools probe the int8-K/V variants)
            # (over a mesh at one shard's heads, on every device of it)
            decoder = draft_cfg if self.spec else cfg
            tp = 1 if mesh is None else mesh.shape.get("tp", 1)
            for dev in [self.device] if mesh is None else mesh.distinct_devices:
                local = decoder.tp_local(tp)
                probe_paged_decode_kernel(local.kv_heads, local.n_heads // local.kv_heads,
                                          local.head_dim, local.dtype, dev,
                                          self.block_size, _kv_dtype(local))
                for c in (cfg, draft_cfg) if self.spec else (cfg,):
                    c = c.tp_local(tp)
                    probe_kv_write_paged(c.kv_heads, c.head_dim, c.dtype, dev, _kv_dtype(c))
        self._allocator = BlockAllocator(self.num_blocks)
        self._draft_allocator = BlockAllocator(self.num_blocks) if self.spec else None
        self._pool = None
        self._draft_pool = None
        self._prefix_blocks: List[int] = []  # the shared full blocks, pinned
        self._prefix_len = (0 if prefix_cache is None
                            else int(first_shard(prefix_cache)["l0"]["k"].shape[2]))
        self._root_key = prng.key(self.seed)  # on the host: sequences' keys fold in here
        # scheduler state: the worker thread's, except arrivals
        self._arrivals: deque = deque()
        self._waiting: deque = deque()
        self._prefilling: List[_Sequence] = []
        self._active: List[_Sequence] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._seq_counter = 0
        self._admit_counter = 0
        # lifetime counters for /stats
        self.admitted_total = 0
        self.retired_total: Dict[str, int] = {}
        self.preempted_total = 0
        self.steps_total: Dict[str, int] = {}
        self.tokens_emitted_total = 0
        self.tick_errors_total = 0
        # the tick's flight-recorder decomposition (utils/genperf.py)
        self._last_tick_end = 0.0
        self._bubble_cause = "idle"
        self._pool_dry = False               # _admit broke on a dry pool
        self._dev_s: Dict[str, float] = {}   # phase -> device seconds
        self._tick_rows = 0                  # padded rows dispatched
        self._tick_real_rows = 0             # real rows dispatched
        self._tick_dev_steps = 0             # single-token device steps
        self._tick_kv_pos = 0                # cache positions streamed
        self._tick_kv_blocks = 0             # blocks the tables covered
        self._tick_kv_ages: List[tuple] = []  # (n_blocks, age_s) freed
        # requests a tick finished, answered when it ends (``_tick``)
        self._in_tick = False
        self._tick_done: List[tuple] = []
        # cost-ledger scratch: per-phase tenant splits of the tick's padded
        # capacity and the KV-block-seconds freed this tick; None with the
        # ledger off (the tick record then carries no "attr")
        self._tick_attr: Optional[Dict[str, Any]] = None
        self._tick_kv_attr: List[tuple] = []   # (tenant, block_s) freed
        #: deployment identity on /costs rows; the engine stamps it
        self.cost_deployment = ""
        # the waiting queue is a brownout depth signal, read through a weak
        # reference (and unregistered when the scheduler is collected), so
        # the ladder never pins a scheduler dropped without stop()
        self._brownout_key = f"genserver:{id(self)}"
        ref = weakref.ref(self)

        def _depth() -> int:
            sched = ref()
            # len() of a deque needs no lock: a signal read, not an invariant
            return 0 if sched is None else len(sched._waiting) + len(sched._arrivals)

        BROWNOUT.register_depth(self._brownout_key, _depth)
        weakref.finalize(self, BROWNOUT.unregister_depth, self._brownout_key)
        # device work dispatched: prefill ticks, single-token decode steps
        # (each step is one launch of each paged kernel per layer),
        # speculative rounds (k + 1 draft steps and one verify each), prefix
        # tail writes, and the most rows a decode round has carried
        self.prefill_dispatches_total = 0
        self.decode_steps_total = 0
        self.spec_rounds_total = 0
        self.spec_row_rounds_total = 0
        self.spec_accepted_total = 0
        self.prefix_tail_writes_total = 0
        self.decode_round_rows_max = 0

    # -- client surface (any thread) ------------------------------------

    def submit(self, rows, max_new: Optional[int] = None,
               tier: Optional[str] = None) -> GenRequest:
        """Unary generation: rows [B, S] (float wire rows: NaN to 0, then
        clamped to [0, vocab) and truncated, as ``sanitize_prompt``).  The
        request's ``future`` resolves to the eos-padded int32 [B, max_new]
        array, ``generate``'s output (``max_new`` as admission scaled it).
        ``tier`` defaults to the one bound to the calling context."""
        return self._enqueue(rows, chunk=None, max_new=max_new, tier=tier)

    def stream(self, rows, chunk: int = 8, max_new: Optional[int] = None,
               tier: Optional[str] = None):
        """Streaming generation: a generator of [B, <=chunk] int32 arrays
        whose concatenation equals the unary output.  Closing it early
        cancels the request, which frees its blocks at the next tick."""
        req = self._enqueue(rows, chunk=max(1, int(chunk)), max_new=max_new, tier=tier)

        def _iter():
            try:
                while True:
                    item = req.queue.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                if not req.future.done():
                    req.cancel()
                    with self._wake:
                        self._wake.notify_all()

        return _iter()

    def _enqueue(self, rows, chunk, max_new, tier: Optional[str] = None) -> GenRequest:
        if self.role == "decode":
            # a decode replica serves hand-offs only: a client generation
            # here is a routing fault, answered typed and retryable
            from seldon_core_tpu_torch.runtime.servingmesh import RoleMismatchError

            raise RoleMismatchError(
                "this replica is decode-only (--gen-role decode): client generation requests "
                "route to prefill/unified replicas")
        tier = tier or current_tier()
        if BROWNOUT.sheds_tier(tier):
            # typed and retryable, before anything is allocated or queued
            RECORDER.record_brownout_shed(tier)
            raise LoadShedError(
                f"{BROWNOUT_INFO_PREFIX}: {tier!r}-tier generation shed at brownout stage "
                f"{BROWNOUT.stage()} — retry later or resubmit as a higher tier")
        rows = np.asarray(rows, dtype=np.float64)
        if rows.ndim < 2:
            rows = rows.reshape(1, -1)
        if rows.ndim != 2 or rows.shape[0] == 0 or rows.shape[1] == 0:
            raise SeldonMessageError(
                f"generation needs prompt token rows [B, S] with B, S >= 1, got shape "
                f"{rows.shape}")
        # sanitize_prompt's clamp, on the host: NaN to 0, clip to the vocab
        prompts = np.clip(np.nan_to_num(rows), 0, self.cfg.vocab - 1).astype(np.int32)
        max_new = int(max_new or self.max_new_tokens)
        scale = BROWNOUT.gen_max_new_scale()
        if scale < 1.0:
            # stage 2: shorter generations free blocks and slots sooner;
            # scaled at admission, so the answer's [B, max_new] shape holds
            max_new = max(1, int(max_new * scale))
        req = GenRequest(chunk, max_new, tier=tier)
        with self._wake:
            if self._stopped:
                raise RuntimeError("generation scheduler stopped")
            waiting = len(self._waiting) + len(self._arrivals)
            if self.max_waiting > 0 and waiting + len(prompts) > self.max_waiting:
                RECORDER.record_autopilot_shed("gen_queue")
                raise LoadShedError(
                    f"{SHED_INFO_PREFIX}: generation admission queue full ({waiting}/"
                    f"{self.max_waiting} sequences waiting; grow SELDON_TPU_GEN_MAX_WAITING "
                    f"or add replicas)")
            for p in prompts:
                self._seq_counter += 1
                seq = _Sequence(self._seq_counter, req, p, req.max_new)
                self._seq_event(seq, "enqueue", prompt_len=len(p))
                if self.temperature > 0.0:
                    # the sequence's own key: its draws never follow its
                    # place in a round or the rows batched with it
                    seq.key = prng.fold_in(self._root_key, self._seq_counter).numpy()
                req.seqs.append(seq)
                self._arrivals.append(seq)
            self._ensure_thread()
            self._wake.notify_all()
        return req

    def prewarm(self, widths=()) -> int:
        """One probe request a prompt width (4 tokens when none is given,
        at most 4,096), run end to end through admission, the prefill tick
        and a decode round, before the server binds: the lane's kernels
        (``kv_write_paged`` and ``flash_decode_paged``), the pool's
        allocation and the first calls of each op pay their first-use cost
        here.  Returns the number of probes served.  A prefill or decode
        replica probes nothing (a prefill probe would hand off to peers
        that may not be up; a decode replica takes no submits)."""
        if self.role != "unified":
            return 0
        count = 0
        for width in list(widths) or [4]:
            w = width if isinstance(width, int) else int(np.prod(width))
            probe = np.zeros((1, max(1, min(w, 4096))))
            req = self.submit(probe, max_new=min(self.span + 1, self.max_new_tokens))
            try:
                req.future.result(timeout=900)
                count += 1
            except Exception as e:  # noqa: BLE001 - prewarm is best effort
                logger.warning("genserver prewarm width %s failed: %s", width, e)
        return count

    def snapshot(self) -> Dict[str, Any]:
        now = time.time()
        with self._lock:
            waiting = len(self._waiting) + len(self._arrivals)
            inflight = len(self._active) + len(self._prefilling)
            tiers: Dict[str, int] = {}
            ledger: List[Dict[str, Any]] = []
            for coll, state in ((self._waiting, "waiting"), (self._arrivals, "waiting"),
                                (self._prefilling, "prefill"), (self._active, "running")):
                for seq in coll:
                    tiers[seq.request.tier] = tiers.get(seq.request.tier, 0) + 1
                    # the sequence ledger (genserver.py:626-687 there): where
                    # each live sequence stands, for an operator or a
                    # failover peer's re-prefill
                    ledger.append({
                        "sid": seq.sid, "tier": seq.request.tier, "state": state,
                        "prompt_len": int(seq.prompt0.shape[-1]),
                        "emitted": len(seq.emitted), "max_new": seq.max_new,
                        "streaming": seq.request.chunk is not None,
                        "age_s": round(now - seq.t_start, 3) if seq.t_start else None,
                    })
        doc = {
            "mode": "speculative" if self.spec else "decode",
            "role": self.role,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "slots": self.slots,
            "inflight_sequences": inflight,
            "waiting_sequences": waiting,
            "max_waiting": self.max_waiting,
            "sequences_by_tier": tiers,
            "kv_blocks": self._allocator.snapshot(),
            "block_size": self.block_size,
            "span": self.span,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunk_effective": self._chunk_eff,
            "admitted_total": self.admitted_total,
            "retired_total": dict(self.retired_total),
            "preempted_total": self.preempted_total,
            "steps_total": dict(self.steps_total),
            "tokens_emitted_total": self.tokens_emitted_total,
            "tick_errors_total": self.tick_errors_total,
            "prefill_dispatches_total": self.prefill_dispatches_total,
            "decode_steps_total": self.decode_steps_total,
            "decode_round_rows_max": self.decode_round_rows_max,
            "prefix_len": self._prefix_len,
            "prefix_tail_writes_total": self.prefix_tail_writes_total,
            "sequence_ledger": ledger,
        }
        if self.spec:
            doc["draft_kv_blocks"] = self._draft_allocator.snapshot()
            doc["spec_rounds_total"] = self.spec_rounds_total
            doc["spec_row_rounds_total"] = self.spec_row_rounds_total
            doc["spec_accepted_total"] = self.spec_accepted_total
        if self.role == "prefill":
            doc["disagg"] = self.coordinator.snapshot() if self.coordinator is not None else None
            doc["handoff_inflight"] = self._handoff_inflight
        if self.role == "decode":
            doc["imports"] = {"pending": len(self._imports),
                              "committed_total": self.imports_committed_total,
                              "reclaimed_total": self.imports_reclaimed_total}
        return doc

    def chunk_history(self) -> Dict[str, Any]:
        """The adaptive prefill chunk's state for ``GET /genperf``: floor,
        ceiling, effective width, whether the probe latched, and the
        per-width EMA walls the latch was decided from."""
        return {
            "floor": self.prefill_chunk,
            "max": self.prefill_chunk_max,
            "effective": self._chunk_eff,
            "latched": self._chunk_latched,
            "wall_ema_s": {str(c): {"ema_s": round(v[0], 6), "ticks": v[1]}
                           for c, v in sorted(self._chunk_wall.items())},
        }

    def stop(self) -> None:
        """Stop the worker thread; every request still queued or in flight
        fails with "generation scheduler stopped".  The waiting queue stops
        being a brownout signal."""
        BROWNOUT.unregister_depth(self._brownout_key)
        with self._wake:
            self._stopped = True
            self._wake.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10)
        if self.coordinator is not None:
            self.coordinator.close()

    # -- worker thread ---------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="genserver", daemon=True)
            self._thread.start()

    def _device_context(self):
        """The scheduler thread's CUDA stream (after the weights' writes on
        the default stream), or nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.default_stream(self.device))
        return torch.cuda.stream(stream)

    def _run(self) -> None:
        with torch.inference_mode(), self._device_context():
            while True:
                with self._wake:
                    while (not self._stopped and not self._arrivals and not self._waiting
                           and not self._prefilling and not self._active
                           and not self._remote_arrivals and not self._handoff_done):
                        if self._imports:
                            # a reservation is out: wake now and then, so the
                            # TTL reaper reclaims a torn hand-off with no
                            # other work arriving
                            self._wake.wait(1.0)
                            break
                        self._wake.wait()
                    if self._stopped:
                        break
                    while self._arrivals:
                        self._waiting.append(self._arrivals.popleft())
                try:
                    progress = self._tick()
                except Exception as e:  # noqa: BLE001 - the scheduler must outlive a bad tick
                    logger.exception("genserver tick failed")
                    self.tick_errors_total += 1
                    # a silently erroring scheduler must be visible: the
                    # counter family, /genperf and a span under a sampled
                    # request riding the failing tick
                    RECORDER.record_gen_tick_error()
                    from seldon_core_tpu_torch.utils.genperf import GENPERF

                    GENPERF.observe_tick_error()
                    self._stamp_tick_error(e)
                    self._fail_all(e)
                    progress = True
                if not progress:
                    # queued work that cannot run yet (a dry pool): no hot spin
                    with self._wake:
                        self._wake.wait(0.005)
        self._fail_all(RuntimeError("generation scheduler stopped"))

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            committed = list(self._remote_arrivals)
            seqs = (list(self._waiting) + list(self._prefilling) + list(self._active)
                    + list(self._arrivals) + [imp.seq for imp in committed]
                    + list(self._handoff_seqs))
            seqs = list(dict.fromkeys(seqs))
            self._waiting.clear()
            self._arrivals.clear()
            self._remote_arrivals.clear()
            self._handoff_seqs.clear()
            self._handoff_done.clear()
            self._prefilling, self._active = [], []
            imports = list(self._imports.values())
            self._imports.clear()
        for imp in imports + committed:
            # a committed import not yet admitted still holds RESERVED blocks
            self._allocator.release_reserved(imp.blocks)
        for seq in seqs:
            self._release_blocks(seq)
            req = seq.request
            if not req.future.done():
                req.future.set_exception(exc)
            req.queue.put(exc)

    # -- the scheduler step ----------------------------------------------

    def _tick(self) -> bool:
        """``_tick_body``, with the requests it completed answered after it
        (and its telemetry record) ends: a request's answer never overtakes
        the record of the tick that finished it, so ``/genperf``, ``/costs``
        and a postmortem read after the answer see that tick."""
        self._in_tick = True
        try:
            return self._tick_body()
        finally:
            self._in_tick = False
            done, self._tick_done = self._tick_done, []
            for req, out in done:
                self._complete(req, out)

    def _tick_body(self) -> bool:
        """One iteration: admit, one prefill tick, one decode round,
        retire, account.  Exactly one telemetry-spine record per tick,
        with the flight recorder's decomposition: each phase's host wall,
        the device seconds the phases fenced at their readbacks, and the
        bubble before the tick, classified by how the previous tick ended.
        Returns False when no work could run (the loop then backs off
        instead of spinning)."""
        t0 = time.perf_counter()
        bubble_s = max(t0 - self._last_tick_end, 0.0) if self._last_tick_end > 0.0 else 0.0
        bubble_cause = self._bubble_cause
        self._pool_dry = False
        self._dev_s = {}
        self._tick_rows = self._tick_real_rows = 0
        self._tick_dev_steps = self._tick_kv_pos = self._tick_kv_blocks = 0
        self._tick_attr = {} if costledger_enabled() else None
        self._tick_kv_attr = []
        if self._pool is None:
            self._init_device()
        self._drop_cancelled()
        ta = time.perf_counter()
        admitted = self._admit()
        admitted += self._import_admit()
        handed_back = self._drain_handoff_done()
        self._reap_stale_imports()
        phases = {"admit": time.perf_counter() - ta}
        kind = None
        tokens = 0
        if self._prefilling:
            kind = "prefill"
            tp = time.perf_counter()
            tokens = self._prefill_tick()
            phases["prefill"] = time.perf_counter() - tp
        # a first token can finish a sequence (eos, max_new 1): retire it
        # before the round, so it takes neither a slot nor a dispatch
        tr = time.perf_counter()
        retired = self._retire_finished()
        phases["retire"] = time.perf_counter() - tr
        if self._active:
            kind = ("spec" if self.spec else "decode") if kind is None else "mixed"
            td = time.perf_counter()
            tokens += self._spec_round() if self.spec else self._decode_round()
            phases["decode"] = time.perf_counter() - td
        tr = time.perf_counter()
        retired += self._retire_finished()
        phases["retire"] += time.perf_counter() - tr
        # idle spins count: a hot-spinning scheduler reads as a bubble on
        # /genperf, not as silence
        self.steps_total[kind or "idle"] = self.steps_total.get(kind or "idle", 0) + 1
        if kind is not None:
            self.tokens_emitted_total += tokens
        wall = time.perf_counter() - t0
        ages, self._tick_kv_ages = self._tick_kv_ages, []
        detail = {
            "wall_s": wall,
            "device_s": sum(self._dev_s.values()),
            "phases": phases,
            "device_phases": dict(self._dev_s),
            "rows": self._tick_rows,
            "real_rows": self._tick_real_rows,
            "tokens": tokens,
            "steps": self._tick_dev_steps,
            "kv_positions": self._tick_kv_pos,
            "kv_blocks": self._tick_kv_blocks,
            "kv_ages": tuple(ages),
        }
        if bubble_s > 0.0:
            detail["bubble_s"] = bubble_s
            detail["bubble_cause"] = bubble_cause
        if self._tick_attr is not None:
            # the cost ledger's payload, on idle ticks too: their bubbles
            # fold to the ledger's idle bucket (its identity needs every
            # second of wall)
            detail["attr"] = {
                "dep": self.cost_deployment,
                "phases": {
                    phase: {"padded": d["padded"],
                            "tenants": [(t, tr, u, r, tok) for (t, tr), (u, r, tok)
                                        in d["tenants"].items()]}
                    for phase, d in self._tick_attr.items()
                },
                "kv": tuple(self._tick_kv_attr),
            }
        self._publish(admitted, retired, kind or "idle", tokens, wall, detail)
        progress = kind is not None or admitted > 0 or retired > 0 or handed_back > 0
        # the bubble ledger: what the gap before the NEXT tick will mean.
        # Progress re-enters at once (host work); a dry pool idles the card
        # until a retirement frees blocks; queued work that was not
        # admitted is an admission stall; otherwise there is no work
        self._last_tick_end = time.perf_counter()
        if progress:
            self._bubble_cause = "host"
        elif self._pool_dry:
            self._bubble_cause = "pool_exhaustion"
        elif self._waiting or self._arrivals:
            self._bubble_cause = "admission_stall"
        else:
            self._bubble_cause = "idle"
        return progress

    def _register_decode_costs(self) -> None:
        """The served decode lane's analytic per-token cost features,
        registered once at device init under ``gen_decode_step`` (the JAX
        package's formula, ``genserver.py:792-828`` there): the matmul
        FLOPs per generated token, the bytes one device step streams
        whatever the batch (every matmul'd weight once, the unembed once),
        and the bytes a step's attention reads per cache position.
        ``utils/genperf.py`` prices served decode MFU and HBM-bandwidth
        share with them against real tokens.  Never raises."""
        try:
            cfg = self.cfg
            d, L = cfg.d_model, cfg.n_layers
            ff, v = cfg.d_ff, cfg.vocab
            kvh = getattr(cfg, "kv_heads", 0) or cfg.n_heads
            hd = d // cfg.n_heads
            qkv_out = d + 2 * kvh * hd
            per_layer = d * qkv_out + d * d + 2 * d * ff
            wb = 1 if getattr(cfg, "quant", "none") == "int8" else 2
            kv_int8 = getattr(cfg, "kv_quant", "none") == "int8"
            kvb = 1 if kv_int8 else 2
            OBSERVATORY.record_compile("gen_decode_step", {
                "flops": float(2 * (L * per_layer + d * v)),
                "bytes_accessed": float(wb * L * per_layer + 2 * d * v),
                "output_bytes": 0.0,
                "kv_bytes_per_position": float(
                    L * (2 * kvh * hd * kvb + (8 * kvh if kv_int8 else 0))),
            }, None)
        except Exception:  # noqa: BLE001 - accounting must not block serving
            logger.debug("decode cost-feature registration failed", exc_info=True)

    def _publish(self, admitted: int, retired: int, kind: str, tokens: int,
                 duration_s: float, detail: Dict[str, Any]) -> None:
        """The tick's gauges and counters, and its one spine record; a
        traced sequence in the tick lends its trace id, which the tick's
        ``seldon_tpu_dispatch_seconds`` observation carries as an
        exemplar."""
        alloc = self._allocator
        used, total, hw = alloc.used, alloc.capacity, alloc.high_water
        with self._lock:
            waiting = len(self._waiting) + len(self._arrivals)
        inflight = len(self._active) + len(self._prefilling)
        RECORDER.set_gen_scheduler(inflight=inflight, waiting=waiting, blocks_used=used,
                                   blocks_total=total, blocks_high_water=hw)
        RECORDER.set_kv_slots(active=used * self.block_size,
                              reserved=(total - used) * self.block_size)
        RECORDER.record_gen_step(kind)
        trace_id = ""
        if kind != "idle" and TRACER.enabled:
            for s in self._active + self._prefilling:
                ctx = s.request.trace_ctx
                if ctx is not None and ctx.sampled:
                    trace_id = ctx.trace_id
                    break
        SPINE.record_gen_step(
            kind=kind, duration_s=duration_s, active=inflight, waiting=waiting,
            admitted=admitted, retired=retired, blocks_used=used, blocks_total=total,
            tokens=tokens, executable="" if kind == "idle" else f"gen_step:{kind}",
            trace_id=trace_id, detail=detail)

    def _init_device(self) -> None:
        """The pools, on the first tick; with a shared prefix its full
        blocks are written once and pinned (block 0 stays scratch).  Bound
        only when all of it succeeded, so a failure fails every tick rather
        than serving without the prefix."""
        pool = init_block_pool(self.cfg, self.num_blocks, self.block_size, self.device)
        if self.mesh is not None:
            from seldon_core_tpu_torch.runtime.servingmesh import shard_gen_pool

            pool = shard_gen_pool(self.mesh, pool)
        draft = (init_block_pool(self.draft_cfg, self.num_blocks, self.block_size, self.device)
                 if self.spec else None)
        if self.prefix_cache is not None:
            full = self._prefix_len // self.block_size
            if full:
                blocks = self._allocator.alloc(full)
                if blocks is None:
                    raise RuntimeError(f"KV pool ({self.num_blocks} blocks) smaller than the "
                                       f"shared prefix ({full} blocks)")
                paged_write_prefix_blocks(pool, self.prefix_cache, blocks, self.cfg,
                                          self.use_flash)
                self._allocator.pin(blocks)
                self._prefix_blocks = blocks
        self._pool, self._draft_pool = pool, draft
        self._register_decode_costs()

    def _drop_cancelled(self) -> None:
        for coll in (self._waiting, self._prefilling, self._active):
            for seq in [s for s in coll if s.request.cancelled]:
                coll.remove(seq)
                self._retire(seq, "cancelled")

    def _blocks_needed(self, upto: int) -> int:
        return -(-upto // self.block_size)  # ceil

    def _ensure_capacity(self, seq: _Sequence, upto: int, draft: bool = False) -> bool:
        """Grow ``seq``'s table (the draft pool's with ``draft``) to cover
        positions [0, upto), the shared prefix blocks counted, preempting
        (youngest first) while the pool is dry."""
        alloc = self._draft_allocator if draft else self._allocator
        shared = 0 if draft else len(self._prefix_blocks)
        owned = seq.draft_blocks if draft else seq.blocks
        need = self._blocks_needed(upto) - shared - len(owned)
        if need <= 0:
            return True
        while not alloc.can_alloc(need):
            victim = self._pick_victim(exclude=seq)
            if victim is None:
                return False
            self._preempt(victim)
        got = alloc.alloc(need)
        if got is None:
            return False
        owned.extend(got)
        return True

    def _pick_victim(self, exclude: _Sequence) -> Optional[_Sequence]:
        """A sequence of the lowest tier present (offline, then batch, then
        interactive), the youngest admitted of that tier, running or
        prefilling, but ``exclude``: interactive sequences keep their blocks
        while a lower-tier victim exists."""
        pool = [s for s in self._active + self._prefilling if s is not exclude]
        return (max(pool, key=lambda s: (tier_rank(s.request.tier), s.admit_order))
                if pool else None)

    def _preempt(self, seq: _Sequence) -> None:
        """Evict a sequence: free its blocks and put it at the front of the
        queue for recompute.  The tokens it already emitted join the
        re-prefill prompt, and its pending token is restored, never
        re-sampled, so it resumes where it stopped."""
        for coll in (self._active, self._prefilling):
            if seq in coll:
                coll.remove(seq)
        self._release_blocks(seq)
        RECORDER.record_gen_retired("preempted")
        self._seq_event(seq, "preempt", n_valid=seq.n_valid, emitted=len(seq.emitted))
        if seq.emitted:
            # rebuilt from the ORIGINAL prompt: folding into an already
            # folded prompt would repeat context on a second preemption
            seq.prompt = np.concatenate(
                [seq.prompt0, np.asarray(seq.emitted[:-1], np.int32)]).astype(np.int32)
            seq.pending = seq.emitted[-1]
        seq.prefill_pos = 0
        seq.n_valid = 0
        self._waiting.appendleft(seq)
        self.preempted_total += 1
        self.retired_total["preempted"] = self.retired_total.get("preempted", 0) + 1

    def _attr_note(self, phase: str, padded_units: float, rows) -> None:
        """Cost-ledger accumulation: ``rows`` of ``(tenant, tier,
        real_units, requests, tokens)`` against the tick's ``phase``
        bucket.  A no-op with the ledger off."""
        if self._tick_attr is None:
            return
        d = self._tick_attr.setdefault(phase, {"padded": 0.0, "tenants": {}})
        d["padded"] += padded_units
        for tenant, tier, units, requests, toks in rows:
            row = d["tenants"].setdefault((tenant, tier), [0.0, 0.0, 0])
            row[0] += units
            row[1] += requests
            row[2] += toks

    def _release_blocks(self, seq: _Sequence) -> None:
        """A sequence's private blocks back to their pools (the shared
        prefix blocks are not its own, and are pinned besides)."""
        if seq.blocks:
            if seq.t_start > 0.0:
                held = time.time() - seq.t_start
                # KV residency at release: the pool-sizing histogram
                self._tick_kv_ages.append((len(seq.blocks), held))
                if self._tick_attr is not None:
                    # KV-block-seconds land on the owning tenant at retire
                    # and preempt: the ledger's memory-residency axis
                    self._tick_kv_attr.append((seq.request.tenant, len(seq.blocks) * held))
            self._allocator.free(seq.blocks)
        seq.blocks = []
        if seq.draft_blocks:
            self._draft_allocator.free(seq.draft_blocks)
        seq.draft_blocks = []

    def _next_waiting_index(self) -> int:
        """Admission order: the highest tier first, FIFO within a tier; with
        every sequence interactive (the default) it is index 0, plain
        FIFO."""
        best, best_rank = 0, None
        for i, seq in enumerate(self._waiting):
            r = tier_rank(seq.request.tier)
            if best_rank is None or r < best_rank:
                best, best_rank = i, r
                if r == 0:
                    break  # nothing outranks interactive
        return best

    def _admit(self) -> int:
        """Tier-first FIFO admission into free slots.  A sequence whose
        first chunk's blocks cannot be allocated stays queued (pool
        exhaustion queues, it never crashes); one that cannot fit with the
        scheduler otherwise empty can never be served and fails with a typed
        error."""
        admitted = 0
        while self._waiting and len(self._active) + len(self._prefilling) < self.slots:
            idx = self._next_waiting_index()
            seq = self._waiting[idx]
            first = min(len(seq.prompt), self.prefill_chunk)
            need = self._blocks_needed(self._prefix_len + first) - len(self._prefix_blocks)
            d_need = self._blocks_needed(first) if self.spec else 0
            if not self._allocator.can_alloc(need) or (
                    self.spec and not self._draft_allocator.can_alloc(d_need)):
                if not self._active and not self._prefilling:
                    # nothing will ever retire to free blocks
                    del self._waiting[idx]
                    self._finish_error(seq, RuntimeError(
                        f"KV pool ({self.num_blocks} blocks of {self.block_size}) cannot hold "
                        f"one prefill chunk (grow SELDON_TPU_GEN_POOL_BLOCKS)"))
                    continue
                self._pool_dry = True  # the bubble ledger's pool_exhaustion
                break  # pool dry: wait for a retirement
            del self._waiting[idx]
            seq.blocks = self._allocator.alloc(need) or []
            if self.spec:
                seq.draft_blocks = self._draft_allocator.alloc(d_need) or []
            # the prefix's partial last block is private: its tail goes into
            # the sequence's first block (again after a preemption)
            p0 = len(self._prefix_blocks) * self.block_size
            if self._prefix_len > p0 and seq.blocks:
                paged_write_prefix_tail(self._pool, self.prefix_cache, seq.blocks[0], self.cfg,
                                        p0=p0, use_flash=self.use_flash)
                self.prefix_tail_writes_total += 1
            seq.n_valid = self._prefix_len
            seq.prefill_pos = 0
            self._admit_counter += 1
            seq.admit_order = self._admit_counter
            self._prefilling.append(seq)
            self.admitted_total += 1
            RECORDER.record_gen_admitted()
            seq.t_start = time.time()
            self._seq_event(seq, "admit", blocks=len(seq.blocks))
            admitted += 1
        return admitted

    def _table(self, seq: _Sequence, nblk: int, draft: bool = False) -> np.ndarray:
        """A row of the round's block table: the shared prefix blocks, then
        the sequence's own (the draft pool's own blocks with ``draft``)."""
        blocks = seq.draft_blocks if draft else self._prefix_blocks + seq.blocks
        row = np.zeros((nblk,), np.int32)
        row[: len(blocks)] = blocks[:nblk]
        return row

    def _to_device(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    # -- prefill ----------------------------------------------------------

    def _prefill_tick(self) -> int:
        """One chunk of every prefilling sequence's prompt as one batched
        ``paged_forward``: a long prompt stalls the running decode for about
        one chunk, and co-arriving prompts prefill together."""
        t0 = time.perf_counter()
        # brownout stage >= 2: the floor grain, so in-flight decode stalls
        # least; the adaptive probe pauses rather than learn degraded walls
        floored = BROWNOUT.gen_chunk_floor()
        C = self.prefill_chunk if floored else self._chunk_eff
        # the capacity pass first: an eviction in it may requeue another
        # prefilling sequence, so the batch is built only afterwards
        for seq in list(self._prefilling):
            if seq not in self._prefilling:
                continue  # preempted by an earlier row's eviction
            w = min(C, len(seq.prompt) - seq.prefill_pos)
            if self._ensure_capacity(seq, self._prefix_len + seq.prefill_pos + w):
                if self.spec:  # the draft pool is sized like the target's: best effort
                    self._ensure_capacity(seq, seq.prefill_pos + w, draft=True)
                continue
            # cannot hold this chunk: give the blocks back and wait (a
            # re-admission starts the prefill over)
            self._prefilling.remove(seq)
            self._release_blocks(seq)
            if not self._active and not self._prefilling:
                # alone and still failing: the prompt exceeds the pool, and
                # requeueing would spin admit -> prefill -> requeue forever
                self._finish_error(seq, RuntimeError(
                    f"KV pool ({self.num_blocks} blocks of {self.block_size}) too small for "
                    f"prompt length {len(seq.prompt)} (grow SELDON_TPU_GEN_POOL_BLOCKS)"))
                continue
            self._waiting.appendleft(seq)
        batch = list(self._prefilling)
        if not batch:
            return 0
        B = _pow2(len(batch))
        toks = np.zeros((B, C), np.int32)
        start = np.zeros((B,), np.int32)
        width = np.zeros((B,), np.int32)
        for i, seq in enumerate(batch):
            lo = seq.prefill_pos
            w = min(C, len(seq.prompt) - lo)
            toks[i, :w] = seq.prompt[lo:lo + w]
            start[i] = self._prefix_len + lo
            width[i] = w
        nblk = _pow2(max(self._blocks_needed(int(start[i] + width[i]))
                         for i in range(len(batch))))
        tables = np.zeros((B, nblk), np.int32)
        for i, seq in enumerate(batch):
            tables[i] = self._table(seq, nblk)
        OBSERVATORY.note_padding(len(batch), B)
        self._tick_rows += B
        self._tick_real_rows += len(batch)
        # cost attribution: the real units are each chunk's real prompt
        # tokens, the capacity B x C (pad rows and pad columns alike)
        self._attr_note("prefill", B * C, [(s.request.tenant, s.request.tier, int(width[i]), 0, 0)
                                           for i, s in enumerate(batch)])
        self._tick_kv_blocks += sum(self._blocks_needed(int(start[i] + width[i]))
                                    for i in range(len(batch)))
        td = time.perf_counter()
        toks_t, tables_t, start_t, width_t = self._to_device(toks, tables, start, width)
        logits, self._pool = paged_forward(self.params, toks_t, self._pool, tables_t, start_t,
                                           width_t, self.cfg, last_only=True,
                                           use_flash=self.use_flash)
        if self.spec:  # the draft's cache follows the target's, without a prefix
            d_nblk = _pow2(max(self._blocks_needed(seq.prefill_pos + int(width[i]))
                               for i, seq in enumerate(batch)))
            d_tables = np.zeros((B, d_nblk), np.int32)
            d_start = np.zeros((B,), np.int32)
            for i, seq in enumerate(batch):
                d_tables[i] = self._table(seq, d_nblk, draft=True)
                d_start[i] = seq.prefill_pos
            d_tables_t, d_start_t = self._to_device(d_tables, d_start)
            _, self._draft_pool = paged_forward(self.draft_params, toks_t, self._draft_pool,
                                                d_tables_t, d_start_t, width_t, self.draft_cfg,
                                                last_only=True, use_flash=self.use_flash)
        # the tick's one sync: every row's next token (argmax takes the
        # first maximal index, as generate's sample_token does) and, when
        # sampling, the keys after the split that drew it
        keys = None
        if self.temperature > 0.0:
            kd = np.zeros((B, 2), np.int64)
            for i, seq in enumerate(batch):
                kd[i] = seq.key
            keys, sub = prng.split(*self._to_device(kd))
            first = sample_token(logits, sub, self.temperature, self.top_k, self.top_p)
            host = torch.cat([first[:, None].long(), keys], dim=1).cpu().numpy()
            first, keys = host[:, 0], host[:, 1:]
        else:
            first = torch.argmax(logits, dim=-1).cpu().numpy()
        # the tick's device seconds end at the readback it pays anyway
        self._dev_s["prefill"] = self._dev_s.get("prefill", 0.0) + time.perf_counter() - td
        self.prefill_dispatches_total += 1
        emitted = 0
        for i, seq in enumerate(batch):
            seq.prefill_pos += int(width[i])
            seq.n_valid = int(start[i] + width[i])
            self._seq_event(seq, "prefill_chunk", pos=seq.prefill_pos, width=int(width[i]))
            if seq.prefill_pos < len(seq.prompt):
                continue
            # prompt consumed: its first token (or the restored pending one)
            self._prefilling.remove(seq)
            if seq.pending is None:
                if keys is not None:
                    seq.key = keys[i]
                seq.pending = int(first[i])
                self._emit_tokens(seq, [seq.pending])
                emitted += 1
                # one completed prefill: one request for the ledger, and
                # the first served token
                self._attr_note("prefill", 0, [(seq.request.tenant, seq.request.tier, 0, 1, 1)])
            if self.role != "prefill":
                self._active.append(seq)
            elif seq.done:  # the first token finished it: nothing to hand off
                self._retire(seq, seq.retire_reason or "length")
            else:
                self._handoff_out(seq)
        if int(width.max()) == C and not floored:
            # only saturated ticks say anything about width-C compute
            self._adapt_chunk(C, time.perf_counter() - t0)
        return emitted

    def _adapt_chunk(self, C: int, wall_s: float) -> None:
        """Probe the effective prefill chunk upward while ticks stay
        dispatch-bound.  After >= 2 ticks at width C: if doubling from C/2
        left the EMA wall under 1.6x (compute would have doubled it), keep
        probing; if it is more than 1.6x slower, shrink back and latch.
        The floor is the configured grain, the ceiling PREFILL_CHUNK_MAX."""
        ema = self._chunk_wall.setdefault(C, [wall_s, 0])
        ema[0] = 0.5 * ema[0] + 0.5 * wall_s
        ema[1] += 1
        if self._chunk_latched or ema[1] < 2:
            return
        prev = self._chunk_wall.get(C // 2)
        if C > self.prefill_chunk and prev and ema[0] > 1.6 * prev[0]:
            self._chunk_eff = C // 2
            self._chunk_latched = True
        elif C < self.prefill_chunk_max:
            self._chunk_eff = min(2 * C, self.prefill_chunk_max)
        else:
            self._chunk_latched = True

    # -- decode -----------------------------------------------------------

    def _decode_round(self) -> int:
        """One ``span``-step round of every running sequence as one
        ``paged_decode_round``: rows padded to a power of two, the table to
        a power-of-two number of blocks; the one host sync is the token
        readback the streams need anyway."""
        for seq in sorted(self._active, key=lambda s: s.sid):
            if seq not in self._active:
                continue  # preempted by an earlier row's eviction
            if not self._ensure_capacity(seq, seq.n_valid + self.span):
                # the pool is exhausted even after eviction: this sequence
                # is alone and cannot fit
                self._active.remove(seq)
                self._finish_error(seq, RuntimeError(
                    f"KV pool too small for sequence length {seq.n_valid + self.span} (grow "
                    f"SELDON_TPU_GEN_POOL_BLOCKS)"))
                return 0
        batch = sorted(self._active, key=lambda s: s.sid)
        if not batch:
            return 0
        B = _pow2(len(batch))
        nblk = _pow2(max(self._blocks_needed(s.n_valid + self.span) for s in batch))
        tables = np.zeros((B, nblk), np.int32)
        token = np.zeros((B,), np.int32)
        n_valid = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        seen = np.zeros((B,), bool)
        for i, s in enumerate(batch):
            tables[i] = self._table(s, nblk)
            token[i] = s.pending
            n_valid[i] = s.n_valid
            active[i] = True
            seen[i] = self.eos_token >= 0 and self.eos_token in s.emitted
        OBSERVATORY.note_padding(len(batch), B)
        self._tick_rows += B
        self._tick_real_rows += len(batch)
        # cost attribution: one real unit a live sequence, capacity B
        self._attr_note("decode", B, [(s.request.tenant, s.request.tier, 1, 0, 0)
                                      for s in batch])
        self._tick_kv_blocks += sum(self._blocks_needed(s.n_valid + self.span) for s in batch)
        # cache positions the round streams (served HBM-bandwidth share):
        # each of the span steps attends over ~n_valid + step positions
        self._tick_kv_pos += sum(self.span * (s.n_valid + self.span // 2) for s in batch)
        self._tick_dev_steps += self.span
        td = time.perf_counter()
        dev = self._to_device(tables, token, n_valid, active, seen)
        keys = None
        if self.temperature > 0.0:
            # the rows' own keys; pad rows draw from a zero key nobody reads
            kd = np.zeros((B, 2), np.int64)
            for i, s in enumerate(batch):
                kd[i] = s.key
            keys, = self._to_device(kd)
        toks, self._pool, _, _, _, keys = paged_decode_round(
            self.params, self._pool, *dev, self.cfg, span=self.span, keys=keys,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            eos_token=self.eos_token, use_flash=self.use_flash)
        # the round's host sync: the tokens, and the keys they leave behind
        if keys is None:
            toks = toks.cpu().numpy()
        else:
            host = torch.cat([toks.long(), keys], dim=1).cpu().numpy()
            toks, keys = host[:, :self.span], host[:, self.span:]
        self._dev_s["decode"] = self._dev_s.get("decode", 0.0) + time.perf_counter() - td
        self.decode_steps_total += self.span
        self.decode_round_rows_max = max(self.decode_round_rows_max, len(batch))
        emitted = 0
        for i, s in enumerate(batch):
            if keys is not None:
                s.key = keys[i]
            take = min(self.span, s.max_new - len(s.emitted))
            s.n_valid += self.span
            s.pending = int(toks[i, -1])
            self._emit_tokens(s, [int(t) for t in toks[i, :take]])
            self._seq_event(s, "decode_round", n_valid=s.n_valid, tokens=take)
            emitted += take
            if take > 0:
                self._attr_note("decode", 0, [(s.request.tenant, s.request.tier, 0, 0, take)])
        return emitted

    def _spec_round(self) -> int:
        """One speculative draft/verify round of every running sequence as
        one ``paged_spec_round`` (greedy): up to k + 1 tokens a row.  The
        host sync reads the new tokens, the gains and the corrected tokens
        back at once."""
        W = self.spec_k + 1
        for seq in sorted(self._active, key=lambda s: s.sid):
            if seq not in self._active:
                continue  # preempted by an earlier row's eviction
            if not (self._ensure_capacity(seq, seq.n_valid + W)
                    and self._ensure_capacity(seq, seq.n_valid + W, draft=True)):
                self._active.remove(seq)
                self._finish_error(seq, RuntimeError(
                    "KV pool too small for speculative round (grow SELDON_TPU_GEN_POOL_BLOCKS)"))
                return 0
        batch = sorted(self._active, key=lambda s: s.sid)
        if not batch:
            return 0
        B = _pow2(len(batch))
        # the draft's tables cover what the target's do: no prefix in this mode
        nblk = _pow2(max(self._blocks_needed(s.n_valid + W) for s in batch))
        tables = np.zeros((B, nblk), np.int32)
        d_tables = np.zeros((B, nblk), np.int32)
        token = np.zeros((B,), np.int32)
        n_valid = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for i, s in enumerate(batch):
            tables[i] = self._table(s, nblk)
            d_tables[i] = self._table(s, nblk, draft=True)
            token[i] = s.pending
            n_valid[i] = s.n_valid
            active[i] = True
        OBSERVATORY.note_padding(len(batch), B)
        self._tick_rows += B
        self._tick_real_rows += len(batch)
        self._attr_note("decode", B, [(s.request.tenant, s.request.tier, 1, 0, 0)
                                      for s in batch])
        self._tick_kv_blocks += sum(self._blocks_needed(s.n_valid + W) for s in batch)
        self._tick_kv_pos += sum(W * (s.n_valid + W // 2) for s in batch)
        self._tick_dev_steps += W
        td = time.perf_counter()
        new_toks, gained, corrected, self._pool, self._draft_pool = paged_spec_round(
            self.params, self.draft_params, self._pool, self._draft_pool,
            *self._to_device(tables, d_tables, token, n_valid, active), self.cfg,
            self.draft_cfg, k=self.spec_k, use_flash=self.use_flash)
        host = torch.cat([new_toks, gained[:, None], corrected[:, None]], dim=1).cpu().numpy()
        self._dev_s["decode"] = self._dev_s.get("decode", 0.0) + time.perf_counter() - td
        self.spec_rounds_total += 1
        self.spec_row_rounds_total += len(batch)
        self.decode_round_rows_max = max(self.decode_round_rows_max, len(batch))
        emitted = 0
        accept_sum = 0.0
        for i, s in enumerate(batch):
            g = int(host[i, W])
            take = min(g, s.max_new - len(s.emitted))
            s.n_valid += g
            s.pending = int(host[i, W + 1])
            self.spec_accepted_total += g - 1
            accept_sum += (g - 1) / self.spec_k
            self._emit_tokens(s, [int(t) for t in host[i, :take]])
            self._seq_event(s, "decode_round", n_valid=s.n_valid, tokens=take)
            emitted += take
            if take > 0:
                self._attr_note("decode", 0, [(s.request.tenant, s.request.tier, 0, 0, take)])
        # the speculative accept ratio: drafts accepted per row per round
        RECORDER.observe_accept_ratio(accept_sum / len(batch))
        return emitted

    # -- emission / retirement --------------------------------------------

    # -- the hand-off: the prefill side (scheduler thread) --------------------

    def _geometry(self):
        """(n_layers, block_size, kv_heads, head_dim, dtype name) of the pool."""
        return (self.cfg.n_layers, self.block_size, self.cfg.kv_heads, self.cfg.head_dim,
                kvstream.dtype_name(self.cfg.dtype, self.cfg.kv_quant))

    def _handoff_out(self, seq: _Sequence) -> None:
        """Export a finished prefill (its private blocks, read back in the
        wire's layout, and its sampling state) to the coordinator; the
        blocks go straight back to the pool."""
        from seldon_core_tpu_torch.runtime.servingmesh import HandoffError

        if self.coordinator is None:
            self._finish_error(seq, HandoffError(
                "prefill-role replica has no decode peers configured "
                "(--decode-peers / ENGINE_DECODE_PEERS)"))
            return
        n_layers, block_size, kv, hd, dtype = self._geometry()
        meta = kvstream.KvBeginMeta(
            n_layers=n_layers, block_size=block_size, kv_heads=kv, head_dim=hd, dtype=dtype,
            n_blocks=len(seq.blocks), n_valid=seq.n_valid, pending=int(seq.pending),
            max_new=int(seq.max_new), prefix_len=self._prefix_len,
            prompt=np.asarray(seq.prompt, np.int32), emitted=list(seq.emitted),
            key_data=None if seq.key is None else np.asarray(seq.key).astype(np.uint32),
            tier=seq.request.tier)
        export = kvstream.KvExport(meta=meta, layers=kvstream.export_blocks(self._pool, seq.blocks),
                                   tenant=seq.request.tenant)
        # the hand-off span's identity is minted now: its traceparent rides
        # every frame's sidecar, so the decode side's spans parent under an
        # id that exists before the coordinator records the span
        req_ctx = seq.request.trace_ctx
        if req_ctx is not None and req_ctx.sampled and TRACER.enabled:
            export.trace_ctx = req_ctx.child(req_ctx.puid)
            export.parent_span_id = req_ctx.span_id
            export.puid = req_ctx.puid
        self._seq_event(seq, "handoff", n_valid=seq.n_valid)
        self._release_blocks(seq)
        self._handoff_inflight += 1
        self._handoff_seqs[seq] = True

        def _done(result, seq=seq):
            self._handoff_done.append((seq, result))
            with self._wake:
                self._wake.notify_all()

        self.coordinator.submit(export, _done)

    def _drain_handoff_done(self) -> int:
        """Completed hand-offs back into their requests: the decode peer's
        tokens become the sequence's (the first token unchanged), or a
        typed failure fails the request."""
        n = 0
        while self._handoff_done:
            seq, result = self._handoff_done.popleft()
            self._handoff_seqs.pop(seq, None)
            self._handoff_inflight -= 1
            n += 1
            if isinstance(result, BaseException):
                self._finish_error(seq, result)
                continue
            toks = [int(t) for t in np.asarray(result).reshape(-1)]
            prev = len(seq.emitted)
            seq.emitted = toks[: seq.max_new]
            if len(seq.emitted) < seq.max_new:
                # defensive eos padding; the decode side pads already
                pad = (self.eos_token if self.eos_token >= 0
                       else (seq.emitted[-1] if seq.emitted else 0))
                seq.emitted += [pad] * (seq.max_new - len(seq.emitted))
            self.tokens_emitted_total += max(0, len(seq.emitted) - prev)
            seq.done = True
            self._retire(seq, "handoff")
        return n

    # -- the hand-off: the decode side (the relay's handler threads) -----------

    def kv_reserve(self, hid: bytes, meta) -> None:
        """BEGIN: check the hand-off against this pool and reserve its
        blocks.  Raises ``KvWireError`` on a geometry, dtype or prefix
        mismatch (a deployment fault), ``LoadShedError`` when the pool
        cannot hold the blocks (retryable: the prefill side tries another
        peer)."""
        kvstream.validate_against_pool(meta, self._geometry(), self._prefix_len)
        blocks = self._allocator.reserve(meta.n_blocks)
        if blocks is None:
            RECORDER.record_kv_handoff("refused")
            raise LoadShedError(
                f"{SHED_INFO_PREFIX}: decode KV pool cannot hold {meta.n_blocks} handoff blocks "
                f"({self._allocator.used}/{self._allocator.capacity} used) — try another "
                "decode replica")
        int8 = meta.dtype == "int8"
        dt = np.int8 if int8 else kvstream.host_dtype(meta.dtype)
        kv_shape = (meta.n_blocks, meta.block_size, meta.kv_heads, meta.head_dim)
        staged = []
        for _ in range(meta.n_layers):
            layer = {"k": np.zeros(kv_shape, dt), "v": np.zeros(kv_shape, dt)}
            if int8:
                layer["k_s"] = np.zeros(kv_shape[:3], np.float32)
                layer["v_s"] = np.zeros(kv_shape[:3], np.float32)
            staged.append(layer)
        imp = _KvImport(hid, meta, blocks, staged)
        # the relay bound the BEGIN's traceparent around this handler: the
        # import and decode spans parent under the prefill side's span
        imp.trace_ctx = current_trace_context()
        with self._wake:
            if self._stopped:
                self._allocator.release_reserved(blocks)
                raise RuntimeError("generation scheduler stopped")
            self._imports[hid] = imp
            # the scheduler thread runs while a reservation is out: it is
            # the TTL reaper of torn hand-offs
            self._ensure_thread()
            self._wake.notify_all()

    def kv_receive(self, hid: bytes, first: int, layers) -> None:
        """KV_BLOCKS: stage one chunk on the host (the pool is the
        scheduler thread's: nothing touches it before the commit)."""
        imp = self._imports.get(hid)
        if imp is None:
            raise kvstream.KvWireError("unknown or expired handoff id")
        imp.receive(first, layers)

    def kv_commit(self, hid: bytes) -> GenRequest:
        """KV_COMMIT: build the sequence and queue it for admission; the
        returned request's future resolves to its [1, max_new] tokens."""
        # pop first: the claim is atomic against the TTL reaper, which pops
        # before it releases
        imp = self._imports.pop(hid, None)
        if imp is None:
            raise kvstream.KvWireError("unknown or expired handoff id")
        if not imp.complete():
            self._allocator.release_reserved(imp.blocks)
            self.imports_reclaimed_total += 1
            RECORDER.record_kv_handoff("reclaimed")
            raise kvstream.KvWireError(
                "commit before every block was received — torn handoff reclaimed")
        meta = imp.meta
        req = GenRequest(None, meta.max_new, tier=meta.tier)
        if imp.trace_ctx is not None:
            # the BEGIN's context is the hand-off's (the COMMIT may come on
            # another relay connection)
            req.trace_ctx = imp.trace_ctx
            if TRACER.enabled:
                TRACER.record_span(
                    "kv_import", kind="kv_import", method="kv_handoff",
                    start_s=imp.created_epoch, duration_ms=(time.time() - imp.created_epoch) * 1e3,
                    ctx=imp.trace_ctx, blocks=len(imp.blocks), n_valid=int(meta.n_valid))
        with self._wake:
            if self._stopped:
                self._allocator.release_reserved(imp.blocks)
                raise RuntimeError("generation scheduler stopped")
            self._seq_counter += 1
            seq = _Sequence(self._seq_counter, req, np.asarray(meta.prompt, np.int32),
                            meta.max_new)
            seq.n_valid = int(meta.n_valid)
            seq.pending = int(meta.pending)
            seq.emitted = list(meta.emitted)
            if meta.key_data is not None:
                seq.key = np.asarray(meta.key_data).astype(np.int64)
            req.seqs.append(seq)
            imp.seq = seq
            self._remote_arrivals.append(imp)
            self._ensure_thread()
            self._wake.notify_all()
        return req

    def kv_abort(self, hid: bytes) -> bool:
        imp = self._imports.pop(hid, None)
        if imp is None:
            return False
        self._allocator.release_reserved(imp.blocks)
        self.imports_reclaimed_total += 1
        RECORDER.record_kv_handoff("reclaimed")
        return True

    def kv_stats(self) -> Dict[str, int]:
        """The free-block score a prefill coordinator's p2c reads."""
        snap = self._allocator.snapshot()
        with self._lock:
            waiting = len(self._waiting) + len(self._arrivals)
            inflight = len(self._active) + len(self._prefilling)
        return {"free": snap["total"] - snap["used"], "total": snap["total"],
                "waiting": waiting, "inflight": inflight}

    # -- the hand-off: the decode side (scheduler thread) ----------------------

    def _import_admit(self) -> int:
        """Committed imports join the decode loop: the staged blocks are
        copied into the pool, the reservation becomes the sequence's, and
        it runs from where a local prefill would have left it."""
        n = 0
        while self._remote_arrivals:
            imp = self._remote_arrivals.popleft()
            kvstream.scatter_staged(self._pool, imp.blocks, imp.staged)
            self._allocator.commit_reserved(imp.blocks)
            seq = imp.seq
            seq.blocks = list(imp.blocks)
            seq.t_start = time.time()
            self._seq_event(seq, "admit", blocks=len(seq.blocks), imported=True)
            self._admit_counter += 1
            seq.admit_order = self._admit_counter
            self._active.append(seq)
            self.admitted_total += 1
            self.imports_committed_total += 1
            RECORDER.record_gen_admitted()
            RECORDER.record_kv_handoff("imported")
            n += 1
        return n

    def _reap_stale_imports(self) -> None:
        """The torn hand-off's backstop: a reservation not committed within
        the TTL goes back to the pool."""
        if not self._imports:
            return
        now = time.monotonic()
        for hid, imp in list(self._imports.items()):
            if now - imp.created > self._import_ttl_s and \
                    self._imports.pop(hid, None) is not None:
                self._allocator.release_reserved(imp.blocks)
                self.imports_reclaimed_total += 1
                RECORDER.record_kv_handoff("reclaimed")
                logger.warning("reclaimed torn KV handoff (%d blocks) after %.0fs TTL",
                               len(imp.blocks), self._import_ttl_s)

    def _emit_tokens(self, seq: _Sequence, toks: List[int]) -> None:
        if not toks or seq.done:
            return
        seq.emitted.extend(toks)
        if self.eos_token >= 0 and self.eos_token in seq.emitted:
            # finished early: eos-pad the tail now (mask_after_eos's contract)
            first = seq.emitted.index(self.eos_token)
            seq.emitted = (seq.emitted[: first + 1]
                           + [self.eos_token] * (seq.max_new - first - 1))
            seq.retire_reason = "eos"
            seq.done = True
        elif len(seq.emitted) >= seq.max_new:
            seq.emitted = seq.emitted[: seq.max_new]
            seq.retire_reason = "length"
            seq.done = True
        req = seq.request
        if not req.ttft_recorded:
            req.ttft_recorded = True
            if req.chunk is not None:
                # TTFT is a streaming metric, one observation a stream
                RECORDER.observe_ttft(time.perf_counter() - req.t_submit)
        self._deliver(req)

    def _deliver(self, req: GenRequest) -> None:
        """Stream chunks once every row has them; the whole array at the
        end."""
        if req.cancelled or req.future.done():
            return
        if req.chunk is not None:
            while True:
                avail = min(len(s.emitted) for s in req.seqs)
                n = min(req.chunk, req.max_new - req.delivered)
                if n <= 0 or avail - req.delivered < n:
                    break
                req.queue.put(np.asarray([s.emitted[req.delivered:req.delivered + n]
                                          for s in req.seqs], np.int32))
                req.delivered += n
        # the whole answer once every row is retired (in the same tick as
        # its last token): each row's gen_sequence span then precedes the
        # request span's close, so a postmortem of the request holds them
        if not req.finished and all(s.done and s.retired for s in req.seqs):
            req.finished = True
            out = np.asarray([s.emitted for s in req.seqs], np.int32)
            if self._in_tick:
                self._tick_done.append((req, out))
            else:
                self._complete(req, out)

    def _complete(self, req: GenRequest, out: np.ndarray) -> None:
        """Hand a finished request its tokens (the stream its end)."""
        if req.future.done():
            return
        elapsed = time.perf_counter() - req.t_submit
        if req.chunk is not None and elapsed > 0:
            # the decode-rate family: once a stream, as TTFT
            RECORDER.observe_decode_rate(out.size / elapsed)
        req.future.set_result(out)
        if req.chunk is not None:
            req.queue.put(None)

    def _retire_finished(self) -> int:
        finished = [s for s in self._active if s.done]
        for seq in finished:
            self._active.remove(seq)
            self._retire(seq, seq.retire_reason or "length")
        return len(finished)

    def _retire(self, seq: _Sequence, reason: str) -> None:
        seq.retired = True
        self._release_blocks(seq)
        self.retired_total[reason] = self.retired_total.get(reason, 0) + 1
        RECORDER.record_gen_retired(reason)
        self._seq_event(seq, "retire", reason=reason, emitted=len(seq.emitted))
        self._emit_seq_timeline(seq, reason)
        self._deliver(seq.request)

    # -- sequence spans (genserver.py:1984-2070 there) ----------------------

    @staticmethod
    def _seq_event(seq: _Sequence, name: str, **attrs: Any) -> None:
        """One lifecycle event on a sampled sequence's timeline, or one
        under postmortem tail capture; a no-op (an attribute read and a
        test or two) for an untraced request."""
        ctx = seq.request.trace_ctx
        if ctx is None or not (ctx.sampled or (ctx.pm and TRACER.pm_hook is not None)):
            return
        if not TRACER.enabled or len(seq.events) >= 512:
            return
        ev: Dict[str, Any] = {"name": name, "ts": round(time.time(), 6)}
        if attrs:
            ev["attrs"] = attrs
        seq.events.append(ev)

    def _emit_seq_timeline(self, seq: _Sequence, reason: str) -> None:
        """One ``gen_sequence`` span per retired sampled sequence, its
        lifecycle (enqueue, admit, prefill chunks, decode rounds,
        preemptions, retire) as events, under the request's span."""
        ctx = seq.request.trace_ctx
        if not seq.events or ctx is None or not TRACER.enabled:
            return
        # a sampled-out sequence under tail capture: pending buffer only
        pm_only = not ctx.sampled
        if pm_only and not (ctx.pm and TRACER.pm_hook is not None):
            return
        start_s = seq.events[0]["ts"]
        TRACER.add(Span(
            puid=ctx.puid, name="gen_sequence", kind="gen_seq", method=reason,
            start_s=start_s, duration_ms=(time.time() - start_s) * 1e3,
            attrs={"sid": seq.sid, "tokens": len(seq.emitted), "n_valid": seq.n_valid,
                   "role": self.role},
            trace_id=ctx.trace_id, span_id=new_span_id(), parent_span_id=ctx.span_id,
            events=list(seq.events), pm_only=pm_only))
        seq.events = []

    def _stamp_tick_error(self, exc: BaseException) -> None:
        """One ``gen_tick_error`` span under a sampled request riding the
        failing tick (the batch is about to fail as a whole)."""
        if not TRACER.enabled:
            return
        for s in list(self._active) + list(self._prefilling):
            ctx = s.request.trace_ctx
            if ctx is not None and ctx.sampled:
                TRACER.record_span("gen_tick_error", kind="gen_step", method="error",
                                   start_s=time.time(), duration_ms=0.0, ctx=ctx,
                                   error=repr(exc)[:200])
                return

    def _finish_error(self, seq: _Sequence, exc: BaseException) -> None:
        self._retire(seq, "error")
        req = seq.request
        if not req.future.done():
            req.future.set_exception(exc)
        req.queue.put(exc)
        # the request is dead: its other rows must not keep decoding or
        # holding blocks (the next tick's _drop_cancelled sweeps them)
        req.cancelled = True
