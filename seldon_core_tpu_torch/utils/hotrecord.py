"""Fused hot-path telemetry: one record per hop, off-path observatory
consumers, and an enforced overhead budget; the port's counterpart of
``seldon_core_tpu/utils/hotrecord.py``.

The quality observatory folds the dispatch records' batches
(``WANT_QUALITY``) and the host-mode / unit-pod quality hop
(``HOP_QUALITY``), the cost ledger the flush and tick records' attribution
payloads (``WANT_COST``), and the postmortem recorder every folded span
(``TRACER.pm_hook``).  The dispatch record's wall also trains the
autopilot (``runtime/autopilot.py``: the prediction in force before it
lands on the dispatch span as ``autopilot_predicted_ms``, which the
postmortem's ``autopilot_excess`` reads) and appends one row to the durable
perf corpus (``utils/perfcorpus.py``), both on the drainer thread.

Inline observability puts per-request work on the dispatch path — a span
append under the tracer lock, a label lookup per span kind, a
per-executable MFU derivation.  This module inverts the flow:

  * On the hot path, each hop (gateway ingress, engine request,
    micro-batch queue wait, device dispatch, decode) appends exactly ONE
    fixed-layout :class:`HotRecord` to a lock-free per-thread SPSC ring
    (:class:`ThreadRing`: the owning thread is the only producer, the
    drainer the only consumer; a full ring drops the record and counts
    it — ``seldon_tpu_telemetry_ring_dropped_total`` — instead of ever
    blocking a request).
  * All on-device statistics collapse into the batch readback the
    response needs anyway: the record carries *references* to the
    already-stacked batch and its readback, and the quality
    observatory's ONE fused summarize per sampled batch now runs in the
    drainer, not inside the dispatch span.  OBSERVATORY and QUALITY no
    longer each touch the arrays on-path.
  * TRACER / OBSERVATORY / QUALITY / RECORDER become **off-path
    consumers**: :meth:`TelemetrySpine.drain` folds ring records into
    their existing snapshots and metric families, so ``GET /stats``,
    ``/perf``, ``/quality``, ``/trace`` and every ``seldon_tpu_*``
    Prometheus family are bit-for-bit-compatible surfaces fed from the
    fused record.  Draining happens from a daemon thread on an interval
    AND lazily from every query surface (tracer lookups, recorder
    snapshots, observatory documents), so reads are always current.
  * The **sampling decision is unified**: one uniform draw per
    request/per batch; subsystem S is sampled iff ``u < rate_S``
    (``SELDON_TPU_TRACE_SAMPLE`` / ``SELDON_TPU_QUALITY_SAMPLE`` stay
    the rate inputs).  Because the draws are nested, a record sampled
    for the rarest subsystem is sampled for every cheaper one — sampled
    records are complete across subsystems instead of three independent
    coin flips agreeing only by luck.
  * The overhead budget is a first-class, self-observed SLO:
    ``GET /overhead`` decomposes framework time per subsystem
    (tracer/perf/quality/recorder/ring) from the records themselves,
    ``seldon_tpu_framework_overhead_ms{subsystem}`` feeds the
    ``SeldonTPUTelemetryOverhead`` alert, and the budget is
    ``SELDON_TPU_OVERHEAD_BUDGET_MS`` (default 1.0).

Kill switches compose independently: ``SELDON_TPU_TELEMETRY=0`` silences
the flight-recorder folds (queue wait / occupancy), ``SELDON_TPU_TRACE``
/ ``SELDON_TPU_PERF`` / ``SELDON_TPU_QUALITY`` keep their own
semantics.  A hop record is only written when at least one enabled
consumer wants it; with all four off the dispatch path performs ZERO
ring writes and zero observatory calls (tests/test_torch_spine.py).

``SELDON_TPU_TELEMETRY_TEST_DELAY_MS`` injects an artificial sleep into
every ring write — the way to prove an overhead gate actually gates.
"""

from __future__ import annotations

import atexit
import os
import random
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.runtime.autopilot import AUTOPILOT, pad_bucket
from seldon_core_tpu_torch.runtime.qos import current_tier
from seldon_core_tpu_torch.utils.perf import OBSERVATORY
from seldon_core_tpu_torch.utils.perfcorpus import CORPUS
from seldon_core_tpu_torch.utils.quality import QUALITY
from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir
from seldon_core_tpu_torch.utils.tracing import (
    TRACER,
    Span,
    current_trace_context,
    new_span_id,
    new_trace_id,
)

__all__ = ["HotRecord", "ThreadRing", "TelemetrySpine", "SPINE", "Wants"]

# consumer-interest bits carried in HotRecord.flags — captured at record
# time so a consumer toggled between write and fold keeps the write-time
# decision (the same rule head sampling follows)
WANT_RECORDER = 1
WANT_TRACE = 2
WANT_PERF = 4
WANT_QUALITY = 8
WANT_COST = 16    # record carries a cost-ledger attribution payload
WANT_PM = 32      # head-sampled OUT, but under postmortem tail capture:
                  # the reconstructed span is pm_only — pending buffer
                  # only, never the tracer ring (utils/postmortem.py)

#: hop kinds (HotRecord.hop)
HOP_SPAN = "span"          # a finished tracer span (request/client/...)
HOP_QUEUE = "queue"        # per-caller micro-batch queue wait
HOP_FLUSH = "flush"        # one stacked flush (occupancy + flush span)
HOP_DISPATCH = "dispatch"  # one device dispatch (perf + quality + span)
HOP_QUALITY = "quality"    # per-node quality observation (host/unit lanes)
HOP_GEN_STEP = "gen_step"  # one continuous-batching scheduler step


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _dispatch_tier() -> str:
    """The QoS tier bound to the calling context (``runtime/qos.py``)."""
    return current_tier() or ""


def _ready_event(*tensors):
    """A CUDA event recorded on the current stream after ``tensors`` when
    any of them lives on a card, else None."""
    for t in tensors:
        dev = getattr(t, "device", None)
        if getattr(dev, "type", None) == "cuda":
            import torch

            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            return ev
    return None


class HotRecord:
    """The fixed-layout per-hop record.  Every hop uses a subset of the
    slots; unused slots stay None.  Deliberately a dumb container — all
    interpretation happens in the drainer."""

    __slots__ = (
        "hop",            # HOP_* kind
        "seq",            # perf_counter at append: cross-ring fold order
        "flags",          # WANT_* consumer-interest bits
        "puid", "trace_id", "span_id", "parent_span_id",
        "start_s",        # epoch seconds at hop start
        "duration_s",
        "name", "kind", "method",
        "executable",     # compiled-executable key (dispatch hops)
        "rows", "real_rows",
        "tier",           # QoS tier bound to the dispatch (perf corpus)
        "deadline_remaining_s",
        "compile_cache",  # "hit" | "miss" | None
        "queue_wait_s",
        "requests",       # callers coalesced into a flush
        "predicted_s",    # autopilot-predicted wall of a planned flush
        "quality_node", "batch_x", "batch_y",
        "ready",          # CUDA event recorded after device batch tensors
                          # (the drainer's summarize waits on it)
        "phases",         # fused-graph per-node phase decomposition
                          # ({node: share}, graph/fuse.py) — one record
                          # still explains a whole-graph dispatch
        "error",          # exception type name of a FAILED dispatch
        "span",           # prebuilt Span (HOP_SPAN only)
        "gen",            # (admitted, retired, blocks_used, blocks_total,
                          # tokens) of one scheduler step (HOP_GEN_STEP)
        "gen_detail",     # flight-recorder per-tick decomposition dict
                          # (host/device/phase splits, bubble ledger,
                          # real rows, KV accounting — utils/genperf.py)
        "cost",           # cost-ledger attribution payload of a flush
                          # (per-tenant real rows + padded capacity —
                          # utils/costledger.py); gen ticks ride
                          # gen_detail["attr"] instead
    )

    def __init__(self, hop: str, flags: int):
        self.hop = hop
        self.flags = flags
        self.seq = 0.0
        self.puid = ""
        self.trace_id = ""
        self.span_id = ""
        self.parent_span_id = ""
        self.start_s = 0.0
        self.duration_s = 0.0
        self.name = ""
        self.kind = ""
        self.method = ""
        self.executable = ""
        self.rows = 0
        self.real_rows = 0
        self.tier = ""
        self.deadline_remaining_s = None
        self.compile_cache = None
        self.queue_wait_s = 0.0
        self.requests = 0
        self.predicted_s = None
        self.quality_node = ""
        self.batch_x = None
        self.batch_y = None
        self.ready = None
        self.phases = None
        self.error = None
        self.span = None
        self.gen = None
        self.gen_detail = None
        self.cost = None


class ThreadRing:
    """Single-producer single-consumer ring: the owning thread appends,
    the drainer pops.  Plain int head/tail cursors — the GIL makes each
    store atomic and the slot write happens BEFORE the head publish, so
    no lock is ever taken on the hot path.  A full ring drops (counted);
    it never blocks and never grows."""

    __slots__ = ("buf", "cap", "head", "tail", "dropped", "writes",
                 "owner")

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self.buf: List[Optional[HotRecord]] = [None] * self.cap
        self.head = 0   # producer cursor (owner thread only)
        self.tail = 0   # consumer cursor (drainer only)
        self.dropped = 0
        self.writes = 0
        #: weakref to the owning thread — drain() retires a fully-drained
        #: ring whose thread died, so thread churn can't grow the ring
        #: list (and leak a buffer per dead thread) forever
        self.owner = weakref.ref(threading.current_thread())

    def push(self, rec: HotRecord) -> bool:
        head = self.head
        if head - self.tail >= self.cap:
            self.dropped += 1
            return False
        self.buf[head % self.cap] = rec
        self.head = head + 1  # publish after the slot write
        self.writes += 1
        return True

    def pop_into(self, out: List[HotRecord]) -> None:
        tail, head = self.tail, self.head
        while tail < head:
            i = tail % self.cap
            rec = self.buf[i]
            self.buf[i] = None  # release array refs promptly
            if rec is not None:
                out.append(rec)
            tail += 1
        self.tail = tail


class Wants:
    """One unified sample verdict: a single uniform draw decides every
    subsystem's interest in this hop (nested sampling — see module
    docstring)."""

    __slots__ = ("trace", "quality", "perf", "recorder", "pm", "flags")

    def __init__(self, trace: bool, quality: bool, perf: bool,
                 recorder: bool, pm: bool = False):
        self.trace = trace
        self.quality = quality
        self.perf = perf
        self.recorder = recorder
        self.pm = pm
        self.flags = (
            (WANT_TRACE if trace else 0)
            | (WANT_QUALITY if quality else 0)
            | (WANT_PERF if perf else 0)
            | (WANT_RECORDER if recorder else 0)
            | (WANT_PM if pm else 0)
        )

    @property
    def any(self) -> bool:
        return self.flags != 0


class TelemetrySpine:
    """Process-global ring owner + drainer.  All record_* methods are
    hot-path-safe: no locks, no allocation beyond the record itself, and
    they never raise."""

    def __init__(
        self,
        ring_capacity: Optional[int] = None,
        drain_interval_s: Optional[float] = None,
        telemetry_enabled: Optional[bool] = None,
    ):
        if telemetry_enabled is None:
            telemetry_enabled = (
                os.environ.get("SELDON_TPU_TELEMETRY", "1") != "0"
            )
        self.telemetry_enabled = bool(telemetry_enabled)
        self.ring_capacity = int(
            ring_capacity
            if ring_capacity is not None
            else _env_float("SELDON_TPU_TELEMETRY_RING", 4096)
        )
        self.drain_interval_s = float(
            drain_interval_s
            if drain_interval_s is not None
            else _env_float("SELDON_TPU_TELEMETRY_DRAIN_MS", 50.0) / 1e3
        )
        self.budget_ms = _env_float("SELDON_TPU_OVERHEAD_BUDGET_MS", 1.0)
        #: gate-validation hook: sleep this long inside every ring write
        #: so an overhead gate can be proven to fail on breach
        self.test_delay_s = (
            _env_float("SELDON_TPU_TELEMETRY_TEST_DELAY_MS", 0.0) / 1e3
        )
        self._local = threading.local()
        self._stopped = False
        self._rings: List[ThreadRing] = []
        self._rings_lock = threading.Lock()
        self._drain_lock = threading.RLock()
        #: drains between popping their records and folding the last one:
        #: empty rings are not "current" while this is above 0
        self._folding = 0
        self._drainer: Optional[threading.Thread] = None
        self._rng = random.Random()
        #: bumped once per drain that folded >= 1 record — the staleness
        #: key behind Engine.stats() caching
        self.fold_generation = 0
        self._last_drain_s = 0.0
        self._last_gauge_refresh = 0.0
        self._gauges_dirty = False
        self._dropped_folded = 0
        #: accounting carried over from retired dead-thread rings
        self._retired_dropped = 0
        self._retired_writes = 0
        self.records_total: Dict[str, int] = {}
        #: off-path fold cost per consumer, seconds per record
        self.fold_cost = {
            "tracer": Reservoir(1024),
            "perf": Reservoir(1024),
            "quality": Reservoir(1024),
            "recorder": Reservoir(1024),
            "ledger": Reservoir(1024),
        }
        #: on-path ring-write cost, sampled every 32nd write
        self.ring_write_s = Reservoir(1024)
        self._write_probe = 0
        #: folded hop durations — the /overhead page derives the
        #: framework-time estimate (request p50 - dispatch p50) from them
        self.hop_ms = {"request": Reservoir(2048), "dispatch": Reservoir(2048)}

    # -- ring plumbing -----------------------------------------------------

    def _ring(self) -> ThreadRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = ThreadRing(self.ring_capacity)
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
            self._ensure_drainer()
        return ring

    def _append(self, rec: HotRecord) -> bool:
        if self.test_delay_s > 0.0:
            time.sleep(self.test_delay_s)  # gate-validation hook only
        rec.seq = time.perf_counter()
        ring = self._ring()
        self._write_probe += 1
        if self._write_probe & 31 == 0:
            t0 = time.perf_counter()
            ok = ring.push(rec)
            self.ring_write_s.observe(time.perf_counter() - t0)
            return ok
        return ring.push(rec)

    def _ensure_drainer(self) -> None:
        if self._drainer is not None and self._drainer.is_alive():
            return
        t = threading.Thread(
            target=self._drain_loop, name="telemetry-spine-drain",
            daemon=True,
        )
        self._drainer = t
        t.start()

    def _drain_loop(self) -> None:  # pragma: no cover - timing-dependent
        while not self._stopped:
            time.sleep(self.drain_interval_s)
            # re-check AFTER the sleep: quiesce() flips the flag while
            # this thread is asleep, and a fold entered past that point
            # races interpreter finalization (its C-extension frames
            # keep running while C++ statics destruct -> std::terminate)
            if self._stopped:
                break
            try:
                self.drain()
            except Exception:  # noqa: BLE001 - the drainer must survive
                pass

    def quiesce(self) -> None:
        """Interpreter-exit hook: stop the drainer and wait for any
        in-flight fold.  Daemon threads are not interrupted inside
        C-extension calls at finalization — one still folding when the
        runtime's C++ statics destruct aborts the process instead of
        exiting it.  The fold lock is taken and deliberately KEPT: a
        drainer that passed the _stopped check before it flipped parks
        on the lock (safe to finalize over) instead of entering a fold."""
        self._stopped = True
        self._drain_lock.acquire(timeout=2.0)

    # -- unified sampling --------------------------------------------------

    def dispatch_wants(self) -> Wants:
        """The per-batch sample verdict, decided ONCE with a single
        uniform draw shared by every subsystem.  An active trace context
        (native-plane worker inside its plane span) overrides the trace
        bit with the context's head decision, exactly like a child span
        would."""
        u = self._rng.random()
        ctx = current_trace_context()
        pm = False
        if ctx is not None:
            trace = TRACER.enabled and ctx.sampled
            # a sampled-out context under postmortem tail capture still
            # wants the dispatch span — pm_only, pending buffer only
            pm = (TRACER.enabled and not ctx.sampled and ctx.pm
                  and TRACER.pm_hook is not None)
        else:
            trace = TRACER.enabled and (
                TRACER.sample >= 1.0 or u < TRACER.sample
            )
        quality = QUALITY.enabled and QUALITY.sample > 0.0 and (
            QUALITY.sample >= 1.0 or u < QUALITY.sample
        )
        return Wants(trace, quality, OBSERVATORY.enabled, False, pm=pm)

    # -- hot-path record sites ---------------------------------------------

    def offer_span(self, span: Span) -> None:
        """Tracer sink: a finished span becomes one ring record instead
        of an inline fold under the tracer lock + a prometheus counter
        bump.  Called only for spans the tracer already decided to
        record (enabled + sampled)."""
        rec = HotRecord(HOP_SPAN, WANT_TRACE)
        rec.span = span
        self._append(rec)

    def record_queue(self, wait_s: float, ctx, rows: int,
                     start_s: float) -> bool:
        """One record per caller per stacked flush: the queue-wait
        reservoir AND the per-caller queue span, fused."""
        want_trace = (
            TRACER.enabled and ctx is not None and ctx.sampled
        )
        want_pm = (
            TRACER.enabled and ctx is not None and not ctx.sampled
            and getattr(ctx, "pm", False) and TRACER.pm_hook is not None
        )
        flags = (WANT_RECORDER if self.telemetry_enabled else 0) | (
            WANT_TRACE if want_trace else 0
        ) | (WANT_PM if want_pm else 0)
        if not flags:
            return False
        rec = HotRecord(HOP_QUEUE, flags)
        rec.queue_wait_s = float(wait_s)
        rec.start_s = start_s
        rec.duration_s = float(wait_s)
        rec.rows = int(rows)
        if want_trace or want_pm:
            rec.puid = ctx.puid
            rec.trace_id = ctx.trace_id
            rec.parent_span_id = ctx.span_id
            rec.span_id = new_span_id()
        return self._append(rec)

    def record_flush(self, rows: int, requests: int, start_s: float,
                     duration_s: float,
                     predicted_s: Optional[float] = None,
                     cost: Optional[Dict[str, Any]] = None) -> bool:
        """One record per stacked flush: batch occupancy + the
        standalone flush span (multi-request, so it has no parent).
        ``predicted_s`` carries the autopilot's planned-flush prediction
        so the decision rides the existing write — never a new one.
        ``cost`` is the batcher's attribution payload (per-tenant real
        rows + padded capacity, utils/costledger.py); it keeps the
        record ring-worthy even with telemetry/tracing off, so the
        ledger's own kill switch is the only gate on attribution."""
        want_trace = TRACER.enabled and (
            TRACER.sample >= 1.0 or self._rng.random() < TRACER.sample
        )
        flags = (WANT_RECORDER if self.telemetry_enabled else 0) | (
            WANT_TRACE if want_trace else 0
        ) | (WANT_COST if cost is not None else 0)
        if not flags:
            return False
        rec = HotRecord(HOP_FLUSH, flags)
        rec.rows = int(rows)
        rec.requests = int(requests)
        rec.start_s = start_s
        rec.duration_s = float(duration_s)
        rec.predicted_s = predicted_s
        rec.cost = cost
        return self._append(rec)

    def record_dispatch(
        self,
        wants: Wants,
        *,
        executable: str,
        seconds: float,
        start_s: float,
        rows: int,
        real_rows: int,
        method: str = "predict",
        quality_node: str = "",
        X=None,
        Y=None,
        deadline_remaining_s: Optional[float] = None,
        compile_cache: Optional[str] = None,
        error: Optional[str] = None,
        phases: Optional[Dict[str, float]] = None,
    ) -> bool:
        """THE fused dispatch-hop write: span identity + phase timing +
        executable key + batch references in one append.  The drainer
        derives MFU/roofline (perf), folds the batch into the drift
        windows (quality: the one fused summarize, now off-path), and
        reconstructs the dispatch span carrying both — the same
        trees/tables/families the inline calls used to feed."""
        if not wants.any:
            return False
        rec = HotRecord(HOP_DISPATCH, wants.flags)
        rec.executable = executable
        rec.duration_s = float(seconds)
        rec.start_s = start_s
        rec.rows = int(rows)
        rec.real_rows = int(real_rows)
        rec.method = method
        if wants.perf:
            # the QoS tier is a contextvar on the CALLING thread — the
            # drainer can't read it later, so it rides the record (one
            # contextvar get; the corpus rows bucket by tier)
            rec.tier = _dispatch_tier()
        rec.deadline_remaining_s = deadline_remaining_s
        rec.compile_cache = compile_cache
        rec.error = error
        rec.phases = phases
        if wants.trace or wants.pm:
            ctx = current_trace_context()
            if ctx is not None:
                rec.trace_id = ctx.trace_id
                rec.parent_span_id = ctx.span_id
                rec.puid = ctx.puid
            else:
                rec.trace_id = new_trace_id()
            rec.span_id = new_span_id()
        if wants.quality:
            rec.quality_node = quality_node
            rec.batch_x = X
            rec.batch_y = Y
        return self._append(rec)

    def record_failed_dispatch(
        self,
        *,
        executable: str,
        seconds: float,
        start_s: float,
        rows: int,
        method: str,
        error: str,
    ) -> bool:
        """A FAILED dispatch still gets its span: the trace of an
        incident request must show the device hop that died, with the
        failure named.  Trace-only — perf/quality folds are skipped,
        matching the pre-spine behaviour.  Shared by the engine's
        batched lane and the native plane's dispatch loop so failure
        record semantics cannot diverge between them."""
        return self.record_dispatch(
            Wants(True, False, False, False),
            executable=executable, seconds=seconds, start_s=start_s,
            rows=rows, real_rows=rows, method=method, error=error,
        )

    def record_gen_step(
        self,
        *,
        kind: str,
        duration_s: float,
        active: int,
        waiting: int,
        admitted: int,
        retired: int,
        blocks_used: int,
        blocks_total: int,
        tokens: int,
        executable: str = "",
        trace_id: str = "",
        detail: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """ONE record per continuous-batching scheduler step
        (runtime/genserver.py): the step picture — kind, in-flight/
        waiting sequences, admission/retirement flow, paged-KV-pool
        occupancy, tokens emitted — lands in the ring and folds into a
        ``gen_step`` tracer span off-path.  The scheduler sets its gauges
        directly (one set per step is batcher-precedent cheap); this
        record exists so traces and the hop accounting see the scheduler
        the way they see every other hop.

        ``detail`` is the flight recorder's per-tick decomposition
        (host/device phase splits, bubble ledger entry, real-vs-padded
        rows, KV-block accounting) — folded into ``GENPERF``
        (utils/genperf.py) and the ``seldon_tpu_gen_step_seconds`` /
        ``gen_bubble`` / ``kv_block_age`` families off-path.  The same
        kill-switch contract applies: with flags == 0 the record never
        touches the ring and GENPERF sees nothing."""
        want_trace = TRACER.enabled and (
            TRACER.sample >= 1.0 or self._rng.random() < TRACER.sample
        )
        flags = (WANT_RECORDER if self.telemetry_enabled else 0) | (
            WANT_TRACE if want_trace else 0
        ) | (WANT_COST if detail is not None and "attr" in detail else 0)
        if not flags:
            return False
        rec = HotRecord(HOP_GEN_STEP, flags)
        rec.kind = kind
        rec.rows = int(active)
        rec.requests = int(waiting)
        rec.start_s = time.time() - duration_s
        rec.duration_s = float(duration_s)
        rec.executable = executable
        rec.trace_id = trace_id
        rec.gen = (int(admitted), int(retired), int(blocks_used),
                   int(blocks_total), int(tokens))
        rec.gen_detail = detail
        return self._append(rec)

    def record_quality(self, node: str, X, Y,
                       real_rows: Optional[int] = None) -> bool:
        """Host-mode / unit-pod quality hop: per-node batch references,
        folded off-path.  Device tensors (a node's input and output on the
        card) get a CUDA event recorded after them on the calling thread's
        stream, which the drainer's summarize waits on: no sync here."""
        wants = self.dispatch_wants()
        if not wants.quality:
            return False
        rec = HotRecord(HOP_QUALITY, WANT_QUALITY)
        rec.quality_node = node
        rec.batch_x = X
        rec.batch_y = Y
        rec.ready = _ready_event(X, Y)
        rec.real_rows = -1 if real_rows is None else int(real_rows)
        return self._append(rec)

    # -- drain (the off-path consumers) ------------------------------------

    def _retire_dead(self, rings: List[ThreadRing]) -> None:
        """Drop fully-drained rings of dead threads (their accounting
        rolls into the retired totals, so drop counts stay monotone) —
        thread churn must not grow the ring list forever."""
        dead = [
            r for r in rings
            if r.head == r.tail
            and (r.owner() is None or not r.owner().is_alive())
        ]
        if not dead:
            return
        with self._rings_lock:
            for r in dead:
                if r in self._rings:
                    self._rings.remove(r)
                    self._retired_dropped += r.dropped
                    self._retired_writes += r.writes

    def drain(self) -> int:
        """Fold every pending record into TRACER / OBSERVATORY / QUALITY
        / RECORDER.  Called by the drainer thread on an interval and by
        every query surface before it reads (so reads are current even
        between ticks).  Reentrant-safe; never raises.

        Fast path: Engine.stats() and the four snapshot walks it runs
        each drain defensively, so back-to-back calls with nothing
        pending are the COMMON case — they return after a lock-free
        cursor scan instead of serializing scrapers on the drain lock.
        Empty rings while another drain is folding the records it popped
        take the lock, so the caller reads once that fold is done."""
        with self._rings_lock:
            rings = list(self._rings)
        # the rings first, then the fold count: a drain counts itself
        # before it pops, so rings seen empty after its pop see its count
        if all(r.head == r.tail for r in rings) and not self._folding:
            self._retire_dead(rings)
            # totals folded just before a traffic pause must still reach
            # the gauges once the throttle window passes
            self._refresh_gauges()
            return 0
        with self._drain_lock:
            self._folding += 1
            try:
                return self._drain_locked()
            finally:
                self._folding -= 1

    def _drain_locked(self) -> int:
        """``drain``'s pop and fold, under the drain lock."""
        with self._rings_lock:
            rings = list(self._rings)
        records: List[HotRecord] = []
        for ring in rings:
            ring.pop_into(records)
        self._retire_dead(rings)
        with self._rings_lock:
            dropped = self._retired_dropped + sum(
                r.dropped for r in self._rings
            )
        new_drops = dropped - self._dropped_folded
        if new_drops > 0:
            self._dropped_folded = dropped
            RECORDER.record_ring_dropped(new_drops)
        if not records:
            self._last_drain_s = time.monotonic()
            self._refresh_gauges()
            return 0
        records.sort(key=lambda r: r.seq)
        for rec in records:
            try:
                self._fold(rec)
            except Exception:  # noqa: BLE001 - a bad record must not
                pass           # wedge the drain behind it
            self.records_total[rec.hop] = (
                self.records_total.get(rec.hop, 0) + 1
            )
        self.fold_generation += 1
        self._last_drain_s = time.monotonic()
        self._gauges_dirty = True
        self._refresh_gauges()
        return len(records)

    def _fold(self, rec: HotRecord) -> None:
        pc = time.perf_counter
        if rec.hop == HOP_SPAN:
            t0 = pc()
            TRACER._fold(rec.span)
            self.fold_cost["tracer"].observe(pc() - t0)
            if rec.span.kind == "request" and not rec.span.pm_only:
                # pm_only request spans exist only for the postmortem
                # pending buffer — the overhead estimator's sample set
                # must stay exactly what head sampling admitted
                self.hop_ms["request"].observe(rec.span.duration_ms)
            return
        if rec.hop == HOP_QUEUE:
            if rec.flags & WANT_RECORDER:
                t0 = pc()
                RECORDER.observe_queue_wait(rec.queue_wait_s)
                self.fold_cost["recorder"].observe(pc() - t0)
            if rec.flags & (WANT_TRACE | WANT_PM):
                t0 = pc()
                TRACER._fold(Span(
                    puid=rec.puid, name="batch_queue", kind="queue",
                    method="wait", start_s=rec.start_s,
                    duration_ms=rec.duration_s * 1e3,
                    attrs={"rows": rec.rows},
                    trace_id=rec.trace_id, span_id=rec.span_id,
                    parent_span_id=rec.parent_span_id,
                    pm_only=not (rec.flags & WANT_TRACE),
                ))
                self.fold_cost["tracer"].observe(pc() - t0)
            return
        if rec.hop == HOP_FLUSH:
            if rec.flags & WANT_RECORDER:
                t0 = pc()
                RECORDER.observe_batch(rec.rows)
                if rec.predicted_s is not None:
                    # an autopilot-planned flush: the decision counter
                    # rides the fold, never the flush path itself
                    RECORDER.record_autopilot_decision("flush")
                self.fold_cost["recorder"].observe(pc() - t0)
            if rec.flags & WANT_TRACE:
                t0 = pc()
                attrs = {"rows": rec.rows, "requests": rec.requests}
                if rec.predicted_s is not None:
                    attrs["autopilot_predicted_ms"] = round(
                        rec.predicted_s * 1e3, 3
                    )
                TRACER._fold(Span(
                    puid="", name="flush", kind="batch", method="dispatch",
                    start_s=rec.start_s, duration_ms=rec.duration_s * 1e3,
                    attrs=attrs,
                    span_id=new_span_id(),
                ))
                self.fold_cost["tracer"].observe(pc() - t0)
            if rec.flags & WANT_COST and rec.cost is not None:
                # tenant attribution of the flush's wall, off-path
                t0 = pc()
                from seldon_core_tpu_torch.utils.costledger import LEDGER

                LEDGER.fold_flush(rec.cost, rec.duration_s)
                self.fold_cost["ledger"].observe(pc() - t0)
            return
        if rec.hop == HOP_GEN_STEP:
            # gauges/counters were set by the scheduler itself (one call
            # per step); the fold's job is the TRACE face of the step —
            # plus the dispatch-latency histogram observation whose
            # bucket carries the step's trace_id as an OpenMetrics
            # exemplar (on a decode replica that joins the KV handoff's
            # federated trace to the slow bucket that served it)
            if rec.executable and rec.flags & WANT_RECORDER:
                t0 = pc()
                RECORDER.observe_dispatch(
                    rec.executable, rec.duration_s,
                    trace_id=rec.trace_id or None,
                )
                self.fold_cost["recorder"].observe(pc() - t0)
            detail = rec.gen_detail
            if detail is not None and rec.flags & WANT_RECORDER:
                # the flight recorder's per-tick decomposition: bubble
                # ledger, phase splits, KV-block ages — aggregated in
                # GENPERF (the /genperf surface) and mirrored into the
                # gen_step_seconds / gen_bubble / kv_block_age families,
                # all off-path on the drainer thread
                t0 = pc()
                from seldon_core_tpu_torch.utils.genperf import GENPERF

                GENPERF.observe_tick(rec.kind, detail)
                dev_phases = detail.get("device_phases") or {}
                for phase, secs in (detail.get("phases") or {}).items():
                    dev = float(dev_phases.get(phase, 0.0))
                    host = max(float(secs) - dev, 0.0)
                    if host > 0:
                        RECORDER.record_gen_step_seconds(
                            rec.kind, phase, host)
                    if dev > 0:
                        RECORDER.record_gen_step_seconds(
                            rec.kind, f"{phase}_device", dev)
                bubble = float(detail.get("bubble_s", 0.0) or 0.0)
                cause = str(detail.get("bubble_cause", "") or "")
                if bubble > 0 and cause:
                    RECORDER.record_gen_bubble(cause, bubble)
                for _n_blocks, age_s in (detail.get("kv_ages") or ()):
                    RECORDER.record_gen_kv_block_age(float(age_s))
                self.fold_cost["recorder"].observe(pc() - t0)
            if detail is not None and rec.flags & WANT_COST:
                # per-tenant split of the tick's device wall and the
                # KV-block-seconds released: the ledger's generation lane
                t0 = pc()
                from seldon_core_tpu_torch.utils.costledger import LEDGER

                LEDGER.fold_gen_tick(detail)
                self.fold_cost["ledger"].observe(pc() - t0)
            if rec.flags & WANT_TRACE:
                t0 = pc()
                admitted, retired, used, total, tokens = rec.gen
                attrs = {
                    "active": rec.rows, "waiting": rec.requests,
                    "admitted": admitted, "retired": retired,
                    "kv_blocks_used": used, "kv_blocks_total": total,
                    "tokens": tokens,
                }
                if detail is not None:
                    # the tick's device/bubble face on the trace too, so
                    # a slow gen_step span decomposes without /genperf
                    attrs["device_ms"] = round(
                        float(detail.get("device_s", 0.0)) * 1e3, 3)
                    if detail.get("bubble_s"):
                        attrs["bubble_ms"] = round(
                            float(detail["bubble_s"]) * 1e3, 3)
                        attrs["bubble_cause"] = detail.get(
                            "bubble_cause", "")
                TRACER._fold(Span(
                    puid="", name="gen_step", kind="gen_step",
                    method=rec.kind, start_s=rec.start_s,
                    duration_ms=rec.duration_s * 1e3,
                    attrs=attrs,
                    span_id=new_span_id(),
                ))
                self.fold_cost["tracer"].observe(pc() - t0)
            return
        if rec.hop == HOP_QUALITY:
            t0 = pc()
            QUALITY.fold_batch(
                rec.quality_node, rec.batch_x, rec.batch_y,
                real_rows=None if rec.real_rows < 0 else rec.real_rows,
                ready=rec.ready,
            )
            self.fold_cost["quality"].observe(pc() - t0)
            return
        if rec.hop == HOP_DISPATCH:
            self.hop_ms["dispatch"].observe(rec.duration_s * 1e3)
            attrs: Dict[str, Any] = {"rows": rec.rows}
            if rec.flags & WANT_PERF:
                t0 = pc()
                derived = OBSERVATORY.observe_dispatch(
                    rec.executable, rec.duration_s, rows=rec.rows,
                    trace_id=rec.trace_id if rec.flags & WANT_TRACE
                    else None,
                )
                for k in ("flops", "mfu", "bound"):
                    if k in derived:
                        attrs[k] = derived[k]
                # the autopilot learns from the same record; the prediction
                # in force before this wall lands on the dispatch span, so
                # mispredictions read off traces
                pred = AUTOPILOT.observe(rec.executable, rec.duration_s)
                if pred is not None:
                    attrs["autopilot_predicted_ms"] = round(pred * 1e3, 3)
                # the durable corpus appends the same record: a disk write on
                # this thread, a flag read when it is off
                if CORPUS.enabled and not rec.error:
                    CORPUS.record(
                        rec.executable, pad_bucket=pad_bucket(rec.rows), tier=rec.tier,
                        wall_s=rec.duration_s, rows=rec.real_rows or rec.rows,
                        features=OBSERVATORY.cost_features(rec.executable))
                self.fold_cost["perf"].observe(pc() - t0)
            if rec.flags & WANT_QUALITY:
                t0 = pc()
                drift = QUALITY.fold_batch(
                    rec.quality_node, rec.batch_x, rec.batch_y,
                    real_rows=rec.real_rows,
                )
                if drift is not None:
                    attrs["drift"] = round(drift, 4)
                self.fold_cost["quality"].observe(pc() - t0)
            if rec.flags & (WANT_TRACE | WANT_PM):
                t0 = pc()
                if rec.error:
                    attrs["error"] = rec.error
                if rec.phases:
                    # fused whole-graph dispatch: the span carries the
                    # per-node phase decomposition (graph/fuse.py)
                    attrs["phases"] = dict(rec.phases)
                if rec.compile_cache:
                    attrs["compile_cache"] = rec.compile_cache
                if rec.deadline_remaining_s is not None:
                    attrs["deadline_remaining_ms"] = round(
                        rec.deadline_remaining_s * 1e3, 3
                    )
                TRACER._fold(Span(
                    puid=rec.puid, name="dispatch", kind="dispatch",
                    method=rec.method, start_s=rec.start_s,
                    duration_ms=rec.duration_s * 1e3, attrs=attrs,
                    trace_id=rec.trace_id, span_id=rec.span_id,
                    parent_span_id=rec.parent_span_id,
                    pm_only=not (rec.flags & WANT_TRACE),
                ))
                self.fold_cost["tracer"].observe(pc() - t0)

    def _refresh_gauges(self) -> None:
        """Publish the self-observed overhead figures (throttled to one
        refresh per second — gauge churn is itself overhead; ``dirty``
        tracking guarantees the LAST folds before a traffic pause still
        land once the window passes)."""
        now = time.monotonic()
        if not self._gauges_dirty or now - self._last_gauge_refresh < 1.0:
            return
        self._last_gauge_refresh = now
        self._gauges_dirty = False
        for name, res in self.fold_cost.items():
            snap = res.snapshot()
            if snap["count"]:
                RECORDER.set_framework_overhead(
                    name, snap["p50"] * 1e3
                )
        ring = self.ring_write_s.snapshot()
        if ring["count"]:
            RECORDER.set_framework_overhead("ring", ring["p50"] * 1e3)
        total = self.framework_p50_ms()
        if total is not None:
            RECORDER.set_framework_overhead("total", total)
        # the budget rides the same family so the alert rule compares
        # total against the CONFIGURED budget, not a hardcoded constant
        RECORDER.set_framework_overhead("budget", self.budget_ms)
        for hop, n in self.records_total.items():
            RECORDER.set_telemetry_records(hop, n)
        # autopilot model health shares the throttled refresh: one gauge
        # pass per second, never per observation
        try:
            AUTOPILOT.publish_gauges()
        except Exception:  # noqa: BLE001 - gauges must not wedge a drain
            pass
        # durable perf-corpus accounting (rows, disk bytes, warm keys)
        try:
            CORPUS.publish_gauges()
        except Exception:  # noqa: BLE001 - gauges must not wedge a drain
            pass
        # derived generation-lane gauges (served decode MFU) ride the
        # same throttle — computed from GENPERF's fold-side totals
        try:
            from seldon_core_tpu_torch.utils.genperf import GENPERF

            GENPERF.publish_gauges()
        except Exception:  # noqa: BLE001 - gauges must not wedge a drain
            pass
        # resource-attribution counters (cost_device_seconds /
        # kv_block_seconds / pad_tax / attributed_fraction): deltas computed
        # fold-side, pushed on the same 1/s throttle
        try:
            from seldon_core_tpu_torch.utils.costledger import LEDGER

            LEDGER.publish_gauges()
        except Exception:  # noqa: BLE001 - gauges must not wedge a drain
            pass
        # postmortem pinned-span accounting rides the same throttle
        try:
            from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM

            POSTMORTEM.publish_gauges()
        except Exception:  # noqa: BLE001 - gauges must not wedge a drain
            pass

    # -- the /overhead surface ---------------------------------------------

    def framework_p50_ms(self) -> Optional[float]:
        """Per-request framework overhead estimate from the folded
        records: request-hop p50 minus dispatch-hop p50 (the same
        subtraction ``span_framework_p50_ms`` makes).  None
        until both hops have samples — request hops need tracing on."""
        req = self.hop_ms["request"].snapshot()
        disp = self.hop_ms["dispatch"].snapshot()
        if not req["count"] or not disp["count"]:
            return None
        return round(max(req["p50"] - disp["p50"], 0.0), 3)

    def overhead_document(self) -> Dict[str, Any]:
        """The ``GET /overhead`` body: the telemetry budget as a
        self-observed SLO, decomposed per subsystem from the records
        themselves."""
        self.drain()
        with self._rings_lock:
            rings = list(self._rings)
        dropped = self._retired_dropped + sum(r.dropped for r in rings)
        writes = self._retired_writes + sum(r.writes for r in rings)

        def us(res: Reservoir) -> Dict[str, Any]:
            s = res.snapshot()
            return {
                "count": s["count"],
                "p50_us": round(s["p50"] * 1e6, 2),
                "p99_us": round(s["p99"] * 1e6, 2),
                "mean_us": round(s["mean"] * 1e6, 2),
            }

        framework = self.framework_p50_ms()
        req = self.hop_ms["request"].snapshot()
        disp = self.hop_ms["dispatch"].snapshot()
        return {
            "budget_ms": self.budget_ms,
            "framework_p50_ms": framework,
            "within_budget": (
                None if framework is None else framework <= self.budget_ms
            ),
            "needs_tracing": not req["count"],
            "hops_ms": {
                "request_p50": round(req["p50"] * 1.0, 3),
                "dispatch_p50": round(disp["p50"] * 1.0, 3),
                "request_count": req["count"],
                "dispatch_count": disp["count"],
            },
            "off_path_fold": {k: us(v) for k, v in self.fold_cost.items()},
            "ring": {
                "threads": len(rings),
                "capacity": self.ring_capacity,
                "writes": writes,
                "dropped_total": dropped,
                "write_cost": us(self.ring_write_s),
                "test_delay_ms": round(self.test_delay_s * 1e3, 3),
            },
            "records_folded": dict(self.records_total),
            "consumers": {
                "recorder": self.telemetry_enabled,
                "tracer": TRACER.enabled,
                "perf": OBSERVATORY.enabled,
                "quality": QUALITY.enabled,
            },
            "sampling": {
                "unified": True,
                "trace": TRACER.sample,
                "quality": QUALITY.sample,
            },
        }

    def reset(self) -> None:
        """Drop pending records and overhead accounting — tests only."""
        with self._drain_lock:
            with self._rings_lock:
                rings = list(self._rings)
            scratch: List[HotRecord] = []
            for ring in rings:
                ring.pop_into(scratch)
            self._dropped_folded = self._retired_dropped + sum(
                r.dropped for r in rings
            )
            self.records_total = {}
            self.fold_cost = {
                k: Reservoir(1024) for k in self.fold_cost
            }
            self.ring_write_s = Reservoir(1024)
            self.hop_ms = {
                "request": Reservoir(2048), "dispatch": Reservoir(2048)
            }


SPINE = TelemetrySpine()
atexit.register(SPINE.quiesce)

# wire the off-path consumers: the singletons' spans route through the
# ring, and every query surface drains before reading.  Local instances
# (tests construct their own Tracer/observatories) keep their inline
# synchronous behaviour — sink/drain hooks default to None.
TRACER.sink = SPINE.offer_span
TRACER.drain_hook = SPINE.drain
RECORDER.drain_hook = SPINE.drain
OBSERVATORY.drain_hook = SPINE.drain
QUALITY.drain_hook = SPINE.drain

# tail-sampled postmortem capture (utils/postmortem.py): every folded span,
# sampled or pm_only, is offered to the pending buffer so the keep/drop
# verdict can wait for request completion.  SELDON_TPU_POSTMORTEM=0 leaves
# pm_hook None, which is head sampling bit for bit: no pm_only span is
# ever recorded.
from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM  # noqa: E402

if POSTMORTEM.enabled:
    TRACER.pm_hook = POSTMORTEM.offer
