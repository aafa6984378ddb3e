"""Causal distributed tracing — span trees, W3C context propagation,
critical-path analysis, trace export + device profiling; the port's
counterpart of ``seldon_core_tpu/utils/tracing.py``.

The reference has no distributed tracing: it logs per-hop call durations
(engine InternalPredictionService.java:267-268) and threads ``puid``
through every hop as a flat correlation id (PredictionService.java:52-58).
This module is a *causal* tracer:

  * Every span carries ``trace_id`` / ``span_id`` / ``parent_span_id``.
    The active span lives in a contextvar (``TRACE_VAR``, parallel to the
    deadline budget of runtime/resilience.py), so nesting is automatic:
    a span opened inside another becomes its child, across ``await`` and
    ``asyncio.gather`` fan-out (tasks inherit a context copy).
  * Trace context rides every hop as a W3C ``traceparent`` header (REST)
    / metadata entry (gRPC), so a multi-process graph — gateway → engine
    → unit microservices — reassembles into ONE tree, queryable at any
    participant's ``GET /trace?puid=`` (or ``trace_id=``).
  * ``critical_path`` walks the assembled tree and attributes the root
    span's wall clock to the chain of spans that actually gated it;
    ``phase_decomposition`` buckets those segments into
    queue / retry+backoff / network / dispatch / decode — the per-phase
    latency data ROADMAP's perf work steers by.
  * ``chrome_trace`` emits Chrome trace-event JSON (``GET /trace/export``)
    loadable in Perfetto / chrome://tracing.
  * Head sampling: ``SELDON_TPU_TRACE_SAMPLE=0.01`` decides ONCE at the
    trace root; the decision propagates in the traceparent flags byte, so
    tracing can stay on under production load.  ``sample=0`` records
    nothing anywhere in the tree.
  * ``device_profile`` and the profile window (``/profile``) wrap
    ``torch.profiler`` (CPU and CUDA activities) for kernel-level
    timelines: a dispatch's kernels show only in the device profile, not
    in host spans.  The artifact is a Chrome trace JSON under the window's
    logdir.  Re-entrancy safe: a nested/concurrent profile request becomes
    a span event (``device_profile``) or a typed 409 (the window), never a
    profiler exception; ``torch.profiler`` is one per process, so a
    session opened elsewhere counts as busy too.  A window that cannot
    profile (the profiler's CUDA tracing unavailable) is a typed
    ``ProfileUnavailableError``, never an empty artifact.

Tracing is off by default (``SELDON_TPU_TRACE=1`` or ``TRACER.enable()``);
disabled spans cost one attribute load and return a shared null context.
Lookups (``trace()`` / ``by_trace()``) are O(result) via bounded
secondary indexes kept in lockstep with the span ring — they never scan
the full ring under the lock the hot-path ``add()`` needs.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Span",
    "SpanHandle",
    "Tracer",
    "TRACER",
    "TraceContext",
    "TRACE_VAR",
    "TRACEPARENT_HEADER",
    "current_trace_context",
    "current_trace_puid",
    "new_trace_id",
    "new_span_id",
    "parse_traceparent",
    "traceparent_header_value",
    "trace_scope",
    "assemble_tree",
    "assembly_fields",
    "critical_path",
    "phase_decomposition",
    "chrome_trace",
    "trace_document",
    "export_document",
    "span_from_json_dict",
    "partial_markers",
    "device_profile",
    "profile_window_start",
    "profile_window_stop",
    "profile_window_status",
    "profile_window_start_request",
    "ProfileBusyError",
    "ProfileUnavailableError",
]

#: wire name of the trace context (W3C Trace Context, level 1).  The same
#: name is used as the gRPC metadata key — gRPC metadata keys are
#: lowercase by spec, and W3C defines the header name case-insensitively.
TRACEPARENT_HEADER = "traceparent"


def new_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars (W3C trace-id)."""
    return f"{random.getrandbits(128):032x}"


def new_span_id() -> str:
    """64-bit random span id, 16 lowercase hex chars (W3C parent-id)."""
    return f"{random.getrandbits(64):016x}"


@dataclass
class TraceContext:
    """The active span's identity — what a child span needs to link to its
    parent, and what rides the wire to the next process.  ``puid`` tags
    along so spans opened without an explicit puid (client aggregate hops,
    feedback with a bare payload) inherit the request's correlation id
    instead of guessing from message payloads."""

    trace_id: str
    span_id: str
    sampled: bool = True
    puid: str = ""
    #: tail-capture (postmortem) bit: a sampled-out trace whose root drew
    #: pm=True still records spans — flagged ``pm_only`` and routed ONLY
    #: to the postmortem pending buffer (utils/postmortem.py), never the
    #: tracer ring.  Rides bit 0x02 of the traceparent flags byte; peers
    #: that predate it read only 0x01 and degrade to local-only capture.
    pm: bool = False

    def child(self, puid: str = "") -> "TraceContext":
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            sampled=self.sampled,
            puid=puid or self.puid,
            pm=self.pm,
        )


TRACE_VAR: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "seldon_tpu_trace", default=None
)


def current_trace_context() -> Optional[TraceContext]:
    return TRACE_VAR.get()


def current_trace_puid() -> str:
    """The active trace's puid ('' when no trace is active) — the
    authoritative correlation id for hops whose payload doesn't carry
    one (aggregate lists, response-less feedback)."""
    ctx = TRACE_VAR.get()
    return ctx.puid if ctx is not None else ""


def traceparent_header_value() -> Optional[str]:
    """The active context serialized per W3C Trace Context
    (``00-<trace-id>-<parent-id>-<flags>``); None when no trace is
    active.  The sampled bit propagates the root's head-sampling decision
    so a sampled-out request records nothing in ANY process."""
    ctx = TRACE_VAR.get()
    if ctx is None or not ctx.trace_id or not ctx.span_id:
        return None
    flags = (0x01 if ctx.sampled else 0x00) | (0x02 if ctx.pm else 0x00)
    return "00-%s-%s-%02x" % (ctx.trace_id, ctx.span_id, flags)


def parse_traceparent(raw: Optional[str]) -> Optional[TraceContext]:
    """Parse an incoming ``traceparent`` value; lenient — absent or
    malformed context means "start a fresh trace" (a bad header must not
    fail a request that would otherwise serve)."""
    if not raw:
        return None
    parts = raw.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
        bits = int(flags[:2], 16)
        sampled = bool(bits & 0x01)
        pm = bool(bits & 0x02)
    except ValueError:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id, sampled=sampled,
                        pm=pm)


def trace_scope(ctx: Optional[TraceContext]):
    """Adopt a remote trace context for the enclosed block (server edges:
    the next span opened becomes the remote caller's child).  No-op when
    ctx is None — the first span then roots a fresh trace."""
    if ctx is None:
        return nullcontext()
    return _ctx_scope(ctx)


@contextmanager
def _ctx_scope(ctx: TraceContext):
    token = TRACE_VAR.set(ctx)
    try:
        yield ctx
    finally:
        TRACE_VAR.reset(token)


@dataclass
class Span:
    puid: str
    name: str  # node name, or "request" / "dispatch" / "batch_queue"
    kind: str  # "request" | "node" | "dispatch" | "client" | "server" | "queue" | "batch"
    method: str  # predict / route / aggregate / ...
    start_s: float  # epoch seconds
    duration_ms: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    #: point-in-time occurrences inside the span: retry attempts, backoff
    #: sleeps, breaker-open short-circuits, degradation fallbacks —
    #: [{"name": ..., "ts": epoch_s, "attrs": {...}}]
    events: List[Dict[str, Any]] = field(default_factory=list)
    #: recorded for the postmortem pending buffer ONLY (the trace was
    #: head-sampled out) — must never reach the tracer ring, indexes, or
    #: per-kind span metrics; deliberately absent from ``to_json_dict``
    pm_only: bool = False

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_ms / 1e3

    def to_json_dict(self) -> dict:
        out = {
            "puid": self.puid,
            "name": self.name,
            "kind": self.kind,
            "method": self.method,
            "start_s": round(self.start_s, 6),
            "duration_ms": round(self.duration_ms, 3),
        }
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.span_id:
            out["span_id"] = self.span_id
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events:
            out["events"] = self.events
        return out


def span_from_json_dict(d: dict) -> Span:
    """Rebuild a :class:`Span` from its ``to_json_dict`` form — the
    federated-trace merge path (gateway/fleet.py) deserializes remote
    participants' spans with this so assembly/critical-path code runs on
    one in-memory shape regardless of which process recorded a span."""
    return Span(
        puid=str(d.get("puid", "") or ""),
        name=str(d.get("name", "") or ""),
        kind=str(d.get("kind", "") or ""),
        method=str(d.get("method", "") or ""),
        start_s=float(d.get("start_s", 0.0) or 0.0),
        duration_ms=float(d.get("duration_ms", 0.0) or 0.0),
        attrs=dict(d.get("attrs") or {}),
        trace_id=str(d.get("trace_id", "") or ""),
        span_id=str(d.get("span_id", "") or ""),
        parent_span_id=str(d.get("parent_span_id", "") or ""),
        events=list(d.get("events") or []),
    )


class SpanHandle(dict):
    """What an open ``tracer.span(...)`` yields.  IS the span's attrs dict
    (``sp["rows"] = 4`` keeps working, and ``isinstance(sp, dict)`` call
    sites stay valid) plus ``event()`` for point-in-time records."""

    def __init__(self, attrs: Optional[dict] = None):
        super().__init__(attrs or {})
        self.events: List[Dict[str, Any]] = []

    def event(self, name: str, **attrs: Any) -> None:
        ev: Dict[str, Any] = {"name": name, "ts": round(time.time(), 6)}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)


class Tracer:
    """Bounded ring of recent spans with puid / trace_id secondary
    indexes.  Thread-safe: spans arrive from the event loop and from
    device-dispatch executor threads."""

    def __init__(
        self,
        capacity: int = 8192,
        enabled: Optional[bool] = None,
        sample: Optional[float] = None,
    ):
        if enabled is None:
            enabled = os.environ.get("SELDON_TPU_TRACE", "") not in ("", "0")
        if sample is None:
            try:
                sample = float(os.environ.get("SELDON_TPU_TRACE_SAMPLE", "1.0"))
            except ValueError:
                sample = 1.0
        self.enabled = bool(enabled)
        self.sample = min(max(float(sample), 0.0), 1.0)
        self.capacity = int(capacity)
        self._spans: deque = deque()
        # secondary indexes share the ring's insertion order, so eviction
        # is popleft on both sides — trace()/by_trace() never scan the
        # ring under the hot-path lock (satellite: the old O(capacity)
        # linear scan serialized queries against add() at volume)
        self._by_puid: Dict[str, deque] = {}
        self._by_trace: Dict[str, deque] = {}
        #: open spans by span_id — event() targets the active one
        self._open: Dict[str, SpanHandle] = {}
        self._lock = threading.Lock()
        self._null = nullcontext()
        self._rng = random  # tests may inject random.Random(seed)
        self.recorded_total = 0
        self.sampled_out_total = 0
        #: telemetry-spine wiring (utils/hotrecord.py), set on the global
        #: TRACER only: ``sink`` routes finished spans into the per-thread
        #: ring (one write per hop, folded off-path); ``drain_hook`` folds
        #: pending records before any query reads.  Local instances keep
        #: the inline synchronous path (both default None).
        self.sink = None
        self.drain_hook = None
        #: tail-capture wiring (utils/postmortem.py), set on the global
        #: TRACER only when postmortem capture is enabled: every folded
        #: span — sampled or pm_only — is offered to the pending buffer
        #: so the keep/drop decision can wait for request completion.
        #: None (the default, and always for local instances) restores
        #: head-sampling behavior bit-for-bit.
        self.pm_hook = None

    # -- admin -------------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _drain(self) -> None:
        """Fold any ring-pending spans before a read — queries stay
        exactly as current as the old inline path made them."""
        if self.drain_hook is not None:
            self.drain_hook()

    def clear(self) -> None:
        self._drain()  # pending records must not resurrect after clear
        with self._lock:
            self._spans.clear()
            self._by_puid.clear()
            self._by_trace.clear()

    def snapshot(self) -> Dict[str, Any]:
        """Tracer health for ``/stats``."""
        self._drain()
        with self._lock:
            spans = len(self._spans)
            traces = len(self._by_trace)
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "spans": spans,
            "traces_indexed": traces,
            "capacity": self.capacity,
            "recorded_total": self.recorded_total,
            "sampled_out_total": self.sampled_out_total,
        }

    # -- recording ---------------------------------------------------------

    def span(self, puid: str, name: str, kind: str = "node",
             method: str = "", **attrs):
        if not self.enabled:
            return self._null
        parent = TRACE_VAR.get()
        if parent is not None:
            if not parent.sampled:
                # the root's head decision governs the RING; a pm-flagged
                # trace still records, pm_only, into the pending buffer
                if parent.pm and self.pm_hook is not None:
                    ctx = parent.child(puid)
                    return self._record(puid or ctx.puid, name, kind,
                                        method, attrs, ctx,
                                        parent.span_id, pm_only=True)
                return self._null
            ctx = parent.child(puid)
            parent_id = parent.span_id
        else:
            # head sampling: decided ONCE here, at the trace root; the
            # bit rides the traceparent flags to every other process
            if self.sample < 1.0 and self._rng.random() >= self.sample:
                self.sampled_out_total += 1
                if self.pm_hook is not None:
                    # sampled OUT of the ring but INTO tail capture: the
                    # keep/drop verdict moves to request completion
                    ctx = TraceContext(
                        trace_id=new_trace_id(), span_id=new_span_id(),
                        sampled=False, puid=puid, pm=True,
                    )
                    return self._record(puid, name, kind, method, attrs,
                                        ctx, "", pm_only=True)
                return self._unsampled(puid)
            ctx = TraceContext(
                trace_id=new_trace_id(), span_id=new_span_id(),
                sampled=True, puid=puid, pm=self.pm_hook is not None,
            )
            parent_id = ""
        return self._record(puid or ctx.puid, name, kind, method, attrs,
                            ctx, parent_id)

    @contextmanager
    def _unsampled(self, puid: str):
        """A sampled-out root still sets a (not-sampled) context with real
        ids, so child hops — local and remote — inherit the decision
        instead of re-drawing it and recording orphan subtrees."""
        ctx = TraceContext(
            trace_id=new_trace_id(), span_id=new_span_id(),
            sampled=False, puid=puid,
        )
        token = TRACE_VAR.set(ctx)
        try:
            yield None
        finally:
            TRACE_VAR.reset(token)

    @contextmanager
    def _record(self, puid, name, kind, method, attrs, ctx, parent_id,
                pm_only: bool = False):
        handle = SpanHandle(attrs)
        token = TRACE_VAR.set(ctx)
        self._open[ctx.span_id] = handle
        t0 = time.perf_counter()
        start = time.time()
        try:
            yield handle  # callers may add attrs / events while open
        finally:
            TRACE_VAR.reset(token)
            self._open.pop(ctx.span_id, None)
            self.add(
                Span(
                    puid=puid,
                    name=name,
                    kind=kind,
                    method=method,
                    start_s=start,
                    duration_ms=(time.perf_counter() - t0) * 1e3,
                    attrs=dict(handle),
                    trace_id=ctx.trace_id,
                    span_id=ctx.span_id,
                    parent_span_id=parent_id,
                    events=handle.events,
                    pm_only=pm_only,
                )
            )

    def event(self, name: str, **attrs: Any) -> bool:
        """Attach a point-in-time event to the ACTIVE span (retry attempt,
        backoff sleep, breaker-open short-circuit, fallback).  Returns
        False (and records nothing) when tracing is off, the trace is
        sampled out (and not under postmortem capture), or no span is
        open.  The gate is handle presence, not ``ctx.sampled``: a
        pm_only span HAS an open handle and its events (preempt, breaker
        open, retry) are exactly what the postmortem retention policy
        keys on."""
        if not self.enabled:
            return False
        ctx = TRACE_VAR.get()
        if ctx is None:
            return False
        handle = self._open.get(ctx.span_id)
        if handle is None:
            return False
        handle.event(name, **attrs)
        return True

    def annotate(self, **attrs: Any) -> bool:
        """Merge attrs into the ACTIVE span (status codes, typed-error
        names, shed verdicts — stamped at catch sites so the postmortem
        retention policy can read them at completion).  Same gating as
        :meth:`event`; returns False when nothing was open to annotate."""
        if not self.enabled:
            return False
        ctx = TRACE_VAR.get()
        if ctx is None:
            return False
        handle = self._open.get(ctx.span_id)
        if handle is None:
            return False
        handle.update(attrs)
        return True

    def record_span(
        self,
        name: str,
        kind: str,
        method: str = "",
        start_s: float = 0.0,
        duration_ms: float = 0.0,
        ctx: Optional[TraceContext] = None,
        puid: str = "",
        **attrs: Any,
    ) -> None:
        """Record an already-measured span — for phases whose start and
        end are observed from outside a ``with`` block (micro-batch queue
        wait: enqueue in one task, dequeue in the flush task).  ``ctx``
        (captured at the causal start) parents the span; a not-sampled
        ctx records nothing."""
        if not self.enabled:
            return
        pm_only = False
        if ctx is not None:
            if not ctx.sampled:
                if not (ctx.pm and self.pm_hook is not None):
                    return
                pm_only = True  # pending buffer only, never the ring
            trace_id, parent_id = ctx.trace_id, ctx.span_id
            puid = puid or ctx.puid
        else:
            if self.sample < 1.0 and self._rng.random() >= self.sample:
                return
            trace_id, parent_id = "", ""
        self.add(
            Span(
                puid=puid, name=name, kind=kind, method=method,
                start_s=start_s, duration_ms=duration_ms, attrs=attrs,
                trace_id=trace_id, span_id=new_span_id(),
                parent_span_id=parent_id, pm_only=pm_only,
            )
        )

    def add(self, span: Span) -> None:
        """Record one finished span.  With a telemetry-spine sink wired
        (the process-global TRACER) this is ONE lock-free ring write; the
        drainer folds the span into the ring/indexes off-path via
        ``_fold``.  Without a sink (local tracers, spine disabled) it
        folds inline — identical end state either way."""
        if self.sink is not None:
            self.sink(span)
            return
        self._fold(span)

    def _fold(self, span: Span) -> None:
        hook = self.pm_hook
        if hook is not None:
            try:
                hook(span)  # tail-capture pending buffer (postmortem)
            except Exception:  # noqa: BLE001 - capture must never fail a fold
                pass
        if span.pm_only:
            # head-sampled-out span: it exists ONLY for the pending
            # buffer — ring, indexes, and span metrics stay untouched
            return
        with self._lock:
            self._spans.append(span)
            if span.puid:
                self._by_puid.setdefault(span.puid, deque()).append(span)
            if span.trace_id:
                self._by_trace.setdefault(span.trace_id, deque()).append(span)
            while len(self._spans) > self.capacity:
                old = self._spans.popleft()
                # index deques share insertion order with the ring, so the
                # evictee is the head of its index entries
                for index, key in (
                    (self._by_puid, old.puid), (self._by_trace, old.trace_id)
                ):
                    if not key:
                        continue
                    entries = index.get(key)
                    if entries:
                        entries.popleft()
                        if not entries:
                            del index[key]
            self.recorded_total += 1
        from seldon_core_tpu_torch.utils.telemetry import RECORDER

        RECORDER.record_trace_span(span.kind or "span")

    # -- queries -----------------------------------------------------------

    def trace(self, puid: str) -> List[Span]:
        """All recorded spans of one request, in start order — O(result)
        via the puid index."""
        self._drain()
        with self._lock:
            found = list(self._by_puid.get(puid, ()))
        return sorted(found, key=lambda s: s.start_s)

    def by_trace(self, trace_id: str) -> List[Span]:
        """All recorded spans of one trace, in start order — O(result)."""
        self._drain()
        with self._lock:
            found = list(self._by_trace.get(trace_id, ()))
        return sorted(found, key=lambda s: s.start_s)

    def recent(self, n: int = 100) -> List[Span]:
        self._drain()
        with self._lock:
            return list(self._spans)[-int(n):]


TRACER = Tracer()


# ---------------------------------------------------------------------------
# Trace assembly: span tree, critical path, phase decomposition, export
# ---------------------------------------------------------------------------


def _links(spans: List[Span]) -> Tuple[List[Span], Dict[str, List[Span]]]:
    """(roots, children-by-parent-span-id).  A span whose parent is not in
    the set is a root (the parent lives in a process we can't see, or the
    span predates the causal tracer)."""
    by_id = {s.span_id: s for s in spans if s.span_id}
    kids: Dict[str, List[Span]] = {}
    roots: List[Span] = []
    for s in spans:
        if s.parent_span_id and s.parent_span_id in by_id:
            kids.setdefault(s.parent_span_id, []).append(s)
        else:
            roots.append(s)
    for lst in kids.values():
        lst.sort(key=lambda s: s.start_s)
    return roots, kids


def assemble_tree(spans: List[Span]) -> List[dict]:
    """Nested JSON span tree(s) — one entry per root, children ordered by
    start time."""
    roots, kids = _links(spans)

    def node(s: Span) -> dict:
        out = s.to_json_dict()
        out["children"] = [node(c) for c in kids.get(s.span_id, [])]
        return out

    return [node(r) for r in sorted(roots, key=lambda s: s.start_s)]


#: span kinds that ANNOTATE a window rather than represent exclusive
#: execution: a gen_seq lifecycle timeline overlaps the very dispatch /
#: kv_handoff legs it narrates, so letting it gate the critical path
#: would swallow those legs (it ends last and has no children)
_ANNOTATION_KINDS = frozenset({"gen_seq"})


def critical_path(spans: List[Span]) -> Tuple[Optional[Span], List[Tuple[Span, float]]]:
    """(root, segments): the chain of spans that gated the root's wall
    clock, as ``(span, self_ms)`` contributions.  Walks backward from the
    root's end, descending into the latest-ending child each time — the
    standard span-tree critical path.  Segment self-times sum to the root
    duration exactly (children are clipped to their parent's window), so
    the decomposition accounts for 100% of observed latency.  Annotation
    spans (``_ANNOTATION_KINDS``) stay in the tree but never gate the
    path."""
    roots, kids = _links(spans)
    if not roots:
        return None, []
    # prefer the request-edge span; fall back to the longest root
    # (annotation spans last — an orphaned timeline must not become
    # the root while a real execution root is present)
    root = max(roots, key=lambda s: (
        s.kind == "request", s.kind not in _ANNOTATION_KINDS,
        s.duration_ms))
    segments: List[Tuple[Span, float]] = []

    def visit(sp: Span, cutoff: float, floor: float) -> None:
        # both bounds clip to the parent's window: cross-process clocks
        # skew, and reconstructed spans (queue waits) mix time.time() with
        # perf_counter deltas — without the floor a child that "starts"
        # before its parent would leak time outside the root's duration
        # and break the sums-exactly invariant
        start = max(sp.start_s, floor)
        cursor = min(sp.end_s, cutoff)
        children = sorted(
            (c for c in kids.get(sp.span_id, [])
             if c.kind not in _ANNOTATION_KINDS),
            key=lambda c: c.end_s)
        while children and cursor > start:
            c = children.pop()  # latest-ending child gates the parent
            c_end = min(c.end_s, cursor)
            c_start = max(c.start_s, start)
            if c_end <= c_start or c_start >= cursor:
                continue
            if cursor > c_end:
                segments.append((sp, (cursor - c_end) * 1e3))
            visit(c, c_end, c_start)
            cursor = c_start
        if cursor > start:
            segments.append((sp, (cursor - start) * 1e3))

    visit(root, root.end_s, root.start_s)
    return root, segments


#: span kind -> latency phase of the per-phase decomposition
_PHASE_BY_KIND = {
    "queue": "queue_ms",
    "client": "network_ms",
    "dispatch": "dispatch_ms",
    "batch": "dispatch_ms",
    "kv_handoff": "kv_handoff_ms",
    "kv_import": "kv_handoff_ms",
}


def phase_decomposition(segments: List[Tuple[Span, float]]) -> Dict[str, float]:
    """Bucket critical-path segments into the phases perf work steers by:
    queue (micro-batch wait) / retry+backoff (sleeps between attempts) /
    network (client-span self time: wire + remote queueing we can't see) /
    dispatch (device) / decode (token generation) / kv_handoff (fenced
    KV-block streaming between prefill and decode) / other (host logic).
    Sums to the root duration."""
    phases = {
        "queue_ms": 0.0, "retry_backoff_ms": 0.0, "network_ms": 0.0,
        "dispatch_ms": 0.0, "decode_ms": 0.0, "kv_handoff_ms": 0.0,
        "other_ms": 0.0,
    }
    for sp, self_ms in segments:
        if sp.method in ("generate_stream", "decode"):
            key = "decode_ms"
        else:
            key = _PHASE_BY_KIND.get(sp.kind, "other_ms")
        if sp.kind == "client" and sp.events:
            # backoff sleeps happen inside the client span's wall time but
            # are retry cost, not network cost
            backoff = sum(
                float((e.get("attrs") or {}).get("backoff_ms", 0.0))
                for e in sp.events
                if e.get("name") == "retry"
            )
            take = min(backoff, self_ms)
            phases["retry_backoff_ms"] += take
            self_ms -= take
        phases[key] += self_ms
    phases["total_ms"] = round(sum(phases.values()), 3)
    for k in list(phases):
        phases[k] = round(phases[k], 3)
    return phases


def chrome_trace(
    spans: List[Span],
    process_name: Optional[str] = None,
    pid: int = 0,
    base_s: Optional[float] = None,
) -> dict:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
    format) — loadable in Perfetto / chrome://tracing.  Spans become
    complete ('X') events on one lane per (kind, name); span events become
    instant ('i') marks on the owner's lane.

    ``process_name`` labels this span set's Perfetto process track
    (replica/role — the federated export gives every participant its own
    ``pid`` so a multi-process tree renders legibly); ``base_s`` pins the
    timestamp origin so several processes' events share one timeline."""
    events: List[dict] = []
    if not spans:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = base_s if base_s is not None else min(s.start_s for s in spans)
    lanes: Dict[Tuple[str, str], int] = {}
    for s in sorted(spans, key=lambda x: x.start_s):
        tid = lanes.setdefault((s.kind, s.name), len(lanes) + 1)
        args: Dict[str, Any] = dict(s.attrs)
        if s.puid:
            args["puid"] = s.puid
        if s.span_id:
            args["span_id"] = s.span_id
        if s.parent_span_id:
            args["parent_span_id"] = s.parent_span_id
        events.append({
            "name": f"{s.name}:{s.method}" if s.method else s.name,
            "cat": s.kind or "span",
            "ph": "X",
            "ts": round((s.start_s - base) * 1e6, 1),
            "dur": round(s.duration_ms * 1e3, 1),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        for ev in s.events:
            events.append({
                "name": ev.get("name", "event"),
                "cat": "event",
                "ph": "i",
                "s": "t",
                "ts": round((float(ev.get("ts", s.start_s)) - base) * 1e6, 1),
                "pid": pid,
                "tid": tid,
                "args": ev.get("attrs", {}),
            })
    for (kind, name), tid in lanes.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"{kind}:{name}"},
        })
    if process_name:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": process_name},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def partial_markers(spans: List[Span], named_query: bool) -> dict:
    """The partial-trace contract (fleet observability): a query that
    names a specific request must never answer an empty or silently
    truncated result when the ring evicted part (or all) of the subtree.
    Returns ``{"partial": bool, "missing": [...]}`` — ``missing`` lists
    the parent span ids that are referenced but absent (evicted locally
    or living in a process this tracer can't see)."""
    if not named_query:
        return {"partial": False, "missing": []}
    present = {s.span_id for s in spans if s.span_id}
    orphans = sorted({
        s.parent_span_id for s in spans
        if s.parent_span_id and s.parent_span_id not in present
    })
    missing: List[Any] = [
        {"parent_span_id": p, "reason": "parent span not found "
         "(evicted from the ring or recorded in another process)"}
        for p in orphans
    ]
    if not spans:
        missing.append({"reason": "no spans found for this query "
                        "(evicted from the ring, or never sampled)"})
    return {"partial": bool(missing), "missing": missing}


def _select_spans(
    tracer: Tracer, puid: str = "", trace_id: str = "", limit: int = 100
) -> List[Span]:
    """Spans for one request: by trace_id directly, or by puid widened to
    every trace the puid participates in (picks up same-trace spans that
    carry no puid, e.g. flush/dispatch internals)."""
    if trace_id:
        return tracer.by_trace(trace_id)
    if not puid:
        return tracer.recent(limit)
    spans = list(tracer.trace(puid))
    seen = {id(s) for s in spans}
    for tid in {s.trace_id for s in spans if s.trace_id}:
        for s in tracer.by_trace(tid):
            if id(s) not in seen:
                seen.add(id(s))
                spans.append(s)
    return sorted(spans, key=lambda s: s.start_s)


def assembly_fields(spans: List[Span]) -> Dict[str, Any]:
    """The named-query assembly block shared by the local and federated
    ``GET /trace`` bodies: partial markers, nested tree, critical path,
    per-phase decomposition, root identity.  One implementation so the
    two surfaces can never drift."""
    doc: Dict[str, Any] = {}
    # a named query whose subtree was (partly) evicted answers the
    # partial tree with an explicit marker, never a silent empty
    doc.update(partial_markers(spans, named_query=True))
    doc["tree"] = assemble_tree(spans)
    root, segments = critical_path(spans)
    doc["critical_path"] = [
        {
            "span_id": sp.span_id,
            "name": sp.name,
            "kind": sp.kind,
            "method": sp.method,
            "self_ms": round(self_ms, 3),
        }
        for sp, self_ms in segments
    ]
    doc["phases"] = phase_decomposition(segments)
    if root is not None:
        doc["root_span_id"] = root.span_id
        doc["root_duration_ms"] = round(root.duration_ms, 3)
    return doc


def trace_document(
    tracer: Tracer, puid: str = "", trace_id: str = "", limit: int = 100
) -> dict:
    """The ``GET /trace`` body: flat spans (back-compat) plus the
    assembled tree, critical path, and per-phase decomposition when a
    specific request is named."""
    spans = _select_spans(tracer, puid, trace_id, limit)
    doc: Dict[str, Any] = {
        "enabled": tracer.enabled,
        "sample": tracer.sample,
        "spans": [s.to_json_dict() for s in spans],
    }
    if puid or trace_id:
        doc.update(assembly_fields(spans))
    return doc


def export_document(
    tracer: Tracer, puid: str = "", trace_id: str = "",
    limit: int = 1000, process_name: Optional[str] = None,
) -> dict:
    """The ``GET /trace/export`` body — Chrome trace-event JSON.
    ``process_name`` labels this process's Perfetto track (replica/role)
    so exports merged across a mesh render legibly."""
    return chrome_trace(
        _select_spans(tracer, puid, trace_id, limit),
        process_name=process_name,
    )


# ---------------------------------------------------------------------------
# Device profiling
# ---------------------------------------------------------------------------

_PROFILE_LOCK = threading.Lock()


class ProfileBusyError(RuntimeError):
    """A profile window (or a ``device_profile`` block, or any other
    ``torch.profiler`` session) is already active in this process —
    overlapping windows are refused, never queued: the second window's
    data would be attributed to the first."""


class ProfileUnavailableError(RuntimeError):
    """The profiler cannot trace what the window asks for (CUDA
    activities without the profiler's CUDA tracing, or a start the
    profiler refused) — the window answers this typed error instead of
    handing back an empty artifact as if it had profiled."""


#: file name of a window's artifact under its logdir
PROFILE_ARTIFACT = "trace.json"


def _profiler_busy() -> bool:
    """True while a ``torch.profiler`` session is open on this thread (the
    flag is per thread; two sessions at once on different threads are not
    supported by the profiler, so the window and ``device_profile`` also
    serialize on the module's profile lock)."""
    import torch

    try:
        return bool(torch.autograd._profiler_enabled())
    except Exception:  # noqa: BLE001 - an old build: the lock alone decides
        return False


def _profiler_open():
    """A started ``torch.profiler.profile`` with the CPU activity and, when
    a card is present, the CUDA one.  Raises ``ProfileBusyError`` when
    another session is open, ``ProfileUnavailableError`` when it cannot
    trace the card or refuses to start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _profiler_busy():
        raise ProfileBusyError(
            "a torch.profiler session is already open in this process")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        kineto = getattr(torch.autograd, "kineto_available", lambda: True)
        if not kineto():
            raise ProfileUnavailableError(
                "torch.profiler has no CUDA tracing in this build (kineto "
                "unavailable): a window would profile no device work")
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 - typed for the route
        raise ProfileUnavailableError(
            f"torch.profiler failed to start: {type(e).__name__}: {e}") from e
    if torch.cuda.is_available():
        # the session is tracing the card once this returns: launches made
        # after the start answered land in the artifact
        torch.cuda.synchronize()
    return prof


def _profiler_close(prof, path: str) -> Dict[str, Any]:
    """Stop ``prof`` and write its Chrome trace to ``path``; returns the
    artifact's event counts: ``events``, ``device_events`` (kernel and
    memcpy records) and ``launch_records`` (the CUDA runtime's kernel
    launch calls, every thread's).  A process that has already traced
    many launches can lose some device records of a later session while
    keeping its API records, so fewer ``kernel`` events than
    ``launch_records`` says the artifact is incomplete.  Raises
    ``ProfileUnavailableError`` when the trace holds no event at all."""
    import json as _json

    import torch

    if torch.cuda.is_available():
        # every launch the window saw has finished before the session
        # stops, so the profiler's last activity records are complete
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = _json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    device = sum(1 for e in events if isinstance(e, dict)
                 and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    launches = sum(1 for e in events if isinstance(e, dict)
                   and e.get("cat") == "cuda_runtime" and "LaunchKernel" in str(e.get("name")))
    if not events:
        raise ProfileUnavailableError(
            f"the profiler wrote an empty trace to {path}")
    return {"events": len(events), "device_events": device, "launch_records": launches}


@contextmanager
def device_profile(logdir: str):
    """Capture a ``torch.profiler`` trace (CPU ops and, on a card, its
    kernels) for the enclosed block, written as Chrome trace JSON to
    ``<logdir>/trace.json``; view it in Perfetto.  This is the
    device-level complement to host spans: a dispatch's kernels only
    show here.

    Re-entrancy safe: a nested or concurrent profile request (a window,
    another block, a session opened elsewhere) records a
    ``device_profile_skipped`` span event (or a zero-length span when no
    span is open) and the block runs unprofiled."""
    prof = None
    if _PROFILE_LOCK.acquire(blocking=False):
        try:
            prof = _profiler_open()
        except ProfileBusyError:
            _PROFILE_LOCK.release()
        except BaseException:
            _PROFILE_LOCK.release()
            raise
    if prof is None:
        if not TRACER.event(
            "device_profile_skipped", logdir=str(logdir),
            reason="profiler already active",
        ):
            TRACER.record_span(
                "device_profile_skipped", kind="profile",
                start_s=time.time(), duration_ms=0.0,
                ctx=current_trace_context(), logdir=str(logdir),
            )
        yield
        return
    try:
        try:
            yield
        finally:
            os.makedirs(logdir, exist_ok=True)
            _profiler_close(prof, os.path.join(logdir, PROFILE_ARTIFACT))
    finally:
        _PROFILE_LOCK.release()


# ---------------------------------------------------------------------------
# Coordinated profiling windows (fleet observability)
# ---------------------------------------------------------------------------

#: hard ceiling on a window's duration — a start whose stop never
#: arrives must not profile forever (profiling has real overhead)
def _profile_max_s() -> float:
    try:
        return float(os.environ.get("SELDON_TPU_PROFILE_MAX_S", "") or 60.0)
    except ValueError:
        return 60.0


_WINDOW_STATE_LOCK = threading.Lock()
_WINDOW: Dict[str, Any] = {
    "active": False, "logdir": None, "started_s": 0.0,
    "duration_s": 0.0, "window": "", "owner": None, "last": None,
}


class _WindowOwner(threading.Thread):
    """The thread that owns one window's ``torch.profiler`` session: the
    profiler must start and stop on the same thread (a stop from another
    one finds no session and crashes), so the window's start, its
    auto-stop at ``duration_s`` and an explicit stop all go through here.
    CUDA kernels are traced on every thread that launches them (CUPTI's
    activity records are process-wide); host ops only on this one."""

    def __init__(self, artifact: str, duration_s: float):
        super().__init__(name="profile-window", daemon=True)
        self.artifact = artifact
        self.duration_s = duration_s
        self.started = threading.Event()
        self.stop_requested = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            prof = _profiler_open()
        except Exception as e:  # noqa: BLE001 - handed to the starter, which raises it
            self.error = e
            self.started.set()
            return
        self.started.set()
        self.stop_requested.wait(self.duration_s)
        try:
            counts = _profiler_close(prof, self.artifact)
            error = None
        except Exception as e:  # noqa: BLE001 - reported, never an empty artifact
            counts, error = {}, f"{type(e).__name__}: {e}"
        _window_closed(self, counts, error)


def _window_closed(owner: _WindowOwner, counts: Dict[str, Any],
                   error: Optional[str]) -> None:
    """The owner's last act: the manifest entry, the window inactive, the
    profile lock given back."""
    with _WINDOW_STATE_LOCK:
        if _WINDOW["owner"] is not owner:
            return
        entry = {
            "window": _WINDOW["window"],
            "artifact": _WINDOW["logdir"] if error is None else None,
            "started_s": _WINDOW["started_s"],
            "duration_s": round(time.time() - _WINDOW["started_s"], 3),
            **counts,
        }
        if error is not None:
            entry["error"] = error
        _WINDOW.update(active=False, owner=None, last=entry)
    _PROFILE_LOCK.release()


def profile_window_start(logdir: str, duration_s: float = 0.0,
                         window: str = "") -> Dict[str, Any]:
    """Open a bounded-duration ``torch.profiler`` window for THIS process —
    the per-engine half of a coordinated fleet profile window.

    Holds the module profile lock for the window's lifetime, so a
    concurrent ``device_profile`` block degrades to a span event exactly
    as it does against any active profiler session.  The window closes
    on ``profile_window_stop()`` or automatically after ``duration_s``
    (clamped to ``SELDON_TPU_PROFILE_MAX_S``); its artifact is the Chrome
    trace ``<logdir>/trace.json``, written at the close.  Raises
    :class:`ProfileBusyError` when a window/profile is already active —
    overlapping windows are refused by contract — and
    :class:`ProfileUnavailableError` when the profiler cannot start."""
    duration_s = float(duration_s or 0.0)
    max_s = _profile_max_s()
    if duration_s <= 0.0 or duration_s > max_s:
        duration_s = max_s
    if _profiler_busy():
        # the profiler's enabled flag is per thread: the caller's own
        # session is seen here, the owner thread checks its own again
        raise ProfileBusyError(
            "a torch.profiler session is already open on this thread")
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise ProfileBusyError(
            "a profile window or device_profile block is already active "
            "in this process — stop it before opening another")
    artifact = os.path.join(str(logdir), PROFILE_ARTIFACT)
    try:
        os.makedirs(logdir, exist_ok=True)
        owner = _WindowOwner(artifact, duration_s)
        with _WINDOW_STATE_LOCK:
            _WINDOW.update(active=True, logdir=artifact, started_s=time.time(),
                           duration_s=duration_s, window=window or new_span_id(),
                           owner=owner)
        owner.start()
        owner.started.wait()
    except BaseException:
        with _WINDOW_STATE_LOCK:
            _WINDOW.update(active=False, owner=None)
        _PROFILE_LOCK.release()
        raise
    if owner.error is not None:
        with _WINDOW_STATE_LOCK:
            _WINDOW.update(active=False, owner=None)
        _PROFILE_LOCK.release()
        raise owner.error
    with _WINDOW_STATE_LOCK:
        return {
            "active": True, "window": _WINDOW["window"],
            "artifact": artifact,
            "started_s": _WINDOW["started_s"],
            "duration_s": duration_s,
        }


def profile_window_stop() -> Dict[str, Any]:
    """Close the active window and wait for its artifact (idempotent — the
    auto-stop and an explicit stop may race; whichever runs second is a
    no-op).  Returns the finished window's manifest entry (with the
    artifact's ``events`` and ``device_events`` counts, or the ``error``
    that kept it from being written), or the LAST one when no window is
    active."""
    with _WINDOW_STATE_LOCK:
        owner = _WINDOW["owner"]
    if owner is not None:
        owner.stop_requested.set()
        owner.join(timeout=300.0)
    with _WINDOW_STATE_LOCK:
        return {"active": False, "last": _WINDOW["last"]}


def profile_window_start_request(body: dict) -> Dict[str, Any]:
    """The engine-side ``POST /profile/start`` contract shared by the
    aiohttp and fast HTTP lanes: body ``{"duration_s", "window",
    "logdir"}`` (all optional) opens a bounded window in THIS process
    and returns its manifest entry.  Raises :class:`ProfileBusyError`
    on overlap — the route answers 409."""
    import tempfile

    window = str(body.get("window", "") or "") or new_span_id()
    base = os.environ.get("SELDON_TPU_PROFILE_DIR", "") or \
        os.path.join(tempfile.gettempdir(), "seldon-tpu-profiles")
    logdir = str(body.get("logdir", "") or "")
    # a caller-supplied logdir must stay INSIDE the configured profile
    # dir — the route is reachable by any client that can reach the
    # engine, and an arbitrary path would let it create directories and
    # write profiler artifacts anywhere the engine user can.  Anything
    # escaping the base falls back to the derived default.
    if logdir:
        base_real = os.path.realpath(base)
        if not os.path.realpath(
                os.path.join(base, logdir)).startswith(
                base_real + os.sep):
            logdir = ""
        else:
            logdir = os.path.join(base, logdir)
    if not logdir:
        logdir = os.path.join(base, window, f"engine-{os.getpid()}")
    try:
        duration_s = float(body.get("duration_s", 0.0) or 0.0)
    except (TypeError, ValueError):
        duration_s = 0.0
    return profile_window_start(logdir, duration_s, window=window)


def profile_window_status() -> Dict[str, Any]:
    """The process-local window state for ``GET /profile``."""
    with _WINDOW_STATE_LOCK:
        return {
            "active": _WINDOW["active"],
            "window": _WINDOW["window"] if _WINDOW["active"] else None,
            "artifact": _WINDOW["logdir"] if _WINDOW["active"] else None,
            "started_s": (
                _WINDOW["started_s"] if _WINDOW["active"] else None
            ),
            "duration_s": (
                _WINDOW["duration_s"] if _WINDOW["active"] else None
            ),
            "last": _WINDOW["last"],
        }
