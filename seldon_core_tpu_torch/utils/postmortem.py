"""Tail-sampled postmortem recorder — keep the worst requests, explain
them automatically; the port's counterpart of
``seldon_core_tpu/utils/postmortem.py``.

The tracer head-samples once at the trace root (``SELDON_TPU_TRACE_SAMPLE``),
so at production rates the requests an operator needs (p99 outliers,
errors, sheds, preemptions) are dropped before anyone knows they were
interesting.  This module moves the keep/drop decision to request
COMPLETION:

  * Every request's spans land in a bounded *pending buffer* whatever the
    head verdict: sampled spans through ``Tracer._fold``, head-sampled-OUT
    ones flagged ``pm_only`` (``utils/tracing.py`` routes them around the
    ring, the indexes and the span metrics).  The capture flag rides bit
    0x02 of the traceparent flags, so child processes feed their own
    pending buffers too.
  * At completion (the ``kind="request"`` span closing) a retention policy
    keeps the FULL trace iff the request was anomalous: a typed error or
    5xx, a shed, latency over the tier's SLO budget
    (``SELDON_TPU_POSTMORTEM_SLO_MS``, else ``SELDON_TPU_SLO_P99_MS``, times
    the tier factor), a leg over ``SELDON_TPU_POSTMORTEM_EXCESS_X`` times the
    autopilot's prediction (the ``autopilot_predicted_ms`` that the spine
    stamps on a dispatch span once the key has a prediction), a
    generation-scheduler preemption (the ``preempt`` event
    of a ``gen_seq`` span), a breaker-open short-circuit (the client's
    ``breaker_open`` event), an out-of-band note (:meth:`note`), or a small
    reservoir-sampled healthy baseline.
  * Kept exemplars are copied out at keep time (``to_json_dict``): a kept
    document never degrades when the trace ring evicts.
  * The explainer names the guilty phase (the per-phase critical-path
    decomposition diffed against the rolling per-key p50), and carries the
    scheduler's per-sequence ledger (the ``gen_seq`` spans) and the
    request's ``/costs`` row (by the ``tenant`` attribute of its spans).

Knobs: ``SELDON_TPU_POSTMORTEM`` (on; ``0`` leaves ``TRACER.pm_hook``
unset, ``utils/hotrecord.py`` wires it, and head sampling behaves bit for
bit as without this module), ``SELDON_TPU_POSTMORTEM_{EXCESS_X,SLO_MS,
TTL_S,PENDING,SPANS,KEEP,BASELINE}``.  Everything is bounded: pending traces
and spans, kept exemplars, baseline slots, synthetic notes and the per-key
baseline table, with drops counted.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.utils.tracing import (
    TRACER,
    Span,
    assembly_fields,
)

__all__ = ["PostmortemRecorder", "POSTMORTEM", "postmortem_enabled"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def postmortem_enabled() -> bool:
    """Capture is ON by default (it is inert unless tracing itself is
    enabled — no spans exist otherwise); ``SELDON_TPU_POSTMORTEM=0``
    restores head-sampling behavior bit-for-bit."""
    return os.environ.get("SELDON_TPU_POSTMORTEM", "1") not in ("", "0")


#: request tier -> multiple of the base SLO budget (interactive requests
#: are judged at 1x; batch and offline tolerate proportionally more wall
#: before a postmortem calls them anomalous).  There are no per-tier SLO
#: objectives: these factors ARE the tier budgets.
_TIER_SLO_X = {"interactive": 1.0, "batch": 4.0, "offline": 16.0}

#: out-of-band note reasons the retention policy accepts (anything else
#: still keeps, labelled "note" — a typo must not silently drop signal)
_NOTE_REASONS = frozenset({"failover", "rehome", "lease", "breaker"})

#: span kinds that complete their trace.  "request" is the per-request
#: root every lane opens; "plane" is the native data plane's per-batch
#: root in the reference (that plane is ROADMAP Queue 1 item [4d] here, so
#: no such span exists yet)
_ROOT_KINDS = frozenset({"request", "plane"})


class _PhaseP50:
    """Tiny sliding-window median per phase — the 'expected' side of the
    explainer's phase diff.  A plain bounded deque per phase; median by
    sort at read time (windows are <= 128 samples, read off-path)."""

    __slots__ = ("window", "_by_phase")

    def __init__(self, window: int = 128):
        self.window = int(window)
        self._by_phase: Dict[str, deque] = {}

    def observe(self, phases: Dict[str, float]) -> None:
        for ph, ms in phases.items():
            if ph == "total_ms":
                continue
            dq = self._by_phase.get(ph)
            if dq is None:
                dq = self._by_phase[ph] = deque(maxlen=self.window)
            dq.append(float(ms))

    def p50(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for ph, dq in self._by_phase.items():
            if dq:
                vals = sorted(dq)
                out[ph] = round(vals[len(vals) // 2], 3)
        return out


class _Pending:
    """One trace's pending capture: spans seen so far, out-of-band notes,
    and the last-touch timestamp the TTL sweep judges."""

    __slots__ = ("spans", "notes", "ts", "truncated")

    def __init__(self):
        self.spans: List[Span] = []
        self.notes: List[Dict[str, Any]] = []
        self.ts = time.time()
        self.truncated = 0


class PostmortemRecorder:
    """Deferred (tail-based) retention over the span/hotrecord machinery.

    ``offer(span)`` is the single capture entry point — wired as
    ``TRACER.pm_hook`` so every folded span (sampled or pm_only) passes
    through; it appends to the bounded pending buffer and, when the
    span is a request root, runs the retention policy.  ``note()`` is
    the out-of-band signal path for anomalies that fire with no span
    open (stream re-home, lease transitions, breaker trips observed by
    the balancer).  Thread-safe: offers arrive from the spine drainer
    and inline folds; notes from the event loop."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        excess_x: Optional[float] = None,
        slo_ms: Optional[float] = None,
        ttl_s: Optional[float] = None,
        pending_traces: Optional[int] = None,
        pending_spans: Optional[int] = None,
        keep: Optional[int] = None,
        baseline: Optional[int] = None,
    ):
        self.enabled = postmortem_enabled() if enabled is None else bool(enabled)
        self.excess_x = (
            _env_float("SELDON_TPU_POSTMORTEM_EXCESS_X", 3.0)
            if excess_x is None else float(excess_x))
        base_slo = (
            _env_float("SELDON_TPU_POSTMORTEM_SLO_MS",
                       _env_float("SELDON_TPU_SLO_P99_MS", 0.0))
            if slo_ms is None else float(slo_ms))
        self.slo_ms = max(base_slo, 0.0)  # 0 = the SLO trigger is inert
        self.ttl_s = (_env_float("SELDON_TPU_POSTMORTEM_TTL_S", 30.0)
                      if ttl_s is None else float(ttl_s))
        self.pending_traces = (
            _env_int("SELDON_TPU_POSTMORTEM_PENDING", 256)
            if pending_traces is None else int(pending_traces))
        self.pending_spans = (
            _env_int("SELDON_TPU_POSTMORTEM_SPANS", 128)
            if pending_spans is None else int(pending_spans))
        self.keep_cap = (_env_int("SELDON_TPU_POSTMORTEM_KEEP", 64)
                         if keep is None else int(keep))
        self.baseline_k = (_env_int("SELDON_TPU_POSTMORTEM_BASELINE", 8)
                           if baseline is None else int(baseline))
        self._lock = threading.Lock()
        self._pending: "OrderedDict[str, _Pending]" = OrderedDict()
        #: anomalous exemplars by trace_id (a later, outer root completion
        #: re-keeps and REPLACES — the widest view of the trace wins)
        self._kept: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        #: Algorithm-R reservoir of healthy exemplars (size baseline_k)
        self._baseline: List[Dict[str, Any]] = []
        self._healthy_n = 0
        #: traceless notes become bounded synthetic exemplars — a lease
        #: flap must not evict real request postmortems
        self._synthetic: deque = deque(maxlen=8)
        #: rolling per-key phase medians — "expected" for the phase diff
        self._phase_p50: "OrderedDict[str, _PhaseP50]" = OrderedDict()
        self._phase_keys_cap = 64
        self._rng = random  # tests may inject random.Random(seed)
        # counters
        self.kept_total: Dict[str, int] = {}
        self.dropped_total = 0
        self.completed_total = 0
        self.noted_total = 0
        self.offer_total = 0
        self.truncated_spans = 0
        #: sampled capture cost (1 in 32 offers measured): the document's
        #: capture_overhead_ms
        self._offer_ms: deque = deque(maxlen=256)

    # -- capture ---------------------------------------------------------

    def offer(self, span: Span) -> None:
        """One folded span into the pending buffer — O(1) append under a
        short lock, off the request hot path (spine drainer / fold).
        Never raises (the fold guards it too)."""
        if not self.enabled:
            return
        tid = span.trace_id
        if not tid:
            return  # no trace linkage (flush internals) — nothing to keep
        probe = (self.offer_total & 31) == 0
        t0 = time.perf_counter() if probe else 0.0
        with self._lock:
            self.offer_total += 1
            pend = self._pending.get(tid)
            if pend is None:
                while len(self._pending) >= max(self.pending_traces, 1):
                    self._pending.popitem(last=False)
                    self.dropped_total += 1
                    self._record_dropped()
                pend = _Pending()
                self._pending[tid] = pend
            if len(pend.spans) < self.pending_spans:
                pend.spans.append(span)
            else:
                pend.truncated += 1
                self.truncated_spans += 1
            pend.ts = time.time()
        if span.kind in _ROOT_KINDS:
            self._complete(tid, span)
        if probe:
            self._offer_ms.append((time.perf_counter() - t0) * 1e3)
            self._sweep()

    def note(self, trace_id: str, reason: str, **attrs: Any) -> None:
        """Out-of-band anomaly signal for paths with no open span: stream
        re-home / hedged-unary failover, coordinator lease transitions,
        breaker trips seen from the balancer.  With a trace_id the note
        joins that trace's pending record (and re-triggers retention if
        the root already completed — pending buffers are TTL-evicted,
        not cleared on a drop verdict, exactly so late signals can still
        rescue a trace).  With no trace_id the note becomes a bounded
        synthetic exemplar so the signal still surfaces in
        ``GET /postmortems``."""
        if not self.enabled:
            return
        entry: Dict[str, Any] = {
            "reason": str(reason), "ts": round(time.time(), 6)}
        if attrs:
            entry["attrs"] = attrs
        root: Optional[Span] = None
        with self._lock:
            self.noted_total += 1
            if not trace_id:
                doc = {
                    "puid": str(attrs.get("puid", "") or ""),
                    "trace_id": "",
                    "kept_at_s": entry["ts"],
                    "reason": entry["reason"],
                    "reasons": [entry["reason"]],
                    "synthetic": True,
                    "note": entry,
                    "spans": [],
                    "pinned_spans": 0,
                }
                self._synthetic.append(doc)
                self.kept_total[entry["reason"]] = (
                    self.kept_total.get(entry["reason"], 0) + 1)
            else:
                pend = self._pending.get(trace_id)
                if pend is None:
                    while len(self._pending) >= max(self.pending_traces, 1):
                        self._pending.popitem(last=False)
                        self.dropped_total += 1
                        self._record_dropped()
                    pend = _Pending()
                    self._pending[trace_id] = pend
                if len(pend.notes) < 16:
                    pend.notes.append(entry)
                pend.ts = time.time()
                for s in pend.spans:
                    if s.kind in _ROOT_KINDS:
                        root = s
                        break
        if not trace_id:
            self._record_kept(entry["reason"])
        elif root is not None:
            # the root already completed and may have been judged healthy
            # before this signal arrived — re-run retention (no recount)
            self._complete(trace_id, root, recount=False)

    # -- retention policy ------------------------------------------------

    def _complete(self, trace_id: str, root: Span,
                  recount: bool = True) -> None:
        with self._lock:
            pend = self._pending.get(trace_id)
            spans = list(pend.spans) if pend is not None else [root]
            notes = list(pend.notes) if pend is not None else []
            truncated = pend.truncated if pend is not None else 0
            if recount:
                self.completed_total += 1
            key = "%s:%s" % (root.name, root.method)
            table = self._phase_p50.get(key)
            baseline_p50 = table.p50() if table is not None else {}
        reasons = self._evaluate(root, spans, notes)
        asm = assembly_fields(spans)
        phases = asm.get("phases") or {}
        if reasons:
            doc = self._explain(root, spans, reasons, notes, asm,
                                baseline_p50, truncated)
            with self._lock:
                self._kept[trace_id] = doc
                while len(self._kept) > max(self.keep_cap, 1):
                    self._kept.popitem(last=False)
                self.kept_total[reasons[0]] = (
                    self.kept_total.get(reasons[0], 0) + 1)
            self._record_kept(reasons[0])
        elif recount and self.baseline_k > 0:
            # Algorithm R over healthy completions: exemplar i survives
            # into one of k slots with probability k/i — a small always-
            # fresh healthy baseline to diff anomalies against
            with self._lock:
                self._healthy_n += 1
                n = self._healthy_n
            if len(self._baseline) < self.baseline_k:
                slot: Optional[int] = len(self._baseline)
            else:
                j = self._rng.randrange(n)
                slot = j if j < self.baseline_k else None
            if slot is not None:
                doc = self._explain(root, spans, ["baseline"], notes, asm,
                                    baseline_p50, truncated)
                with self._lock:
                    if slot >= len(self._baseline):
                        self._baseline.append(doc)
                    else:
                        self._baseline[slot] = doc
                self._record_kept("baseline")
        if recount and phases:
            # the rolling "expected" fold happens AFTER judgement so an
            # exemplar's excess is measured against its predecessors, not
            # softened by its own contribution
            with self._lock:
                table = self._phase_p50.get(key)
                if table is None:
                    table = self._phase_p50[key] = _PhaseP50()
                else:
                    self._phase_p50.move_to_end(key)
                while len(self._phase_p50) > self._phase_keys_cap:
                    self._phase_p50.popitem(last=False)
                table.observe(phases)

    def _slo_budget_ms(self, tier: Any) -> float:
        if self.slo_ms <= 0:
            return 0.0
        return self.slo_ms * _TIER_SLO_X.get(str(tier or "interactive"), 1.0)

    def _evaluate(self, root: Span, spans: List[Span],
                  notes: List[Dict[str, Any]]) -> List[str]:
        """The retention verdict: ordered anomaly reasons, [] = drop."""
        reasons: List[str] = []
        attrs = root.attrs or {}
        status: Optional[int] = None
        try:
            raw = attrs.get("status")
            status = int(raw) if raw is not None else None
        except (TypeError, ValueError):
            status = None
        if attrs.get("shed"):
            reasons.append("shed")
        elif attrs.get("error") or (status is not None and status >= 500):
            reasons.append("error")
        budget = self._slo_budget_ms(attrs.get("tier"))
        if budget and root.duration_ms > budget:
            reasons.append("slo")
        # autopilot_excess: a leg (the dispatch span the spine stamped with
        # the prediction in force) over EXCESS_X times its prediction
        for s in spans:
            pred = (s.attrs or {}).get("autopilot_predicted_ms")
            try:
                pred_f = float(pred) if pred is not None else 0.0
            except (TypeError, ValueError):
                pred_f = 0.0
            if pred_f > 0 and s.duration_ms > self.excess_x * pred_f:
                reasons.append("autopilot_excess")
                break
        names = set()
        for s in spans:
            for ev in s.events or ():
                names.add(ev.get("name"))
        if "preempt" in names:
            reasons.append("preemption")
        if "breaker_open" in names and "breaker" not in reasons:
            reasons.append("breaker")
        for n in notes:
            r = str(n.get("reason") or "")
            r = r if r in _NOTE_REASONS else (r or "note")
            if r not in reasons:
                reasons.append(r)
        return reasons

    # -- the explainer ---------------------------------------------------

    def _explain(self, root: Span, spans: List[Span], reasons: List[str],
                 notes: List[Dict[str, Any]], asm: Dict[str, Any],
                 baseline_p50: Dict[str, float],
                 truncated: int) -> Dict[str, Any]:
        """Build the immutable postmortem document: copied-out spans, the
        assembled tree/critical path, and the guilty-phase diff against
        the rolling per-key p50."""
        phases = dict(asm.get("phases") or {})
        excess: Dict[str, float] = {}
        for ph, ms in phases.items():
            if ph == "total_ms":
                continue
            excess[ph] = round(float(ms) - baseline_p50.get(ph, 0.0), 3)
        guilty: Optional[str] = None
        if excess:
            worst = max(excess, key=lambda p: excess[p])
            if excess[worst] > 0:
                guilty = worst
            else:
                # nothing exceeds expectation (errors/sheds fail fast) —
                # name the biggest phase so the document still points
                guilty = max(phases, key=lambda p: (
                    phases[p] if p != "total_ms" else -1.0))
        autopilot: List[Dict[str, Any]] = []
        for s in spans:
            pred = (s.attrs or {}).get("autopilot_predicted_ms")
            try:
                pred_f = float(pred) if pred is not None else 0.0
            except (TypeError, ValueError):
                pred_f = 0.0
            if pred_f > 0:
                autopilot.append({
                    "name": s.name,
                    "kind": s.kind,
                    "predicted_ms": round(pred_f, 3),
                    "actual_ms": round(s.duration_ms, 3),
                    "ratio": round(s.duration_ms / pred_f, 2),
                })
        p2c: Optional[Dict[str, Any]] = None
        for s in spans:
            a = s.attrs or {}
            if "p2c_candidates" in a or "replica" in a:
                p2c = {k: a[k] for k in
                       ("replica", "p2c_candidates", "p2c_scores")
                       if k in a}
                break
        gen_ledger = [
            {
                "name": s.name,
                "method": s.method,
                "duration_ms": round(s.duration_ms, 3),
                "events": list(s.events or ()),
            }
            for s in spans if s.kind == "gen_seq"
        ]
        cost_row = None
        tenant = next(
            (str((s.attrs or {}).get("tenant"))
             for s in spans if (s.attrs or {}).get("tenant")), "")
        if tenant:
            try:
                from seldon_core_tpu_torch.utils.costledger import LEDGER

                for row in LEDGER.document().get("tenants") or ():
                    if row.get("tenant") == tenant:
                        cost_row = row
                        break
            except Exception:  # noqa: BLE001 - attribution is best-effort
                cost_row = None
        doc: Dict[str, Any] = {
            "puid": root.puid,
            "trace_id": root.trace_id,
            "kept_at_s": round(time.time(), 6),
            "reason": reasons[0],
            "reasons": list(reasons),
            "root": {
                "name": root.name,
                "kind": root.kind,
                "method": root.method,
                "duration_ms": round(root.duration_ms, 3),
                "start_s": round(root.start_s, 6),
                "attrs": dict(root.attrs or {}),
            },
            # copy-out AT KEEP TIME: ring eviction can never degrade a
            # kept exemplar into a partial tree after the fact
            "spans": [s.to_json_dict() for s in spans],
            "pinned_spans": len(spans),
            "truncated_spans": truncated,
            "tree": asm.get("tree"),
            "critical_path": asm.get("critical_path"),
            "phases": phases,
            "partial": asm.get("partial", False),
            "missing": asm.get("missing", []),
            "explain": {
                "guilty_phase": guilty,
                "excess_ms": excess.get(guilty, 0.0) if guilty else 0.0,
                "phase_excess_ms": excess,
                "baseline_p50_ms": baseline_p50,
                "autopilot": autopilot,
                "p2c": p2c,
                "gen_ledger": gen_ledger,
                "cost_row": cost_row,
                "notes": list(notes),
            },
        }
        return doc

    # -- housekeeping ----------------------------------------------------

    def _sweep(self) -> None:
        """TTL-evict idle pending traces (requests that never completed:
        crashed workers, abandoned streams) — counted as drops."""
        deadline = time.time() - self.ttl_s
        with self._lock:
            stale = [tid for tid, p in self._pending.items()
                     if p.ts < deadline]
            for tid in stale:
                del self._pending[tid]
                self.dropped_total += 1
        for _ in stale:
            self._record_dropped()

    def _record_kept(self, reason: str) -> None:
        try:
            from seldon_core_tpu_torch.utils.telemetry import RECORDER

            RECORDER.record_postmortem_kept(reason)
        except Exception:  # noqa: BLE001 - metrics must not fail capture
            pass

    def _record_dropped(self) -> None:
        try:
            from seldon_core_tpu_torch.utils.telemetry import RECORDER

            RECORDER.record_postmortem_dropped()
        except Exception:  # noqa: BLE001
            pass

    def publish_gauges(self) -> None:
        """Pinned-span accounting, refreshed from the spine's throttled
        gauge pass (utils/hotrecord.py), never per-keep."""
        if not self.enabled:
            return
        with self._lock:
            pinned = sum(d.get("pinned_spans", 0)
                         for d in self._kept.values())
            pinned += sum(d.get("pinned_spans", 0) for d in self._baseline)
        try:
            from seldon_core_tpu_torch.utils.telemetry import RECORDER

            RECORDER.set_postmortem_pinned(pinned)
        except Exception:  # noqa: BLE001
            pass

    # -- query surfaces --------------------------------------------------

    @staticmethod
    def _summary(doc: Dict[str, Any]) -> Dict[str, Any]:
        explain = doc.get("explain") or {}
        root = doc.get("root") or {}
        return {
            "puid": doc.get("puid", ""),
            "trace_id": doc.get("trace_id", ""),
            "reason": doc.get("reason", ""),
            "reasons": list(doc.get("reasons") or ()),
            "duration_ms": root.get("duration_ms"),
            "guilty_phase": explain.get("guilty_phase"),
            "excess_ms": explain.get("excess_ms"),
            "kept_at_s": doc.get("kept_at_s"),
            "pinned_spans": doc.get("pinned_spans", 0),
            "synthetic": bool(doc.get("synthetic")),
        }

    def _find(self, puid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for store in (list(self._kept.values()), list(self._baseline),
                          list(self._synthetic)):
                for doc in store:
                    if doc.get("puid") == puid or doc.get("trace_id") == puid:
                        return doc
        return None

    def document(self, puid: str = "") -> Dict[str, Any]:
        """The ``GET /postmortems`` body.  Without ``puid``: config,
        counters, and worst-first exemplar summaries.  With ``puid`` (or
        a trace_id): the full immutable postmortem document."""
        if TRACER.drain_hook is not None:
            try:
                TRACER.drain_hook()  # fold pending spine records first
            except Exception:  # noqa: BLE001
                pass
        if puid:
            doc = self._find(puid)
            return {"found": doc is not None, "puid": puid,
                    "postmortem": doc}
        with self._lock:
            kept = [self._summary(d) for d in self._kept.values()]
            baseline = [self._summary(d) for d in self._baseline]
            synthetic = [self._summary(d) for d in self._synthetic]
            counters = {
                "completed": self.completed_total,
                "kept": dict(self.kept_total),
                "dropped": self.dropped_total,
                "noted": self.noted_total,
                "offers": self.offer_total,
                "truncated_spans": self.truncated_spans,
            }
            pending = {
                "traces": len(self._pending),
                "spans": sum(len(p.spans) for p in self._pending.values()),
            }
        kept.sort(key=lambda s: (-(s.get("excess_ms") or 0.0),
                                 -(s.get("kept_at_s") or 0.0)))
        return {
            "enabled": self.enabled,
            "config": {
                "excess_x": self.excess_x,
                "slo_ms": self.slo_ms,
                "ttl_s": self.ttl_s,
                "pending_traces": self.pending_traces,
                "pending_spans": self.pending_spans,
                "keep": self.keep_cap,
                "baseline": self.baseline_k,
            },
            "counters": counters,
            "pending": pending,
            "capture_overhead_ms": self._offer_p50(),
            "kept": kept,
            "baseline": baseline,
            "synthetic": synthetic,
        }

    def _offer_p50(self) -> Optional[float]:
        vals = sorted(self._offer_ms)
        if not vals:
            return None
        return round(vals[len(vals) // 2], 4)

    def exemplar_puids(self, deployment: str = "",
                       limit: int = 4) -> List[str]:
        """Recent anomalous exemplar puids — the evidence a rollout
        rollback cites.  Prefers exemplars whose root carries the named
        deployment; falls back to the most recent anomalies when none
        match (an engine-rooted exemplar may not carry the attr)."""
        with self._lock:
            docs = list(self._kept.values())
        docs.reverse()  # most recent first
        if deployment:
            matched = [d for d in docs
                       if (d.get("root") or {}).get("attrs", {})
                       .get("deployment") == deployment]
            if matched:
                docs = matched
        out: List[str] = []
        for d in docs:
            p = d.get("puid") or d.get("trace_id") or ""
            if p and p not in out:
                out.append(p)
            if len(out) >= limit:
                break
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Compact health view."""
        with self._lock:
            kept = sum(self.kept_total.values())
        return {
            "enabled": self.enabled,
            "completed_total": self.completed_total,
            "kept_total": kept,
            "dropped_total": self.dropped_total,
            "offer_p50_ms": self._offer_p50(),
        }

    def reset(self) -> None:
        with self._lock:
            self._pending.clear()
            self._kept.clear()
            self._baseline = []
            self._healthy_n = 0
            self._synthetic.clear()
            self._phase_p50.clear()
            self.kept_total = {}
            self.dropped_total = 0
            self.completed_total = 0
            self.noted_total = 0
            self.offer_total = 0
            self.truncated_spans = 0
            self._offer_ms.clear()


POSTMORTEM = PostmortemRecorder()
