"""Canary rollouts with automatic rollback — the controller that makes
the observability stack load-bearing; the port's copy of
``seldon_core_tpu/operator/rollouts.py``, reading the port's gateway,
recorder, tracer, postmortems and quality observatory.

The reference platform ships the canary *pattern* (two predictors behind a
replica-weighted split, ``examples/canary_deployment.json``) but leaves
promotion and rollback to a human watching dashboards.  This module closes
the loop: a :class:`RolloutController` walks a candidate predictor through
staged traffic shifts (default 1 → 5 → 25 → 100 %) by reassigning the
gateway's weighted predictor split (``DeploymentStore.set_weights`` — the
same lever the reference's replica weighting is), and gates every stage on
the live signals the platform already measures:

  * **drift** — the candidate's PSI/KS drift score (``GET /quality``,
    utils/quality.py),
  * **SLO burn rate** — the 5-minute fast-burn window (``GET /quality``),
  * **error rate** — the candidate's share of FAILURE answers at the
    gateway (per-predictor traffic accounting, ``GET /stats``),
  * **shadow/replay disagreement** — live-vs-candidate divergence from
    the shadow mirror (``GET /shadow``) or a pre-rollout firehose replay
    verdict (runtime/replay.py) supplied as the plan's prior.

Any breach **snaps the split back to the baseline in one step**, stamps a
rollback event into the audit firehose and
``seldon_tpu_rollbacks_total{reason}``, and **quarantines** the deployment:
the same spec (identified by its config hash) is never promoted again —
only a changed spec clears the quarantine.  Every stage decision rides a
tracer span (kind ``rollout``) so the promotion history is auditable next
to the request trees it governed.

``SELDON_TPU_ROLLOUTS=0`` freezes the controller (no weight changes — a
kill switch that restores today's manual behavior).

Signal sources are pluggable: :class:`GatewaySignals` reads the in-process
gateway + the process-global quality observatory (the common co-located
topology); :class:`HttpSignals` scrapes the same surfaces over HTTP for a
split-process control plane.  ``operator/reconciler.py`` drives the
controller from CR annotations (``seldon.io/canary`` et al.) and writes
the rollout state back onto the CR status.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from seldon_core_tpu_torch.utils.telemetry import RECORDER

__all__ = [
    "RolloutGates",
    "RolloutPlan",
    "RolloutController",
    "GatewaySignals",
    "HttpSignals",
    "rollouts_enabled",
    "plan_from_annotations",
    "CANARY_ANNOTATION",
]

CANARY_ANNOTATION = "seldon.io/canary"

DEFAULT_STAGES = (1, 5, 25, 100)


def rollouts_enabled() -> bool:
    """``SELDON_TPU_ROLLOUTS=0`` freezes every controller — no weight
    changes, no promotions, no rollbacks (checked per tick)."""
    return os.environ.get("SELDON_TPU_ROLLOUTS", "1").strip() != "0"


@dataclass
class RolloutGates:
    """Per-stage promotion gates.  ``None`` disables a gate; a stage is
    judged only after ``min_requests`` candidate requests AND
    ``hold_s`` seconds at its weight — deciding on no evidence is how
    a 1% stage with zero traffic gets promoted to 100%."""

    max_drift: Optional[float] = 0.25          # PSI — 0.25 is "major shift"
    max_burn_rate: Optional[float] = 14.4      # classic 5m fast-burn page
    max_error_rate: Optional[float] = 0.05
    max_shadow_disagreement: Optional[float] = 0.1
    min_requests: int = 20

    def to_json_dict(self) -> dict:
        return {
            "max_drift": self.max_drift,
            "max_burn_rate": self.max_burn_rate,
            "max_error_rate": self.max_error_rate,
            "max_shadow_disagreement": self.max_shadow_disagreement,
            "min_requests": self.min_requests,
        }


@dataclass
class RolloutPlan:
    """Desired rollout for one deployment: shift ``candidate`` from 0 to
    100 % of the live split through ``stages``, holding each stage
    ``hold_s`` seconds, gated by ``gates``.  ``config_hash`` is the
    quarantine identity — a rolled-back hash is never retried."""

    deployment: str
    candidate: str
    baseline: str
    stages: Tuple[int, ...] = DEFAULT_STAGES
    hold_s: float = 30.0
    gates: RolloutGates = field(default_factory=RolloutGates)
    config_hash: str = ""

    def __post_init__(self):
        stages = tuple(int(s) for s in self.stages)
        if not stages or any(
            not 0 < s <= 100 for s in stages
        ) or list(stages) != sorted(set(stages)):
            raise ValueError(
                f"stages must be strictly increasing percents in (0, 100], "
                f"got {self.stages!r}"
            )
        if stages[-1] != 100:
            stages = stages + (100,)  # a rollout that never finishes isn't one
        self.stages = stages
        if self.candidate == self.baseline:
            raise ValueError("candidate and baseline must differ")


class _Rollout:
    """State machine for one deployment's active rollout."""

    def __init__(self, plan: RolloutPlan, now: float):
        self.plan = plan
        self.state = "pending"           # pending|running|promoted|rolled_back
        self.stage_idx = -1              # -1 = not yet shifted
        self.stage_entered_at = now
        self.stage_requests_at_entry = 0
        self.stage_errors_at_entry = 0
        self.rollback_reason: Optional[str] = None
        self.history: List[dict] = []

    @property
    def current_percent(self) -> int:
        if self.state == "promoted":
            return 100
        if self.state == "rolled_back" or self.stage_idx < 0:
            return 0
        return self.plan.stages[self.stage_idx]

    def note(self, decision: str, now_wall: float, **fields) -> dict:
        event = {"ts": now_wall, "decision": decision,
                 "stage_percent": self.current_percent, **fields}
        self.history.append(event)
        if len(self.history) > 64:
            del self.history[:-64]
        return event

    def snapshot(self) -> dict:
        return {
            "deployment": self.plan.deployment,
            "candidate": self.plan.candidate,
            "baseline": self.plan.baseline,
            "state": self.state,
            "stage_percent": self.current_percent,
            "stages": list(self.plan.stages),
            "config_hash": self.plan.config_hash,
            "rollback_reason": self.rollback_reason,
        }

    def document(self) -> dict:
        return {
            **self.snapshot(),
            "hold_s": self.plan.hold_s,
            "gates": self.plan.gates.to_json_dict(),
            "history": list(self.history),
        }


class RolloutController:
    """Drives every active rollout against one deployment store.

    ``signals`` is a callable ``(plan) -> dict`` returning whatever
    subset of ``{"requests", "errors", "drift", "burn_rate",
    "shadow_disagreement"}`` the topology can measure — missing keys
    simply disable the matching gate for that tick (the gates that CAN
    be evaluated still roll back).  ``firehose`` (optional) receives
    stage/rollback events next to the request stream
    (gateway/firehose.py ``publish_event``)."""

    def __init__(self, store, signals: Callable[[RolloutPlan], dict],
                 firehose=None, clock: Callable[[], float] = time.monotonic,
                 federation=None):
        self.store = store
        self.signals = signals
        self.firehose = firehose
        self.clock = clock
        #: optional GatewayFederation (gateway/federation.py).  A rollout
        #: controller is a SINGLETON duty — with N gateway replicas over
        #: one store, only the coordinator's controller may tick, and its
        #: traffic-split writes go through the fenced path so a paused
        #: ex-coordinator that wakes up mid-write is rejected by the
        #: store itself (fencing token), not by luck
        self.federation = federation
        self._rollouts: Dict[str, _Rollout] = {}
        #: deployment -> EVERY config_hash that rolled back (bounded to
        #: the most recent 64) — the quarantine survives the _Rollout
        #: object being superseded, and a flip-flopping operator can't
        #: re-run a known-bad revision by shipping something else in
        #: between (only CR deletion clears the history)
        self._quarantined: Dict[str, List[str]] = {}

    # -- plan intake -----------------------------------------------------

    def apply(self, plan: RolloutPlan) -> _Rollout:
        """Idempotent desired-state intake (the reconciler calls this
        every tick).  Same config_hash -> the existing rollout (or the
        standing quarantine); a NEW hash supersedes both — the operator
        shipped a changed spec, which is the one sanctioned quarantine
        exit."""
        ro = self._rollouts.get(plan.deployment)
        if ro is not None and ro.plan.config_hash == plan.config_hash:
            return ro
        if plan.config_hash in self._quarantined.get(plan.deployment, ()):
            # rebuild the quarantined terminal state for status surfaces
            if ro is None or ro.plan.config_hash != plan.config_hash:
                ro = _Rollout(plan, self.clock())
                ro.state = "rolled_back"
                ro.rollback_reason = "quarantined"
                self._rollouts[plan.deployment] = ro
            return ro
        ro = _Rollout(plan, self.clock())
        self._rollouts[plan.deployment] = ro
        RECORDER.set_rollout_stage(plan.deployment, 0)
        return ro

    def forget(self, deployment: str) -> None:
        """Deployment deleted: drop its rollout AND its quarantine."""
        self._rollouts.pop(deployment, None)
        self._quarantined.pop(deployment, None)

    # -- the control loop ------------------------------------------------

    def tick(self) -> List[dict]:
        """One pass over every active rollout; returns the decisions
        taken (promote / hold / rollback), one dict per deployment."""
        if not rollouts_enabled():
            return []
        if self.federation is not None and not self.federation.is_coordinator:
            return []  # singleton duty: only the coordinator replica ticks
        decisions = []
        for ro in list(self._rollouts.values()):
            if ro.state in ("promoted", "rolled_back"):
                continue
            decisions.append(self._tick_one(ro))
        return decisions

    def tick_deployment(self, deployment: str) -> Optional[dict]:
        """Tick just one deployment (the reconciler's per-CR path)."""
        if not rollouts_enabled():
            return None
        if self.federation is not None and not self.federation.is_coordinator:
            return None
        ro = self._rollouts.get(deployment)
        if ro is None or ro.state in ("promoted", "rolled_back"):
            return None
        return self._tick_one(ro)

    def _tick_one(self, ro: _Rollout) -> dict:
        from seldon_core_tpu_torch.utils.tracing import TRACER

        plan = ro.plan
        now = self.clock()
        with TRACER.span(
            f"rollout-{plan.deployment}", "rollout", kind="rollout",
            deployment=plan.deployment, candidate=plan.candidate,
            stage_percent=str(ro.current_percent), state=ro.state,
        ) as span:
            try:
                decision = self._decide(ro, now)
            except Exception as e:  # noqa: BLE001 — narrow re-raise below
                from seldon_core_tpu_torch.gateway.state import StaleFenceError

                if not isinstance(e, StaleFenceError):
                    raise
                # this replica lost the coordinator lease mid-decision and
                # the store rejected the split write (stale fencing token).
                # Abandon the transition — the successor's controller owns
                # the rollout now, re-derived from the shared store
                RECORDER.record_lease_transition("fenced_write_rejected")
                decision = ro.note("fenced", time.time(), error=str(e))
            if span is not None:
                span["decision"] = decision["decision"]
                if decision.get("reason"):
                    span["reason"] = decision["reason"]
        return decision

    def _decide(self, ro: _Rollout, now: float) -> dict:
        plan = ro.plan
        if ro.state == "pending":
            resumed = self._maybe_resume(ro, now)
            if resumed is not None:
                return resumed
            # first shift: candidate enters at stage 0's percent
            return self._advance(ro, now)
        sig = self._signals_safe(plan)
        if "_scrape_error" not in sig and ro.stage_requests_at_entry is None:
            # the stage entered during a scrape outage: this is the first
            # good read — it becomes the entry baseline, and the stage
            # clock restarts so the candidate is judged on traffic it
            # actually served AT this weight
            ro.stage_requests_at_entry = int(sig.get("requests", 0) or 0)
            ro.stage_errors_at_entry = int(sig.get("errors", 0) or 0)
            ro.stage_entered_at = now
        breach = self._breach(ro, sig)
        if breach is not None:
            return self._rollback(ro, now, breach, sig)
        held_s = now - ro.stage_entered_at
        stage_requests = max(
            int(sig.get("requests", 0)) - (ro.stage_requests_at_entry or 0), 0
        )
        if held_s < plan.hold_s or stage_requests < plan.gates.min_requests:
            return ro.note(
                "hold", time.time(), held_s=round(held_s, 3),
                stage_requests=stage_requests,
            )
        if ro.stage_idx >= len(plan.stages) - 1:
            return self._promote(ro, now, sig)
        return self._advance(ro, now)

    def _maybe_resume(self, ro: _Rollout, now: float) -> Optional[dict]:
        """Continue a predecessor's rollout instead of restarting it.

        With N federated gateway replicas, the rollout's only durable
        state is the traffic split in the shared store — the _Rollout
        object dies with the coordinator that held it.  A fresh
        controller whose pending plan finds the candidate ALREADY at one
        of its stage percents (the dead coordinator got that far)
        fast-forwards to that stage and holds it, rather than snapping
        live traffic back to stage 0.

        Only armed under federation: a lone controller owns its rollout
        for the rollout's whole life, and a fresh canary whose candidate
        REGISTRATION weight happens to equal a stage percent must not
        read as a predecessor's progress."""
        if self.federation is None:
            return None
        plan = ro.plan
        try:
            current = self.store.weights(plan.deployment)
        except Exception:  # noqa: BLE001 — a store that can't answer (no
            # weights API, partitioned) degrades to the stage-0 start
            return None
        pct = current.get(plan.candidate)
        if pct is None or pct not in plan.stages:
            return None
        ro.state = "running"
        ro.stage_idx = plan.stages.index(pct)
        ro.stage_entered_at = now
        sig = self._signals_safe(plan)
        if "_scrape_error" in sig:
            ro.stage_requests_at_entry = None
            ro.stage_errors_at_entry = None
        else:
            ro.stage_requests_at_entry = int(sig.get("requests", 0) or 0)
            ro.stage_errors_at_entry = int(sig.get("errors", 0) or 0)
        RECORDER.set_rollout_stage(plan.deployment, pct)
        event = ro.note("resume", time.time(),
                        stage=ro.stage_idx, percent=pct)
        self._publish("rollout_resumed", plan, stage=ro.stage_idx,
                      percent=pct)
        return event

    # -- signal plumbing --------------------------------------------------

    def _signals_safe(self, plan: RolloutPlan) -> dict:
        try:
            return dict(self.signals(plan) or {})
        except Exception as e:  # noqa: BLE001 — a broken scrape must not
            # crash the loop, but it must not read as "all healthy"
            # either: fail the stage closed via a sentinel the breach
            # check treats as a scrape failure
            return {"_scrape_error": f"{type(e).__name__}: {e}"}

    def _breach(self, ro: _Rollout, sig: dict) -> Optional[Tuple[str, Any]]:
        """First breached gate as (reason, observed), else None."""
        gates = ro.plan.gates
        if "_scrape_error" in sig:
            # no signals at all while the candidate takes live traffic is
            # itself unsafe — roll back rather than fly blind
            return ("signals_unavailable", sig["_scrape_error"])
        checks = [
            ("drift", gates.max_drift, sig.get("drift")),
            ("burn_rate", gates.max_burn_rate, sig.get("burn_rate")),
            ("shadow", gates.max_shadow_disagreement,
             sig.get("shadow_disagreement")),
        ]
        for reason, limit, observed in checks:
            if limit is not None and observed is not None \
                    and float(observed) > float(limit):
                return (reason, round(float(observed), 6))
        if gates.max_error_rate is not None and \
                ro.stage_requests_at_entry is not None:
            # judged on THIS stage's delta (counts since stage entry) and
            # on a minimum sample — one failed request out of three must
            # not read as a 33% error rate.  Entry-None (stage entered
            # during a scrape outage, not yet backfilled) skips the gate
            # for the tick rather than judging against all-time counts
            requests = int(sig.get("requests", 0)) - ro.stage_requests_at_entry
            errors = int(sig.get("errors", 0)) - (ro.stage_errors_at_entry or 0)
            if requests >= max(gates.min_requests, 1):
                rate = max(errors, 0) / requests
                if rate > gates.max_error_rate:
                    return ("error_rate", round(rate, 6))
        return None

    # -- transitions -------------------------------------------------------

    def _write_split(self, deployment: str, weights: Dict[str, int]) -> None:
        """The controller's only store write, fenced when federated: a
        stale fencing token (this replica lost the coordinator lease to
        a successor while deciding) surfaces as StaleFenceError — the
        caller's transition is abandoned, the NEW coordinator's
        controller re-derives it from the shared store."""
        if self.federation is not None:
            self.federation.set_weights(deployment, weights)
        else:
            self.store.set_weights(deployment, weights)

    def _set_split(self, plan: RolloutPlan, candidate_percent: int) -> None:
        self._write_split(plan.deployment, {
            plan.candidate: candidate_percent,
            plan.baseline: 100 - candidate_percent,
        })
        RECORDER.set_rollout_stage(plan.deployment, candidate_percent)

    def _advance(self, ro: _Rollout, now: float) -> dict:
        plan = ro.plan
        if ro.state == "pending":
            ro.state = "running"
        ro.stage_idx += 1
        percent = plan.stages[ro.stage_idx]
        self._set_split(plan, percent)
        ro.stage_entered_at = now
        sig = self._signals_safe(plan)
        if "_scrape_error" in sig:
            # entry counters unknown: leave them None so the FIRST
            # successful read after the shift backfills them — zeroing
            # here would judge the stage against all-time cumulative
            # counts (min_requests trivially satisfied with zero actual
            # stage traffic, error deltas diluted by history)
            ro.stage_requests_at_entry = None
            ro.stage_errors_at_entry = None
        else:
            ro.stage_requests_at_entry = int(sig.get("requests", 0) or 0)
            ro.stage_errors_at_entry = int(sig.get("errors", 0) or 0)
        event = ro.note(
            "advance", time.time(),
            stage=ro.stage_idx, percent=percent,
        )
        self._publish("rollout_stage", plan, stage=ro.stage_idx,
                      percent=percent)
        return event

    def _promote(self, ro: _Rollout, now: float, sig: dict) -> dict:
        ro.state = "promoted"
        self._set_split(ro.plan, 100)
        event = ro.note("promote", time.time())
        self._publish("rollout_promoted", ro.plan)
        return event

    def _rollback(self, ro: _Rollout, now: float,
                  breach: Tuple[str, Any], sig: dict) -> dict:
        """The one-step snap-back: baseline takes 100% in a single
        set_weights call, the breach is stamped everywhere an operator
        looks (firehose, /stats counter mirror, Prometheus), and the
        config hash is quarantined until the spec changes."""
        plan = ro.plan
        reason, observed = breach
        ro.state = "rolled_back"
        ro.rollback_reason = reason
        self._write_split(plan.deployment, {
            plan.candidate: 0,
            plan.baseline: 100,
        })
        RECORDER.set_rollout_stage(plan.deployment, 0)
        RECORDER.record_rollback(reason)
        hashes = self._quarantined.setdefault(plan.deployment, [])
        if plan.config_hash not in hashes:
            hashes.append(plan.config_hash)
            del hashes[:-64]
        # cite the postmortem exemplars that witnessed the breach: the
        # operator lands on GET /postmortems?puid=<one of these> instead
        # of re-deriving which requests the gate actually saw
        evidence: list = []
        try:
            from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM
            evidence = POSTMORTEM.exemplar_puids(
                deployment=plan.deployment, limit=4)
        except Exception:  # noqa: BLE001 - evidence is best-effort
            evidence = []
        event = ro.note(
            "rollback", time.time(), reason=reason, observed=observed,
            signals={k: v for k, v in sig.items() if not k.startswith("_")},
            evidence_puids=evidence,
        )
        self._publish(
            "rollback", plan, reason=reason, observed=observed,
            config_hash=plan.config_hash, evidence_puids=evidence,
        )
        return event

    def _publish(self, kind: str, plan: RolloutPlan, **fields) -> None:
        if self.firehose is not None:
            self.firehose.publish_event(
                plan.deployment, kind,
                candidate=plan.candidate, baseline=plan.baseline, **fields,
            )

    # -- surfaces ----------------------------------------------------------

    def status_block(self, deployment: str) -> Optional[dict]:
        ro = self._rollouts.get(deployment)
        return None if ro is None else ro.snapshot()

    def snapshot(self) -> dict:
        return {
            "enabled": rollouts_enabled(),
            "rollouts": {
                dep: ro.snapshot()
                for dep, ro in sorted(self._rollouts.items())
            },
        }

    def document(self) -> dict:
        """The ``GET /rollouts`` body: full per-deployment state with
        gates and decision history."""
        return {
            "enabled": rollouts_enabled(),
            "rollouts": {
                dep: ro.document()
                for dep, ro in sorted(self._rollouts.items())
            },
            "quarantined": {
                dep: list(hashes)
                for dep, hashes in sorted(self._quarantined.items())
            },
        }


# ---------------------------------------------------------------------------
# signal sources
# ---------------------------------------------------------------------------


class GatewaySignals:
    """Candidate health read straight off the co-located gateway + the
    process-global quality observatory — the in-process topology every
    demo/test runs and the single-host production default.

    ``nodes``: graph node names whose drift scores describe the
    candidate (None = max over all nodes — correct when baseline and
    candidate share node names and therefore one drift window)."""

    def __init__(self, gateway, nodes: Optional[List[str]] = None):
        self.gateway = gateway
        self.nodes = nodes

    def __call__(self, plan: RolloutPlan) -> dict:
        from seldon_core_tpu_torch.utils.quality import QUALITY

        requests, errors = self.gateway.predictor_traffic(
            plan.deployment, plan.candidate
        )
        out: dict = {"requests": requests, "errors": errors}
        # force-fresh drift: a stage decision must judge the batches the
        # candidate just served, not the last throttle window's scores
        QUALITY.refresh_gauges()
        snap = QUALITY.snapshot()
        drifts = []
        for name, ent in (snap.get("nodes") or {}).items():
            if self.nodes is not None and name not in self.nodes:
                continue
            for key, val in ent.items():
                if key.endswith("psi_max") or key == "prediction_psi":
                    try:
                        drifts.append(float(val))
                    except (TypeError, ValueError):
                        pass
        if drifts:
            out["drift"] = max(drifts)
        # burn gates judge the fleet-truth aggregate when federation
        # publishes one, the local ring otherwise — the SAME
        # effective_burn_rate the brownout ladder reads, so a canary
        # cannot pass on a 1/N slice of the fleet's burn
        from seldon_core_tpu_torch.utils.quality import effective_burn_rate

        burn = effective_burn_rate("5m")
        if burn is not None:
            out["burn_rate"] = burn
        dis = self.gateway.shadow.disagreement_rate(plan.deployment)
        if dis is not None:
            out["shadow_disagreement"] = dis
        return out


class HttpSignals:
    """The same signals scraped over HTTP: the gateway's ``/stats`` +
    ``/shadow`` and an engine's ``/quality`` — for a control plane that
    does not share a process with the data plane."""

    def __init__(self, gateway_url: str, quality_url: Optional[str] = None,
                 timeout_s: float = 5.0):
        self.gateway_url = gateway_url.rstrip("/")
        self.quality_url = (quality_url or gateway_url).rstrip("/")
        self.timeout_s = timeout_s

    def _get(self, url: str) -> dict:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode("utf-8", "replace"))

    def __call__(self, plan: RolloutPlan) -> dict:
        stats = self._get(self.gateway_url + "/stats")
        out: dict = {}
        traffic = (stats.get("traffic") or {}).get(
            f"{plan.deployment}/{plan.candidate}"
        )
        if traffic:
            out["requests"] = int(traffic.get("count", 0))
            out["errors"] = int(traffic.get("errors", 0))
        else:
            out["requests"] = 0
            out["errors"] = 0
        shadow = (stats.get("shadow") or {}).get("deployments", {}).get(
            plan.deployment
        )
        if shadow and shadow.get("mean_disagreement") is not None:
            out["shadow_disagreement"] = shadow["mean_disagreement"]
        try:
            quality = self._get(self.quality_url + "/quality")
        except Exception:
            quality = None
        if quality:
            drifts = []
            for row in quality.get("nodes", []):
                drift = row.get("drift") or {}
                for key in ("psi_max", "prediction_psi"):
                    if key in drift:
                        try:
                            drifts.append(float(drift[key]))
                        except (TypeError, ValueError):
                            pass
            if drifts:
                out["drift"] = max(drifts)
            slo = (quality.get("slo") or {}).get("windows") or {}
            if "5m" in slo and (quality.get("slo") or {}).get("configured"):
                out["burn_rate"] = slo["5m"].get("burn_rate")
        return out


# ---------------------------------------------------------------------------
# CR annotation contract (operator/reconciler.py)
# ---------------------------------------------------------------------------


def _ann(annotations: dict, key: str, default: Optional[str] = None):
    v = annotations.get(f"seldon.io/canary-{key}")
    return default if v is None else str(v)


def plan_from_annotations(spec, config_hash: str) -> Optional[RolloutPlan]:
    """Build a RolloutPlan from deployment annotations, or None when the
    CR doesn't opt in.  Contract:

      ``seldon.io/canary``                      candidate predictor name
      ``seldon.io/canary-baseline``             baseline (default: the
                                                other predictor)
      ``seldon.io/canary-stages``               "1,5,25,100"
      ``seldon.io/canary-hold-s``               per-stage hold seconds
      ``seldon.io/canary-max-drift``            gate knobs ("none"
      ``seldon.io/canary-max-burn-rate``         disables a gate)
      ``seldon.io/canary-max-error-rate``
      ``seldon.io/canary-max-shadow-disagreement``
      ``seldon.io/canary-min-requests``

    Raises ValueError on a malformed contract (unknown predictor names,
    bad stage lists) — the reconciler surfaces that on the CR status the
    same way it surfaces an invalid graph."""
    ann = spec.annotations
    candidate = str(ann.get(CANARY_ANNOTATION, "") or "").strip()
    if not candidate:
        return None
    names = [p.name for p in spec.predictors]
    if candidate not in names:
        raise ValueError(
            f"canary annotation names unknown predictor {candidate!r} "
            f"(have {names})"
        )
    baseline = _ann(ann, "baseline")
    if baseline is None:
        others = [n for n in names if n != candidate]
        if len(others) != 1:
            raise ValueError(
                "canary-baseline annotation required when the deployment "
                f"doesn't have exactly one other predictor (have {names})"
            )
        baseline = others[0]
    elif baseline not in names:
        raise ValueError(
            f"canary-baseline names unknown predictor {baseline!r}"
        )

    def _gate(key: str, default: Optional[float]) -> Optional[float]:
        raw = _ann(ann, key)
        if raw is None:
            return default
        if raw.strip().lower() in ("none", "off", ""):
            return None
        return float(raw)

    stages_raw = _ann(ann, "stages")
    stages = (
        DEFAULT_STAGES if stages_raw is None
        else tuple(int(s) for s in stages_raw.split(",") if s.strip())
    )
    defaults = RolloutGates()
    gates = RolloutGates(
        max_drift=_gate("max-drift", defaults.max_drift),
        max_burn_rate=_gate("max-burn-rate", defaults.max_burn_rate),
        max_error_rate=_gate("max-error-rate", defaults.max_error_rate),
        max_shadow_disagreement=_gate(
            "max-shadow-disagreement", defaults.max_shadow_disagreement
        ),
        min_requests=int(float(_ann(ann, "min-requests",
                                    str(defaults.min_requests)))),
    )
    return RolloutPlan(
        deployment=spec.name,
        candidate=candidate,
        baseline=baseline,
        stages=stages,
        hold_s=float(_ann(ann, "hold-s", "30")),
        gates=gates,
        config_hash=config_hash,
    )
