"""Predictive scale-ahead — replicas move BEFORE the burn window fires;
the port's copy of ``seldon_core_tpu/operator/scaleahead.py``, reading the
port's gateway and quality observatory.

Without it ``operator/reconciler.py`` copies ``spec.replicas`` verbatim:
capacity changes by hand, after the SLO has already burned.  A
:class:`ScaleAheadPlanner` accumulates per-deployment load samples
(queue depth + gateway-side inflight, scraped from the gateway / fed by
the autopilot's surfaces), fits the queue-growth trend, and forecasts
the load ``horizon_s`` ahead — the 5-minute fast-burn window by
default, so the replica write lands before the page would.  The
reconciler consults it per tick and overrides the rendered engine
Deployments' ``spec.replicas``:

  * **Scale-out** is eager: the forecast (or the live load, whichever
    is larger) divided by the per-replica target decides the count —
    a growing queue buys capacity on the trend, not on the damage.
  * **Scale-in** is deliberate: hysteresis (the forecast must clear the
    smaller fleet's capacity with margin) and HARD-GATED on the rollout
    controller — a canary in flight holds the floor, because shrinking
    the fleet mid-rollout would let a capacity cut masquerade as (or
    mask) a candidate regression.  Same fail-closed polarity as the
    rollout gates: when in doubt, keep the capacity.

Opt-in per CR via annotations (docs/operations.md "Surviving
overload")::

    seldon.io/autoscale: "true"
    seldon.io/autoscale-min: "1"            # floor (default 1)
    seldon.io/autoscale-max: "8"            # ceiling (default 8)
    seldon.io/autoscale-target-inflight: "4"   # per-replica load target
    seldon.io/autoscale-horizon-s: "300"    # forecast horizon

Malformed annotations fail the reconcile with a clear CR status (the
same contract as the canary annotations), never a crash loop.  Every
decision is a typed record on :meth:`ScaleAheadPlanner.snapshot` and
the CR's ``status.autoscale`` block, so "why did the fleet grow at
14:02" is one status read."""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = [
    "AUTOSCALE_ANNOTATION",
    "AutoscalePolicy",
    "ScaleAheadPlanner",
    "gateway_load_sample",
]

AUTOSCALE_ANNOTATION = "seldon.io/autoscale"
ANN_MIN = "seldon.io/autoscale-min"
ANN_MAX = "seldon.io/autoscale-max"
ANN_TARGET = "seldon.io/autoscale-target-inflight"
ANN_HORIZON = "seldon.io/autoscale-horizon-s"


@dataclass
class AutoscalePolicy:
    """Per-CR scale-ahead contract, parsed from annotations."""

    min_replicas: int = 1
    max_replicas: int = 8
    target_inflight: float = 4.0
    horizon_s: float = 300.0
    #: scale-in headroom: the forecast must fit the SMALLER fleet at
    #: this utilization or better before a replica is taken away
    scale_in_margin: float = 0.85

    @classmethod
    def from_spec(cls, spec) -> Optional["AutoscalePolicy"]:
        """None unless the CR opts in; ValueError on malformed values
        (the reconciler surfaces it as a Failed/invalid status)."""
        ann = getattr(spec, "annotations", None) or {}
        if str(ann.get(AUTOSCALE_ANNOTATION, "")).lower() != "true":
            return None
        try:
            policy = cls(
                min_replicas=int(ann.get(ANN_MIN, 1)),
                max_replicas=int(ann.get(ANN_MAX, 8)),
                target_inflight=float(ann.get(ANN_TARGET, 4.0)),
                horizon_s=float(ann.get(ANN_HORIZON, 300.0)),
            )
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"malformed seldon.io/autoscale-* annotation: {e}"
            ) from e
        if policy.min_replicas < 1 or policy.max_replicas < policy.min_replicas:
            raise ValueError(
                f"autoscale bounds invalid: min={policy.min_replicas} "
                f"max={policy.max_replicas}"
            )
        if policy.target_inflight <= 0 or policy.horizon_s <= 0:
            raise ValueError(
                "autoscale-target-inflight and autoscale-horizon-s must "
                "be positive"
            )
        return policy


class ScaleAheadPlanner:
    """Per-deployment load series -> forecast -> desired replica count."""

    MAX_SAMPLES = 128
    MAX_DECISIONS = 64

    def __init__(self, now_fn: Callable[[], float] = time.monotonic):
        self._now = now_fn
        self._series: Dict[str, deque] = {}
        self.decisions: deque = deque(maxlen=self.MAX_DECISIONS)

    # -- signal intake ----------------------------------------------------

    def observe(self, deployment: str, *, queue_depth: float = 0.0,
                inflight: float = 0.0, burn_5m: float = 0.0,
                now: Optional[float] = None) -> None:
        """One load sample.  ``queue_depth + inflight`` is the load the
        fleet must absorb; ``burn_5m`` rides along for the decision
        record (the planner acts BEFORE burn, it doesn't wait for it)."""
        now = now if now is not None else self._now()
        q = self._series.setdefault(
            deployment, deque(maxlen=self.MAX_SAMPLES))
        q.append((float(now), float(queue_depth) + float(inflight),
                  float(burn_5m)))

    # -- forecast ---------------------------------------------------------

    def forecast(self, deployment: str, horizon_s: float,
                 now: Optional[float] = None) -> Dict[str, float]:
        """Least-squares trend over the retained samples, extrapolated
        ``horizon_s`` ahead (clamped at zero).  With < 2 samples the
        forecast is the last observation — no trend, no extrapolation."""
        now = now if now is not None else self._now()
        q = self._series.get(deployment)
        if not q:
            return {"current": 0.0, "predicted": 0.0, "slope_per_s": 0.0,
                    "samples": 0}
        ts = [s[0] for s in q]
        loads = [s[1] for s in q]
        current = loads[-1]
        n = len(q)
        if n < 2 or ts[-1] == ts[0]:
            return {"current": current, "predicted": current,
                    "slope_per_s": 0.0, "samples": n}
        tbar = sum(ts) / n
        lbar = sum(loads) / n
        denom = sum((t - tbar) ** 2 for t in ts)
        slope = (
            sum((t - tbar) * (l - lbar) for t, l in zip(ts, loads)) / denom
            if denom > 0 else 0.0
        )
        predicted = max(0.0, current + slope * horizon_s)
        return {"current": current, "predicted": predicted,
                "slope_per_s": slope, "samples": n}

    # -- the decision -----------------------------------------------------

    def desired_replicas(
        self,
        deployment: str,
        current_replicas: int,
        policy: AutoscalePolicy,
        rollout_active: bool = False,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The replica count the reconciler should write, with the full
        reasoning as a typed record (also appended to ``decisions``)."""
        fc = self.forecast(deployment, policy.horizon_s, now=now)
        # no samples = no signal, NOT "idle": an operator restart (the
        # planner is in-memory) or a dead scrape feed must hold the
        # fleet, never cut capacity mid-overload — the same
        # keep-capacity-when-in-doubt polarity as the rollout gate
        if fc["samples"] == 0:
            decision = {
                "deployment": deployment,
                "ts": time.time(),
                "current_replicas": int(current_replicas),
                "desired_replicas": int(current_replicas),
                "reason": "no load signal (hold)",
                "rollout_active": bool(rollout_active),
                "load_now": 0.0, "load_forecast": 0.0,
                "slope_per_s": 0.0,
                "horizon_s": policy.horizon_s,
                "target_inflight": policy.target_inflight,
            }
            return decision
        # plan for the WORSE of live load and forecast: a spike that
        # already arrived must not be scaled for "later"
        load = max(fc["current"], fc["predicted"])
        want = max(1, math.ceil(load / policy.target_inflight))
        want = min(max(want, policy.min_replicas), policy.max_replicas)
        reason = "steady"
        if want > current_replicas:
            reason = "queue-growth forecast"
        elif want < current_replicas:
            if rollout_active:
                # a canary never masks a capacity cut: hold the fleet
                want, reason = current_replicas, "scale-in rollout-gated"
            else:
                # hysteresis: the smaller fleet must absorb the forecast
                # with margin, or we'd flap at the boundary
                cap = (want * policy.target_inflight
                       * policy.scale_in_margin)
                if load > cap:
                    want, reason = current_replicas, "scale-in hysteresis"
                else:
                    reason = "load receded"
        decision = {
            "deployment": deployment,
            "ts": time.time(),
            "current_replicas": int(current_replicas),
            "desired_replicas": int(want),
            "reason": reason,
            "rollout_active": bool(rollout_active),
            "load_now": round(fc["current"], 3),
            "load_forecast": round(fc["predicted"], 3),
            "slope_per_s": round(fc["slope_per_s"], 6),
            "horizon_s": policy.horizon_s,
            "target_inflight": policy.target_inflight,
        }
        if want != current_replicas:
            self.decisions.append(decision)
        return decision

    def snapshot(self) -> Dict[str, Any]:
        return {
            "deployments": {
                dep: {
                    "samples": len(q),
                    "last_load": q[-1][1] if q else 0.0,
                }
                for dep, q in self._series.items()
            },
            "decisions": list(self.decisions)[-16:],
        }

    def reset(self) -> None:
        self._series = {}
        self.decisions.clear()


def gateway_load_sample(gateway, deployment: str) -> Dict[str, float]:
    """Scrape one load sample for ``deployment`` from an in-process
    gateway: gateway-side inflight summed over the deployment's replica
    sets, plus the fair-queue backlog, plus the global 5m burn — the
    co-located-control-plane analogue of the rollout controller's
    GatewaySignals.  Feed the result to :meth:`ScaleAheadPlanner
    .observe`."""
    inflight = 0
    for (dep, _pred), (_fp, rs) in getattr(
            gateway, "_replica_sets", {}).items():
        if dep != deployment:
            continue
        for ep in rs.endpoints:
            inflight += max(int(getattr(ep, "inflight", 0)), 0)
    queue_depth = 0
    tenants = getattr(gateway, "tenants", None)
    if tenants is not None:
        queue_depth = tenants.queue_depth()
    burn = 0.0
    try:
        from seldon_core_tpu_torch.utils.quality import QUALITY

        if QUALITY.slo.configured:
            burn = float(QUALITY.slo.burn_rates()["5m"]["burn_rate"])
    except Exception:  # noqa: BLE001 - a dead feed is a zero, not a crash
        pass
    return {"queue_depth": float(queue_depth),
            "inflight": float(inflight), "burn_5m": burn}
