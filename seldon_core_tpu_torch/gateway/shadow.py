"""Shadow traffic mirroring — live requests duplicated to a shadow
predictor, fire-and-forget; the port's copy of
``seldon_core_tpu/gateway/shadow.py``.  Both answers of a pair are host
messages, diffed by the port's ``messages.prediction_delta``.

The reference platform's shadow pattern routes a *copy* of production
traffic to a non-serving predictor so a candidate model sees real inputs
without ever answering a user.  Here the gateway owns it: after a live
predict completes, a sampled fraction of requests is re-dispatched to the
deployment's shadow predictor on a background task and the pair of
answers is diffed — prediction disagreement (``messages.prediction_delta``,
the same rule the firehose replayer uses), latency delta, and error delta
accumulate per deployment and surface on ``GET /shadow`` plus the
``seldon_tpu_shadow_*`` metric families.

Hard invariants (the whole point of the design):

  * **Never on the response path.**  The live handler pays one RNG draw
    and, for the sampled fraction, one ``loop.create_task`` — the mirror
    dispatch, the shadow predictor's latency, and the diff all happen
    after the live response has left the building.  A hung shadow
    predictor cannot slow a user by construction.
  * **Concurrency- and budget-capped.**  At most ``max_concurrency``
    mirrors in flight per deployment and a token-bucket rate cap
    (``budget_per_s``, burst 2x) — a traffic spike mirrors *less*, never
    amplifies 2x into the backend.  Capped requests are counted
    (``outcome="capped"``), not queued.
  * **Deadline-clamped.**  Each mirror runs under its own fresh deadline
    (``deadline_ms``) — it does NOT inherit the live request's spent
    budget (which is typically exhausted by the time the mirror runs),
    and a wedged shadow predictor fails at the clamp, not never.

Configuration rides the deployment spec: a predictor annotated
``seldon.io/shadow: "true"`` is excluded from the live weighted split and
becomes the mirror target; deployment-level annotations
``seldon.io/shadow-sample`` / ``-deadline-ms`` / ``-max-concurrency`` /
``-budget-per-s`` tune the caps.  ``SELDON_TPU_SHADOW=0`` kills the whole
subsystem (no sampling, no tasks — today's behavior).
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from seldon_core_tpu_torch.messages import SeldonMessage, prediction_delta
from seldon_core_tpu_torch.runtime.resilience import DEADLINE_VAR, deadline_scope
from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir

__all__ = [
    "ShadowConfig",
    "ShadowMirror",
    "shadow_enabled",
    "shadow_config_from_spec",
    "SHADOW_ANNOTATION",
]

SHADOW_ANNOTATION = "seldon.io/shadow"


def shadow_enabled() -> bool:
    """``SELDON_TPU_SHADOW=0`` restores the pre-mirroring gateway —
    checked per request so a flip needs no restart."""
    return os.environ.get("SELDON_TPU_SHADOW", "1").strip() != "0"


def _ann_float(annotations: dict, key: str, default: float) -> float:
    try:
        return float(annotations.get(key, "") or default)
    except (TypeError, ValueError):
        return default


@dataclass
class ShadowConfig:
    """Mirror policy for one deployment."""

    predictor: str               #: shadow predictor name (weight-0 live)
    sample: float = 0.1          #: mirrored fraction of live predicts
    max_concurrency: int = 8     #: in-flight mirror cap
    budget_per_s: float = 50.0   #: token-bucket rate cap (burst 2x)
    deadline_ms: float = 2000.0  #: per-mirror deadline clamp

    def to_json_dict(self) -> dict:
        return {
            "predictor": self.predictor,
            "sample": self.sample,
            "max_concurrency": self.max_concurrency,
            "budget_per_s": self.budget_per_s,
            "deadline_ms": self.deadline_ms,
        }

    @staticmethod
    def from_json_dict(d: dict) -> "ShadowConfig":
        return ShadowConfig(
            predictor=str(d["predictor"]),
            sample=float(d.get("sample", 0.1)),
            max_concurrency=int(d.get("max_concurrency", 8)),
            budget_per_s=float(d.get("budget_per_s", 50.0)),
            deadline_ms=float(d.get("deadline_ms", 2000.0)),
        )


def shadow_config_from_spec(spec) -> Optional[ShadowConfig]:
    """The spec-level shadow contract: the FIRST predictor annotated
    ``seldon.io/shadow: "true"`` becomes the mirror target (weight 0 in
    the live split — apife/state enforce that); deployment annotations
    tune the caps.  None when no predictor opts in."""
    target = None
    for p in spec.predictors:
        flag = str(p.annotations.get(SHADOW_ANNOTATION, "")).strip().lower()
        if flag in ("true", "1", "yes"):
            target = p.name
            break
    if target is None:
        return None
    ann = spec.annotations
    sample = _ann_float(ann, "seldon.io/shadow-sample", 0.1)
    return ShadowConfig(
        predictor=target,
        sample=min(max(sample, 0.0), 1.0),
        max_concurrency=max(
            int(_ann_float(ann, "seldon.io/shadow-max-concurrency", 8)), 1
        ),
        budget_per_s=max(
            _ann_float(ann, "seldon.io/shadow-budget-per-s", 50.0), 0.1
        ),
        deadline_ms=max(
            _ann_float(ann, "seldon.io/shadow-deadline-ms", 2000.0), 1.0
        ),
    )


@dataclass
class _DeploymentShadow:
    """Per-deployment mirror state: caps plus the divergence picture."""

    config: ShadowConfig
    inflight: int = 0
    tokens: float = 0.0
    tokens_at: float = field(default_factory=time.monotonic)
    mirrored: int = 0
    sampled_out: int = 0
    capped: int = 0
    live_errors: int = 0      # over mirrored requests only — comparable
    shadow_errors: int = 0
    disagreement: Reservoir = field(default_factory=Reservoir)
    latency_delta_ms: Reservoir = field(default_factory=Reservoir)
    shadow_latency_ms: Reservoir = field(default_factory=Reservoir)
    last_error: str = ""

    def take_token(self, now: float) -> bool:
        burst = 2.0 * self.config.budget_per_s
        self.tokens = min(
            burst, self.tokens + (now - self.tokens_at) * self.config.budget_per_s
        )
        self.tokens_at = now
        if self.tokens < 1.0:
            return False
        self.tokens -= 1.0
        return True

    def document_row(self) -> dict:
        mirrored = self.mirrored
        dis = self.disagreement.snapshot()
        return {
            "config": self.config.to_json_dict(),
            "mirrored": mirrored,
            "sampled_out": self.sampled_out,
            "capped": self.capped,
            "inflight": self.inflight,
            "disagreement": {
                "count": dis["count"],
                "mean": dis["mean"],
                "p50": dis["p50"],
                "p95": dis["p95"],
            },
            "latency_delta_ms": self.latency_delta_ms.snapshot(),
            "shadow_latency_ms": self.shadow_latency_ms.snapshot(),
            "error_delta": {
                "live": self.live_errors,
                "shadow": self.shadow_errors,
                "live_rate": round(self.live_errors / mirrored, 6)
                if mirrored else 0.0,
                "shadow_rate": round(self.shadow_errors / mirrored, 6)
                if mirrored else 0.0,
            },
            "last_error": self.last_error,
        }


def _is_error(resp: Optional[SeldonMessage]) -> bool:
    return (resp is None
            or (resp.status is not None and resp.status.status == "FAILURE"))


class ShadowMirror:
    """Gateway-owned mirror engine.  ``dispatch`` is supplied by the
    gateway: ``async dispatch(reg, predictor_name, msg) -> SeldonMessage``
    — it reuses the real pick/lane machinery so the shadow predictor's
    replica set, breakers and lanes behave exactly as they would for live
    traffic."""

    def __init__(self, dispatch: Callable, seed: int = 0):
        self._dispatch = dispatch
        self._rng = random.Random(seed)
        self._by_deployment: Dict[str, _DeploymentShadow] = {}
        self._tasks: set = set()

    # -- configuration ---------------------------------------------------

    def state_for(self, deployment: str,
                  config: Optional[ShadowConfig]) -> Optional[_DeploymentShadow]:
        """Lazily (re)build per-deployment state; a re-registration that
        changed the shadow target/config resets the divergence windows —
        they described the OLD candidate."""
        if config is None:
            self._by_deployment.pop(deployment, None)
            return None
        ds = self._by_deployment.get(deployment)
        if ds is None or ds.config != config:
            ds = _DeploymentShadow(config=config)
            # the bucket starts FULL: the first sampled request after a
            # (re)configuration must mirror, not bootstrap the refill
            ds.tokens = 2.0 * config.budget_per_s
            self._by_deployment[deployment] = ds
        return ds

    # -- the live-path hook ----------------------------------------------

    def maybe_mirror(self, reg, live_predictor: str, msg: SeldonMessage,
                     live_resp: SeldonMessage,
                     live_latency_s: float) -> bool:
        """Called by the gateway AFTER the live response exists.  Costs
        one RNG draw on the unsampled path.  Returns True when a mirror
        task was scheduled."""
        config = getattr(reg, "shadow", None)
        if config is None or not shadow_enabled():
            return False
        if live_predictor == config.predictor:
            return False  # never mirror the shadow's own traffic
        ds = self.state_for(reg.deployment_id, config)
        if self._rng.random() >= config.sample:
            ds.sampled_out += 1
            RECORDER.record_shadow("sampled_out")
            return False
        now = time.monotonic()
        if ds.inflight >= config.max_concurrency or not ds.take_token(now):
            ds.capped += 1
            RECORDER.record_shadow("capped")
            return False
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False  # no loop (sync tests drive predict() directly)
        ds.inflight += 1
        task = loop.create_task(
            self._mirror(ds, reg, msg, live_resp, live_latency_s)
        )
        # keep a strong ref until done (asyncio only holds weak ones)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return True

    async def _mirror(self, ds: _DeploymentShadow, reg, msg: SeldonMessage,
                      live_resp: SeldonMessage,
                      live_latency_s: float) -> None:
        t0 = time.perf_counter()
        shadow_resp: Optional[SeldonMessage] = None
        try:
            # drop the live request's (spent) deadline before clamping to
            # the mirror's own budget — deadline_scope tightens only, so
            # an inherited exhausted budget would 504 every mirror
            token = DEADLINE_VAR.set(None)
            try:
                with deadline_scope(ds.config.deadline_ms / 1e3):
                    # wait_for enforces the clamp even against targets
                    # that ignore the deadline contextvar (a wedged
                    # in-process stub, a lane without propagation) — and
                    # cancels the hung coroutine instead of leaking it
                    shadow_resp = await asyncio.wait_for(
                        self._dispatch(reg, ds.config.predictor, msg),
                        timeout=ds.config.deadline_ms / 1e3,
                    )
            finally:
                DEADLINE_VAR.reset(token)
        except asyncio.TimeoutError:
            ds.last_error = (
                f"shadow deadline exceeded ({ds.config.deadline_ms:.0f} ms)"
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — the mirror NEVER raises
            ds.last_error = f"{type(e).__name__}: {e}"
        finally:
            ds.inflight -= 1
        shadow_latency_s = time.perf_counter() - t0
        ds.mirrored += 1
        if _is_error(live_resp):
            ds.live_errors += 1
        if _is_error(shadow_resp):
            ds.shadow_errors += 1
            if shadow_resp is not None and shadow_resp.status is not None:
                ds.last_error = shadow_resp.status.info or ds.last_error
            RECORDER.record_shadow("shadow_error")
        else:
            RECORDER.record_shadow("mirrored")
        # the disagree figure is recorded UNCONDITIONALLY: an
        # incomparable pair is either matched failures (disagree 0.0 —
        # faithfully reproducing the baseline's error) or a contract
        # break (shape/kind mismatch, one-sided failure → 1.0) — a
        # candidate that changes the output contract must read as
        # maximal divergence, not fall out of the window
        disagreement = prediction_delta(live_resp, shadow_resp)["disagree"]
        ds.shadow_latency_ms.observe(shadow_latency_s * 1e3)
        ds.latency_delta_ms.observe((shadow_latency_s - live_latency_s) * 1e3)
        ds.disagreement.observe(disagreement)
        RECORDER.observe_shadow(disagreement, shadow_latency_s)

    def prune(self, live_deployments) -> None:
        """Drop divergence state of deployments no longer registered —
        rides the gateway's existing prune gate (apife._prune_stale_sets)
        so an unregistered deployment's windows don't outlive it."""
        live = set(live_deployments)
        for dep in [d for d in self._by_deployment if d not in live]:
            del self._by_deployment[dep]

    # -- surfaces ---------------------------------------------------------

    async def drain(self, timeout_s: float = 5.0) -> None:
        """Wait for in-flight mirrors (tests / orderly shutdown)."""
        pending = [t for t in self._tasks if not t.done()]
        if pending:
            await asyncio.wait(pending, timeout=timeout_s)

    def cancel_all(self) -> None:
        """Cancel in-flight mirrors — gateway shutdown.  Mirrors are
        fire-and-forget by contract (nothing awaits their results), so
        dying with the gateway is the correct teardown."""
        for t in list(self._tasks):
            t.cancel()

    def disagreement_rate(self, deployment: str) -> Optional[float]:
        """Rolling mean live-vs-shadow disagreement — the signal the
        rollout controller gates stages on.  None before any mirror
        completed (no evidence is not zero divergence)."""
        ds = self._by_deployment.get(deployment)
        if ds is None or len(ds.disagreement) == 0:
            return None
        return float(ds.disagreement.snapshot()["mean"])

    def document(self) -> dict:
        """The ``GET /shadow`` body."""
        return {
            "enabled": shadow_enabled(),
            "deployments": {
                dep: ds.document_row()
                for dep, ds in sorted(self._by_deployment.items())
            },
        }

    def snapshot(self) -> dict:
        """Compact block for the gateway's ``/stats``."""
        return {
            "enabled": shadow_enabled(),
            "deployments": {
                dep: {
                    "predictor": ds.config.predictor,
                    "sample": ds.config.sample,
                    "mirrored": ds.mirrored,
                    "capped": ds.capped,
                    "inflight": ds.inflight,
                    "mean_disagreement": round(
                        ds.disagreement.snapshot()["mean"], 6
                    ) if len(ds.disagreement) else None,
                }
                for dep, ds in sorted(self._by_deployment.items())
            },
        }
