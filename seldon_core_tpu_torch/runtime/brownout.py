"""Brownout controller — the port's counterpart of
``seldon_core_tpu/runtime/brownout.py``: a staged, auto-reverting
degradation ladder for overload.

Without a policy, what gives under overload is chosen by accident; the
ladder makes the give-up order explicit, observable and reversible.  It is
driven by live SLO burn (the 5-minute fast-burn window, through
``utils/quality.py``'s ``effective_burn_rate``) and admission queue depth
(registered providers: the generation scheduler's waiting queue):

  ===== ====================== ===========================================
  stage name                   effect
  ===== ====================== ===========================================
  0     normal                 none
  1     shed-offline           ``offline``-tier requests answer a typed,
                               retryable 503 at admission
  2     degrade-generation     ``max_new`` scaled down
                               (``SELDON_TPU_BROWNOUT_MAXNEW_SCALE``, 0.5)
                               and chunked prefill at its floor grain (the
                               adaptive probe pauses)
  3     shed-batch             ``batch`` sheds too, and the autopilot's
                               admission margin tightens
                               (``SELDON_TPU_BROWNOUT_MARGIN_SCALE``, 0.8)
  ===== ====================== ===========================================

**Pressure rule.**  Each tick reads burn and depth, normalizes each
against its enter threshold and takes the max::

    pressure = max(burn / enter_burn, depth / enter_depth)
    severity = 0 if pressure < 1 else 1 + floor(log2(pressure))   # cap 3

Stages move one step a tick, in both directions.  Escalation waits a dwell
per stage (``SELDON_TPU_BROWNOUT_DWELL_S``); reversion needs the severity
below the stage continuously for ``SELDON_TPU_BROWNOUT_REVERT_S``, then
steps down one stage and restarts the clock.  Every move is a typed
:class:`BrownoutTransition` (``/stats`` ``brownout``), a
``seldon_tpu_brownout_stage`` gauge write and a
``seldon_tpu_brownout_transitions_total{stage}`` tick.

**Fail-closed on signals.**  A dead signal source (the burn read or a depth
provider raises) reads as calm: escalation stops, the revert clock runs,
and the outage is counted (``signals_unavailable``).

``SELDON_TPU_BROWNOUT=0`` is the kill switch: ``stage()`` reads 0 and every
effect returns its neutral value.  The clock is injectable (``now_fn``), so
the ladder is walked in tests without sleeping."""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from seldon_core_tpu_torch.runtime.qos import TIER_BATCH, TIER_OFFLINE
from seldon_core_tpu_torch.utils.telemetry import RECORDER

__all__ = [
    "BROWNOUT",
    "BrownoutController",
    "BrownoutTransition",
    "BROWNOUT_INFO_PREFIX",
    "STAGE_NAMES",
    "brownout_enabled",
]

logger = logging.getLogger(__name__)

#: every brownout-shed FAILURE message starts with this: like the
#: autopilot's SHED_INFO_PREFIX it marks a DECISION, not a sick replica
#: — the gateway accounts these neutrally (no failure streak, no EWMA)
BROWNOUT_INFO_PREFIX = "brownout load shed"

STAGE_NAMES = ("normal", "shed-offline", "degrade-generation",
               "shed-batch")
MAX_STAGE = len(STAGE_NAMES) - 1


def brownout_enabled() -> bool:
    return os.environ.get("SELDON_TPU_BROWNOUT", "1").strip() != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class BrownoutTransition:
    """One typed ladder move — what /stats shows and tests pin."""

    __slots__ = ("ts", "from_stage", "to_stage", "reason", "signals")

    def __init__(self, ts: float, from_stage: int, to_stage: int,
                 reason: str, signals: Dict[str, Any]):
        self.ts = ts
        self.from_stage = from_stage
        self.to_stage = to_stage
        self.reason = reason
        self.signals = signals

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "ts": round(self.ts, 3),
            "from": self.from_stage,
            "from_name": STAGE_NAMES[self.from_stage],
            "to": self.to_stage,
            "to_name": STAGE_NAMES[self.to_stage],
            "reason": self.reason,
            "signals": self.signals,
        }


def _default_burn() -> Optional[float]:
    """The 5m fast-burn rate the ladder judges: the federated
    fleet-truth aggregate when the gateway federation publishes a fresh
    one, the process-local SLO ring otherwise (and the max of both when
    both exist) — ``effective_burn_rate`` in utils/quality.py is the
    single shared rule, so the rollout burn gates judge the SAME number.
    None when no SLO is configured anywhere (burn then simply isn't a
    signal)."""
    from seldon_core_tpu_torch.utils.quality import effective_burn_rate

    burn = effective_burn_rate("5m")
    return None if burn is None else float(burn)


class BrownoutController:
    """The ladder.  One process-global instance (:data:`BROWNOUT`) is
    consulted by the engine (tier sheds + autopilot margin at
    admission) and the genserver (tier sheds at admission,
    max_new / prefill-chunk degradation); hot paths call
    :meth:`maybe_tick` (a monotonic-throttled no-op between ticks) and
    the cheap effect reads below."""

    def __init__(
        self,
        burn_fn: Optional[Callable[[], Optional[float]]] = None,
        now_fn: Callable[[], float] = time.monotonic,
        enter_burn: Optional[float] = None,
        enter_depth: Optional[float] = None,
        dwell_s: Optional[float] = None,
        revert_s: Optional[float] = None,
        tick_interval_s: Optional[float] = None,
    ):
        self.burn_fn = burn_fn or _default_burn
        self._now = now_fn
        self.enter_burn = (
            enter_burn if enter_burn is not None
            else _env_float("SELDON_TPU_BROWNOUT_ENTER_BURN", 2.0)
        )
        self.enter_depth = (
            enter_depth if enter_depth is not None
            else _env_float("SELDON_TPU_BROWNOUT_DEPTH", 512.0)
        )
        self.dwell_s = (
            dwell_s if dwell_s is not None
            else _env_float("SELDON_TPU_BROWNOUT_DWELL_S", 5.0)
        )
        self.revert_s = (
            revert_s if revert_s is not None
            else _env_float("SELDON_TPU_BROWNOUT_REVERT_S", 60.0)
        )
        self.tick_interval_s = (
            tick_interval_s if tick_interval_s is not None
            else _env_float("SELDON_TPU_BROWNOUT_TICK_MS", 250.0) / 1e3
        )
        self._lock = threading.Lock()
        self._depth_fns: Dict[str, Callable[[], int]] = {}
        self._stage = 0
        self._stage_entered = self._now()
        self._calm_since: Optional[float] = None
        self._published_stage = 0
        self._last_tick = 0.0
        self._last_signals: Dict[str, Any] = {}
        self.transitions: deque = deque(maxlen=64)
        self.ticks = 0
        self.signals_unavailable = 0
        #: optional control-plane event hook: a caller that keeps an
        #: event stream wires its publisher here, so ladder moves land
        #: beside the traffic they shaped
        self.event_sink: Optional[Callable[..., None]] = None

    # -- signal providers ------------------------------------------------

    def register_depth(self, name: str, fn: Callable[[], int]) -> None:
        """Add a queue-depth provider (a genserver's waiting queue, a
        governor's fair-queue backlog).  Total depth is the sum; a provider that
        raises is skipped and counted as a signal outage."""
        with self._lock:
            self._depth_fns[name] = fn

    def unregister_depth(self, name: str) -> None:
        with self._lock:
            self._depth_fns.pop(name, None)

    # -- the state machine -----------------------------------------------

    def stage(self) -> int:
        return self._stage if brownout_enabled() else 0

    def maybe_tick(self, now: Optional[float] = None) -> int:
        """Hot-path entry: run a tick when the interval elapsed, else a
        single float compare.  Returns the (possibly updated) stage."""
        now = now if now is not None else self._now()
        if now - self._last_tick >= self.tick_interval_s:
            self.tick(now)
        return self.stage()

    def _read_signals(self, now: float):
        """(pressure, signals) — pressure None when every source was
        unavailable this tick (fail-closed: reads as calm)."""
        signals: Dict[str, Any] = {}
        pressures = []
        outage = False
        try:
            burn = self.burn_fn()
        except Exception:  # noqa: BLE001 - a dead feed must not wedge us
            burn = None
            outage = True
        if burn is not None:
            signals["burn_5m"] = round(float(burn), 4)
            if self.enter_burn > 0:
                pressures.append(float(burn) / self.enter_burn)
        with self._lock:
            fns = list(self._depth_fns.items())
        depth = 0
        depth_ok = False
        for _name, fn in fns:
            try:
                depth += int(fn())
                depth_ok = True
            except Exception:  # noqa: BLE001
                outage = True
        if depth_ok:
            signals["queue_depth"] = depth
            if self.enter_depth > 0:
                pressures.append(depth / self.enter_depth)
        if outage:
            signals["signal_outage"] = True
        return (max(pressures) if pressures else None), signals

    @staticmethod
    def _severity(pressure: Optional[float]) -> int:
        """Doubling ladder: pressure 1x -> stage 1, 2x -> 2, 4x -> 3."""
        if pressure is None or pressure < 1.0:
            return 0
        sev = 1
        while pressure >= 2.0 and sev < MAX_STAGE:
            pressure /= 2.0
            sev += 1
        return sev

    def tick(self, now: Optional[float] = None) -> int:
        """One evaluation.  Safe from any thread; cheap enough to ride
        admission paths behind :meth:`maybe_tick`'s throttle."""
        now = now if now is not None else self._now()
        with self._lock:
            self._last_tick = now
            self.ticks += 1
        pressure, signals = self._read_signals(now)
        if pressure is None and signals.get("signal_outage"):
            with self._lock:
                self.signals_unavailable += 1
        severity = self._severity(pressure)
        signals["pressure"] = (
            None if pressure is None else round(pressure, 4))
        signals["severity"] = severity
        with self._lock:
            self._last_signals = signals
            if severity > self._stage:
                self._calm_since = None
                dwell_ok = (
                    self._stage == 0
                    or now - self._stage_entered >= self.dwell_s
                )
                if dwell_ok:
                    self._move(self._stage + 1, "pressure", signals, now)
            elif severity < self._stage:
                if self._calm_since is None:
                    self._calm_since = now
                elif now - self._calm_since >= self.revert_s:
                    self._move(self._stage - 1, "calm", signals, now)
                    # each further step down needs its own hold — revert
                    # deliberately, in order
                    self._calm_since = now
            else:
                self._calm_since = None
            # the gauge always tracks the EFFECTIVE stage — stage() is 0
            # under the kill switch regardless of the internal ladder,
            # and flipping the switch mid-stage corrects it on the next
            # tick without churning the stats cache every tick
            effective = self._stage if brownout_enabled() else 0
            if effective != self._published_stage:
                self._published_stage = effective
                RECORDER.set_brownout_stage(effective)
        return self.stage()

    def _move(self, to: int, reason: str, signals: Dict[str, Any],
              now: float) -> None:
        """Lock held.  One ladder step.  With the kill switch on the
        INTERNAL stage still moves (so re-enable resumes from live
        signals) but none of the operator-facing accounting fires — a
        disabled ladder paging SeldonTPUBrownoutActive while /stats
        reads stage 0 would send the on-call chasing a degradation that
        is not happening."""
        tr = BrownoutTransition(time.time(), self._stage, to, reason,
                                dict(signals))
        self.transitions.append(tr)
        self._stage = to
        self._stage_entered = now
        if not brownout_enabled():
            return
        RECORDER.record_brownout_transition(to)
        logger.warning(
            "brownout: stage %d (%s) -> %d (%s) [%s] signals=%s",
            tr.from_stage, STAGE_NAMES[tr.from_stage], to,
            STAGE_NAMES[to], reason, signals,
        )
        sink = self.event_sink
        if sink is not None:
            try:
                sink("brownout_transition", **tr.to_json_dict())
            except Exception:  # noqa: BLE001 - the sink is best-effort
                pass

    # -- effects (cheap reads on admission/scheduler paths) ---------------

    def sheds_tier(self, tier: str) -> bool:
        """Stage 1 sheds ``offline``, stage 3 sheds ``batch`` too.
        ``interactive`` is never shed by the ladder — that is what the
        autopilot's deadline admission and the token buckets are for."""
        stage = self.stage()
        if stage >= 3 and tier == TIER_BATCH:
            return True
        return stage >= 1 and tier == TIER_OFFLINE

    def gen_max_new_scale(self) -> float:
        """Stage >= 2: generation lengths scale down so each sequence
        frees its KV blocks (and its slot) sooner."""
        if self.stage() >= 2:
            return min(max(_env_float(
                "SELDON_TPU_BROWNOUT_MAXNEW_SCALE", 0.5), 0.05), 1.0)
        return 1.0

    def gen_chunk_floor(self) -> bool:
        """Stage >= 2: chunked prefill drops to its floor grain so
        in-flight interactive decode stalls as little as possible."""
        return self.stage() >= 2

    def shed_margin_scale(self) -> float:
        """Stage >= 3: multiply the autopilot's shed margin by < 1 so
        admission refuses marginal requests it would normally gamble
        on — capacity goes to requests that will certainly fit."""
        if self.stage() >= 3:
            return min(max(_env_float(
                "SELDON_TPU_BROWNOUT_MARGIN_SCALE", 0.8), 0.1), 1.0)
        return 1.0

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": brownout_enabled(),
                "stage": self._stage if brownout_enabled() else 0,
                "stage_name": STAGE_NAMES[
                    self._stage if brownout_enabled() else 0],
                "signals": dict(self._last_signals),
                "ticks": self.ticks,
                "signals_unavailable": self.signals_unavailable,
                "transitions": [
                    t.to_json_dict() for t in list(self.transitions)[-8:]
                ],
                "knobs": {
                    "kill_switch": "SELDON_TPU_BROWNOUT",
                    "enter_burn": self.enter_burn,
                    "enter_depth": self.enter_depth,
                    "dwell_s": self.dwell_s,
                    "revert_s": self.revert_s,
                },
            }

    def reset(self) -> None:
        """Tests only: back to stage 0 with empty history."""
        with self._lock:
            self._stage = 0
            self._stage_entered = self._now()
            self._calm_since = None
            self._published_stage = 0
            self._last_tick = 0.0
            self._last_signals = {}
            self.transitions.clear()
            self.ticks = 0
            self.signals_unavailable = 0
        RECORDER.set_brownout_stage(0)


BROWNOUT = BrownoutController()
