"""Learned cost-model autopilot — the port's counterpart of
``seldon_core_tpu/runtime/autopilot.py``: the layer that makes the
observatories act instead of watch.

One robust online latency estimate per key (an EWMA location with
Huber-clipped residuals and an EWMA absolute-deviation scale: a single
straggler moves the estimate by at most ``lr * OUTLIER_K * scale``, a real
shift converges in a few samples).  Keys are the perf observatory's
executable identities (``predict[64x784/float32]``), so every pad bucket is
its own model, and ``branch:<router>/<b>[<bucket>]`` for a router's
branches.  Before a key has ``min_samples`` measured dispatches its
prediction blends toward the observatory's seed prior
(``OBSERVATORY.seed_predicted_s``: the analytic cost over the card's peak
table in ``utils/chips.py``, times ``SELDON_TPU_PERF_OVERHEAD_X``, scaled by
the measured wall-to-roofline ratio).

The predictions drive four decision sites:

  * the micro-batcher's flush planner (``runtime/batching.py``
    ``_plan_flush``): the queue prefix with the best predicted goodput
    under the waiting requests' tightest deadline;
  * the engine's admission (``runtime/engine.py`` ``_submit``): a request
    whose predicted queue + dispatch wall exceeds ``shed_margin()`` times
    its remaining budget answers a typed 503 (``LoadShedError``, its message
    led by ``SHED_INFO_PREFIX``) before it takes a dispatch slot;
  * branch demotion in fused mode (``graph/fuse.py``: the per-router cost
    vectors of ``branch_cost_vector``) and in host mode
    (``graph/interpreter.py`` ``_autopilot_branch``).

Learning rides the telemetry spine: each dispatch record's wall folds into
the model on the drainer thread (``utils/hotrecord.py``), never on the
dispatch path; the per-branch walls are learned inline where the branch's
wall ends (the readback the response pays, or the host interpreter's
children).  Predictions are plain dict reads, and no decision site adds a
device sync.  ``GET /autopilot`` is the per-key table.

``SELDON_TPU_AUTOPILOT=0`` is the kill switch: every decision site restores
its earlier behaviour bit for bit (flush-all batching, no admission shed, no
branch demotion) while the model keeps learning.  Knobs:

  * ``SELDON_TPU_AUTOPILOT``             kill switch (default on)
  * ``SELDON_TPU_AUTOPILOT_LR``          online learning rate (0.3)
  * ``SELDON_TPU_AUTOPILOT_MIN_SAMPLES`` samples before a key's learned
                                         estimate is trusted outright (5)
  * ``SELDON_TPU_AUTOPILOT_SHED_MARGIN`` shed when predicted latency >
                                         margin x remaining budget (1.25)

``reset_learned_singletons`` drains the spine and resets the process-global
state that changes decisions (this ``AUTOPILOT``, the brownout ladder, the
fleet burn view and the cost ledger): what a test calls between cases.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir

__all__ = [
    "Autopilot",
    "AUTOPILOT",
    "autopilot_enabled",
    "shed_margin",
    "pad_bucket",
    "branch_key",
    "branch_cost_vector",
    "message_rows",
    "SHED_INFO_PREFIX",
    "reset_learned_singletons",
]

#: every LoadShedError message starts with this, and it is how the
#: gateway recognizes a predictive shed on the wire (apife.py): a shed
#: is an ENGINE DECISION, not replica sickness — it must count as load
#: for routing but never feed fail-degradation or the latency EWMA
SHED_INFO_PREFIX = "autopilot load shed"


def autopilot_enabled() -> bool:
    """Kill switch: ``SELDON_TPU_AUTOPILOT=0`` restores every decision
    site's pre-autopilot behaviour bit-for-bit (the model keeps learning
    off-path so flipping the switch back on starts warm)."""
    return os.environ.get("SELDON_TPU_AUTOPILOT", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def shed_margin() -> float:
    """Admission sheds when predicted latency exceeds ``margin`` x the
    remaining deadline budget.  The default 1.25 demands headroom beyond
    the model's typical ~25% misprediction before refusing work — a shed
    must be CONFIDENTLY doomed (shed precision stays >= 0.9), at the
    cost of letting marginal requests try and sometimes miss.  Lower
    toward 1.0 to shed earlier (more capacity saved, lower precision);
    raise to shed only on hopeless requests."""
    return _env_float("SELDON_TPU_AUTOPILOT_SHED_MARGIN", 1.25)


def pad_bucket(rows: int) -> int:
    """Power-of-two pad bucket for a row count — the same bucketing the
    MicroBatcher pads to and the balancer's shape models key on."""
    n = max(int(rows), 1)
    return 1 << (n - 1).bit_length()


def branch_key(node: str, branch: int, rows: Optional[int]) -> str:
    """Model key for one ROUTER branch at one request-shape bucket —
    the per-branch analogue of the per-executable key."""
    bucket = pad_bucket(rows) if rows else 1
    return f"branch:{node}/{int(branch)}[{bucket}]"


def branch_cost_vector(node: str, n_children: int,
                       rows: Optional[int]) -> "List[Optional[float]]":
    """Predicted wall seconds for EVERY branch of one router at one
    request-shape bucket (None = no prediction) — the shared rule behind
    both demotion sites: the host interpreter prices branches one
    ``predict_s`` at a time (graph/interpreter.py ``_autopilot_branch``)
    and the fused program receives this whole vector as a runtime
    argument (graph/fuse.py), so the two paths can never bucket or key a
    branch differently."""
    return [
        AUTOPILOT.predict_s(branch_key(node, b, rows))
        for b in range(int(n_children))
    ]


def message_rows(msg) -> Optional[int]:
    """Row count of a SeldonMessage's tensor payload (None for
    non-tensor payloads) — THE shape-bucketing rule every decision site
    shares (router branch keys), so the buckets cannot drift between
    layers.  A device tensor's shape is read without touching its data."""
    try:
        data = msg.data
        if data is None or data.array is None:
            return None
        shape = np.shape(data.array)
        return int(shape[0]) if len(shape) >= 2 else 1
    except Exception:  # noqa: BLE001 - shape probing must never fail a path
        return None


class _KeyModel:
    """Robust online latency estimate for one key: EWMA location with
    Huber-clipped residuals plus an EWMA absolute-deviation scale.  A
    single outlier moves the estimate by at most ``lr * OUTLIER_K *
    scale``; a sustained shift converges at the learning rate."""

    __slots__ = ("key", "n", "est_s", "scale_s", "last_s")

    def __init__(self, key: str):
        self.key = key
        self.n = 0
        self.est_s = 0.0
        self.scale_s = 0.0
        self.last_s = 0.0


class Autopilot:
    """Process-global per-key latency predictor.  All methods are cheap,
    lock-free (plain dict ops under the GIL — ``observe`` runs in the
    spine drainer, ``predict_s`` on decision sites) and never raise."""

    #: residuals are clipped at this many scales before they update the
    #: location — the "robust" in robust online regression
    OUTLIER_K = 4.0
    #: bounded model table: an exploding shape set must not grow memory;
    #: novel keys beyond the cap are simply not modelled (predict -> seed)
    MAX_KEYS = 256

    def __init__(
        self,
        lr: Optional[float] = None,
        min_samples: Optional[int] = None,
    ):
        self.lr = (
            lr if lr is not None
            else _env_float("SELDON_TPU_AUTOPILOT_LR", 0.3)
        )
        self.min_samples = int(
            min_samples if min_samples is not None
            else _env_float("SELDON_TPU_AUTOPILOT_MIN_SAMPLES", 5)
        )
        self._models: Dict[str, _KeyModel] = {}
        #: keys seeded from the durable perf corpus at boot (warm_start)
        self.warm_keys = 0
        #: |measured - predicted| / predicted per observed dispatch, the
        #: honesty figure behind seldon_tpu_autopilot_mispredict_pct
        self.mispredict_pct = Reservoir(1024)
        #: seed priors resolve through this hook (set to the perf
        #: observatory's seed_predicted_s below; injectable for tests)
        self.seed_fn: Optional[Callable[[str], Optional[float]]] = None

    # -- learning (off-path: the spine drainer calls this) ---------------

    def observe(self, key: str, seconds: float) -> Optional[float]:
        """Fold one measured wall time into the key's model.  Returns the
        prediction that was in force BEFORE this observation (None when
        the key had neither samples nor a seed) so the caller can stamp
        predicted-vs-measured onto the span it is folding."""
        if not key or seconds <= 0:
            return None
        pred = self.predict_s(key)
        m = self._models.get(key)
        if m is None:
            if len(self._models) >= self.MAX_KEYS:
                return pred
            m = self._models[key] = _KeyModel(key)
        if m.n == 0:
            m.est_s = float(seconds)
            # first-sample scale: half the observation — wide enough to
            # admit real movement, finite so clipping works immediately
            m.scale_s = float(seconds) * 0.5
        else:
            resid = float(seconds) - m.est_s
            lim = self.OUTLIER_K * max(m.scale_s, 1e-9)
            clipped = max(-lim, min(lim, resid))
            m.est_s += self.lr * clipped
            m.scale_s += self.lr * (min(abs(resid), lim) - m.scale_s)
        m.n += 1
        m.last_s = float(seconds)
        if pred is not None and pred > 0:
            self.mispredict_pct.observe(
                abs(float(seconds) - pred) / pred * 100.0
            )
        return pred

    def warm_start(self, entries) -> int:
        """Seed the model table from a prior process's compacted perf
        corpus (utils/perfcorpus.py) so a restarted engine prices
        previously-seen keys BEFORE its first dispatch.  Each entry is
        ``{key, n, est_s, scale_s, last_s}``; only keys with no live
        observations are seeded (a measurement always beats history),
        sample counts are capped so the learning rate keeps full
        authority over a warm key, and MAX_KEYS holds.  Returns the
        number of keys seeded."""
        seeded = 0
        for ent in entries:
            try:
                key = str(ent.get("key") or "")
                est = float(ent.get("est_s") or 0.0)
            except (TypeError, ValueError):
                continue
            if not key or est <= 0 or key in self._models:
                continue
            if len(self._models) >= self.MAX_KEYS:
                break
            m = _KeyModel(key)
            # cap the inherited weight: enough to be trusted outright
            # (n >= min_samples -> predict returns est_s), small enough
            # that the count stays honest about being historical
            m.n = min(max(int(ent.get("n") or 1), 1), 10 * self.min_samples)
            m.est_s = est
            scale = float(ent.get("scale_s") or 0.0)
            m.scale_s = scale if scale > 0 else est * 0.5
            m.last_s = float(ent.get("last_s") or est)
            self._models[key] = m
            seeded += 1
        self.warm_keys += seeded
        return seeded

    # -- prediction (decision sites) --------------------------------------

    def _seed_s(self, key: str) -> Optional[float]:
        if self.seed_fn is None:
            return None
        try:
            return self.seed_fn(key)
        except Exception:  # noqa: BLE001 - a prior must never fail a path
            return None

    def predict_s(self, key: str) -> Optional[float]:
        """Predicted wall seconds for one key: the learned estimate once
        ``min_samples`` dispatches are in, the seed prior before any, and
        a sample-count-weighted blend between (so the first measurements
        pull the roofline prior toward reality instead of snapping)."""
        m = self._models.get(key)
        if m is None or m.n == 0:
            return self._seed_s(key)
        if m.n >= self.min_samples:
            return m.est_s
        seed = self._seed_s(key)
        if seed is None:
            return m.est_s
        w = m.n / self.min_samples
        return w * m.est_s + (1.0 - w) * seed

    # -- surfaces ----------------------------------------------------------

    def publish_gauges(self) -> None:
        """Refresh the seldon_tpu_autopilot_* gauges — called from the
        spine's throttled gauge refresh, never per-request."""
        snap = self.mispredict_pct.snapshot()
        RECORDER.set_autopilot_model(
            mispredict_p50_pct=snap["p50"] if snap["count"] else None,
            keys=len(self._models),
        )

    def document(self) -> Dict[str, Any]:
        """The ``GET /autopilot`` body: knobs, the per-key model table
        (sorted by sample count), and the misprediction distribution."""
        rows: List[Dict[str, Any]] = []
        # list() under the GIL: the drainer inserts new keys concurrently
        # and a plain dict iteration would raise mid-growth
        for m in list(self._models.values()):
            pred = self.predict_s(m.key)
            seed = self._seed_s(m.key)
            rows.append({
                "key": m.key,
                "samples": m.n,
                "predicted_ms": (
                    None if pred is None else round(pred * 1e3, 4)
                ),
                "learned_ms": round(m.est_s * 1e3, 4) if m.n else None,
                "seed_ms": None if seed is None else round(seed * 1e3, 4),
                "scale_ms": round(m.scale_s * 1e3, 4),
                "last_ms": round(m.last_s * 1e3, 4),
                "trusted": m.n >= self.min_samples,
            })
        rows.sort(key=lambda r: r["samples"], reverse=True)
        snap = self.mispredict_pct.snapshot()
        sheds, decisions = RECORDER.autopilot_counters()
        return {
            "enabled": autopilot_enabled(),
            "knobs": {
                "kill_switch": "SELDON_TPU_AUTOPILOT",
                "lr": self.lr,
                "min_samples_before_trust": self.min_samples,
                "shed_margin": shed_margin(),
            },
            "keys": rows,
            "mispredict_pct": {
                k: round(snap[k], 3)
                for k in ("count", "mean", "p50", "p95", "p99", "max")
            },
            "sheds": sheds,
            "decisions": decisions,
        }

    def snapshot(self) -> Dict[str, Any]:
        """Compact health block — the full table lives on /autopilot."""
        snap = self.mispredict_pct.snapshot()
        return {
            "enabled": autopilot_enabled(),
            "keys": len(self._models),
            "warm_keys": self.warm_keys,
            "observations": snap["count"],
            "mispredict_p50_pct": round(snap["p50"], 2),
        }

    def reset(self) -> None:
        """Fresh state — tests and A/B bench arms only."""
        self._models = {}
        self.warm_keys = 0
        self.mispredict_pct = Reservoir(1024)


AUTOPILOT = Autopilot()


def _wire_seed() -> None:
    # seed priors come from the perf observatory's overhead-adjusted
    # roofline (late import: utils/perf.py must stay importable first)
    from seldon_core_tpu_torch.utils.perf import OBSERVATORY

    AUTOPILOT.seed_fn = OBSERVATORY.seed_predicted_s


_wire_seed()


def reset_learned_singletons() -> None:
    """Drain the telemetry spine, then reset the process-global state that
    changes decisions: ``AUTOPILOT`` (flush sizing, sheds, demotion),
    ``BROWNOUT`` (tier sheds, generation degradation), ``FLEET_BURN`` (the
    ladder's burn signal) and ``LEDGER`` (the usage-weighted fair queue), in
    that order.  The drain comes first so a previous run's pending dispatch
    records fold into the old table, not the fresh one.  The observing
    singletons (recorder, observatory, tracer) are left as they are."""
    from seldon_core_tpu_torch.runtime.brownout import BROWNOUT
    from seldon_core_tpu_torch.utils.costledger import LEDGER
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.quality import FLEET_BURN

    SPINE.drain()
    AUTOPILOT.reset()
    BROWNOUT.reset()
    FLEET_BURN.clear()
    LEDGER.reset()
