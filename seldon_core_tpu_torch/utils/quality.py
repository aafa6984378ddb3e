"""Prediction-quality observatory — drift detection, feedback/reward
accounting and SLO burn-rate tracking; the port's counterpart of
``seldon_core_tpu/utils/quality.py``.

The flight recorder says how many requests flow, the causal tracer where
time goes, the perf observatory whether the card is used well; this module
watches whether the PREDICTIONS are still good, with three instruments:

  * **Drift detection**: per graph node, a frozen **reference window**
    (``SELDON_TPU_QUALITY_REF_ROWS`` rows, per-feature bin edges at the
    reference's quantiles) plus a rolling **live window** of sampled
    inputs and predictions.  The per-batch update (per-feature bin counts
    against the edges, sums and sums of squares, a prediction histogram)
    is one summarize of the dispatch's batch, folded off-path on the
    telemetry spine's drainer thread (``utils/hotrecord.py``).
    Live-vs-reference distance is scored as **PSI** and a **KS
    statistic** per feature plus a prediction-distribution PSI.
  * **Feedback accounting**: ``send_feedback`` rewards and
    truth-vs-prediction agreement fold into rolling per-predictor
    reward/accuracy; the MAB router's state (``success`` / ``tries``) is
    read back into per-branch reward, routing share and regret
    (``router_quality``).
  * **SLO engine**: latency/error objectives (``SELDON_TPU_SLO_P99_MS``,
    ``SELDON_TPU_SLO_ERROR_RATE``) tracked as 5m/1h burn rates over the
    request stream ``MetricsRegistry.time_server`` observes.

The summarizer: the reference sends batches of at least
``SELDON_TPU_QUALITY_JIT_MIN_ROWS`` rows through a jitted ``jnp`` program
and smaller ones through its numpy twin ``_summarize_np``.  The port's
counterpart of the jitted program is ``_summarize_torch``, plain torch on
the engine's device (the card): it runs on the drainer thread, under
``torch.inference_mode``, on a CUDA stream of the observatory's own (never
the dispatch stream; a device batch from a host-mode node is waited on by
an event its producer recorded), and its only readback is its six small
results packed in one float64 vector.  A bin is the number of thresholds
``t`` with ``x >= t``, by comparison (NaN compares False and lands in bin
0, as in the reference; ``torch.searchsorted`` would put it past every
edge); counts are integers equal to ``_summarize_np``'s, sums float32 as
in the jitted reference.  There is nothing to compile, so
``_warm_summarizer`` only marks a shape ready in ``_jit_ready``;
``summarizer_rows`` / ``summarizer_batches`` count what each path served.

Surfaces: ``GET /quality``, ``POST /quality/reference`` (freeze/reset the
reference window), the ``quality`` and ``routers`` keys of ``/stats``, the
``seldon_tpu_drift_score`` / ``seldon_tpu_prediction_quantile`` /
``seldon_tpu_feedback_*`` / ``seldon_tpu_outlier_*`` /
``seldon_tpu_slo_burn_rate`` / ``seldon_tpu_quality_sampled_total``
families, drift stamped on dispatch spans and audit lines.

Everything is process-global (``QUALITY``) and never raises into the hot
path.  ``SELDON_TPU_QUALITY=0`` disables the subsystem;
``SELDON_TPU_QUALITY_SAMPLE`` (0..1, decided once per batch) bounds its
cost under load.  Not ported: the gateway's fleet-truth burn publisher (the
gateway is not ported); ``FLEET_BURN`` and ``effective_burn_rate`` are, and
read the local ring while nothing publishes.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir

__all__ = [
    "QualityObservatory",
    "QUALITY",
    "SloTracker",
    "FleetBurnView",
    "FLEET_BURN",
    "fleet_burn_enabled",
    "effective_burn_rate",
    "router_quality",
    "psi",
    "ks_statistic",
    "parse_reference_action",
]

logger = logging.getLogger(__name__)

#: proportion floor for PSI's log ratio: keeps an empty bin finite
_EPS_P = 1e-6


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _np64(a) -> np.ndarray:
    """A host float64 array of ``a``: a tensor (on any device, bf16 too) is
    moved to the host first, which ``np.asarray`` of a CUDA tensor cannot
    do."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def _rows2d(a):
    """``a`` as [rows, features], tensor or array alike."""
    if isinstance(a, torch.Tensor):
        return a.reshape(a.shape[0], -1)
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1)


# ---------------------------------------------------------------------------
# score math (numpy on the small aggregated count vectors)
# ---------------------------------------------------------------------------


def _proportions(counts) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum(axis=-1, keepdims=True)
    return counts / np.maximum(total, 1.0)


def psi(ref_counts, live_counts) -> np.ndarray:
    """Population Stability Index between binned distributions (last axis
    = bins; leading axes broadcast); proportions floored at 1e-6."""
    p = np.clip(_proportions(ref_counts), _EPS_P, None)
    q = np.clip(_proportions(live_counts), _EPS_P, None)
    return ((q - p) * np.log(q / p)).sum(axis=-1)


def ks_statistic(ref_counts, live_counts) -> np.ndarray:
    """Kolmogorov–Smirnov distance between binned distributions: the max
    absolute CDF gap across bin boundaries."""
    p = _proportions(ref_counts).cumsum(axis=-1)
    q = _proportions(live_counts).cumsum(axis=-1)
    return np.abs(q - p).max(axis=-1)


# ---------------------------------------------------------------------------
# the batched summarizer and its numpy twin
# ---------------------------------------------------------------------------


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _summarize_torch(X, Y, x_thr, y_thr, n, device=None):
    """The device summarizer: ``_summarize_np``'s six results for the first
    ``n`` rows of X [N, F] and Y [N, C] (arrays or tensors), computed in
    torch on ``device`` (X's own when X is a tensor) and read back once.

    Bin counts come from cumulative ``>=``-threshold counts (bin b =
    count(>= thr[b-1]) - count(>= thr[b])), integers throughout; sums and
    sums of squares are float32."""
    dev = X.device if isinstance(X, torch.Tensor) else torch.device(device or "cpu")
    n = int(n)
    # the real rows only, before any copy to the device
    Xt = _as_f32(_rows2d(X)[:n], dev)
    Yt = _as_f32(_rows2d(Y)[:n], dev)
    xt = torch.as_tensor(np.asarray(x_thr, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y_thr, np.float32), device=dev)
    F, C = Xt.shape[1], Yt.shape[1]
    gcounts = (Xt[:, :, None] >= xt[None, :, :]).sum(0)                  # [F, B-1] int64
    full = torch.full((F, 1), n, dtype=gcounts.dtype, device=dev)
    zero = torch.zeros((F, 1), dtype=gcounts.dtype, device=dev)
    x_counts = torch.cat([full, gcounts], 1) - torch.cat([gcounts, zero], 1)
    ygc = (Yt[:, :, None] >= yt[None, None, :]).sum((0, 1))              # [B-1] int64
    ny = torch.full((1,), n * C, dtype=ygc.dtype, device=dev)
    y_counts = torch.cat([ny, ygc]) - torch.cat([ygc, ny.new_zeros(1)])
    packed = torch.cat([
        x_counts.reshape(-1).double(), Xt.sum(0).double(), (Xt * Xt).sum(0).double(),
        y_counts.double(), Yt.sum().double()[None], (Yt * Yt).sum().double()[None],
    ]).cpu().numpy()
    B = x_counts.shape[1]
    o = 0
    xc = packed[o:o + F * B].reshape(F, B)
    o += F * B
    xs = packed[o:o + F].astype(np.float32)
    o += F
    xss = packed[o:o + F].astype(np.float32)
    o += F
    yc = packed[o:o + len(y_counts)]
    o += len(y_counts)
    return xc, xs, xss, yc, float(packed[o]), float(packed[o + 1])


def _summarize_np(X, Y, x_thr, y_thr, n):
    """Numpy twin of the summarizer: small batches, and the cross-check
    oracle in tests.  Identical counts by construction."""
    X = np.asarray(X, dtype=np.float32)[:n]
    Y = np.asarray(Y, dtype=np.float32).reshape(len(Y), -1)[:n]
    F = X.shape[1]
    gcounts = (X[:, :, None] >= x_thr[None, :, :]).sum(0).astype(np.float64)
    lower = np.concatenate([np.full((F, 1), float(len(X))), gcounts], axis=1)
    upper = np.concatenate([gcounts, np.zeros((F, 1))], axis=1)
    x_counts = lower - upper
    ygc = (Y[:, :, None] >= y_thr[None, None, :]).sum((0, 1)).astype(np.float64)
    ny = float(len(Y) * Y.shape[1])
    y_counts = np.concatenate([[ny], ygc]) - np.concatenate([ygc, [0.0]])
    return (
        x_counts, X.sum(0), (X * X).sum(0),
        y_counts, float(Y.sum()), float((Y * Y).sum()),
    )


# ---------------------------------------------------------------------------
# per-node windows
# ---------------------------------------------------------------------------


class _NodeQuality:
    """Reference + rolling live window for one graph node."""

    def __init__(self, node: str, n_bins: int, ref_target: int,
                 live_window: int, score_interval_s: float = 0.25):
        self.node = node
        self.n_bins = int(n_bins)
        self.ref_target = int(ref_target)
        self.live_window = int(live_window)  # live batches retained
        #: PSI/KS rescore throttle: the first live batch always scores,
        #: then at most once an interval; every read surface rescores
        self.score_interval_s = float(score_interval_s)
        self._scored_at = 0.0
        self.lock = threading.Lock()
        #: bumped on every clear/freeze: an observation summarized against
        #: superseded thresholds must not land in the new window
        self.generation = 0
        self._clear()

    def _clear(self) -> None:
        self.generation += 1
        self.frozen = False
        self._ref_x: List[np.ndarray] = []
        self._ref_y: List[np.ndarray] = []
        self._ref_width: Optional[int] = None
        self._ref_y_width: Optional[int] = None
        self.ref_rows = 0
        self.x_thr: Optional[np.ndarray] = None   # [F, B-1]
        self.y_thr: Optional[np.ndarray] = None   # [B-1]
        self.ref_x_counts: Optional[np.ndarray] = None  # [F, B]
        self.ref_y_counts: Optional[np.ndarray] = None  # [B]
        self.ref_x_mean: Optional[np.ndarray] = None
        self.ref_x_std: Optional[np.ndarray] = None
        self.sampled_batches = 0
        self.sampled_rows = 0
        self.width_mismatches = 0
        self._blocks: deque = deque()
        self.live_x_counts: Optional[np.ndarray] = None
        self.live_x_sum: Optional[np.ndarray] = None
        self.live_x_sumsq: Optional[np.ndarray] = None
        self.live_y_counts: Optional[np.ndarray] = None
        self.live_rows = 0
        self.last_scores: Dict[str, float] = {}

    # -- reference ---------------------------------------------------------

    def _collect_reference(self, X: np.ndarray, Y: np.ndarray) -> None:
        # one feature width per node: the first seen wins, others are
        # counted and skipped (a mixed-width node would never freeze)
        if self._ref_width is None:
            self._ref_width = X.shape[1]
            self._ref_y_width = Y.shape[1]
        elif X.shape[1] != self._ref_width or Y.shape[1] != self._ref_y_width:
            self.width_mismatches += 1
            return
        self._ref_x.append(np.asarray(X, dtype=np.float64))
        self._ref_y.append(np.asarray(Y, dtype=np.float64).reshape(len(Y), -1))
        self.ref_rows += len(X)
        if self.ref_rows >= self.ref_target:
            self._freeze()

    def _freeze(self) -> bool:
        """Fix the collected rows as the reference: per-feature bin edges at
        the reference's quantiles, reference counts/mean/std, an empty live
        window.  False when nothing was collected yet."""
        if not self._ref_x:
            return False
        self.generation += 1
        ref = np.concatenate(self._ref_x, axis=0)
        ref_y = np.concatenate(self._ref_y, axis=0).reshape(-1)
        B = self.n_bins
        qs = np.arange(1, B) / B
        # inner thresholds: the bin of x = #(x >= thr) in [0, B-1]
        self.x_thr = np.quantile(ref, qs, axis=0).T.astype(np.float32)
        self.y_thr = np.quantile(ref_y, qs).astype(np.float32)
        F = ref.shape[1]
        counts, _, _, yc, _, _ = _summarize_np(
            ref, np.concatenate(self._ref_y, axis=0), self.x_thr, self.y_thr, len(ref))
        self.ref_x_counts = counts
        self.ref_y_counts = yc
        self.ref_x_mean = ref.mean(axis=0)
        self.ref_x_std = ref.std(axis=0) + 1e-12
        self.ref_rows = len(ref)
        self._ref_x = []
        self._ref_y = []
        self.frozen = True
        self._blocks = deque()
        self.live_x_counts = np.zeros((F, self.n_bins))
        self.live_x_sum = np.zeros(F)
        self.live_x_sumsq = np.zeros(F)
        self.live_y_counts = np.zeros(self.n_bins)
        self.live_rows = 0
        self.last_scores = {}
        return True

    # -- live --------------------------------------------------------------

    def _push_block(self, x_counts, x_sum, x_sumsq, y_counts, rows) -> None:
        self._blocks.append((x_counts, x_sum, x_sumsq, y_counts, rows))
        self.live_x_counts += x_counts
        self.live_x_sum += x_sum
        self.live_x_sumsq += x_sumsq
        self.live_y_counts += y_counts
        self.live_rows += rows
        while len(self._blocks) > self.live_window:
            oc, osum, osq, oyc, orows = self._blocks.popleft()
            self.live_x_counts -= oc
            self.live_x_sum -= osum
            self.live_x_sumsq -= osq
            self.live_y_counts -= oyc
            self.live_rows -= orows

    def _maybe_score(self) -> Dict[str, float]:
        """Throttled rescore for the per-batch fold: {} while the current
        scores are fresh (callers then reuse ``last_scores``)."""
        now = time.monotonic()
        if self.last_scores and now - self._scored_at < self.score_interval_s:
            return {}
        self._scored_at = now
        return self._score()

    def _score(self) -> Dict[str, float]:
        if not self.frozen or self.live_rows <= 0:
            return {}
        x_psi = psi(self.ref_x_counts, self.live_x_counts)
        x_ks = ks_statistic(self.ref_x_counts, self.live_x_counts)
        y_psi = float(psi(self.ref_y_counts, self.live_y_counts))
        self._x_psi = x_psi
        self._x_ks = x_ks
        self.last_scores = {
            "psi_max": float(x_psi.max()),
            "psi_mean": float(x_psi.mean()),
            "ks_max": float(x_ks.max()),
            "prediction_psi": y_psi,
        }
        return self.last_scores

    def prediction_quantiles(self) -> Dict[str, float]:
        """Approximate live prediction quantiles off the binned CDF (the
        upper bin threshold where the CDF crosses q)."""
        if not self.frozen or self.live_rows <= 0 or self.y_thr is None \
                or len(self.y_thr) == 0:
            return {}
        cdf = _proportions(self.live_y_counts).cumsum()
        out = {}
        for q in (0.5, 0.9, 0.99):
            j = int(np.searchsorted(cdf, q))
            out[str(q)] = float(self.y_thr[min(j, len(self.y_thr) - 1)])
        return out

    def document_row(self, top_k: int = 16) -> Dict[str, Any]:
        if self.frozen and self.live_rows > 0:
            # read surfaces always serve a fresh score
            self._scored_at = time.monotonic()
            self._score()
        row: Dict[str, Any] = {
            "node": self.node,
            "status": "live" if self.frozen else "collecting_reference",
            "sampled_batches": self.sampled_batches,
            "sampled_rows": self.sampled_rows,
            "ref_rows": self.ref_rows,
            "live_rows": int(self.live_rows),
        }
        if self.width_mismatches:
            row["width_mismatches"] = self.width_mismatches
        if self.frozen and self.last_scores:
            row["drift"] = {k: round(v, 6) for k, v in self.last_scores.items()}
            live_n = max(self.live_rows, 1)
            live_mean = self.live_x_sum / live_n
            order = np.argsort(self._x_psi)[::-1][:top_k]
            row["top_features"] = [
                {
                    "feature": int(i),
                    "psi": round(float(self._x_psi[i]), 6),
                    "ks": round(float(self._x_ks[i]), 6),
                    "ref_mean": round(float(self.ref_x_mean[i]), 6),
                    "live_mean": round(float(live_mean[i]), 6),
                }
                for i in order
            ]
            pq = self.prediction_quantiles()
            if pq:
                row["prediction_quantiles"] = {k: round(v, 6) for k, v in pq.items()}
        return row


# ---------------------------------------------------------------------------
# SLO burn-rate engine
# ---------------------------------------------------------------------------


class SloTracker:
    """Multi-window SLO burn rates over the request stream.

    Objectives: ``SELDON_TPU_SLO_P99_MS`` (at most 1% of requests over the
    target: latency budget 0.01) and ``SELDON_TPU_SLO_ERROR_RATE``
    (allowed 5xx fraction).  Burn rate per window = the bad fraction over
    the budget.  Events land in per-second slots of a fixed ring;
    ``record()`` is O(1), window sums happen on read."""

    WINDOWS = (("5m", 300), ("1h", 3600))
    HORIZON = 3600
    LATENCY_BUDGET = 0.01
    #: finite stand-in for "infinite burn" (JSON-safe)
    BURN_CAP = 1e6

    def __init__(self, p99_ms: Optional[float] = None,
                 error_rate: Optional[float] = None,
                 horizon: Optional[int] = None):
        self.p99_ms = p99_ms if p99_ms is not None else _env_float("SELDON_TPU_SLO_P99_MS")
        self.error_rate = (error_rate if error_rate is not None
                           else _env_float("SELDON_TPU_SLO_ERROR_RATE"))
        # a smaller horizon shrinks the ring and drops the windows it
        # cannot cover (the per-tenant trackers use 300 s)
        self.horizon = int(horizon) if horizon else self.HORIZON
        self.windows = tuple(
            (name, w) for name, w in self.WINDOWS if w <= self.horizon
        ) or (self.WINDOWS[0],)
        self._lock = threading.Lock()
        self._sec = np.zeros(self.horizon, dtype=np.int64)
        self._counts = np.zeros((self.horizon, 3), dtype=np.int64)

    @property
    def configured(self) -> bool:
        return self.p99_ms is not None or self.error_rate is not None

    def record(self, latency_s: float, error: bool = False,
               now: Optional[float] = None) -> None:
        ts = int(now if now is not None else time.time())
        i = ts % self.horizon
        with self._lock:
            if self._sec[i] != ts:
                self._sec[i] = ts
                self._counts[i] = 0
            self._counts[i, 0] += 1
            if self.p99_ms is not None and latency_s * 1e3 > self.p99_ms:
                self._counts[i, 1] += 1
            if error:
                self._counts[i, 2] += 1

    def window_counts(self, now: Optional[float] = None) -> Dict[str, Dict[str, int]]:
        """Raw ``{window: {total, slow, errors}}`` sums (counts sum across
        replicas; rates do not)."""
        ts = int(now if now is not None else time.time())
        with self._lock:
            sec = self._sec.copy()
            counts = self._counts.copy()
        out: Dict[str, Dict[str, int]] = {}
        for name, w in self.windows:
            mask = (sec > ts - w) & (sec <= ts)
            total, slow, errors = (int(v) for v in counts[mask].sum(axis=0))
            out[name] = {"total": total, "slow": slow, "errors": errors}
        return out

    @classmethod
    def burn_entry(cls, total: int, slow: int, errors: int,
                   p99_ms: Optional[float],
                   error_rate: Optional[float]) -> Dict[str, Any]:
        """Burn math over one window's counts: the one rule behind the local
        ``burn_rates`` read and a fleet fold of summed counts."""
        entry: Dict[str, Any] = {"requests": total}
        burns = []
        if p99_ms is not None:
            lb = (slow / total) / cls.LATENCY_BUDGET if total else 0.0
            entry["latency_burn"] = round(lb, 4)
            burns.append(lb)
        if error_rate is not None:
            # an explicit zero budget: any error burns at the cap
            if not total:
                eb = 0.0
            elif error_rate > 0:
                eb = min((errors / total) / error_rate, cls.BURN_CAP)
            else:
                eb = 0.0 if errors == 0 else cls.BURN_CAP
            entry["error_burn"] = round(eb, 4)
            burns.append(eb)
        rate = max(burns) if burns else 0.0
        entry["burn_rate"] = round(rate, 4)
        entry["budget_remaining"] = round(max(0.0, 1.0 - rate), 4)
        return entry

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, Any]:
        return {
            name: self.burn_entry(c["total"], c["slow"], c["errors"],
                                  self.p99_ms, self.error_rate)
            for name, c in self.window_counts(now).items()
        }

    def snapshot(self) -> Dict[str, Any]:
        return {
            "p99_ms": self.p99_ms,
            "error_rate": self.error_rate,
            "configured": self.configured,
            "windows": self.burn_rates(),
        }

    def reset_events(self) -> None:
        with self._lock:
            self._sec[:] = 0
            self._counts[:] = 0


# ---------------------------------------------------------------------------
# fleet-truth burn (federated gateway replicas publish into it)
# ---------------------------------------------------------------------------


def fleet_burn_enabled() -> bool:
    """``SELDON_TPU_FLEET_BURN=0``: no fleet view is read, every consumer
    reads its own per-replica burn."""
    return os.environ.get("SELDON_TPU_FLEET_BURN", "1") != "0"


def _fleet_burn_stale_s() -> float:
    return _env_float("SELDON_TPU_FLEET_BURN_STALE_S") or 15.0


class FleetBurnView:
    """Process-global holder of the fleet-truth burn aggregate: publish/read
    under a lock with a freshness bound, so a wedged publisher degrades to
    the per-replica fallback instead of freezing a stale fleet number."""

    def __init__(self):
        self._lock = threading.Lock()
        self._doc: Optional[Dict[str, Any]] = None
        self._set_at = 0.0

    def publish(self, doc: Dict[str, Any]) -> None:
        with self._lock:
            self._doc = doc
            self._set_at = time.monotonic()

    def clear(self) -> None:
        with self._lock:
            self._doc = None
            self._set_at = 0.0

    def age_s(self) -> Optional[float]:
        with self._lock:
            if self._doc is None:
                return None
            return time.monotonic() - self._set_at

    def fresh(self) -> bool:
        age = self.age_s()
        return age is not None and age <= _fleet_burn_stale_s()

    def burn_rate(self, window: str = "5m") -> Optional[float]:
        """The fleet burn for one window; None when switched off, never
        published, or stale."""
        if not fleet_burn_enabled() or not self.fresh():
            return None
        with self._lock:
            doc = self._doc
        try:
            entry = (doc or {}).get("windows", {}).get(window)
            if entry is None:
                return None
            return float(entry["burn_rate"])
        except (KeyError, TypeError, ValueError):
            return None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            doc = dict(self._doc) if self._doc else None
        age = self.age_s()
        return {
            "enabled": fleet_burn_enabled(),
            "fresh": self.fresh(),
            "age_s": None if age is None else round(age, 3),
            "stale_after_s": _fleet_burn_stale_s(),
            "view": doc,
        }


FLEET_BURN = FleetBurnView()


def effective_burn_rate(window: str = "5m") -> Optional[float]:
    """The burn number decision sites act on: the fleet aggregate when a
    fresh one exists, the local ring otherwise, the max of both when both
    do; None when neither has a signal."""
    local: Optional[float] = None
    if QUALITY.slo.configured:
        entry = QUALITY.slo.burn_rates().get(window)
        if entry is not None:
            local = float(entry["burn_rate"])
    fleet = FLEET_BURN.burn_rate(window)
    if fleet is None:
        return local
    if local is None:
        return fleet
    return max(local, fleet)


# ---------------------------------------------------------------------------
# MAB router read-back
# ---------------------------------------------------------------------------


def router_quality(states: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-branch reward/share/regret read out of bandit state.

    Any node state shaped like the MAB router's (``success`` / ``tries``
    1-D, ``models/mab.py``) yields a row; the reward rate is the router's
    own Laplace-smoothed ratio, so the best branch is the one ``route()``
    exploits.  Regret per branch = tries x (best rate - branch rate).  The
    port's router state is torch tensors on the engine's device: each is
    moved to the host before numpy reads it."""
    out: Dict[str, Any] = {}
    for name, st in (states or {}).items():
        try:
            if not isinstance(st, dict) or "success" not in st or "tries" not in st:
                continue
            s = _np64(st["success"])
            t = _np64(st["tries"])
            if s.shape != t.shape or s.ndim != 1:
                continue
        except Exception:  # noqa: BLE001 - odd state leaf: not a bandit
            continue
        ratio = (s + 1.0) / (t + 1.0)
        best = float(ratio.max())
        total = float(t.sum())
        out[name] = {
            "best_branch": int(np.argmax(ratio)),
            "total_tries": total,
            "total_regret": round(float((t * (best - ratio)).sum()), 4),
            "branches": [
                {
                    "branch": i,
                    "tries": float(t[i]),
                    "success": float(s[i]),
                    "reward_rate": round(float(ratio[i]), 4),
                    "share": round(float(t[i] / total), 4) if total else 0.0,
                    "regret": round(float(t[i] * (best - ratio[i])), 4),
                }
                for i in range(len(t))
            ],
        }
    return out


# ---------------------------------------------------------------------------
# feedback accounting helpers
# ---------------------------------------------------------------------------


def _agreement(prediction, truth) -> Optional[float]:
    """Truth-vs-prediction agreement fraction: multi-column outputs compare
    per-row argmax, everything else values within a relative tolerance.
    None when the shapes cannot be compared."""
    if prediction is None or truth is None:
        return None
    try:
        p = np.atleast_2d(_np64(prediction))
        t = np.atleast_2d(_np64(truth))
        if p.ndim == 2 and t.ndim == 2 and p.shape == t.shape and p.shape[-1] > 1:
            return float((p.argmax(axis=-1) == t.argmax(axis=-1)).mean())
        pf, tf = p.reshape(-1), t.reshape(-1)
        if pf.size != tf.size or pf.size == 0:
            return None
        return float((np.abs(pf - tf) <= 1e-6 + 1e-3 * np.abs(tf)).mean())
    except Exception:  # noqa: BLE001 - uncomparable payloads
        return None


class _FeedbackStats:
    __slots__ = ("count", "reward", "truth_count", "agree_rows", "truth_rows")

    def __init__(self):
        self.count = 0
        self.reward = Reservoir(2048)
        self.truth_count = 0
        self.agree_rows = 0.0
        self.truth_rows = 0.0

    def snapshot(self) -> Dict[str, Any]:
        r = self.reward.snapshot()
        out = {
            "count": self.count,
            "mean_reward": round(r["mean"], 6),
            "truth_provided": self.truth_count,
        }
        if self.truth_rows > 0:
            out["accuracy"] = round(self.agree_rows / self.truth_rows, 6)
        return out


# ---------------------------------------------------------------------------
# the observatory
# ---------------------------------------------------------------------------


class QualityObservatory:
    """Process-global prediction-quality accounting.  Record methods are
    cheap and never raise."""

    #: bounded node table
    MAX_NODES = 64

    def __init__(
        self,
        enabled: Optional[bool] = None,
        sample: Optional[float] = None,
        n_bins: int = 10,
        ref_target: Optional[int] = None,
        live_window: int = 64,
        outlier_threshold: Optional[float] = None,
        use_numpy: bool = False,
    ):
        if enabled is None:
            enabled = os.environ.get("SELDON_TPU_QUALITY", "1") != "0"
        self.enabled = bool(enabled)
        if sample is None:
            sample = _env_float("SELDON_TPU_QUALITY_SAMPLE")
            sample = 1.0 if sample is None else sample
        self.sample = min(max(float(sample), 0.0), 1.0)
        self.n_bins = int(n_bins)
        if ref_target is None:
            rt = _env_float("SELDON_TPU_QUALITY_REF_ROWS")
            ref_target = 256 if rt is None else int(rt)
        self.ref_target = max(int(ref_target), 2)
        self.live_window = int(live_window)
        self.outlier_threshold = (
            outlier_threshold if outlier_threshold is not None
            else _env_float("SELDON_TPU_OUTLIER_THRESHOLD")
        )
        self.use_numpy = bool(use_numpy)
        interval_ms = _env_float("SELDON_TPU_QUALITY_SCORE_MS")
        self.score_interval_s = 0.25 if interval_ms is None else max(interval_ms, 0.0) / 1e3
        jit_min = _env_float("SELDON_TPU_QUALITY_JIT_MIN_ROWS")
        self.jit_min_rows = 32 if jit_min is None else int(jit_min)
        self._lock = threading.Lock()
        self._nodes: Dict[str, _NodeQuality] = {}
        self._feedback: Dict[str, _FeedbackStats] = {}
        #: summarizer shapes marked ready (``_warm_summarizer``)
        self._jit_ready: set = set()
        #: the device a host batch is summarized on (``set_device``; the
        #: engine's), and the observatory's own CUDA stream per card
        self.device = torch.device("cpu")
        self._streams: Dict[Any, Any] = {}
        #: batches / rows each summarizer served
        self.summarizer_batches = {"torch": 0, "numpy": 0}
        self.summarizer_rows = {"torch": 0, "numpy": 0}
        self._rng = random.Random(0xC0FFEE)
        self.slo = SloTracker()
        # per-tenant SLO rings: the same objectives, 5m-horizon rings,
        # LRU-bounded
        self._tenant_slo: "OrderedDict[str, SloTracker]" = OrderedDict()
        self.outlier = Reservoir(2048)
        self.outlier_total = 0
        self.outlier_exceeded = 0
        self.errors = 0
        #: telemetry-spine wiring (utils/hotrecord.py), set on the global
        #: QUALITY only: query and control surfaces fold pending dispatch
        #: records before reading
        self.drain_hook = None

    def set_device(self, device) -> None:
        """The device host batches (the engine's stacked rows and readback)
        are summarized on: the engine's card."""
        self.device = torch.device(device) if device is not None else torch.device("cpu")

    def _drain(self) -> None:
        if self.drain_hook is not None:
            self.drain_hook()

    def _bump_errors(self) -> None:
        with self._lock:
            self.errors += 1

    # -- node windows ------------------------------------------------------

    def _node(self, name: str) -> Optional[_NodeQuality]:
        ent = self._nodes.get(name)
        if ent is None:
            with self._lock:
                ent = self._nodes.get(name)
                if ent is None:
                    if len(self._nodes) >= self.MAX_NODES:
                        return None
                    ent = self._nodes[name] = _NodeQuality(
                        name, self.n_bins, self.ref_target, self.live_window,
                        score_interval_s=self.score_interval_s)
        return ent

    def observe_batch(self, node: str, X, Y,
                      real_rows: Optional[int] = None) -> Optional[float]:
        """One dispatched batch's inputs + predictions (``real_rows`` masks
        pad rows out).  Returns the node's current PSI max for span
        stamping, or None when nothing was recorded.  The per-batch sample
        decision happens here, once."""
        if not self.enabled or self.sample <= 0.0:
            return None
        if self.sample < 1.0 and self._rng.random() >= self.sample:
            return None
        try:
            return self._observe(node, X, Y, real_rows)
        except Exception:  # noqa: BLE001 - never raise into dispatch
            self._bump_errors()
            logger.debug("quality observe failed", exc_info=True)
            return None

    def fold_batch(self, node: str, X, Y, real_rows: Optional[int] = None,
                   ready=None) -> Optional[float]:
        """Pre-sampled observe: the telemetry spine drainer's entry point
        (the sample verdict rode the record).  ``ready``: a CUDA event the
        producer of device tensors X / Y recorded after them."""
        if not self.enabled:
            return None
        try:
            return self._observe(node, X, Y, real_rows, ready)
        except Exception:  # noqa: BLE001 - never raise into the drainer
            self._bump_errors()
            logger.debug("quality fold failed", exc_info=True)
            return None

    def _summarize_device(self, X, Y, x_thr, y_thr, n, ready):
        """``_summarize_torch`` on X's device (a tensor's) or the
        observatory's, on its own stream when that is a card."""
        dev = X.device if isinstance(X, torch.Tensor) else self.device
        with torch.inference_mode():
            if dev.type != "cuda":
                return _summarize_torch(X, Y, x_thr, y_thr, n, device=dev)
            key = (dev.type, dev.index)
            stream = self._streams.get(key)
            if stream is None:
                stream = self._streams.setdefault(key, torch.cuda.Stream(device=dev))
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                return _summarize_torch(X, Y, x_thr, y_thr, n, device=dev)

    def _observe(self, node: str, X, Y, real_rows: Optional[int],
                 ready=None) -> Optional[float]:
        ent = self._node(node)
        if ent is None:
            return None
        n = int(real_rows) if real_rows is not None else int(
            X.shape[0] if hasattr(X, "shape") else np.shape(X)[0])
        if n <= 0:
            return None
        RECORDER.record_quality_sampled(node)
        with ent.lock:
            ent.sampled_batches += 1
            ent.sampled_rows += n
            if not ent.frozen:
                Xn = _np64(X)[:n].reshape(n, -1)
                Yn = _np64(Y)[:n].reshape(n, -1)
                ent._collect_reference(Xn, Yn)
                return None
            # the window's identity and thresholds, captured under the lock:
            # the summarize below runs lock-free
            gen = ent.generation
            x_thr, y_thr = ent.x_thr, ent.y_thr
            F, y_width = x_thr.shape[0], ent._ref_y_width
        Xa = _rows2d(X)
        Ya = _rows2d(Y)
        # both widths must match the frozen reference
        if Xa.shape[1] != F or Ya.shape[1] != y_width:
            with ent.lock:
                ent.width_mismatches += 1
            return None
        on_device = not (self.use_numpy or Xa.shape[0] < self.jit_min_rows)
        if on_device:
            key = (1 << max(Xa.shape[0] - 1, 0).bit_length(), Xa.shape[1], Ya.shape[1],
                   self.n_bins)
            if key not in self._jit_ready:
                self._warm_summarizer(key)
            x_counts, x_sum, x_sumsq, y_counts, _, _ = self._summarize_device(
                Xa, Ya, x_thr, y_thr, n, ready)
            path = "torch"
        else:
            x_counts, x_sum, x_sumsq, y_counts, _, _ = _summarize_np(
                _np64(Xa) if isinstance(Xa, torch.Tensor) else Xa,
                _np64(Ya) if isinstance(Ya, torch.Tensor) else Ya, x_thr, y_thr, n)
            path = "numpy"
        with self._lock:
            self.summarizer_batches[path] += 1
            self.summarizer_rows[path] += n
        x_counts, x_sum, x_sumsq, y_counts = (
            np.asarray(a, dtype=np.float64) for a in (x_counts, x_sum, x_sumsq, y_counts))
        with ent.lock:
            if not ent.frozen or ent.generation != gen:
                # the reference was reset or refrozen meanwhile: counts binned
                # against the old edges must not enter the new window
                return None
            ent._push_block(x_counts, x_sum, x_sumsq, y_counts, n)
            scores = ent._maybe_score()
            pq = ent.prediction_quantiles() if scores else {}
            drift = ent.last_scores.get("psi_max")
        if scores:
            RECORDER.set_drift(node, "psi", scores["psi_max"])
            RECORDER.set_drift(node, "ks", scores["ks_max"])
            RECORDER.set_drift(node, "prediction", scores["prediction_psi"])
        for q, v in pq.items():
            RECORDER.set_prediction_quantile(node, q, v)
        return drift

    def _warm_summarizer(self, key) -> None:
        """Mark one (batch, widths, bins) shape ready: the reference
        compiles its jitted program for it on a thread; torch has nothing
        to compile."""
        with self._lock:
            self._jit_ready.add(key)

    def last_drift(self, node: str) -> Optional[float]:
        """Most recent PSI max for a node (stamped on audit lines); when
        the node has no window (host-mode engines record per model node),
        the worst live node in the process."""
        self._drain()
        ent = self._nodes.get(node)
        v = ent.last_scores.get("psi_max") if ent is not None else None
        if v is None:
            with self._lock:
                scores = [e.last_scores["psi_max"] for e in self._nodes.values()
                          if "psi_max" in e.last_scores]
            v = max(scores) if scores else None
        return None if v is None else round(v, 4)

    # -- reference control -------------------------------------------------

    def reference_control(self, action: str, node: Optional[str] = None) -> Dict[str, Any]:
        """``freeze``: promote the collected window of every (or one) node to
        the reference; ``reset``: drop reference + live and collect afresh."""
        if action not in ("freeze", "reset"):
            raise ValueError(f"unknown reference action {action!r} (expected freeze|reset)")
        # rows already served must land in the window this call changes
        self._drain()
        done: Dict[str, str] = {}
        with self._lock:
            if node:
                # a named node must resolve: a typo must not reset them all
                targets = [self._nodes[node]] if node in self._nodes else []
            else:
                targets = list(self._nodes.values())
        if node and not targets:
            return {"action": action, "nodes": {node: "unknown_node"},
                    "enabled": self.enabled}
        for ent in targets:
            with ent.lock:
                if action == "reset":
                    ent._clear()
                    done[ent.node] = "reset"
                elif ent.frozen:
                    # a re-freeze needs fresh raw rows: collection restarts
                    ent._clear()
                    done[ent.node] = "recollecting"
                else:
                    done[ent.node] = "frozen" if ent._freeze() else "no_rows"
            # published gauges must not outlive the window they scored
            if done[ent.node] in ("reset", "recollecting"):
                RECORDER.clear_drift(ent.node)
        return {"action": action, "nodes": done, "enabled": self.enabled}

    # -- feedback ----------------------------------------------------------

    def record_feedback(self, predictor: str, reward: float, truth=None,
                        prediction=None) -> None:
        """Fold one send_feedback into rolling per-predictor reward and
        truth-vs-prediction accuracy (+ the seldon_tpu_feedback_* families)."""
        if not self.enabled:
            return
        try:
            agreement = _agreement(prediction, truth)
            with self._lock:
                ent = self._feedback.get(predictor)
                if ent is None:
                    if len(self._feedback) >= self.MAX_NODES:
                        return
                    ent = self._feedback[predictor] = _FeedbackStats()
            rows = (max(int(np.atleast_2d(_np64(truth)).shape[0]), 1)
                    if agreement is not None else 0)
            with self._lock:
                ent.count += 1
                if truth is not None:
                    ent.truth_count += 1
                if agreement is not None:
                    ent.truth_rows += rows
                    ent.agree_rows += agreement * rows
            ent.reward.observe(float(reward))
            RECORDER.record_feedback_event(float(reward), truth_provided=truth is not None,
                                           agreement=agreement)
        except Exception:  # noqa: BLE001
            self._bump_errors()
            logger.debug("quality feedback failed", exc_info=True)

    # -- outlier bridge ----------------------------------------------------

    def record_outlier_tags(self, tags: Optional[Dict[str, Any]],
                            real_rows: Optional[int] = None) -> None:
        """Bridge the Mahalanobis outlier scores out of
        ``meta.tags['outlierScore']`` (``models/outlier.py``) into the
        ``seldon_tpu_outlier_score`` family and the /quality block;
        ``SELDON_TPU_OUTLIER_THRESHOLD`` exceedances count separately."""
        if not self.enabled or not tags or "outlierScore" not in tags:
            return
        try:
            scores = _np64(tags["outlierScore"]).reshape(-1)
            if real_rows is not None:
                scores = scores[: int(real_rows)]
            if scores.size == 0:
                return
            n = (int((scores > self.outlier_threshold).sum())
                 if self.outlier_threshold is not None else 0)
            with self._lock:
                self.outlier_total += int(scores.size)
                self.outlier_exceeded += n
            self.outlier.observe_many(scores)
            RECORDER.record_outlier_scores(scores)
            if n:
                RECORDER.record_outlier_exceeded(n)
        except Exception:  # noqa: BLE001
            self._bump_errors()
            logger.debug("outlier bridge failed", exc_info=True)

    # -- SLO ---------------------------------------------------------------

    #: bound on tracked tenant SLO rings (LRU past it)
    MAX_TENANTS = 256
    #: per-tenant ring horizon: the 5m window only
    TENANT_HORIZON_S = 300

    def record_request(self, latency_s: float, error: bool = False,
                       now: Optional[float] = None) -> None:
        """One served request into the SLO engine (fed by
        ``MetricsRegistry.time_server`` on the predictions service)."""
        if not self.enabled:
            return
        self.slo.record(latency_s, error=error, now=now)

    def record_tenant_request(self, tenant: str, latency_s: float, error: bool = False,
                              now: Optional[float] = None) -> None:
        """Per-tenant SLO accounting: one hog's burned budget stays
        attributable on ``GET /quality``."""
        if not self.enabled or not tenant:
            return
        with self._lock:
            t = self._tenant_slo.get(tenant)
            if t is None:
                while len(self._tenant_slo) >= self.MAX_TENANTS:
                    self._tenant_slo.popitem(last=False)
                t = self._tenant_slo[tenant] = SloTracker(
                    p99_ms=self.slo.p99_ms, error_rate=self.slo.error_rate,
                    horizon=self.TENANT_HORIZON_S)
            else:
                self._tenant_slo.move_to_end(tenant)
        t.record(latency_s, error=error, now=now)

    def tenant_slo_block(self) -> Dict[str, Any]:
        """{tenant: burn windows}, bounded by MAX_TENANTS."""
        with self._lock:
            trackers = list(self._tenant_slo.items())
        return {tenant: tracker.burn_rates() for tenant, tracker in trackers}

    def tenant_window_counts(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """{tenant: {window: counts}} raw sums."""
        with self._lock:
            trackers = list(self._tenant_slo.items())
        return {tenant: tracker.window_counts() for tenant, tracker in trackers}

    def refresh_gauges(self) -> None:
        """Recompute the seldon_tpu_slo_burn_rate and drift gauges (called
        at scrape time, so a scrape-only deployment sees live scores; drift
        is force-rescored, as the /quality page does)."""
        if not self.enabled:
            return
        try:
            for window, entry in self.slo.burn_rates().items():
                RECORDER.set_slo_burn(window, entry["burn_rate"])
            with self._lock:
                nodes = list(self._nodes.values())
            for ent in nodes:
                with ent.lock:
                    if not ent.frozen or ent.live_rows <= 0:
                        continue
                    ent._scored_at = time.monotonic()
                    scores = ent._score()
                    pq = ent.prediction_quantiles()
                if scores:
                    RECORDER.set_drift(ent.node, "psi", scores["psi_max"])
                    RECORDER.set_drift(ent.node, "ks", scores["ks_max"])
                    RECORDER.set_drift(ent.node, "prediction", scores["prediction_psi"])
                for q, v in pq.items():
                    RECORDER.set_prediction_quantile(ent.node, q, v)
        except Exception:  # noqa: BLE001 - a scrape must never fail here
            self._bump_errors()

    # -- snapshots ---------------------------------------------------------

    def outlier_block(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "scores": self.outlier.snapshot(),
            "total": self.outlier_total,
            "threshold": self.outlier_threshold,
        }
        if self.outlier_threshold is not None:
            out["exceeded"] = self.outlier_exceeded
        return out

    def document(self) -> Dict[str, Any]:
        """The ``GET /quality`` body: per-node drift table, feedback
        reward/accuracy, the outlier bridge, SLO burn rates."""
        self._drain()
        self.refresh_gauges()
        with self._lock:
            nodes = list(self._nodes.values())
            fb = {k: v.snapshot() for k, v in self._feedback.items()}
        rows = []
        for ent in nodes:
            with ent.lock:
                rows.append(ent.document_row())
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "n_bins": self.n_bins,
            "ref_target": self.ref_target,
            "nodes": sorted(rows, key=lambda r: r["node"]),
            "feedback": fb,
            "outliers": self.outlier_block(),
            "slo": self.slo.snapshot(),
            "tenant_slo": self.tenant_slo_block(),
            "fleet_burn": FLEET_BURN.snapshot(),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Compact health block for ``/stats``."""
        self._drain()
        with self._lock:
            nodes = {
                name: {
                    "status": "live" if ent.frozen else "collecting_reference",
                    "sampled_rows": ent.sampled_rows,
                    **{k: round(v, 6) for k, v in ent.last_scores.items()},
                }
                for name, ent in self._nodes.items()
            }
            fb_count = sum(v.count for v in self._feedback.values())
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "nodes": nodes,
            "feedback_count": fb_count,
            "outliers_scored": self.outlier_total,
            "slo_configured": self.slo.configured,
            "tenants_tracked": len(self._tenant_slo),
            "errors": self.errors,
        }

    def reset(self) -> None:
        """Fresh state — tests only (config survives)."""
        self._drain()  # pending records fold into the pre-reset state
        with self._lock:
            self._nodes = {}
            self._feedback = {}
            self._rng = random.Random(0xC0FFEE)
            self.outlier = Reservoir(2048)
            self.outlier_total = 0
            self.outlier_exceeded = 0
            self.errors = 0
            self._tenant_slo = OrderedDict()
            self.summarizer_batches = {"torch": 0, "numpy": 0}
            self.summarizer_rows = {"torch": 0, "numpy": 0}
        self.slo.reset_events()


def parse_reference_action(body, action: Optional[str] = None, node: Optional[str] = None):
    """POST /quality/reference payload -> ``(action, node)``.  Query
    ``?action=`` / ``?node=`` win; else a JSON body ``{"action":
    "freeze"|"reset", "node": "<name>"}``; action defaults to freeze, node
    to all nodes.  Raises ValueError on anything else (a 400)."""
    candidate = action or None
    if (candidate is None or node is None) and body:
        text = body.decode("utf-8", "replace") if isinstance(body, bytes) else str(body)
        text = text.strip()
        if text:
            try:
                doc = json.loads(text)
            except ValueError:
                raise ValueError("reference body must be JSON")
            if isinstance(doc, dict):
                if candidate is None and "action" in doc:
                    candidate = str(doc["action"])
                if node is None and "node" in doc:
                    node = str(doc["node"])
            elif isinstance(doc, str) and candidate is None:
                candidate = doc
    candidate = candidate or "freeze"
    if candidate not in ("freeze", "reset"):
        raise ValueError(f"unknown reference action {candidate!r} (expected freeze|reset)")
    return candidate, node


QUALITY = QualityObservatory()
