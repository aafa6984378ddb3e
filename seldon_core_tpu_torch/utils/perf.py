"""Performance observatory — per-executable cost accounting, MFU and
roofline classes, HBM watermarks, and metric-to-trace exemplars; the
port's counterpart of ``seldon_core_tpu/utils/perf.py``.

The flight recorder (utils/telemetry.py) says how many requests flow and
the causal tracer (utils/tracing.py) says where time goes, but neither
says whether the card itself is being used well: a dispatch running at 4%
MFU looks identical to one at 55%.

  * **Cost features**: the port has no XLA ``cost_analysis()``, so its
    counterpart is an analytic count registered where the JAX package's
    AOT capture runs (``record_compile`` from graph/compiled.py and
    graph/fuse.py, under the same ``executable_key``): the fused MLP's
    dispatch counts ``2·B·Σ d_in·d_out`` FLOPs and its weights, input and
    output as bytes (``ops/fused_mlp.py:dispatch_cost``); the generation
    scheduler registers ``gen_decode_step`` with the JAX package's own
    analytic formula (runtime/genserver.py); any other executable is a
    latency-only row.  The compile time recorded is the first call's
    wall, since the port runs eagerly.
  * **Dispatch time**: the measured wall combines with the features into
    achieved TFLOP/s, achieved GB/s, MFU against the device-kind-matched
    advertised peak (utils/chips.py), and a roofline class:
    compute-bound vs memory-bound by which peak binds first,
    overhead-bound when the measured time exceeds the roofline prediction
    by ``SELDON_TPU_PERF_OVERHEAD_X``.  The wall runs from the dispatch's
    start to the end of the readback the response already makes (a CUDA
    launch returns before its work ends; no sync is added to measure):
    it is wall to readback, not kernel time, exactly as the JAX
    package's ``block_until_ready`` figure is.
  * **Anomalies**: ``seldon_tpu_perf_anomaly_total{kind}`` fires when a
    dispatch drifts past ``SELDON_TPU_PERF_ANOMALY_FACTOR`` x its own
    executable's rolling p50 (``kind="slow_dispatch"``) or its rolling
    measured/predicted ratio (``kind="ratio_drift"``).
  * **HBM watermarks**: ``torch.cuda.memory_stats()`` (current and peak
    allocated bytes) and ``torch.cuda.mem_get_info()`` (the card's total)
    polled into ``seldon_tpu_hbm_*`` gauges; a CPU engine reports
    ``memory_stats: null`` rows.

Surfaces: ``GET /perf`` (engine + unit) renders the per-executable table;
``seldon_tpu_dispatch_seconds`` histogram observations carry OpenMetrics
exemplars with the active ``trace_id``; dispatch spans gain ``flops`` /
``mfu`` / ``bound`` attributes.

Everything is process-global (module global ``OBSERVATORY``) and never
raises into the hot path.  ``SELDON_TPU_PERF=0`` disables capture
entirely.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.utils.chips import chip_peak_hbm_gbs, chip_peak_tflops
from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir

__all__ = [
    "PerfObservatory",
    "OBSERVATORY",
    "executable_key",
    "extract_cost_features",
]


@functools.lru_cache(maxsize=1024)
def executable_key(name: str, shape, dtype) -> str:
    """Canonical per-executable identity: program name + input shape +
    post-canonicalization dtype (x64 demotion means the dtype that actually
    compiled, not the dtype the client sent).  Shared by the compile-time
    capture (graph/compiled.py) and the dispatch-time observation
    (runtime/engine.py) so both sides name the same executable.  Cached:
    the dispatch hot path names its executable twice per batch (once per
    side), and dtype canonicalization + string building should cost a
    dict hit.

    The canonical dtype is the JAX package's with x64 off (float64 ->
    float32, int64 -> int32, uint64 -> uint32, complex128 -> complex64),
    so one request gives the same key in both packages; a torch dtype
    (``torch.bfloat16``) is named as numpy names it (``bfloat16``)."""
    dname = _dtype_name(dtype)
    return "%s[%s/%s]" % (
        name, "x".join(str(int(d)) for d in shape), _X64_DEMOTE.get(dname, dname)
    )


#: the JAX package's dtype canonicalization with x64 off
_X64_DEMOTE = {"float64": "float32", "int64": "int32", "uint64": "uint32",
               "complex128": "complex64"}


def _dtype_name(dtype) -> str:
    """A numpy dtype, a torch dtype or a dtype name, as numpy names it."""
    if hasattr(dtype, "is_floating_point") or str(dtype).startswith("torch."):
        return str(dtype).split(".", 1)[1]
    return np.dtype(dtype).name


def extract_cost_features(cost: Any) -> Optional[Dict[str, float]]:
    """Normalize whatever ``cost_analysis()`` returned — a dict, a list of
    dicts (one per partition), or nothing — into
    ``{flops, bytes_accessed, output_bytes}``.  Returns None when the
    backend yields no usable features (the caller degrades to
    latency-only accounting); negative/zero FLOPs count as absent (some
    backends report -1 for "unknown")."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else None
    if not isinstance(cost, dict):
        return None
    flops = cost.get("flops")
    bytes_accessed = cost.get("bytes accessed")
    output_bytes = None
    for k in ("bytes accessed output", "bytes accessedout{}"):
        if k in cost:
            output_bytes = cost[k]
            break
    out: Dict[str, float] = {}
    if flops is not None and float(flops) > 0:
        out["flops"] = float(flops)
    if bytes_accessed is not None and float(bytes_accessed) > 0:
        out["bytes_accessed"] = float(bytes_accessed)
    if output_bytes is not None and float(output_bytes) > 0:
        out["output_bytes"] = float(output_bytes)
    return out or None


class _ExecutableStats:
    """Everything the observatory knows about one compiled executable."""

    __slots__ = (
        "key", "cost", "compile_s", "calls", "rows_total", "latency",
        "ratio", "calibration", "last", "anomalies", "phases",
    )

    def __init__(self, key: str):
        self.key = key
        self.cost: Optional[Dict[str, float]] = None
        self.compile_s: Optional[float] = None
        #: fused-graph per-node phase decomposition ({node: share of the
        #: program's FLOPs}, graph/fuse.py) — how a one-program-per-graph
        #: executable still itemizes on the /perf table
        self.phases: Optional[Dict[str, float]] = None
        self.calls = 0
        self.rows_total = 0
        self.latency = Reservoir(512)
        #: rolling measured/predicted ratios — the drift baseline
        self.ratio = Reservoir(512)
        #: rolling measured / (overhead-adjusted roofline) ratios — the
        #: per-pad-bucket calibration the autopilot's seed prior uses
        self.calibration = Reservoir(256)
        #: most recent derived figures (mfu, tflops, gbs, bound, ratio)
        self.last: Dict[str, Any] = {}
        self.anomalies = 0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class PerfObservatory:
    """Process-global per-executable performance accounting.  All record
    methods are cheap and never raise — instrumentation must not grow
    failure modes on the dispatch hot path."""

    #: bounded executable table: an exploding shape set must not grow
    #: memory; overflow dispatches aggregate under one key
    MAX_EXECUTABLES = 64
    OVERFLOW_KEY = "other"

    def __init__(
        self,
        enabled: Optional[bool] = None,
        anomaly_factor: Optional[float] = None,
        overhead_x: Optional[float] = None,
        min_calls: int = 10,
        hbm_poll_interval_s: float = 5.0,
    ):
        if enabled is None:
            enabled = os.environ.get("SELDON_TPU_PERF", "1") != "0"
        self.enabled = bool(enabled)
        #: a dispatch beyond factor x its executable's rolling p50 (or
        #: rolling ratio median) is an anomaly
        self.anomaly_factor = (
            anomaly_factor
            if anomaly_factor is not None
            else _env_float("SELDON_TPU_PERF_ANOMALY_FACTOR", 3.0)
        )
        #: measured/predicted beyond this classifies overhead-bound: the
        #: device work the roofline prices is a sliver of the wall time
        self.overhead_x = (
            overhead_x
            if overhead_x is not None
            else _env_float("SELDON_TPU_PERF_OVERHEAD_X", 10.0)
        )
        self.min_calls = int(min_calls)
        self.hbm_poll_interval_s = float(hbm_poll_interval_s)
        self._lock = threading.Lock()
        self._execs: Dict[str, _ExecutableStats] = {}
        #: micro-batcher padding accounting (runtime/batching.py): pad rows
        #: are pure waste FLOPs — the compiler fodder share of device work
        self.real_rows_total = 0
        self.pad_rows_total = 0
        self._peaks: Optional[Dict[str, Any]] = None
        #: the device the engine serves on (``set_device``): peaks and HBM
        #: watermarks read this card, or report the CPU
        self._device_type = "cpu"
        self._device_index = 0
        self._hbm_last_poll = 0.0
        self._hbm_last: List[Dict[str, Any]] = []
        #: telemetry-spine wiring (utils/hotrecord.py), set on the global
        #: OBSERVATORY only: dispatch observations arrive via the fused
        #: per-hop record, so query surfaces fold pending records first
        self.drain_hook = None

    def _drain(self) -> None:
        if self.drain_hook is not None:
            self.drain_hook()

    # -- device peaks ------------------------------------------------------

    def peaks(self) -> Dict[str, Any]:
        """Device identity + advertised peaks (lazy; cached).  A CUDA
        engine reads ``torch.cuda.get_device_name()`` with platform
        ``"gpu"``; a CPU engine (``set_device`` with a CPU device, or no
        card) reads ``"cpu"`` and normalizes against the assumed
        defaults."""
        if self._peaks is not None:
            return self._peaks
        device_kind, platform = "cpu", "cpu"
        if self._device_type == "cuda":
            try:
                import torch

                device_kind = str(torch.cuda.get_device_name(self._device_index))
                platform = "gpu"
            except Exception:  # noqa: BLE001 - no card: assumed peaks
                device_kind, platform = "cpu", "cpu"
        tflops, tflops_assumed = chip_peak_tflops(device_kind)
        hbm_gbs, hbm_assumed = chip_peak_hbm_gbs(device_kind)
        self._peaks = {
            "device_kind": device_kind,
            "platform": platform,
            "peak_bf16_tflops": tflops,
            "peak_hbm_gbs": hbm_gbs,
            "peak_assumed": bool(tflops_assumed or hbm_assumed),
        }
        return self._peaks

    # -- recording ---------------------------------------------------------

    def _entry(self, key: str) -> _ExecutableStats:
        ent = self._execs.get(key)
        if ent is None:
            with self._lock:
                ent = self._execs.get(key)
                if ent is None:
                    if len(self._execs) >= self.MAX_EXECUTABLES:
                        key = self.OVERFLOW_KEY
                        ent = self._execs.get(key)
                        if ent is None:
                            ent = self._execs[key] = _ExecutableStats(key)
                        return ent
                    ent = self._execs[key] = _ExecutableStats(key)
        return ent

    def record_compile(
        self,
        key: str,
        cost: Optional[Dict[str, float]],
        compile_s: Optional[float],
    ) -> None:
        """Static cost features + compile wall time for one executable
        (called once per compiled shape, graph/compiled.py)."""
        if not self.enabled:
            return
        ent = self._entry(key)
        with self._lock:
            # the shared overflow entry must not carry any one shape's
            # cost features — derived figures for unrelated shapes would
            # divide by the wrong FLOP count
            if cost is not None and ent.key != self.OVERFLOW_KEY:
                ent.cost = dict(cost)
            if compile_s is not None:
                ent.compile_s = float(compile_s)
        if compile_s is not None:
            RECORDER.record_compile_seconds(compile_s)

    def note_phases(self, key: str, phases: Dict[str, float]) -> None:
        """Attach a fused graph's per-node phase decomposition to one
        executable row (graph/fuse.py) so the /perf table itemizes a
        one-program-per-graph dispatch per node."""
        if not self.enabled or not phases:
            return
        ent = self._entry(key)
        with self._lock:
            if ent.key != self.OVERFLOW_KEY:
                ent.phases = dict(phases)

    def observe_dispatch(
        self,
        key: str,
        seconds: float,
        rows: Optional[int] = None,
        trace_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Combine one measured dispatch with the executable's static cost
        features.  Returns the derived figures (mfu/bound/flops/...) so
        the caller can stamp them onto its dispatch span; {} when the
        observatory is disabled."""
        if not self.enabled or seconds <= 0:
            return {}
        ent = self._entry(key)
        overflow = ent.key == self.OVERFLOW_KEY
        # anomaly baselines BEFORE this observation joins the window
        base = ent.latency.snapshot() if ent.calls >= self.min_calls else None
        ratio_base = (
            ent.ratio.snapshot() if len(ent.ratio) >= self.min_calls else None
        )
        ent.latency.observe(seconds)
        with self._lock:
            ent.calls += 1
            if rows:
                ent.rows_total += int(rows)
            cost = None if overflow else ent.cost
        derived: Dict[str, Any] = {}
        slowdown = None  # measured time as a multiple of the roofline
        peaks = self.peaks()
        if cost:
            flops = cost.get("flops", 0.0)
            nbytes = cost.get("bytes_accessed", 0.0)
            peak_flops_s = peaks["peak_bf16_tflops"] * 1e12
            peak_bytes_s = peaks["peak_hbm_gbs"] * 1e9
            t_compute = flops / peak_flops_s if flops else 0.0
            t_memory = nbytes / peak_bytes_s if nbytes else 0.0
            predicted_s = max(t_compute, t_memory)
            if flops:
                derived["flops"] = flops
                derived["achieved_tflops"] = flops / seconds / 1e12
                derived["mfu"] = flops / seconds / peak_flops_s
            if nbytes:
                derived["achieved_gbs"] = nbytes / seconds / 1e9
                if flops:
                    derived["arithmetic_intensity"] = flops / nbytes
            if predicted_s > 0:
                slowdown = seconds / predicted_s
                derived["predicted_s"] = predicted_s
                # the WALL-time prior is the overhead-adjusted roofline:
                # raw roofline prices device work only, and overhead_x is
                # already the configured device-vs-wall factor (the same
                # one the overhead-bound classification below uses).
                # Using it on BOTH sides keeps this ratio, the per-bucket
                # calibration, and the autopilot's seed prior
                # (seed_predicted_s) in agreement — before this fix the
                # /perf page showed raw-roofline ratios while the
                # overhead classification judged the adjusted time
                adjusted_s = predicted_s * self.overhead_x
                derived["adjusted_predicted_s"] = adjusted_s
                # reads in name order: predicted over measured, 1.0 =
                # wall time exactly at the overhead-adjusted roofline
                derived["predicted_vs_measured"] = adjusted_s / seconds
                ent.calibration.observe(seconds / adjusted_s)
                ent.ratio.observe(slowdown)
                if slowdown > self.overhead_x:
                    derived["bound"] = "overhead"
                else:
                    derived["bound"] = (
                        "compute" if t_compute >= t_memory else "memory"
                    )
        RECORDER.observe_dispatch(
            ent.key, seconds,
            mfu=derived.get("mfu"), trace_id=trace_id,
        )
        # drift detection against the executable's OWN history — no
        # hardware-dependent thresholds.  The shared overflow entry mixes
        # unrelated shapes, so its baselines mean nothing: never fire
        anomaly = None
        if overflow:
            base = ratio_base = None
        if base is not None and base["p50"] > 0:
            if (
                seconds > self.anomaly_factor * base["p50"]
                and seconds - base["p50"] > 1e-3
            ):
                anomaly = "slow_dispatch"
        if (
            anomaly is None
            and slowdown is not None
            and ratio_base is not None
            and ratio_base["p50"] > 0
            and slowdown > self.anomaly_factor * ratio_base["p50"]
        ):
            anomaly = "ratio_drift"
        if anomaly is not None:
            with self._lock:
                ent.anomalies += 1
            derived["anomaly"] = anomaly
            RECORDER.record_perf_anomaly(anomaly)
        with self._lock:
            ent.last = dict(derived)
        return derived

    def seed_predicted_s(self, key: str) -> Optional[float]:
        """The autopilot's seed prior for one executable/pad bucket:
        overhead-adjusted roofline time (``cost_analysis()`` features x
        ``SELDON_TPU_PERF_OVERHEAD_X`` — the same adjusted time
        ``predicted_vs_measured`` reports) scaled by the measured
        calibration ratio — this key's own rolling median when it has
        dispatched, else the median across every calibrated executable
        (so a never-dispatched pad bucket inherits the box's measured
        wall-vs-roofline behaviour).  None when the key has no cost
        features (the autopilot then waits for measurements)."""
        if not self.enabled:
            return None
        ent = self._execs.get(key)
        if ent is None or ent.key == self.OVERFLOW_KEY or not ent.cost:
            return None
        cost = ent.cost
        peaks = self.peaks()
        t_compute = cost.get("flops", 0.0) / (
            peaks["peak_bf16_tflops"] * 1e12
        )
        t_memory = cost.get("bytes_accessed", 0.0) / (
            peaks["peak_hbm_gbs"] * 1e9
        )
        roofline = max(t_compute, t_memory)
        if roofline <= 0:
            return None
        adjusted = roofline * self.overhead_x
        cal = ent.calibration.snapshot()
        if cal["count"]:
            return adjusted * cal["p50"]
        # cross-bucket transfer: the median of every calibrated key's
        # median — one slow shape cannot skew it the way a mean would
        with self._lock:
            entries = list(self._execs.values())
        medians = sorted(
            c["p50"] for c in (e.calibration.snapshot() for e in entries)
            if c["count"]
        )
        if medians:
            return adjusted * medians[len(medians) // 2]
        return adjusted

    def cost_features(self, key: str) -> Optional[Dict[str, float]]:
        """One executable's registered static cost features (or None) —
        the read side of ``record_compile`` for derived-figure consumers
        (the generation flight recorder prices served decode MFU off the
        ``gen_decode_step`` features the scheduler registers)."""
        if not self.enabled:
            return None
        ent = self._execs.get(key)
        if ent is None or not ent.cost:
            return None
        with self._lock:
            return dict(ent.cost)

    def note_padding(self, real_rows: int, padded_rows: int) -> None:
        """Micro-batcher padding accounting: pad rows burn FLOPs without
        serving traffic (runtime/batching.py reports each padded chunk)."""
        if not self.enabled:
            return
        with self._lock:
            self.real_rows_total += int(real_rows)
            self.pad_rows_total += int(padded_rows) - int(real_rows)

    # -- HBM watermarks ----------------------------------------------------

    def hbm_watermarks(self, force: bool = False) -> List[Dict[str, Any]]:
        """The card's memory watermarks, throttled (scrapes and /perf polls
        share one cached reading per interval): ``bytes_in_use`` and
        ``peak_bytes_in_use`` from ``torch.cuda.memory_stats()`` (the
        caching allocator's current and peak allocated bytes) and
        ``bytes_limit`` from ``torch.cuda.mem_get_info()`` (the card's
        total), published as the ``seldon_tpu_hbm_*`` gauges.  A CPU
        engine reports a ``memory_stats: null`` row and sets no gauges —
        never raises.  ``SELDON_TPU_PERF=0`` really is the kill switch:
        disabled, no device call happens even from the scrape path."""
        if not self.enabled:
            return []
        now = time.monotonic()
        if not force and now - self._hbm_last_poll < self.hbm_poll_interval_s:
            return self._hbm_last
        self._hbm_last_poll = now
        label = f"{self._device_type}:{self._device_index}"
        if self._device_type != "cuda":
            self._hbm_last = [{"device": label, "memory_stats": None}]
            return self._hbm_last
        try:
            import torch

            stats = torch.cuda.memory_stats(self._device_index)
            _free, total = torch.cuda.mem_get_info(self._device_index)
        except Exception:  # noqa: BLE001 - no card after all
            self._hbm_last = [{"device": label, "memory_stats": None}]
            return self._hbm_last
        row = {
            "device": label,
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
        RECORDER.set_hbm(
            label,
            bytes_in_use=row["bytes_in_use"],
            peak_bytes_in_use=row["peak_bytes_in_use"],
            bytes_limit=row["bytes_limit"],
        )
        self._hbm_last = [row]
        return self._hbm_last

    def set_device(self, device) -> None:
        """Bind the observatory to the card an engine serves on (a
        ``torch.device``): the peaks and the watermarks read it.  A CPU
        device keeps the assumed peaks and null memory rows."""
        dtype = getattr(device, "type", str(device))
        index = getattr(device, "index", None)
        if dtype == "cuda" and index is None:
            try:
                import torch

                index = torch.cuda.current_device()
            except Exception:  # noqa: BLE001
                index = 0
        index = int(index or 0)
        if (dtype, index) != (self._device_type, self._device_index):
            self._device_type, self._device_index = dtype, index
            self._peaks = None
            self._hbm_last_poll = 0.0

    # -- snapshots ---------------------------------------------------------

    def _row(self, ent: _ExecutableStats) -> Dict[str, Any]:
        lat = ent.latency.snapshot()
        row: Dict[str, Any] = {
            "executable": ent.key,
            "calls": ent.calls,
            "rows": ent.rows_total,
            "latency_ms": {
                k: round(lat[k] * 1e3, 3)
                for k in ("mean", "p50", "p95", "p99", "max")
            },
            "compile_s": (
                None if ent.compile_s is None else round(ent.compile_s, 4)
            ),
            "anomalies": ent.anomalies,
        }
        if ent.phases:
            row["phases"] = dict(ent.phases)
        cost = ent.cost
        if cost:
            row["flops"] = cost.get("flops")
            row["bytes_accessed"] = cost.get("bytes_accessed")
            row["output_bytes"] = cost.get("output_bytes")
            if cost.get("flops") and cost.get("bytes_accessed"):
                row["arithmetic_intensity"] = round(
                    cost["flops"] / cost["bytes_accessed"], 3
                )
        cal = ent.calibration.snapshot()
        if cal["count"]:
            # measured wall / overhead-adjusted roofline, rolling median
            # per pad bucket — 1.0 = the adjusted prior prices this
            # bucket exactly; the autopilot seed (seed_predicted_s) and
            # this figure agree by construction
            row["calibration_ratio"] = float("%.4g" % cal["p50"])
        last = ent.last
        if last:
            for k in ("mfu", "achieved_tflops", "achieved_gbs",
                      "predicted_vs_measured"):
                if k in last:
                    # significant figures, not decimal places: CPU-backend
                    # MFU is legitimately ~1e-8 and must not round to 0
                    row[k] = float("%.4g" % float(last[k]))
            if "bound" in last:
                row["bound"] = last["bound"]
        return row

    def document(self) -> Dict[str, Any]:
        """The ``GET /perf`` body: device identity + peaks, per-executable
        table (calls, latency percentiles, MFU, arithmetic intensity,
        predicted-vs-measured, compile time), batching pad overhead, and
        HBM watermarks."""
        self._drain()
        with self._lock:
            entries = list(self._execs.values())
            real, pad = self.real_rows_total, self.pad_rows_total
        rows = sorted(
            (self._row(e) for e in entries),
            key=lambda r: r["calls"], reverse=True,
        )
        doc: Dict[str, Any] = {
            "enabled": self.enabled,
            "device": self.peaks(),
            "executables": rows,
            "hbm": self.hbm_watermarks(),
            "anomaly_factor": self.anomaly_factor,
            "overhead_x": self.overhead_x,
        }
        if real or pad:
            doc["batching"] = {
                "real_rows_total": real,
                "pad_rows_total": pad,
                "pad_overhead_pct": round(100.0 * pad / max(real + pad, 1), 2),
            }
        return doc

    def snapshot(self) -> Dict[str, Any]:
        """Compact health block for ``/stats`` — the full table lives on
        ``/perf``."""
        self._drain()
        with self._lock:
            n = len(self._execs)
            calls = sum(e.calls for e in self._execs.values())
            anomalies = sum(e.anomalies for e in self._execs.values())
        return {
            "enabled": self.enabled,
            "executables": n,
            "dispatches": calls,
            "anomalies": anomalies,
        }

    def reset(self) -> None:
        """Fresh state — tests only."""
        self._drain()  # pending records fold into the pre-reset state
        with self._lock:
            self._execs = {}
            self.real_rows_total = 0
            self.pad_rows_total = 0
            self._hbm_last_poll = 0.0
            self._hbm_last = []


OBSERVATORY = PerfObservatory()
