"""Firehose replay — vet a candidate predictor on recorded traffic before
it ever sees a user; the port's copy of ``seldon_core_tpu/runtime/replay.py``.

The gateway's audit firehose (gateway/firehose.py) keeps one JSONL
line per served request: ``{puid, deployment, ts, request, response}``.
This module replays those lines against a *candidate* predictor and diffs
every answer against the recorded live one:

  * **prediction disagreement** — ``messages.prediction_delta``, the same
    rule the shadow mirror applies to live traffic, so an offline verdict
    and a live shadow read on the same scale;
  * **error delta** — recorded FAILURE rate vs the candidate's;
  * **latency** — the candidate's own percentiles (recorded lines carry
    no latency, so there is nothing dishonest to compare against);
  * **prediction drift** — PSI between the recorded and candidate
    prediction distributions (utils/quality.py ``psi`` over a shared
    histogram), i.e. "would the quality observatory have paged".

Pacing: ``max`` replays as fast as the candidate admits (``concurrency``
in flight), ``recorded`` honors the recorded inter-arrival gaps scaled by
``speed`` (2.0 = twice as fast — the time-warp knob).

The outcome is a **verdict artifact** (JSON): counters, percentiles, the
gates that were checked, and ``verdict: "pass"|"fail"`` with the breached
reasons — the document a rollout pipeline checks before ever granting a
candidate stage 1 of live traffic (operator/rollouts.py).

Targets: an in-process engine-like object (anything with ``async
predict(SeldonMessage)``, the port's ``EngineService`` for one), a base URL
(the engine REST contract, ``POST /api/v0.1/predictions``, over the port's
stdlib ``runtime/client.py`` ``HttpClient``), or a deployment spec file +
predictor name (boots a throwaway in-process port EngineService on
``--device``, ``cuda`` unless asked for the CPU).  CLI::

    python -m seldon_core_tpu_torch.runtime.replay firehose.jsonl \
        --spec examples/canary_deployment.json --predictor canary \
        --out replay_verdict.json [--pace recorded --speed 10] [--device cpu]
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np

from seldon_core_tpu_torch.messages import (
    SeldonMessage,
    SeldonMessageError,
    prediction_delta,
)
from seldon_core_tpu_torch.utils.telemetry import Reservoir

__all__ = ["ReplayGates", "ReplayTarget", "replay_events", "replay_file",
           "load_firehose_events"]


@dataclass
class ReplayGates:
    """Verdict thresholds; None disables a gate."""

    max_disagreement: Optional[float] = 0.02   # mean per-request disagree
    max_error_rate_delta: Optional[float] = 0.01
    max_prediction_psi: Optional[float] = 0.25
    max_latency_p50_ms: Optional[float] = None
    min_requests: int = 10

    def to_json_dict(self) -> dict:
        return {
            "max_disagreement": self.max_disagreement,
            "max_error_rate_delta": self.max_error_rate_delta,
            "max_prediction_psi": self.max_prediction_psi,
            "max_latency_p50_ms": self.max_latency_p50_ms,
            "min_requests": self.min_requests,
        }


class ReplayTarget:
    """Uniform async predict over the three target shapes."""

    def __init__(self, target: Any):
        self.target = target
        self._session = None

    @property
    def kind(self) -> str:
        return "inprocess" if hasattr(self.target, "predict") else "http"

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if self.kind == "inprocess":
            return await self.target.predict(msg)
        from seldon_core_tpu_torch.runtime.client import HttpClient

        if self._session is None or self._session.closed:
            self._session = HttpClient()
        url = str(self.target).rstrip("/") + "/api/v0.1/predictions"
        try:
            r = await self._session.post(
                url, msg.to_json().encode(),
                {"Content-Type": "application/json"}, timeout=30)
            return SeldonMessage.from_json(r.text())
        except (OSError, asyncio.TimeoutError) as e:
            return SeldonMessage.failure(
                f"candidate unreachable: {e}", code=503
            )
        except SeldonMessageError as e:
            return SeldonMessage.failure(
                f"candidate answered garbage: {e}", code=502
            )

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()


def load_firehose_events(path: str,
                         deployment: Optional[str] = None,
                         limit: Optional[int] = None) -> List[dict]:
    """Parse a firehose JSONL file into replayable events — request lines
    only (control-plane events like rollbacks carry no request), oldest
    first, optionally filtered by deployment."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line mid-write: skip, like the consumer
            if "request" not in ev or "response" not in ev:
                continue
            if deployment is not None and ev.get("deployment") != deployment:
                continue
            events.append(ev)
            if limit is not None and len(events) >= limit:
                break
    return events


def _prediction_rows(msg: Optional[SeldonMessage]) -> Optional[np.ndarray]:
    if msg is None or msg.data is None:
        return None
    try:
        arr = np.asarray(msg.array(), dtype=np.float64)
    except (SeldonMessageError, ValueError):
        return None
    return arr if arr.size else None


def _prediction_psi(recorded: List[np.ndarray],
                    candidate: List[np.ndarray]) -> Optional[float]:
    """PSI between the two prediction-value distributions over a shared
    histogram whose edges come from the RECORDED side's quantiles — the
    exact framing the quality observatory uses for prediction drift."""
    from seldon_core_tpu_torch.utils.quality import psi

    if not recorded or not candidate:
        return None
    ref = np.concatenate([r.ravel() for r in recorded])
    live = np.concatenate([c.ravel() for c in candidate])
    if ref.size < 8 or live.size < 8:
        return None
    edges = np.quantile(ref, np.linspace(0.0, 1.0, 11)[1:-1])
    edges = np.unique(edges)
    if edges.size == 0:
        return 0.0 if np.allclose(ref.mean(), live.mean()) else None
    ref_counts = np.histogram(ref, bins=np.concatenate(
        ([-np.inf], edges, [np.inf])))[0]
    live_counts = np.histogram(live, bins=np.concatenate(
        ([-np.inf], edges, [np.inf])))[0]
    return float(np.sum(psi(
        ref_counts[None, :], live_counts[None, :]
    )))


async def replay_events(
    events: List[dict],
    target: Any,
    pace: str = "max",
    speed: float = 1.0,
    concurrency: int = 8,
    gates: Optional[ReplayGates] = None,
) -> dict:
    """Replay ``events`` against ``target`` and return the verdict
    document.  ``pace="recorded"`` honors recorded inter-arrival gaps
    divided by ``speed``; ``pace="max"`` keeps ``concurrency`` requests
    in flight."""
    if pace not in ("max", "recorded"):
        raise ValueError(f"pace must be 'max' or 'recorded', got {pace!r}")
    gates = gates or ReplayGates()
    rt = target if isinstance(target, ReplayTarget) else ReplayTarget(target)
    latency_ms = Reservoir(4096)
    disagreement = Reservoir(4096)
    recorded_preds: List[np.ndarray] = []
    candidate_preds: List[np.ndarray] = []
    counts = {
        "replayed": 0, "recorded_errors": 0, "candidate_errors": 0,
        "incomparable": 0, "disagreed": 0,
    }
    sem = asyncio.Semaphore(max(int(concurrency), 1))

    async def one(ev: dict) -> None:
        try:
            req = SeldonMessage.from_json_dict(ev["request"])
            recorded = SeldonMessage.from_json_dict(ev["response"])
        except (SeldonMessageError, TypeError, KeyError):
            counts["incomparable"] += 1
            return
        async with sem:
            t0 = time.perf_counter()
            cand = await rt.predict(req)
            latency_ms.observe((time.perf_counter() - t0) * 1e3)
        counts["replayed"] += 1
        rec_err = recorded.status is not None and \
            recorded.status.status == "FAILURE"
        cand_err = cand.status is not None and \
            cand.status.status == "FAILURE"
        if rec_err:
            counts["recorded_errors"] += 1
        if cand_err:
            counts["candidate_errors"] += 1
        # recorded UNCONDITIONALLY, same rationale as the shadow mirror:
        # matched failures agree (0.0), a contract break (shape/kind
        # mismatch, one-sided failure) is maximal divergence (1.0) — a
        # candidate that changes the output shape must fail the vet, not
        # fall out of the disagreement window
        delta = prediction_delta(recorded, cand)
        disagreement.observe(delta["disagree"])
        if delta["disagree"] > 0:
            counts["disagreed"] += 1
        if not delta["comparable"] and not (rec_err or cand_err):
            counts["incomparable"] += 1  # contract mismatch, not errors
        rp, cp = _prediction_rows(recorded), _prediction_rows(cand)
        if rp is not None:
            recorded_preds.append(rp)
        if cp is not None:
            candidate_preds.append(cp)

    t_start = time.perf_counter()
    try:
        if pace == "recorded":
            base_ts = events[0].get("ts", 0.0) if events else 0.0
            t0 = time.perf_counter()
            pending = []
            for ev in events:
                offset = max(ev.get("ts", base_ts) - base_ts, 0.0) / max(
                    speed, 1e-6
                )
                delay = offset - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                pending.append(asyncio.ensure_future(one(ev)))
            if pending:
                await asyncio.gather(*pending)
        else:
            await asyncio.gather(*(one(ev) for ev in events))
    finally:
        if not isinstance(target, ReplayTarget):
            await rt.close()
    wall_s = time.perf_counter() - t_start

    replayed = counts["replayed"]
    dis = disagreement.snapshot()
    rec_rate = counts["recorded_errors"] / replayed if replayed else 0.0
    cand_rate = counts["candidate_errors"] / replayed if replayed else 0.0
    pred_psi = _prediction_psi(recorded_preds, candidate_preds)

    reasons = []
    if replayed < gates.min_requests:
        reasons.append(
            f"insufficient_traffic: {replayed} < {gates.min_requests}"
        )
    if gates.max_disagreement is not None and \
            dis["mean"] > gates.max_disagreement:
        reasons.append(
            f"disagreement: mean {dis['mean']:.4f} > "
            f"{gates.max_disagreement}"
        )
    if gates.max_error_rate_delta is not None and \
            (cand_rate - rec_rate) > gates.max_error_rate_delta:
        reasons.append(
            f"error_rate: candidate {cand_rate:.4f} vs recorded "
            f"{rec_rate:.4f}"
        )
    if gates.max_prediction_psi is not None and pred_psi is not None and \
            pred_psi > gates.max_prediction_psi:
        reasons.append(
            f"prediction_psi: {pred_psi:.4f} > {gates.max_prediction_psi}"
        )
    lat = latency_ms.snapshot()
    if gates.max_latency_p50_ms is not None and replayed and \
            lat["p50"] > gates.max_latency_p50_ms:
        reasons.append(
            f"latency: p50 {lat['p50']:.1f}ms > {gates.max_latency_p50_ms}"
        )

    return {
        "verdict": "pass" if not reasons else "fail",
        "reasons": reasons,
        "target": rt.kind,
        "pace": pace,
        "speed": speed,
        "wall_s": round(wall_s, 3),
        "replayed_per_s": round(replayed / wall_s, 1) if wall_s > 0 else None,
        "counts": counts,
        "disagreement": {
            "mean": round(dis["mean"], 6),
            "p95": round(dis["p95"], 6),
            "count": dis["count"],
        },
        "error_rate": {
            "recorded": round(rec_rate, 6),
            "candidate": round(cand_rate, 6),
        },
        "prediction_psi": (
            None if pred_psi is None else round(pred_psi, 6)
        ),
        "candidate_latency_ms": lat,
        "gates": gates.to_json_dict(),
    }


async def replay_file(path: str, target: Any, deployment: Optional[str] = None,
                      limit: Optional[int] = None, **kw) -> dict:
    events = load_firehose_events(path, deployment=deployment, limit=limit)
    doc = await replay_events(events, target, **kw)
    doc["source"] = {"path": path, "deployment": deployment,
                     "events": len(events)}
    return doc


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="replay a firehose log against a candidate predictor"
    )
    parser.add_argument("firehose", help="JSONL firehose file (gateway/"
                                         "firehose.py format)")
    parser.add_argument("--url", default=None,
                        help="candidate engine base URL")
    parser.add_argument("--spec", default=None,
                        help="deployment spec JSON: boot an in-process "
                             "candidate engine instead of dialing one")
    parser.add_argument("--predictor", default=None,
                        help="predictor name inside --spec")
    parser.add_argument("--deployment", default=None,
                        help="filter recorded lines to one deployment")
    parser.add_argument("--pace", choices=("max", "recorded"), default="max")
    parser.add_argument("--speed", type=float, default=1.0,
                        help="time-warp factor for --pace recorded")
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--max-disagreement", type=float, default=0.02)
    parser.add_argument("--max-error-rate-delta", type=float, default=0.01)
    parser.add_argument("--max-prediction-psi", type=float, default=0.25)
    parser.add_argument("--out", default=None,
                        help="write the verdict artifact here")
    parser.add_argument("--device", default="cuda",
                        help="--spec's engine: cuda (default) or cpu")
    args = parser.parse_args(argv)
    if bool(args.url) == bool(args.spec):
        raise SystemExit("exactly one of --url / --spec is required")

    async def run() -> dict:
        engine = None
        if args.spec is not None:
            from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
            from seldon_core_tpu_torch.runtime.engine import EngineService

            with open(args.spec) as f:
                spec = SeldonDeploymentSpec.from_json_dict(json.load(f))
            engine = EngineService(spec, args.predictor, device=args.device)
            target: Any = engine
        else:
            target = args.url
        try:
            return await replay_file(
                args.firehose, target,
                deployment=args.deployment,
                limit=args.limit,
                pace=args.pace, speed=args.speed,
                concurrency=args.concurrency,
                gates=ReplayGates(
                    max_disagreement=args.max_disagreement,
                    max_error_rate_delta=args.max_error_rate_delta,
                    max_prediction_psi=args.max_prediction_psi,
                ),
            )
        finally:
            if engine is not None:
                engine.close()

    doc = asyncio.run(run())
    text = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    if doc["verdict"] != "pass":
        raise SystemExit(3)


if __name__ == "__main__":
    main()
