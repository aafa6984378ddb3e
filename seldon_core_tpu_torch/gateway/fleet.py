"""Mesh-wide observability plane — federated trace assembly, fleet
aggregation, coordinated profiling windows; the port's copy of
``seldon_core_tpu/gateway/fleet.py``.  Its fetches go through the
gateway's one upstream client (``runtime/client.py`` ``HttpClient``), and
its profiling windows are the port engines' ``torch.profiler`` windows.

The data plane is a multi-process mesh (gateway → prefill engine →
OP_KVSTREAM handoff → decode engine; replica sets and sharded node
engines spread one predict over N processes) while every engine's
observability surface is per-process.  This module is the single pane
over the sheet of workers:

* **Federated trace assembly** — ``GET /trace?trace_id=`` on the
  gateway fans out to every replica the balancer's endpoint registry
  knows (HTTP for URL endpoints, the relay ``OP_TRACE`` frame for
  uds-only replicas and relay-spec decode peers, a direct call for
  in-process engines), merges the returned spans into ONE causal tree,
  and recomputes the critical path across process boundaries.  A
  subtree a remote ring already evicted answers a PARTIAL tree with an
  explicit marker and a per-source ``missing`` list — never a silent
  empty.  ``GET /trace/export`` renders the same merge as Perfetto
  trace JSON with one process track per participant (replica/role).
* **Fleet aggregation** — ``GET /fleet`` merges every replica's
  ``/stats`` + ``/perf`` + ``/quality`` into per-deployment rollups
  with per-replica deltas against the set median (MFU, dispatch p99,
  drift, free KV blocks, handoff outcomes) and per-replica staleness.
  The raw documents ride the EXISTING ``SELDON_TPU_GW_SCRAPE_S``
  scrape pass (gateway/balancer.py ``scrape_once`` stashes them next
  to the health fields it already parses — zero new polling loops);
  the ``seldon_tpu_fleet_*`` outlier gauges refresh on that same pass
  so one alert pages on "replica 3 is 2× slower than its siblings".
* **Coordinated profiling windows** — ``POST /profile/start`` opens a
  bounded ``torch.profiler`` window (utils/tracing.py
  ``profile_window_start``) on every engine of a deployment
  *simultaneously* and collects the artifact paths into one manifest;
  overlapping windows are refused (409), both at the gateway and by
  each engine's process-local profile lock.

Everything here is READ-PATH-ONLY: assembly, merging and outlier math
run at query time (or on the existing scrape tick), never on the
request hot path.  ``SELDON_TPU_FLEET=0`` kills federation: the gateway
answers every surface from local data only.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

__all__ = [
    "fleet_enabled",
    "fleet_outlier_x",
    "FleetSource",
    "gather_sources",
    "federated_trace_document",
    "federated_export_document",
    "fleet_document",
    "corpus_document",
    "costs_document",
    "postmortems_document",
    "refresh_outlier_gauges",
    "extract_replica_row",
    "compute_outliers",
    "profile_start",
    "profile_stop",
    "profile_status",
]


def fleet_enabled() -> bool:
    """Kill switch: ``SELDON_TPU_FLEET=0`` disables every federated
    fan-out — gateway surfaces answer from local data only."""
    return os.environ.get("SELDON_TPU_FLEET", "1") != "0"


def fleet_outlier_x() -> float:
    """``SELDON_TPU_FLEET_OUTLIER_X`` — the worse-than-median ratio at
    which a replica is flagged an outlier on ``/fleet`` (default 1.5;
    the SeldonTPUReplicaOutlier alert pages at 2.0 sustained)."""
    try:
        return float(os.environ.get("SELDON_TPU_FLEET_OUTLIER_X", "") or 1.5)
    except ValueError:
        return 1.5


def _fleet_timeout_s() -> float:
    try:
        return float(os.environ.get("SELDON_TPU_FLEET_TIMEOUT_S", "") or 2.0)
    except ValueError:
        return 2.0


def _extra_peers() -> List[str]:
    """``SELDON_TPU_FLEET_PEERS`` — comma-separated extra federation
    targets outside the balancer registry (sharded node engines, decode
    peers registered nowhere): ``http://host:port``, ``uds:/path`` or
    ``tcp:host:port`` specs."""
    raw = os.environ.get("SELDON_TPU_FLEET_PEERS", "")
    return [p.strip() for p in raw.split(",") if p.strip()]


@dataclass
class FleetSource:
    """One federation target: how the gateway reaches a process that may
    hold spans / stats of a request that crossed the mesh."""

    name: str                 # replica endpoint name (or peer spec)
    set_name: str             # deployment/predictor ("_peers" for extras)
    role: str = "unified"
    lane: str = "http"        # "inprocess" | "http" | "relay"
    target: Any = None        # EngineService (inprocess lane)
    base_url: Optional[str] = None
    relay_spec: Optional[str] = None   # "uds:/path" | "tcp:host:port"
    endpoint: Any = None      # the balancer ReplicaEndpoint, if any


def gather_sources(gateway, deployment: Optional[str] = None
                   ) -> List[FleetSource]:
    """Every distinct process the gateway can federate over: the replica
    endpoints of every registered deployment (built through the same
    cached replica sets the data plane uses), the decode peers of
    in-process prefill coordinators, and ``SELDON_TPU_FLEET_PEERS``
    extras.  Deduplicated by reachable address/identity."""
    sources: List[FleetSource] = []
    seen: set = set()

    def add(src: FleetSource, key) -> None:
        if key in seen:
            return
        seen.add(key)
        sources.append(src)

    for reg in list(gateway.store._by_key.values()):
        if deployment is not None and reg.deployment_id != deployment:
            continue
        for pred_name, _w, engine in reg.engines:
            rs = gateway._replica_set(reg, pred_name, engine)
            set_name = f"{reg.deployment_id}/{pred_name}"
            for ep in rs.endpoints:
                if hasattr(ep.target, "predict"):
                    add(FleetSource(
                        name=ep.name, set_name=set_name, role=ep.role,
                        lane="inprocess", target=ep.target, endpoint=ep,
                    ), ("inprocess", id(ep.target)))
                elif ep.base_url is not None:
                    add(FleetSource(
                        name=ep.name, set_name=set_name, role=ep.role,
                        lane="http", base_url=ep.base_url, endpoint=ep,
                    ), ("http", ep.base_url))
                elif ep.uds_path is not None:
                    add(FleetSource(
                        name=ep.name, set_name=set_name, role=ep.role,
                        lane="relay", relay_spec=f"uds:{ep.uds_path}",
                        endpoint=ep,
                    ), ("relay", ep.uds_path))
            # an in-process prefill engine knows its decode peers by
            # relay spec — they may be registered nowhere else, yet a
            # disaggregated generation's decode spans live there
            for ep in rs.endpoints:
                gs = getattr(ep.target, "genserver", None)
                coord = getattr(gs, "coordinator", None)
                for peer in getattr(coord, "peers", None) or []:
                    add(FleetSource(
                        name=peer, set_name=set_name, role="decode",
                        lane="relay", relay_spec=peer,
                    ), ("relay", peer.split("uds:")[-1]))
    for spec in _extra_peers():
        if spec.startswith("http"):
            add(FleetSource(name=spec, set_name="_peers", lane="http",
                            base_url=spec.rstrip("/")),
                ("http", spec.rstrip("/")))
        else:
            add(FleetSource(name=spec, set_name="_peers", lane="relay",
                            relay_spec=spec),
                ("relay", spec.split("uds:")[-1]))
    return sources


# ---------------------------------------------------------------------------
# Federated trace assembly
# ---------------------------------------------------------------------------


async def _fetch_json(gateway, url: str) -> dict:
    r = await gateway._get_session().get(url, timeout=_fleet_timeout_s())
    if r.status != 200:
        raise RuntimeError(f"HTTP {r.status} from {url}")
    doc = r.json()
    if not isinstance(doc, dict):
        raise RuntimeError(f"non-object body from {url}")
    return doc


async def _relay_trace(gateway, spec: str, query: dict) -> dict:
    """One OP_TRACE round trip to a relay-only peer.  ``uds:`` specs
    reuse the gateway's pooled relay clients; ``tcp:`` specs dial a
    transient client (read path — connection cost is acceptable and the
    cross-host case is rare)."""
    import json as _json

    from seldon_core_tpu_torch.runtime.udsrelay import (
        OP_TRACE,
        make_relay_client,
    )

    payload = _json.dumps(query).encode()
    transient = None
    if spec.startswith("tcp:"):
        client = transient = make_relay_client(spec)
    else:
        path = spec[len("uds:"):] if spec.startswith("uds:") else spec
        client = gateway._uds_client(path)
    try:
        body, status = await asyncio.wait_for(
            client.call(OP_TRACE, payload), timeout=_fleet_timeout_s())
    finally:
        if transient is not None:
            await transient.close()
    if status != 200:
        raise RuntimeError(
            f"relay trace status {status}: "
            f"{body.decode('utf-8', 'replace')[:200]}")
    doc = _json.loads(body.decode("utf-8", "replace"))
    if not isinstance(doc, dict):
        raise RuntimeError("non-object relay trace body")
    return doc


async def _fetch_source_trace(gateway, src: FleetSource, trace_id: str,
                              puid: str, limit: int) -> List[dict]:
    """One source's span dicts for the query.  In-process engines share
    the gateway's global TRACER — their spans are already in the local
    result, so they contribute nothing new here (the dedup would drop
    them anyway); skipping the call keeps the fan-out lean."""
    if src.lane == "inprocess":
        return []
    query = {"trace_id": trace_id, "puid": puid, "limit": limit}
    if src.lane == "http":
        from urllib.parse import urlencode

        url = src.base_url + "/trace?" + urlencode(
            {k: v for k, v in query.items() if v})
        doc = await _fetch_json(gateway, url)
    else:
        doc = await _relay_trace(gateway, src.relay_spec, query)
    spans = doc.get("spans")
    return spans if isinstance(spans, list) else []


async def _federated_spans(gateway, trace_id: str, puid: str, limit: int):
    """(merged Span list, per-source report, span-id -> origin label).
    Local spans first, then every remote source concurrently; dedup by
    span id (spans without ids fall back to a content key).  The origin
    map remembers WHICH process actually returned each span so the
    Perfetto export can put it on that process's track."""
    from seldon_core_tpu_torch.utils.tracing import (
        TRACER,
        _select_spans,
        span_from_json_dict,
    )

    local = _select_spans(TRACER, puid=puid, trace_id=trace_id,
                          limit=limit)
    merged: Dict[Any, Any] = {}
    origin: Dict[Any, str] = {}

    def key_of(s) -> Any:
        return s.span_id or (s.puid, s.name, s.kind, round(s.start_s, 6),
                             round(s.duration_ms, 3))

    for s in local:
        merged[key_of(s)] = s
    reports: List[dict] = [{
        "source": "gateway", "lane": "local", "role": "gateway",
        "spans": len(local), "error": None,
    }]
    if fleet_enabled():
        sources = gather_sources(gateway)

        async def one(src: FleetSource):
            try:
                dicts = await _fetch_source_trace(
                    gateway, src, trace_id, puid, limit)
                return src, [span_from_json_dict(d) for d in dicts], None
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reported per source
                return src, [], f"{type(e).__name__}: {e}"

        for src, spans, error in await asyncio.gather(
                *(one(s) for s in sources)):
            fresh = 0
            for s in spans:
                k = key_of(s)
                if k not in merged:
                    merged[k] = s
                    origin[k] = f"{src.name} ({src.role})"
                    fresh += 1
            reports.append({
                "source": src.name, "lane": src.lane, "role": src.role,
                "set": src.set_name, "spans": fresh, "error": error,
            })
    return (sorted(merged.values(), key=lambda s: s.start_s), reports,
            origin)


async def federated_trace_document(gateway, trace_id: str = "",
                                   puid: str = "",
                                   limit: int = 100) -> dict:
    """The gateway's ``GET /trace`` body: ONE assembled tree across
    every process a request touched, with the critical path recomputed
    over the merged span set.  Without a named query it reports the
    local recent spans only (fan-out for "everything recent" would be
    all cost, no join key)."""
    from seldon_core_tpu_torch.utils.tracing import (
        TRACER,
        assembly_fields,
        trace_document,
    )

    if not (trace_id or puid):
        doc = trace_document(TRACER, limit=limit)
        doc["federated"] = False
        return doc
    spans, reports, _origin = await _federated_spans(
        gateway, trace_id, puid, limit)
    doc: Dict[str, Any] = {
        "enabled": TRACER.enabled,
        "sample": TRACER.sample,
        "federated": fleet_enabled(),
        "sources": reports,
        "spans": [s.to_json_dict() for s in spans],
    }
    # the assembly block (tree / critical path / phases / partial
    # markers) is the SAME code the engine-local /trace serves — the two
    # surfaces cannot drift (utils/tracing.py assembly_fields)
    doc.update(assembly_fields(spans))
    # a source that errored (or an engine whose ring evicted the
    # subtree) makes the result partial even when the local tree looks
    # self-consistent — the operator must know the view may be narrow
    source_missing = [
        {"source": r["source"], "reason": r["error"]}
        for r in reports if r.get("error")
    ]
    if source_missing:
        doc["partial"] = True
        doc["missing"] = list(doc["missing"]) + source_missing
    return doc


async def federated_export_document(gateway, trace_id: str = "",
                                    puid: str = "",
                                    limit: int = 1000) -> dict:
    """The gateway's ``GET /trace/export`` body: Perfetto trace JSON of
    the merged tree with ONE PROCESS TRACK PER PARTICIPANT — the
    gateway's spans on pid 0, each replica's on its own pid, named
    ``replica (role)`` so the federated tree renders legibly."""
    from seldon_core_tpu_torch.utils.tracing import chrome_trace

    spans, reports, origin = await _federated_spans(
        gateway, trace_id, puid, limit)
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(s.start_s for s in spans)
    # per-process track assignment: a span a REMOTE source returned
    # renders on that source's track (the merge recorded its origin).
    # Locally-held spans need a heuristic — co-located engines share
    # the gateway's tracer, so the recorder's identity only survives in
    # what the scheduler stamped: its role attr on prefill/decode legs,
    # kv_import on the decode side, kv_handoff on the prefill side.
    by_source: Dict[str, List] = {}
    for s in spans:
        key = s.span_id or (s.puid, s.name, s.kind,
                            round(s.start_s, 6), round(s.duration_ms, 3))
        label = origin.get(key)
        if label is None:
            label = "gateway (local)"
            role = (s.attrs.get("role")
                    if isinstance(s.attrs, dict) else None)
            if s.kind in ("kv_import",) or (s.method == "decode"
                                            and role == "decode"):
                label = "decode replica"
            elif s.method == "prefill" or (role == "prefill"):
                label = "prefill replica"
            elif s.kind == "kv_handoff":
                label = "prefill replica"
        by_source.setdefault(label, []).append(s)
    events: List[dict] = []
    for pid, (label, group) in enumerate(sorted(by_source.items())):
        doc = chrome_trace(group, process_name=label, pid=pid,
                           base_s=base)
        events.extend(doc["traceEvents"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "sources": reports,
    }


# ---------------------------------------------------------------------------
# Fleet aggregation (GET /fleet)
# ---------------------------------------------------------------------------

#: finite ceiling on a worse-than-median ratio (a zero-MFU replica vs a
#: healthy median would otherwise be infinitely worse — unrenderable in
#: strict JSON and invisible to a max() over finite gauge values)
_RATIO_CAP = 1e6

#: outlier metrics: name -> direction ("high" = higher is worse)
_OUTLIER_METRICS = {
    "dispatch_p99_ms": "high",
    "ewma_ms": "high",
    "drift_max": "high",
    "mfu": "low",
    "free_kv_blocks": "low",
}


def _num(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f else None  # NaN -> None


def extract_replica_row(stats: Optional[dict], perf: Optional[dict],
                        quality: Optional[dict]) -> Dict[str, Any]:
    """Compact per-replica metrics off the three per-process documents.
    Defensive throughout: a replica mid-deploy may serve partial docs,
    and a missing figure must read as absent, not zero (zero would make
    it the 'best' replica on a lower-is-worse metric)."""
    row: Dict[str, Any] = {}
    stats = stats or {}
    perf = perf or {}
    quality = quality or {}
    tel = stats.get("telemetry") or {}
    batch = tel.get("batch") or {}
    row["inflight"] = _num(batch.get("inflight_dispatches"))
    req_lat = tel.get("request_latency_s") or {}
    counts = [
        (_num(v.get("count")), _num(v.get("p99")))
        for v in req_lat.values() if isinstance(v, dict)
    ]
    if counts:
        row["requests"] = sum(c for c, _ in counts if c)
        p99s = [p for _, p in counts if p]
        if p99s:
            row["request_p99_ms"] = round(max(p99s) * 1e3, 3)
    # dispatch latency + MFU off the /perf executable table
    execs = perf.get("executables") or []
    p99s, mfus = [], []
    weighted_p50, calls_total = 0.0, 0
    for e in execs:
        if not isinstance(e, dict):
            continue
        lat = e.get("latency_ms")
        if not isinstance(lat, dict):
            lat = {}
        calls = _num(e.get("calls")) or 0
        p99 = _num(lat.get("p99"))
        p50 = _num(lat.get("p50"))
        if p99 is not None:
            p99s.append(p99)
        if p50 is not None and calls:
            weighted_p50 += p50 * calls
            calls_total += calls
        mfu = _num(e.get("mfu"))
        if mfu is not None:
            mfus.append(mfu)
    if p99s:
        row["dispatch_p99_ms"] = round(max(p99s), 3)
    if calls_total:
        row["dispatch_p50_ms"] = round(weighted_p50 / calls_total, 3)
    if mfus:
        row["mfu"] = max(mfus)
    # drift: the worst live PSI/KS-ish score over nodes (either the
    # /quality document's rows or the compact /stats walk)
    drift_vals: List[float] = []

    def _drift_scan(node) -> None:
        if not isinstance(node, dict):
            return
        scores = node.get("scores")
        items = list(node.items()) + (
            list(scores.items()) if isinstance(scores, dict) else [])
        for k, v in items:
            if isinstance(k, str) and ("psi" in k or "drift" in k):
                f = _num(v)
                if f is not None:
                    drift_vals.append(f)

    nodes = quality.get("nodes")
    if isinstance(nodes, list):
        for n in nodes:
            _drift_scan(n)
    qsnap = stats.get("quality") or {}
    if isinstance(qsnap.get("nodes"), dict):
        for n in qsnap["nodes"].values():
            _drift_scan(n)
    if drift_vals:
        row["drift_max"] = round(max(drift_vals), 6)
    slo = (quality.get("slo") or {})
    if isinstance(slo, dict) and slo.get("burn_rates"):
        row["slo_burn"] = slo["burn_rates"]
    # generation lane: pool headroom, role, handoff flow
    gs = stats.get("genserver")
    if isinstance(gs, dict):
        row["role"] = gs.get("role")
        kvb = gs.get("kv_blocks") or {}
        total, used = _num(kvb.get("total")), _num(kvb.get("used"))
        if total is not None and used is not None:
            row["free_kv_blocks"] = int(total - used)
        disagg = gs.get("disagg")
        if isinstance(disagg, dict):
            row["handoffs"] = disagg.get("handoffs")
            row["handoff_ms_p50"] = disagg.get("handoff_ms_p50")
            row["chain_ewma_ms"] = disagg.get("chain_ewma_ms")
        imports = gs.get("imports")
        if isinstance(imports, dict):
            row["imports"] = imports
    return {k: v for k, v in row.items() if v is not None}


def compute_outliers(rows: Dict[str, Dict[str, Any]],
                     threshold: Optional[float] = None) -> dict:
    """Per-set outlier math: for each metric, the set median and each
    replica's worse-than-median ratio (>=1 always; direction folded in,
    so ``ratio=2.0`` uniformly reads "2x worse than the median
    sibling").  Returns ``{"median": {...}, "ratios": {replica:
    {metric: ratio}}, "outliers": [...]}``."""
    threshold = threshold if threshold is not None else fleet_outlier_x()
    medians: Dict[str, float] = {}
    ratios: Dict[str, Dict[str, float]] = {}
    outliers: List[dict] = []
    for metric, direction in _OUTLIER_METRICS.items():
        vals = sorted(
            v for v in (_num(r.get(metric)) for r in rows.values())
            if v is not None
        )
        if len(vals) < 2:
            continue
        n = len(vals)
        # true median (middle-two average for even n): with 2 replicas
        # an upper-middle convention would BE the outlier's own value
        # and the sick replica could never flag against itself
        median = (vals[n // 2] if n % 2
                  else (vals[n // 2 - 1] + vals[n // 2]) / 2.0)
        medians[metric] = round(median, 6)
        for replica, row in rows.items():
            v = _num(row.get(metric))
            if v is None:
                continue
            if direction == "high":
                ratio = v / median if median > 0 else (
                    1.0 if v <= 0 else _RATIO_CAP)
            else:
                ratio = median / v if v > 0 else (
                    1.0 if median <= 0 else _RATIO_CAP)
            # capped FINITE: an infinite ratio would serialize as the
            # bare `Infinity` literal (breaking strict JSON consumers of
            # /fleet) and fall out of the gauge max — the most extreme
            # outlier would be exactly the one that never pages
            ratio = round(min(max(ratio, 1.0), _RATIO_CAP), 3)
            ratios.setdefault(replica, {})[metric] = ratio
            if ratio >= threshold:
                outliers.append({
                    "replica": replica, "metric": metric,
                    "value": v, "median": median, "ratio": ratio,
                })
    outliers.sort(key=lambda o: -o["ratio"])
    return {"median": medians, "ratios": ratios, "outliers": outliers}


def _source_docs_cached(src: FleetSource) -> "tuple[Optional[dict], Optional[dict], Optional[dict], Optional[float]]":
    """(stats, perf, quality, age_s) from the scrape-stashed docs of a
    URL endpoint (balancer.scrape_once), or None when never scraped."""
    ep = src.endpoint
    docs = getattr(ep, "fleet_docs", None) if ep is not None else None
    if not docs:
        return None, None, None, None
    age = time.monotonic() - docs.get("ts", 0.0)
    return docs.get("stats"), docs.get("perf"), docs.get("quality"), age


async def _source_docs(gateway, src: FleetSource, max_age_s: float
                       ) -> "tuple[dict, float, Optional[str]]":
    """(row, staleness_s, error) for one source: in-process documents
    are assembled directly; URL endpoints serve from the scrape-stashed
    docs when fresh enough and are fetched on demand otherwise (query-
    time cost, never hot-path); relay-only endpoints have no document
    surface and report so."""
    if src.lane == "inprocess":
        t = src.target
        stats = t.stats() if hasattr(t, "stats") else None
        perf = (t.perf_document()
                if hasattr(t, "perf_document") else None)
        quality = (t.quality_document()
                   if hasattr(t, "quality_document") else None)
        row = extract_replica_row(stats, perf, quality)
        # co-located engines share the process-global observatories, so
        # perf/quality figures are identical across in-process rows —
        # flagged so the operator reads the per-replica distinction off
        # the gateway-side figures (ewma/picks/failures), which ARE
        # per-endpoint
        row["shared_process"] = True
        ep = src.endpoint
        if ep is not None:
            row.setdefault("ewma_ms", _num(ep.ewma_ms))
            row["picks"] = ep.picks
            row["failures"] = ep.failures
        return row, 0.0, None
    if src.lane == "relay":
        return {}, float("inf"), (
            "no document surface on the relay lane (uds-only endpoint "
            "— register an http://..+uds:/ spec for fleet rollups)")
    # a lapsed store lease (gateway/federation.py heartbeats) means the
    # stashed fleet_docs describe a DEAD process — serving their figures
    # as a live row would hide the death behind week-old numbers.  The
    # row says so explicitly and its staleness is pinned to at least the
    # lease TTL so the staleness gauge reads stale, not fresh
    if getattr(src.endpoint, "lease_state", None) == "dead":
        from seldon_core_tpu_torch.gateway.federation import lease_ttl_s

        _s, _p, _q, age = _source_docs_cached(src)
        return ({"lease": "dead"}, max(age or 0.0, lease_ttl_s()),
                "engine lease lapsed")
    stats, perf, quality, age = _source_docs_cached(src)
    error = None
    if stats is None or age is None or age > max_age_s:
        try:
            stats, perf, quality = await asyncio.gather(
                _fetch_json(gateway, src.base_url + "/stats"),
                _fetch_json(gateway, src.base_url + "/perf"),
                _fetch_json(gateway, src.base_url + "/quality"),
            )
            age = 0.0
        except Exception as e:  # noqa: BLE001 - reported per replica
            error = f"{type(e).__name__}: {e}"
            if age is None:
                return {}, float("inf"), error
    row = extract_replica_row(stats, perf, quality)
    ep = src.endpoint
    if ep is not None:
        row.setdefault("ewma_ms", _num(ep.ewma_ms))
        row["picks"] = ep.picks
        row["failures"] = ep.failures
        if ep.lease_state is not None:
            row["lease"] = ep.lease_state
    return row, age or 0.0, error


async def fleet_document(gateway) -> dict:
    """The ``GET /fleet`` body.  With federation killed
    (``SELDON_TPU_FLEET=0``) only in-process replicas report — local
    data, no fan-out."""
    from seldon_core_tpu_torch.gateway.balancer import scrape_interval_s
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    enabled = fleet_enabled()
    max_age = 3.0 * scrape_interval_s()
    sources = gather_sources(gateway)
    if not enabled:
        sources = [s for s in sources if s.lane == "inprocess"]
    results = await asyncio.gather(
        *(_source_docs(gateway, s, max_age) for s in sources))
    deployments: Dict[str, Dict[str, Any]] = {}
    for src, (row, staleness, error) in zip(sources, results):
        dep = deployments.setdefault(src.set_name, {"replicas": {}})
        entry = {
            "role": src.role, "lane": src.lane,
            "staleness_s": (None if staleness == float("inf")
                            else round(staleness, 3)),
            **row,
        }
        if error:
            entry["error"] = error
        dep["replicas"][src.name] = entry
    threshold = fleet_outlier_x()
    for set_name, dep in deployments.items():
        rows = {
            name: r for name, r in dep["replicas"].items()
            # a dead-lease row carries no live metrics — feeding its
            # stale figures to the outlier math would skew the median
            if r.get("lease") != "dead"
            and ("error" not in r or r.get("staleness_s") is not None)
        }
        out = compute_outliers(rows, threshold)
        dep.update(out)
        totals: Dict[str, float] = {}
        for r in dep["replicas"].values():
            for k in ("requests", "picks", "failures"):
                v = _num(r.get(k))
                if v is not None:
                    totals[k] = totals.get(k, 0) + v
            for k, v in (r.get("handoffs") or {}).items():
                totals[f"handoffs_{k}"] = (
                    totals.get(f"handoffs_{k}", 0) + (_num(v) or 0))
        dep["totals"] = totals
        # publish the gauges from the same rollup the document shows
        _publish_set_gauges(RECORDER, set_name, dep)
    from seldon_core_tpu_torch.utils.quality import FLEET_BURN

    return {
        "enabled": enabled,
        "outlier_threshold": threshold,
        "scrape_interval_s": scrape_interval_s(),
        # fleet-truth SLO/QoS burn: the aggregate every replica folds
        # from the shared store's burn_deltas (gateway/federation.py)
        "burn": FLEET_BURN.snapshot(),
        "deployments": deployments,
    }


def _publish_set_gauges(recorder, set_name: str, dep: dict) -> None:
    recorder.set_fleet_replicas(set_name, len(dep.get("replicas") or {}))
    for replica, metrics in (dep.get("ratios") or {}).items():
        worst = max(metrics.values(), default=1.0)
        recorder.set_fleet_outlier(set_name, replica, worst)
    for replica, row in (dep.get("replicas") or {}).items():
        st = row.get("staleness_s")
        if st is not None:
            recorder.set_fleet_staleness(set_name, replica, st)


def _merge_corpus_keys(merged: Dict[str, Dict[str, Any]],
                       doc: dict) -> int:
    """Fold one replica's ``/corpus`` key table into the fleet merge:
    quantiles combine as n-weighted means (each replica's sketch already
    summarizes its own sample ring — exact fleet quantiles would need
    the raw walls, which the compact rows deliberately do not carry),
    tier counts sum, recency takes the max."""
    folded = 0
    for row in doc.get("keys") or []:
        if not isinstance(row, dict):
            continue
        key, n = row.get("key"), row.get("n") or 0
        if not key or n <= 0:
            continue
        folded += 1
        ent = merged.get(key)
        if ent is None:
            merged[key] = {**row, "sources": 1}
            continue
        total = ent["n"] + n
        for f in ("p50_ms", "p90_ms", "p99_ms", "spread_ms", "last_ms"):
            a, b = _num(ent.get(f)), _num(row.get(f))
            if a is not None and b is not None:
                ent[f] = round((a * ent["n"] + b * n) / total, 4)
            elif b is not None:
                ent[f] = b
        tiers = dict(ent.get("tiers") or {})
        for t, c in (row.get("tiers") or {}).items():
            tiers[t] = tiers.get(t, 0) + (c or 0)
        ent["tiers"] = tiers
        ent["n"] = total
        ent["last_ts"] = max(_num(ent.get("last_ts")) or 0.0,
                             _num(row.get("last_ts")) or 0.0)
        ent["sources"] += 1
    return folded


async def corpus_document(gateway) -> dict:
    """The gateway's ``GET /corpus`` body: every replica's durable perf
    corpus merged into ONE fleet-wide key table — the training substrate
    for learned cost models (ROADMAP item 4) assembled across the whole
    fleet instead of read one process at a time.  In-process engines
    share the gateway's process-global corpus, so the local document
    covers them; URL replicas are fetched at query time (read path, never
    hot); with ``SELDON_TPU_FLEET=0`` the local document stands alone."""
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.perfcorpus import CORPUS

    SPINE.drain()  # in-process engines' pending dispatches land first
    local = CORPUS.document()
    merged: Dict[str, Dict[str, Any]] = {}
    rows_total = int(local.get("rows_total") or 0)
    reports: List[dict] = [{
        "source": "gateway", "lane": "local",
        "keys": _merge_corpus_keys(merged, local), "error": None,
    }]
    if fleet_enabled():
        sources = [s for s in gather_sources(gateway)
                   if s.lane == "http"]

        async def one(src: FleetSource):
            try:
                doc = await _fetch_json(
                    gateway, src.base_url + "/corpus")
                return src, doc, None
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reported per source
                return src, None, f"{type(e).__name__}: {e}"

        for src, doc, error in await asyncio.gather(
                *(one(s) for s in sources)):
            folded = 0
            if doc is not None:
                folded = _merge_corpus_keys(merged, doc)
                rows_total += int(doc.get("rows_total") or 0)
            reports.append({
                "source": src.name, "lane": src.lane, "role": src.role,
                "set": src.set_name, "keys": folded, "error": error,
            })
    keys = sorted(merged.values(), key=lambda r: r["n"], reverse=True)
    return {
        "federated": fleet_enabled(),
        "sources": reports,
        "rows_total": rows_total,
        "key_count": len(keys),
        "keys": keys,
    }


async def costs_document(gateway) -> dict:
    """The gateway's ``GET /costs`` body: every replica's resource
    ledger merged into ONE fleet-wide attribution table (who is
    consuming the fleet — device-seconds, pad tax, KV-block-seconds,
    bytes per tenant x deployment, plus the summed accounting identity
    and capacity block).  In-process engines share the gateway's
    process-global ledger, so the local document covers them; URL
    replicas are fetched at query time (read path, never hot); with
    ``SELDON_TPU_FLEET=0`` the local document stands alone."""
    from seldon_core_tpu_torch.utils.costledger import (
        LEDGER,
        merge_cost_documents,
    )
    from seldon_core_tpu_torch.utils.hotrecord import SPINE

    SPINE.drain()  # in-process engines' pending flush/tick records first
    local = LEDGER.document()
    docs: List[dict] = [local]
    reports: List[dict] = [{
        "source": "gateway", "lane": "local",
        "tenants": len(local.get("tenants") or ()), "error": None,
    }]
    if fleet_enabled():
        sources = [s for s in gather_sources(gateway)
                   if s.lane == "http"]

        async def one(src: FleetSource):
            try:
                doc = await _fetch_json(
                    gateway, src.base_url + "/costs")
                return src, doc, None
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reported per source
                return src, None, f"{type(e).__name__}: {e}"

        for src, doc, error in await asyncio.gather(
                *(one(s) for s in sources)):
            if doc is not None:
                docs.append(doc)
            reports.append({
                "source": src.name, "lane": src.lane, "role": src.role,
                "set": src.set_name,
                "tenants": len((doc or {}).get("tenants") or ()),
                "error": error,
            })
    merged = merge_cost_documents(docs)
    merged["federated"] = fleet_enabled()
    merged["sources"] = reports
    merged["enabled"] = bool(local.get("enabled"))
    return merged


async def postmortems_document(gateway, puid: str = "") -> dict:
    """The gateway's ``GET /postmortems`` body: worst-of-fleet kept
    exemplars.  The summary view merges the gateway's own recorder
    (which also covers in-process engines — they share the
    process-global singleton) with the replica summaries the health
    scrape already stashed next to ``/perf`` and ``/quality``
    (``ep.fleet_docs`` — zero new polling loops).  ``?puid=`` chases ONE
    exemplar: the local recorder first, then each HTTP replica at query
    time (read path, never hot).  With ``SELDON_TPU_FLEET=0`` the local
    document stands alone."""
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM

    SPINE.drain()  # pending request spans complete their verdicts first
    if puid:
        local = POSTMORTEM.document(puid=puid)
        if local.get("found") or not fleet_enabled():
            local["source"] = "gateway" if local.get("found") else None
            return local
        from urllib.parse import quote

        sources = [s for s in gather_sources(gateway) if s.lane == "http"]

        async def chase(src: FleetSource):
            try:
                doc = await _fetch_json(
                    gateway, src.base_url + "/postmortems?puid="
                    + quote(puid, safe=""))
                return src, doc
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - absent source = not found
                return src, None

        for src, doc in await asyncio.gather(
                *(chase(s) for s in sources)):
            if isinstance(doc, dict) and doc.get("found"):
                doc["source"] = src.name
                return doc
        return {"found": False, "puid": puid, "postmortem": None,
                "source": None}
    local = POSTMORTEM.document()
    kept = [dict(s, source="gateway") for s in local.get("kept") or ()]
    synthetic = [dict(s, source="gateway")
                 for s in local.get("synthetic") or ()]
    counters = dict(local.get("counters") or {})
    reports: List[dict] = [{
        "source": "gateway", "lane": "local",
        "kept": len(kept), "stale_s": None, "error": None,
    }]
    if fleet_enabled():
        now = time.monotonic()
        for src in gather_sources(gateway):
            if src.lane != "http":
                continue
            docs = getattr(src.endpoint, "fleet_docs", None) \
                if src.endpoint is not None else None
            pm = (docs or {}).get("postmortems")
            stale_s = (round(now - docs["ts"], 3)
                       if docs and docs.get("ts") else None)
            if not isinstance(pm, dict):
                reports.append({
                    "source": src.name, "lane": src.lane, "role": src.role,
                    "set": src.set_name, "kept": 0, "stale_s": stale_s,
                    "error": "no scraped postmortem document",
                })
                continue
            folded = 0
            for key in ("kept", "synthetic"):
                dest = kept if key == "kept" else synthetic
                for s in pm.get(key) or ():
                    if isinstance(s, dict):
                        dest.append(dict(s, source=src.name))
                        folded += 1
            for name, val in (pm.get("counters") or {}).items():
                if isinstance(val, dict):
                    slot = counters.setdefault(name, {})
                    if isinstance(slot, dict):
                        for reason, n in val.items():
                            slot[reason] = slot.get(reason, 0) + int(n or 0)
                elif isinstance(val, (int, float)):
                    counters[name] = (counters.get(name) or 0) + val
            reports.append({
                "source": src.name, "lane": src.lane, "role": src.role,
                "set": src.set_name, "kept": folded, "stale_s": stale_s,
                "error": None,
            })
    # worst-of-fleet ordering: biggest explained excess first, then most
    # recent — same sort the per-process document uses
    kept.sort(key=lambda s: (-(s.get("excess_ms") or 0.0),
                             -(s.get("kept_at_s") or 0.0)))
    return {
        "federated": fleet_enabled(),
        "enabled": bool(local.get("enabled")),
        "sources": reports,
        "counters": counters,
        "kept_count": len(kept),
        "kept": kept,
        "synthetic": synthetic,
    }


def refresh_outlier_gauges(gateway) -> None:
    """Scrape-tick gauge refresh: recompute each URL replica set's
    outlier ratios from the docs the scrape pass just stashed — zero
    extra polling, so the SeldonTPUReplicaOutlier alert fires without
    anyone ever querying ``/fleet``.  In-process sets are covered at
    query time (they never run the scrape loop)."""
    if not fleet_enabled():
        return
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    from seldon_core_tpu_torch.gateway.federation import lease_ttl_s

    now = time.monotonic()
    for (dep, pred), (_fp, rs) in list(gateway._replica_sets.items()):
        rows: Dict[str, Dict[str, Any]] = {}
        stale: Dict[str, float] = {}
        for ep in rs.endpoints:
            docs = getattr(ep, "fleet_docs", None)
            if getattr(ep, "lease_state", None) == "dead":
                # lapsed lease: the stashed docs describe a dead process
                # — keep it out of the outlier median, but publish a
                # staleness of at least the lease TTL so the gauge (and
                # any alert on it) reads stale instead of silently fresh
                age = (now - docs.get("ts", now)) if docs else 0.0
                stale[ep.name] = round(max(age, lease_ttl_s()), 3)
                continue
            if not docs:
                continue
            row = extract_replica_row(
                docs.get("stats"), docs.get("perf"), docs.get("quality"))
            row.setdefault("ewma_ms", _num(ep.ewma_ms))
            rows[ep.name] = row
            stale[ep.name] = round(now - docs.get("ts", now), 3)
        if len(rows) < 2 and not (stale.keys() - rows.keys()):
            continue
        out = compute_outliers(rows)
        _publish_set_gauges(
            RECORDER, f"{dep}/{pred}",
            {"replicas": {n: {"staleness_s": stale.get(n)}
                          for n in stale},
             "ratios": out["ratios"]},
        )


# ---------------------------------------------------------------------------
# Coordinated profiling windows
# ---------------------------------------------------------------------------


def _profile_window_s() -> float:
    try:
        return float(
            os.environ.get("SELDON_TPU_PROFILE_WINDOW_S", "") or 5.0)
    except ValueError:
        return 5.0


def _profile_dir() -> str:
    import tempfile

    return os.environ.get("SELDON_TPU_PROFILE_DIR", "") or os.path.join(
        tempfile.gettempdir(), "seldon-tpu-profiles")


async def profile_start(gateway, deployment: Optional[str] = None,
                        duration_s: Optional[float] = None
                        ) -> "tuple[int, dict]":
    """Open ONE bounded profiling window across every engine of
    ``deployment`` (or every registered deployment) simultaneously.
    Returns ``(http_status, manifest)`` — 409 with the live manifest
    when a window is already open (overlap refused, never queued).

    Lanes: in-process engines share the gateway's device/process — one
    local ``profile_window_start`` covers them all; URL replicas get a
    ``POST /profile/start``; relay-only endpoints have no profile
    surface and are reported as skipped."""
    from seldon_core_tpu_torch.utils.tracing import (
        ProfileBusyError,
        ProfileUnavailableError,
        new_span_id,
        profile_window_start,
    )

    from seldon_core_tpu_torch.utils.tracing import profile_window_status

    active = gateway._profile_manifest
    if active is not None and active.get("state") == "open":
        started = active.get("started_s", 0.0)
        dur = active.get("duration_s", 0.0)
        # expired = well past the bounded duration AND the local
        # process window has actually closed (the first start_trace can
        # take seconds — the wall clock alone must not declare a window
        # dead while its profiler demonstrably still runs)
        if (time.time() < started + dur + 5.0
                or profile_window_status()["active"]):
            return 409, {
                "error": "a coordinated profile window is already open "
                         "— stop it (POST /profile/stop) or wait for "
                         "its bounded duration to elapse",
                "manifest": active,
            }
        # an expired window nobody stopped: finalize it lazily
        await profile_stop(gateway)
    try:
        duration_s = float(duration_s or 0.0)
    except (TypeError, ValueError):
        duration_s = 0.0
    if duration_s <= 0.0:
        duration_s = _profile_window_s()
    wid = new_span_id()
    base = os.path.join(_profile_dir(), wid)
    # publish the manifest BEFORE the first await: the overlap check
    # above and this assignment run atomically on the event loop, so a
    # second concurrent POST /profile/start sees the open window and
    # answers 409 instead of racing past the check during the remote
    # fan-out and overwriting this manifest (losing its stop URLs)
    manifest: Dict[str, Any] = {
        "window": wid,
        "deployment": deployment,
        "state": "open",
        "started_s": time.time(),
        "duration_s": duration_s,
        "sources": [],
    }
    gateway._profile_manifest = manifest
    sources = gather_sources(gateway, deployment)
    if not fleet_enabled():
        sources = [s for s in sources if s.lane == "inprocess"]
    entries: List[dict] = manifest["sources"]
    local_done = False
    remote: List[FleetSource] = []
    for src in sources:
        if src.lane == "inprocess":
            if local_done:
                continue
            local_done = True
            try:
                res = profile_window_start(
                    os.path.join(base, "gateway-local"),
                    duration_s, window=wid)
                # the expiry clock runs from when the profiler actually
                # started — the first profiler start can take
                # seconds, and stamping before it would let the very
                # next request judge this window already expired
                manifest["started_s"] = time.time()
                entries.append({
                    "source": "inprocess-engines", "lane": "inprocess",
                    "artifact": res["artifact"],
                })
            except (ProfileBusyError, ProfileUnavailableError) as e:
                entries.append({
                    "source": "inprocess-engines", "lane": "inprocess",
                    "error": str(e),
                })
        elif src.lane == "http":
            remote.append(src)
        else:
            entries.append({
                "source": src.name, "lane": "relay", "skipped": True,
                "error": "no profile surface on the relay lane",
            })

    async def start_remote(src: FleetSource) -> dict:
        import json as _json

        body = _json.dumps({"duration_s": duration_s, "window": wid}).encode()
        try:
            r = await gateway._get_session().post(
                src.base_url + "/profile/start", body,
                {"Content-Type": "application/json"}, timeout=_fleet_timeout_s())
            doc = r.json()
            if r.status != 200:
                return {"source": src.name, "lane": "http",
                        "error": (doc or {}).get(
                            "error", f"HTTP {r.status}")}
            # the stop fans out to THIS url — stashed so a replica
            # deregistered mid-window is still stopped
            return {"source": src.name, "lane": "http",
                    "role": src.role, "base_url": src.base_url,
                    "artifact": (doc or {}).get("artifact")}
        except Exception as e:  # noqa: BLE001 - reported per source
            return {"source": src.name, "lane": "http",
                    "error": f"{type(e).__name__}: {e}"}

    entries.extend(await asyncio.gather(*(start_remote(s)
                                          for s in remote)))
    return 200, manifest


async def profile_stop(gateway) -> "tuple[int, dict]":
    """Close the open window on every participant and finalize the
    manifest (idempotent: engines whose bounded timer already fired
    answer their LAST window)."""
    from seldon_core_tpu_torch.utils.tracing import profile_window_stop

    manifest = gateway._profile_manifest
    if manifest is None:
        return 404, {"error": "no profile window has been opened"}
    if manifest.get("state") == "closed":
        return 200, manifest
    stops: List = []
    for entry in manifest["sources"]:
        if entry.get("error") or entry.get("skipped"):
            continue
        if entry["lane"] == "inprocess":
            try:
                profile_window_stop()
            except Exception as e:  # noqa: BLE001 - finalize best-effort
                entry["stop_error"] = f"{type(e).__name__}: {e}"
        elif entry["lane"] == "http":
            stops.append(entry)

    async def stop_remote(entry: dict) -> None:
        # the URL was stashed at start time, so a replica deregistered
        # mid-window still gets its stop (the bounded timer is only the
        # backstop, not the plan)
        url = entry.get("base_url")
        if not url:
            entry["stop_error"] = "no base_url stashed at start"
            return
        try:
            await gateway._get_session().post(
                url + "/profile/stop", b"", timeout=_fleet_timeout_s())
        except Exception as e:  # noqa: BLE001
            entry["stop_error"] = f"{type(e).__name__}: {e}"

    await asyncio.gather(*(stop_remote(e) for e in stops))
    manifest["state"] = "closed"
    manifest["stopped_s"] = time.time()
    return 200, manifest


def profile_status(gateway) -> dict:
    """The ``GET /profile`` body: the latest manifest plus the local
    process window state."""
    from seldon_core_tpu_torch.utils.tracing import profile_window_status

    return {
        "manifest": gateway._profile_manifest,
        "local": profile_window_status(),
    }
