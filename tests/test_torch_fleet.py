"""The port's fleet plane (seldon_core_tpu_torch/gateway/fleet.py) against
the JAX package's, on the CPU: the outlier math and the replica row, run
against both packages on the same documents (``package`` "jax" and
"torch"), and the cases of tests/test_fleet_observability.py on port
engines: the slow replica surfaced as the outlier, the kill switch, a dead
lease's row and gauge, the federated trace merging a remote source's spans
(fetched through the gateway's own HTTP client), the decode peers among
the sources, a subtree pulled from a relay peer, and the coordinated
``torch.profiler`` window — opened,
refused while open (409 at the gateway and the engine), closed, reopened
and always closed before the test ends."""

import asyncio
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.utils.tracing import TRACER, profile_window_stop

WAIT_S = 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_state():
    reset_learned_singletons()
    TRACER.clear()
    TRACER.disable()
    TRACER.sample = 1.0
    yield
    TRACER.clear()
    TRACER.disable()
    TRACER.sample = 1.0


def run(coro, timeout: float = WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _fleet(name: str):
    if name == "jax":
        from seldon_core_tpu.gateway import fleet
    else:
        from seldon_core_tpu_torch.gateway import fleet
    return fleet


def _iris_doc(name="d") -> dict:
    return {"spec": {"name": name, "predictors": [{
        "name": "p", "graph": {"name": "m", "type": "MODEL"},
        "components": [{"name": "m", "runtime": "inprocess",
                        "class_path": "IrisClassifier"}]}]}}


def _gen_doc(name="d") -> dict:
    return {"spec": {"name": name, "predictors": [{
        "name": "p", "graph": {"name": "gen", "type": "MODEL"},
        "components": [{"name": "gen", "runtime": "inprocess",
                        "class_path": "TransformerGenerator",
                        "parameters": [{"name": k, "value": v, "type": t} for k, v, t in (
                            ("vocab", "64", "INT"), ("d_model", "32", "INT"),
                            ("n_heads", "2", "INT"), ("n_layers", "2", "INT"),
                            ("d_ff", "64", "INT"), ("max_new_tokens", "4", "INT"),
                            ("dtype", "float32", "STRING"))]}]}]}}


def _port():
    from seldon_core_tpu_torch.gateway import apife, fleet
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.engine import EngineService

    return SimpleNamespace(apife=apife, fleet=fleet, Spec=SeldonDeploymentSpec,
                           SeldonMessage=SeldonMessage,
                           engine=lambda spec, **kw: EngineService(spec, device="cpu", **kw))


# -- the same math in both packages ---------------------------------------------------


OUTLIER_ROWS = [
    {"r0": {"dispatch_p99_ms": 10.0, "mfu": 0.4, "free_kv_blocks": 100},
     "r1": {"dispatch_p99_ms": 10.0, "mfu": 0.4, "free_kv_blocks": 100},
     "r2": {"dispatch_p99_ms": 30.0, "mfu": 0.1, "free_kv_blocks": 10}},
    {"a": {"ewma_ms": 2.0}, "b": {"ewma_ms": 30.0}},
    {"a": {"mfu": 0.0, "drift_max": 0.0}, "b": {"mfu": 0.5, "drift_max": 0.2},
     "c": {"mfu": "bogus", "drift_max": float("nan")}},
]


@pytest.mark.parametrize("case", range(len(OUTLIER_ROWS)))
def test_outlier_math_matches_jax(case):
    rows = OUTLIER_ROWS[case]
    got = _fleet("torch").compute_outliers(rows, threshold=1.5)
    assert got == _fleet("jax").compute_outliers(rows, threshold=1.5)
    if case == 0:
        assert got["median"]["dispatch_p99_ms"] == 10.0
        assert got["ratios"]["r2"] == {"dispatch_p99_ms": 3.0, "mfu": 4.0,
                                       "free_kv_blocks": 10.0}
        assert ("r0", "mfu") not in {(o["replica"], o["metric"]) for o in got["outliers"]}
    if case == 1:
        assert got["ratios"]["b"]["ewma_ms"] >= 1.5


ROW_DOCS = [
    ({"telemetry": {"batch": {"inflight_dispatches": 3},
                    "request_latency_s": {"engine": {"count": 100, "p99": 0.2}}},
      "genserver": {"role": "decode", "kv_blocks": {"total": 1000, "used": 400},
                    "imports": {"pending": 1, "committed_total": 7, "reclaimed_total": 0},
                    "disagg": {"handoffs": {"ok": 3}, "handoff_ms_p50": 1.5}},
      "quality": {"nodes": {"m": {"status": "live", "psi_max": 0.31}}}},
     {"executables": [{"executable": "e1", "calls": 10, "mfu": 0.25,
                       "latency_ms": {"p50": 5.0, "p99": 9.0}},
                      {"executable": "e2", "calls": 30, "mfu": 0.5,
                       "latency_ms": {"p50": 1.0, "p99": 2.0}}]},
     {"nodes": [{"scores": {"psi": 0.4}}], "slo": {"burn_rates": {"5m": 2.0}}}),
    (None, None, None),
    ({}, {"executables": [{"latency_ms": "bogus"}, "x"]}, {}),
]


@pytest.mark.parametrize("case", range(len(ROW_DOCS)))
def test_extract_replica_row_matches_jax(case):
    docs = ROW_DOCS[case]
    got = _fleet("torch").extract_replica_row(*docs)
    assert got == _fleet("jax").extract_replica_row(*docs)
    if case == 0:
        assert (got["inflight"], got["requests"], got["request_p99_ms"], got["dispatch_p99_ms"],
                got["dispatch_p50_ms"], got["mfu"], got["free_kv_blocks"], got["role"],
                got["drift_max"]) == (3, 100, 200.0, 9.0, 2.0, 0.5, 600, "decode", 0.4)
    if case == 1:
        assert got == {}


# -- the fleet document over port engines -----------------------------------------------


def test_fleet_surfaces_slow_replica_as_outlier():
    from seldon_core_tpu_torch.testing.faults import FaultSpec, FaultyEngine
    from seldon_core_tpu_torch.utils.quality import QUALITY
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    p = _port()
    QUALITY.reset()

    async def drive():
        spec = p.Spec.from_json_dict(_iris_doc())
        fast = p.engine(spec)
        slow = FaultyEngine(p.engine(spec), FaultSpec(delay_s=0.03))
        store = p.apife.DeploymentStore()
        store.register(spec, {"p": [fast, slow]})
        gw = p.apife.ApiGateway(store, require_auth=False)
        msg = lambda: p.SeldonMessage.from_array(np.array([[5.1, 3.5, 1.4, 0.2]]))
        await fast.predict(msg())
        await slow.inner.predict(msg())
        for _ in range(40):
            await gw.predict(msg())
        doc = await p.fleet.fleet_document(gw)
        await gw.close()
        fast.close()
        slow.inner.close()
        return doc

    doc = run(drive())
    dep = doc["deployments"]["d/p"]
    assert set(dep["replicas"]) == {"inprocess-0", "inprocess-1"}
    worst = dep["outliers"][0]
    assert (worst["replica"], worst["metric"]) == ("inprocess-1", "ewma_ms")
    assert worst["ratio"] >= 1.5
    assert dep["replicas"]["inprocess-1"]["shared_process"] is True
    assert RECORDER.fleet_outliers["d/p"]["inprocess-1"] >= 1.5
    assert RECORDER.fleet_replicas["d/p"] == 2
    assert doc["enabled"] is True and "burn" in doc


def test_fleet_kill_switch_dead_lease_and_scrape_tick_gauges(monkeypatch):
    from seldon_core_tpu_torch.gateway.federation import lease_ttl_s
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    p = _port()
    published = {}
    monkeypatch.setattr(RECORDER, "set_fleet_staleness",
                        lambda set_name, replica, s: published.__setitem__(replica, s))

    async def drive():
        spec = p.Spec.from_json_dict(_iris_doc())
        live = p.engine(spec)
        store = p.apife.DeploymentStore()
        store.register(spec, {"p": [live, "http://127.0.0.1:1/gone"]})
        gw = p.apife.ApiGateway(store, require_auth=False)
        monkeypatch.setenv("SELDON_TPU_FLEET", "0")
        off = await p.fleet.fleet_document(gw)
        monkeypatch.delenv("SELDON_TPU_FLEET")
        (src,) = [s for s in p.fleet.gather_sources(gw) if s.lane == "http"]
        ep = src.endpoint
        ep.fleet_docs = {"ts": time.monotonic(), "perf": None, "quality": None,
                         "stats": {"telemetry": {"request_latency_s": {
                             "engine": {"count": 500, "p99": 0.002}}}}}
        ep.lease_state = "dead"
        on = await p.fleet.fleet_document(gw)
        await gw.close()
        live.close()
        # the scrape tick's lane: a dead lease still publishes its staleness
        store = p.apife.DeploymentStore()
        store.register(spec, {"p": ["http://127.0.0.1:1/a", "http://127.0.0.1:2/b"]})
        gw = p.apife.ApiGateway(store, require_auth=False)
        dead, alive = [s.endpoint for s in p.fleet.gather_sources(gw)]
        now = time.monotonic()
        for e, lease in ((dead, "dead"), (alive, "live")):
            e.fleet_docs = {"ts": now, "stats": {}, "perf": None, "quality": None}
            e.lease_state = lease
        published.clear()
        p.fleet.refresh_outlier_gauges(gw)
        await gw.close()
        return off, on, ep.name, dead.name, alive.name

    off, on, name, dead, alive = run(drive())
    assert off["enabled"] is False and list(off["deployments"]["d/p"]["replicas"]) == [
        "inprocess-0"]
    dep = on["deployments"]["d/p"]
    row = dep["replicas"][name]
    assert (row["lease"], row["error"]) == ("dead", "engine lease lapsed")
    assert "requests" not in row and row["staleness_s"] >= lease_ttl_s()
    assert name not in dep["ratios"]
    assert published[dead] >= lease_ttl_s() > published[alive]


def test_federated_trace_merges_a_remote_sources_spans():
    """``/trace?puid=`` on the gateway: the local spans and a URL replica's
    (its ``/trace`` fetched through the gateway's HTTP client) merge into
    one tree; an unreachable source makes the answer partial with its
    reason; the export puts each source on its own track."""
    from seldon_core_tpu_torch.runtime.rest import FastHttpServer
    from seldon_core_tpu_torch.utils.tracing import Span

    p = _port()
    remote_span = Span(puid="pq", name="m", kind="server", method="predict",
                       start_s=time.time(), duration_ms=2.0, trace_id="t" * 32,
                       span_id="a" * 16, parent_span_id="b" * 16)

    class Routes:
        post, any = {}, {}

        def __init__(self):
            self.get = {b"/trace": self.trace}

        async def trace(self, body, ctype):
            return 200, json.dumps({"spans": [remote_span.to_json_dict()]}).encode(), \
                "application/json"

    async def drive():
        server = FastHttpServer(routes=Routes())
        await server.start("127.0.0.1", 0)
        spec = p.Spec.from_json_dict(_iris_doc())
        store = p.apife.DeploymentStore()
        store.register(spec, {"p": [f"http://127.0.0.1:{server.port}", "http://127.0.0.1:1"]})
        gw = p.apife.ApiGateway(store, require_auth=False)
        TRACER.enable()
        with TRACER.span("pq", "gateway", kind="request", method="predict"):
            pass
        try:
            doc = await p.fleet.federated_trace_document(gw, puid="pq")
            export = await p.fleet.federated_export_document(gw, puid="pq")
        finally:
            await gw.close()
            await server.stop()
        return doc, export

    doc, export = run(drive())
    assert doc["federated"] is True
    assert {s["name"] for s in doc["spans"]} == {"gateway", "m"}
    by_source = {r["source"]: r for r in doc["sources"]}
    assert [r["spans"] for r in doc["sources"]][:2] == [1, 1]
    assert by_source["http://127.0.0.1:1"]["error"] and doc["partial"] is True
    tracks = {e["args"]["name"] for e in export["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert len(tracks) == 2 and any("127.0.0.1" in t for t in tracks)


class _TraceShim:
    """A relay-served remote process answering OP_TRACE with canned spans."""

    def __init__(self, spans):
        self.spans = spans

    def trace_json(self, query: str) -> str:
        tid = json.loads(query or "{}").get("trace_id", "")
        return json.dumps({"spans": [s.to_json_dict() for s in self.spans
                                     if s.trace_id == tid]})


def test_federated_merge_pulls_a_subtree_over_the_relay(monkeypatch):
    """Spans only a relay peer holds (``SELDON_TPU_FLEET_PEERS`` ``uds:``)
    merge under the gateway's root: one tree, not partial; with
    ``SELDON_TPU_FLEET=0`` the local spans only; a dead peer makes the
    answer partial with its reason."""
    import tempfile

    from seldon_core_tpu_torch.runtime.udsrelay import serve_uds
    from seldon_core_tpu_torch.utils.tracing import Span

    p = _port()
    TRACER.enable()
    tid = "ab" * 16
    TRACER.add(Span(puid="pX", name="gateway", kind="request", method="predict",
                    start_s=1000.0, duration_ms=50.0, trace_id=tid, span_id="11" * 8))
    remote = [Span(puid="pX", name="decode", kind="dispatch", method="decode",
                   start_s=1000.01, duration_ms=30.0, trace_id=tid, span_id="22" * 8,
                   parent_span_id="11" * 8)]
    sock = os.path.join(tempfile.mkdtemp(prefix="fleet-", dir="/tmp"), "s.sock")

    async def drive():
        server = await serve_uds(_TraceShim(remote), sock)
        gw = p.apife.ApiGateway(p.apife.DeploymentStore(), require_auth=False)
        try:
            monkeypatch.setenv("SELDON_TPU_FLEET_PEERS", f"uds:{sock}")
            merged = await p.fleet.federated_trace_document(gw, trace_id=tid)
            monkeypatch.setenv("SELDON_TPU_FLEET", "0")
            killed = await p.fleet.federated_trace_document(gw, trace_id=tid)
            monkeypatch.delenv("SELDON_TPU_FLEET")
            monkeypatch.setenv("SELDON_TPU_FLEET_PEERS", "uds:/nonexistent/peer.sock")
            dead = await p.fleet.federated_trace_document(gw, trace_id=tid)
        finally:
            await gw.close()
            await server.stop()
        return merged, killed, dead

    doc, killed, dead = run(drive())
    assert {s["name"] for s in doc["spans"]} == {"gateway", "decode"}
    assert doc["partial"] is False and len(doc["tree"]) == 1
    assert doc["tree"][0]["children"][0]["name"] == "decode"
    assert next(r for r in doc["sources"] if r["lane"] == "relay")["spans"] == 1
    assert killed["federated"] is False and {s["name"] for s in killed["spans"]} == {"gateway"}
    assert dead["partial"] is True
    assert "peer.sock" in [m for m in dead["missing"] if m.get("source")][0]["source"]


def test_gather_sources_includes_decode_peers_and_dedups():
    p = _port()
    spec = p.Spec.from_json_dict(_gen_doc())
    prefill = p.engine(spec, gen_role="prefill", decode_peers=["uds:/tmp/fleet-decode.sock"])
    store = p.apife.DeploymentStore()
    store.register(spec, {"p": [prefill, prefill]})
    gw = p.apife.ApiGateway(store, require_auth=False)
    try:
        lanes = [(s.lane, s.role) for s in p.fleet.gather_sources(gw)]
        assert lanes.count(("inprocess", "prefill")) == 1 and ("relay", "decode") in lanes
    finally:
        run(gw.close())
        prefill.close()


# -- the coordinated profile window --------------------------------------------------------


def test_profile_window_coordinated_overlap_refused_and_routes(tmp_path, monkeypatch):
    """A coordinated window over an in-process engine is the process's one
    ``torch.profiler`` window: a second start answers 409 at the gateway
    and at the engine's own lock; the stop closes it, writes its artifact
    directory, and a fresh window opens cleanly; the same over the
    gateway's HTTP routes (start 200, start 409, stop 200, /profile
    inactive)."""
    from seldon_core_tpu_torch.gateway.apife import serve_gateway
    from seldon_core_tpu_torch.runtime.client import HttpClient
    from seldon_core_tpu_torch.utils.tracing import ProfileBusyError, profile_window_start

    p = _port()
    monkeypatch.setenv("SELDON_TPU_PROFILE_DIR", str(tmp_path))

    async def drive():
        spec = p.Spec.from_json_dict(_iris_doc())
        e1 = p.engine(spec)
        store = p.apife.DeploymentStore()
        store.register(spec, {"p": e1})
        gw = p.apife.ApiGateway(store, require_auth=False)
        out = {}
        try:
            out["start"] = await p.fleet.profile_start(gw, duration_s=30.0)
            out["again"] = await p.fleet.profile_start(gw, duration_s=1.0)
            try:
                profile_window_start(str(tmp_path / "second"), 1.0)
                out["engine_lock"] = False
            except ProfileBusyError:
                out["engine_lock"] = True
            out["stop"] = await p.fleet.profile_stop(gw)
            out["status"] = p.fleet.profile_status(gw)
            server = await serve_gateway(gw, "127.0.0.1", 0)
            cl = HttpClient()
            base = f"http://127.0.0.1:{server.port}"
            try:
                codes = []
                for path, body in (("/profile/start", b'{"duration_s": 30.0}'),
                                   ("/profile/start", b'{"duration_s": 1.0}'),
                                   ("/profile/stop", b"")):
                    codes.append((await cl.post(base + path, body)).status)
                out["codes"] = codes
                out["get"] = (await cl.get(base + "/profile")).json()
            finally:
                await cl.close()
                await server.stop()
        finally:
            profile_window_stop()  # never leave a window open
            await gw.close()
            e1.close()
        return out

    out = run(drive())
    status, manifest = out["start"]
    assert status == 200 and manifest["state"] == "closed"  # closed by the stop
    entry = manifest["sources"][0]
    assert entry["lane"] == "inprocess" and entry["artifact"].startswith(str(tmp_path))
    assert os.path.exists(entry["artifact"])  # the torch.profiler trace, written
    assert out["again"][0] == 409 and "already open" in out["again"][1]["error"]
    assert out["engine_lock"] is True
    assert out["stop"][0] == 200 and out["status"]["local"]["active"] is False
    assert out["codes"] == [200, 409, 200] and out["get"]["local"]["active"] is False
