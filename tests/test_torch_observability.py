"""The observability slice served end to end on the CPU: the port's MNIST
engine against the JAX package's with tracing on (the same span names,
kinds and tree for one request, the same ``/perf`` rows and call counts,
the reference's ``/stats`` walks), one trace tree per request across the
batcher and the dispatch thread, the engine's observability routes over
the REST lane (``/prometheus`` parsed with ``prometheus_client``'s
parsers, ``/perf``, ``/genperf``, ``/overhead``, ``/trace``,
``/trace/export``, the trace switches and the profile window's
contract), a ``traceparent`` across a REST, a binary-wire, a gRPC and a
relay hop, and the continuous lane's ``/genperf`` accounting."""

import asyncio
import json
import os
import socket
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from prometheus_client.openmetrics.parser import text_string_to_metric_families as om_parse
from prometheus_client.parser import text_string_to_metric_families as text_parse

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.utils import hotrecord as jhr
from seldon_core_tpu.utils import perf as jperf
from seldon_core_tpu.utils import tracing as jtr
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    PredictiveUnit,
    SeldonDeploymentSpec,
    UnitType,
)
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime import udsrelay
from seldon_core_tpu_torch.runtime.client import make_node_runtime
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcServer
from seldon_core_tpu_torch.runtime.microservice import build_runtime
from seldon_core_tpu_torch.runtime.rest import serve_fast, serve_unit
from seldon_core_tpu_torch.utils import hotrecord as phr
from seldon_core_tpu_torch.utils import perf as pperf
from seldon_core_tpu_torch.utils import tracing as ptr
from seldon_core_tpu_torch.utils.genperf import GENPERF
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

WAIT_S = 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    # the autopilot's table, the brownout ladder, the fleet burn view and the
    # cost ledger are process-global and change decisions: what one test
    # trained must not steer the next
    reset_learned_singletons()
    yield


@pytest.fixture
def traced(monkeypatch):
    """Both packages' tracers on at sample 1, cleared before and after;
    the process-global perf tables fresh."""
    for tr, hr, perf in ((jtr, jhr, jperf), (ptr, phr, pperf)):
        hr.SPINE.drain()
        tr.TRACER.clear()
        perf.OBSERVATORY.reset()
        monkeypatch.setattr(tr.TRACER, "enabled", True)
        monkeypatch.setattr(tr.TRACER, "sample", 1.0)
    yield
    for tr, hr in ((jtr, jhr), (ptr, phr)):
        hr.SPINE.drain()
        tr.TRACER.clear()


def _mnist_doc(hidden=32):
    return {"spec": {"name": "mnist-deployment", "predictors": [{
        "name": "main",
        "components": [{"name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": str(hidden),
                                        "type": "INT"}]}],
        "graph": {"name": "mnist", "type": "MODEL", "children": []}}]}}


def _port_engine():
    return EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu")


def _body(x, puid):
    return json.dumps({"meta": {"puid": puid}, "data": {"ndarray": x.tolist()}})


def _shape(spans, root_id, keep=lambda s: True):
    """The tree under ``root_id`` as nested (name, kind, method, children)."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent_span_id, []).append(s)

    def node(s):
        return (s.name, s.kind, s.method,
                tuple(sorted(node(c) for c in kids.get(s.span_id, ()) if keep(c))))

    root = next(s for s in spans if s.span_id == root_id)
    return node(root)


def test_engines_give_the_same_spans_perf_rows_and_stats_walks(traced):
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()))
    engine = _port_engine()
    engine.load_states({"mnist": params_from_jax(
        {k: np.asarray(v) for k, v in jax_engine.states()["mnist"].items()}, device="cpu")})
    x = np.random.default_rng(0).random((1, 784))

    async def run():
        for i in range(3):
            assert (await engine.predict_json(_body(x, f"obs-{i}")))[1] == 200
            assert (await jax_engine.predict_json(_body(x, f"obs-{i}")))[1] == 200

    try:
        asyncio.run(run())
        for i in range(3):
            js, ps = jtr.TRACER.trace(f"obs-{i}"), ptr.TRACER.trace(f"obs-{i}")
            jroot = next(s for s in js if s.kind == "request")
            proot = next(s for s in ps if s.kind == "request")
            # one tree each; the port's dispatch span is the request's child,
            # the JAX engine's stacked dispatch stands alone
            assert _shape(ps, proot.span_id, lambda s: s.kind != "dispatch") == \
                _shape(js, jroot.span_id)
            assert ("dispatch", "dispatch", "predict") in {
                (s.name, s.kind, s.method) for s in ps if s.parent_span_id == proot.span_id}
        jd = {(s.name, s.kind, s.method) for s in jtr.TRACER.recent(200) if s.kind == "dispatch"}
        pd = {(s.name, s.kind, s.method) for s in ptr.TRACER.recent(200) if s.kind == "dispatch"}
        assert pd == jd
        jp, pp = jax_engine.perf_document(), engine.perf_document()
        assert set(pp) == set(jp) and pp["engine"] == jp["engine"]
        jrows = {r["executable"]: r["calls"] for r in jp["executables"]}
        prows = {r["executable"]: r["calls"] for r in pp["executables"]}
        assert prows == jrows == {"predict[1x784/float32]": 3}
        assert set(pp["executables"][0]) == set(jp["executables"][0])  # the row's fields
        jstats, pstats = jax_engine.stats(), engine.stats()
        for walk in ("telemetry", "perf", "tracer", "audit"):
            assert set(pstats[walk]) == set(jstats[walk]), walk
        assert {"boot_id", "quality", "staleness_s"} <= set(pstats)
        assert set(engine.overhead_document()) == set(jax_engine.overhead_document())
        assert set(engine.genperf_document()) == set(jax_engine.genperf_document())
    finally:
        engine.close()
        asyncio.run(jax_engine.close())


def test_one_tree_per_request_across_the_batcher_and_dispatch_threads(traced):
    engine = _port_engine()
    x = np.random.default_rng(1).random((1, 784))

    async def serial():
        for i in range(4):
            assert (await engine.predict_json(_body(x, f"s-{i}")))[1] == 200

    async def concurrent():
        out = await asyncio.gather(*(engine.predict_json(_body(x, f"c-{i}")) for i in range(6)))
        assert all(status == 200 for _, status in out)

    try:
        asyncio.run(serial())
        asyncio.run(concurrent())
    finally:
        engine.close()
    for i in range(4):
        spans = ptr.TRACER.trace(f"s-{i}")
        roots = [s for s in spans if not s.parent_span_id]
        assert len(roots) == 1 and roots[0].name == "request"
        assert len({s.trace_id for s in spans}) == 1
        assert {(s.name, s.parent_span_id) for s in spans if s is not roots[0]} == {
            ("batch_queue", roots[0].span_id), ("dispatch", roots[0].span_id)}
        doc = ptr.trace_document(ptr.TRACER, puid=f"s-{i}")
        covered = sum(seg["self_ms"] for seg in doc["critical_path"])
        assert covered >= 0.9 * doc["root_duration_ms"]
    for i in range(6):
        spans = ptr.TRACER.trace(f"c-{i}")
        assert len([s for s in spans if not s.parent_span_id]) == 1
        assert len({s.trace_id for s in spans}) == 1
        assert {"request", "batch_queue"} <= {s.name for s in spans}


class _Server:
    """The port's REST lane for ``engine`` on a private loop thread."""

    def __init__(self, engine):
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = asyncio.run_coroutine_threadsafe(
            serve_fast(engine, "127.0.0.1", 0), self.loop).result(30)
        self.base = f"http://127.0.0.1:{self.server.port}"

    def call(self, path, body=None, headers=None, method=None):
        req = urllib.request.Request(self.base + path, data=body, headers=headers or {},
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, r.read(), r.headers.get("Content-Type")
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers.get("Content-Type")

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture
def served(traced, monkeypatch, tmp_path):
    monkeypatch.setenv("SELDON_TPU_PROFILE_DIR", str(tmp_path))
    engine = _port_engine()
    srv = _Server(engine)
    yield engine, srv
    ptr.profile_window_stop()
    srv.close()
    engine.close()


def _families(text, parse):
    return {f.name: f for f in parse(text) if not f.name.endswith("_created")}


def test_routes_answer_the_reference_documents(served):
    engine, srv = served
    x = np.random.default_rng(2).random((1, 784))
    before = {f.name: f for f in text_parse(srv.call("/prometheus")[1].decode())}

    def calls():
        perf = json.loads(srv.call("/perf")[1])
        return sum(r["calls"] for r in perf["executables"]
                   if r["executable"] == "predict[1x784/float32]")

    calls_before = calls()

    def count(fams):
        fam = fams.get("seldon_api_engine_server_requests_duration_seconds")
        return sum(s.value for s in fam.samples if s.name.endswith("_count")) if fam else 0.0

    n = 5
    for i in range(n):
        st, body, _ = srv.call("/api/v0.1/predictions", _body(x, f"r-{i}").encode(),
                               {"Content-Type": "application/json"})
        assert st == 200, body
    st, text, ctype = srv.call("/prometheus")
    assert st == 200 and ctype.startswith("text/plain; version=0.0.4")
    fams = _families(text.decode(), text_parse)
    want = set()
    for base in MetricsRegistry.family_names():
        want.add(base[: -len("_total")] if base.endswith("_total") else base)
    assert set(fams) == want
    assert count(fams) - count(before) == n
    for accept in ({"Accept": "application/openmetrics-text"}, None):
        path = "/prometheus" if accept else "/prometheus?format=openmetrics"
        st, text, ctype = srv.call(path, headers=accept)
        assert st == 200 and ctype.startswith("application/openmetrics-text")
        om = _families(text.decode(), om_parse)
        assert set(om) == want
        dispatch = om["seldon_tpu_dispatch_seconds"]
        exemplars = [s.exemplar for s in dispatch.samples if s.exemplar]
        assert exemplars and all("trace_id" in e.labels for e in exemplars)
    st, body, _ = srv.call("/perf")
    perf = json.loads(body)
    row = next(r for r in perf["executables"] if r["executable"] == "predict[1x784/float32]")
    assert row["calls"] - calls_before == n  # the process-global table: the delta
    assert row["flops"] == 2 * (784 * 32 + 32 * 32 + 32 * 10)
    assert perf["device"]["platform"] == "cpu" and perf["hbm"][0]["memory_stats"] is None
    st, body, _ = srv.call("/genperf")
    assert st == 200 and json.loads(body)["scheduler"] is None
    st, body, _ = srv.call("/overhead")
    over = json.loads(body)
    assert over["budget_ms"] == 1.0 and over["framework_p50_ms"] is not None
    st, body, _ = srv.call("/trace?puid=r-0")
    doc = json.loads(body)
    assert {s["name"] for s in doc["spans"]} == {"request", "batch_queue", "dispatch"}
    assert doc["tree"][0]["name"] == "request" and doc["critical_path"]
    st, body, _ = srv.call("/trace/export?limit=50")
    assert st == 200 and json.loads(body)["traceEvents"]
    assert srv.call("/trace?limit=x")[0] == 400
    st, body, _ = srv.call("/stats")
    assert {"telemetry", "perf", "tracer", "quality", "audit"} <= set(json.loads(body))


def test_trace_switches_are_post_only(served):
    engine, srv = served
    assert srv.call("/trace/enable")[0] == 405
    assert srv.call("/trace/disable", b"", method="POST")[:2] == (200, b"tracing disabled")
    assert ptr.TRACER.enabled is False
    assert srv.call("/trace/enable", b"", method="POST")[:2] == (200, b"tracing enabled")
    assert ptr.TRACER.enabled is True
    assert srv.call("/nowhere")[0] == 404


def test_engine_profile_routes_contract(served):
    """``tests/test_fleet_observability.py::test_engine_profile_routes_
    contract`` on the port's engine app."""
    engine, srv = served
    st, body, _ = srv.call("/profile/start", json.dumps({"duration_s": 30.0}).encode(),
                           method="POST")
    assert st == 200
    doc = json.loads(body)
    assert doc["active"] is True and doc["artifact"]
    assert srv.call("/profile/start", b"{}", method="POST")[0] == 409
    x = np.random.default_rng(3).random((1, 784))
    assert srv.call("/api/v0.1/predictions", _body(x, "prof").encode())[0] == 200
    st, body, _ = srv.call("/profile/stop", b"", method="POST")
    assert st == 200
    last = json.loads(body)["last"]
    assert "error" not in last and os.path.exists(last["artifact"]) and last["events"] > 0
    st, body, _ = srv.call("/profile")
    assert json.loads(body)["active"] is False


# ---------------------------------------------------------------------------
# a traceparent across hops
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _unit_runtime():
    from seldon_core_tpu_torch.graph.spec import Parameter

    return build_runtime("MnistClassifier", "MODEL",
                         [Parameter(name="hidden", value="16", type="INT")],
                         unit_name="m3", device="cpu")


def _node(runtime_kind, port, wire_ok=True):
    node = make_node_runtime(
        PredictiveUnit(name="m3", type=UnitType.MODEL),
        ComponentBinding(name="m3", runtime=runtime_kind, host="127.0.0.1", port=port))
    if runtime_kind == "rest":
        node._wire_ok = wire_ok
    return node


def _check_hop(puid, transport):
    spans = ptr.TRACER.trace(puid)
    root = next(s for s in spans if s.name == "caller")
    client = next(s for s in spans if s.kind == "client")
    server = next(s for s in spans if s.kind == "server")
    assert client.parent_span_id == root.span_id
    assert server.parent_span_id == client.span_id  # the traceparent crossed the hop
    assert root.trace_id == client.trace_id == server.trace_id
    assert client.attrs.get("transport") == transport and server.name == "m3"


@pytest.mark.parametrize("lane", ["rest", "wire", "grpc"])
def test_a_traceparent_survives_the_hop_into_the_unit_s_tracer(traced, lane):
    runtime = _unit_runtime()
    x = np.random.default_rng(4).random((1, 784))
    puid = f"hop-{lane}"

    async def run():
        if lane == "grpc":
            server = FastGrpcServer.for_unit(runtime)
            await server.start("127.0.0.1", 0)
        else:
            server = await serve_unit(runtime, "127.0.0.1", 0)
        node = _node("grpc" if lane == "grpc" else "rest", server.port, wire_ok=lane == "wire")
        try:
            msg = SeldonMessage.from_array(x)
            msg.meta.puid = puid
            with ptr.TRACER.span(puid, "caller", kind="request"):
                out = await node.predict(msg)
            assert out.array().shape == (1, 10)
        finally:
            node.close()
            await server.stop()

    asyncio.run(run())
    _check_hop(puid, {"rest": "rest", "wire": "wire", "grpc": "grpc"}[lane])


@pytest.fixture
def sock_dir():
    """A short directory for the socket file (sun_path holds 108 bytes)."""
    d = tempfile.mkdtemp(prefix="sct")
    yield d
    for name in os.listdir(d):
        os.unlink(os.path.join(d, name))
    os.rmdir(d)


def test_a_traceparent_survives_the_relay_hop(traced, sock_dir):
    engine = _port_engine()
    path = os.path.join(sock_dir, "r.sock")
    x = np.random.default_rng(5).random((1, 784))

    async def run():
        server = await udsrelay.serve_uds(engine, path)
        client = udsrelay.UdsRelayClient(path)
        try:
            with ptr.TRACER.span("relay-1", "caller", kind="request"):
                caller = ptr.current_trace_context()
                body, status = await client.call(udsrelay.OP_PREDICT,
                                                 _body(x, "relay-1").encode(),
                                                 meta=udsrelay.current_relay_meta())
            assert status == 200, body
            doc, st = await client.call(udsrelay.OP_TRACE,
                                        json.dumps({"trace_id": caller.trace_id}).encode())
            return caller, json.loads(doc), st
        finally:
            await client.close()
            await server.stop()

    try:
        caller, doc, st = asyncio.run(run())
    finally:
        engine.close()
    assert st == 200
    spans = {s["name"]: s for s in doc["spans"]}
    assert spans["request"]["parent_span_id"] == caller.span_id
    assert spans["request"]["trace_id"] == caller.trace_id


# ---------------------------------------------------------------------------
# the continuous lane behind /genperf
# ---------------------------------------------------------------------------


def _gen_spec():
    dims = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_new_tokens=12)
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in dims.items()]
    params.append({"name": "dtype", "value": "float32", "type": "STRING"})
    return SeldonDeploymentSpec.from_json_dict({"spec": {"name": "cg", "predictors": [{
        "name": "p", "graph": {"name": "g", "type": "MODEL"},
        "components": [{"name": "g", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": params}]}]}})


def test_genperf_accounts_for_the_scheduler_s_wall(traced, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_GEN_SPAN", "4")
    # prompts longer than one prefill chunk: ticks that only prefill
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK", "8")
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK_MAX", "8")
    GENPERF.reset()
    engine = EngineService(_gen_spec(), device="cpu")
    rng = np.random.default_rng(6)

    async def run():
        reqs = [engine.predict_json(_body(rng.integers(0, 48, (1, 20)), f"g-{i}"))
                for i in range(3)]
        reqs.append(engine.predict_json(_body(rng.integers(0, 48, (4, 17)), "g-batch")))
        out = await asyncio.wait_for(asyncio.gather(*reqs), WAIT_S)
        assert all(status == 200 for _, status in out)

    try:
        asyncio.run(run())
        doc = engine.genperf_document()
    finally:
        engine.close()
    assert doc["ticks"].get("prefill", 0) > 0
    assert doc["ticks"].get("decode", 0) + doc["ticks"].get("mixed", 0) > 0
    assert doc["accounting"]["accounted_fraction"] >= 0.95
    served = doc["served_decode"]
    # the decode steps the ticks ran are the scheduler's own count: what a
    # card's paged-decode launches are held to (layers x steps)
    assert served["device_steps"] == engine.genserver.decode_steps_total > 0
    # priced (the CPU's figures round to ~0 against the assumed peaks)
    assert served["decode_device_s"] > 0 and served["real_tokens"] > 0
    assert served["served_decode_mfu_pct"] is not None
    assert served["served_decode_hbm_bw_util_pct"] is not None
    assert doc["adaptive_chunk"]["floor"] == engine.genserver.prefill_chunk
    assert doc["scheduler"]["admitted_total"] == 7
    seqs = [s for s in ptr.TRACER.trace("g-batch") if s.name == "gen_sequence"]
    assert len(seqs) == 4 and all(s.events[0]["name"] == "enqueue" for s in seqs)
    root = next(s for s in ptr.TRACER.trace("g-batch") if s.kind == "request")
    assert all(s.parent_span_id == root.span_id for s in seqs)


# -- /stats and /genperf are the reference's documents (Queue 3 item 5) --------


# the engine's own blocks, whose keys are fixed three levels down; the
# observatory walks' deeper maps are keyed by data (nodes, executables,
# tenants) that other tests' process-global singletons also fill
_FIXED_BLOCKS = ("engine", "batcher", "genserver", "scheduler", "resilience")


def _key_tree(doc, depth=3, prefix=""):
    """The document's keys as paths: two levels, three under the engine's
    own blocks."""
    out = set()
    if isinstance(doc, dict) and depth:
        for k, v in doc.items():
            out.add(f"{prefix}/{k}")
            sub = depth - 1 if prefix or k in _FIXED_BLOCKS else min(depth - 1, 1)
            out |= _key_tree(v, sub, f"{prefix}/{k}")
    return out


def _reset_observatories():
    """Both packages' process-global observatories fresh, pending records
    dropped first: the decode lane's ``GENPERF``, the flight recorder and
    the perf observatory.  Their maps are keyed by what earlier requests
    in the process ran (tick kinds, executables), so a key comparison
    reads only what the test's own engines serve."""
    from seldon_core_tpu.utils import genperf as jgp
    from seldon_core_tpu.utils import telemetry as jtel
    from seldon_core_tpu_torch.utils import telemetry as ptel

    for hr, perf, rec, gp in ((jhr, jperf, jtel.RECORDER, jgp.GENPERF),
                              (phr, pperf, ptel.RECORDER, GENPERF)):
        hr.SPINE.drain()
        hr.SPINE.reset()
        perf.OBSERVATORY.reset()
        rec.reset()
        gp.reset()


@pytest.fixture
def fresh_observatories():
    """``_reset_observatories`` at set-up; the test may call it again."""
    _reset_observatories()
    yield _reset_observatories


@pytest.mark.parametrize("which", ["mnist", "generator"])
def test_stats_and_genperf_have_every_key_of_the_reference(which, fresh_observatories):
    """Both engines' ``stats()`` and ``genperf_document()`` after one
    request: every key of the reference's is in the port's (the port's
    ``kernels``, ``wire``, ``device``, ``engine.http_impl`` /
    ``codec`` and its scheduler counters are additions), and the
    reference's readers of ``engine.graph_fuse``, ``engine.paused`` and
    ``engine.dispatch_timeout_s`` resolve.  The observatories start fresh
    (Queue 3 item 6: the verdict depended on what ran before)."""
    _compare_stats_keys(which)


def test_the_key_comparison_holds_after_a_reference_generator_served(fresh_observatories,
                                                                        monkeypatch):
    """The order fault's regression case: a reference generator engine
    serves first, so the reference's ``GENPERF`` holds prefill, decode and
    idle ticks; after the reset the comparison still passes, for both
    documents."""
    from seldon_core_tpu.utils.genperf import GENPERF as JGENPERF

    # prompts longer than one prefill chunk: ticks that only prefill
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK", "8")
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK_MAX", "8")
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_gen_spec().to_json_dict()))
    rng = np.random.default_rng(3)

    async def run():
        for i in range(3):
            body = _body(rng.integers(0, 48, (1, 20)), f"pre-{i}")
            assert (await jax_engine.predict_json(body))[1] == 200

    asyncio.run(run())
    # one tick with nothing to do, as the loop runs when a pending KV import
    # wakes it (the scheduler thread is parked on its condition meanwhile)
    jax_engine.genserver._tick()
    # stopped (its thread joined), so no late tick of it lands after a reset
    jax_engine.genserver.stop()
    jhr.SPINE.drain()
    assert {"prefill", "decode", "idle"} <= set(JGENPERF.ticks), JGENPERF.ticks
    for which in ("mnist", "generator"):
        fresh_observatories()
        _compare_stats_keys(which)


def _compare_stats_keys(which):
    if which == "mnist":
        doc = _mnist_doc()
        jax_engine = JaxEngine(JaxSpec.from_json_dict(doc))
        engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
        body = json.dumps({"data": {"ndarray": np.zeros((1, 784)).tolist()}})
    else:
        jax_engine = JaxEngine(JaxSpec.from_json_dict(_gen_spec().to_json_dict()))
        engine = EngineService(_gen_spec(), device="cpu")
        body = json.dumps({"data": {"ndarray": [[1, 2, 3]]}})

    async def run():
        assert (await jax_engine.predict_json(body))[1] == 200
        assert (await engine.predict_json(body))[1] == 200

    try:
        asyncio.run(run())
        docs = [(jax_engine.stats(), engine.stats()),
                (jax_engine.genperf_document(), engine.genperf_document())]
    finally:
        engine.close()
        if jax_engine.genserver is not None:
            # its retire tick may follow the answer: none lands in a later
            # comparison's fresh observatories
            jax_engine.genserver.stop()
    for ref, port in docs:
        assert _key_tree(ref) <= _key_tree(port), sorted(_key_tree(ref) - _key_tree(port))
    stats = docs[0][1]
    assert stats["engine"]["graph_fuse"] == {"enabled": True, "plan": None}
    assert stats["engine"]["paused"] is False and stats["engine"]["dispatch_timeout_s"] == 30.0
    assert stats["engine"]["http_impl"] == "python" and stats["engine"]["codec"] == "native"
    assert stats["engine"]["pipelined"] is (which == "mnist")
    if which == "mnist":
        assert stats["genserver"] is None and stats["engine"]["known_good_widths"] == ["(784,)"]
        assert stats["batcher"]["pad_to_buckets"] is True
        assert stats["batcher"]["atomic_chunks"] is False
    else:
        gen = stats["genserver"]
        assert gen["role"] == "unified" and gen["mesh"] is None
        assert gen["kv_blocks"]["reserved"] == 0 and gen["sequence_ledger"] == []
