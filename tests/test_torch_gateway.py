"""The port's gateway (seldon_core_tpu_torch/gateway/apife.py, firehose.py,
shadow.py; the route table on the port's FastHttpServer and the gRPC front
``FastGrpcServer.for_gateway``) against the JAX package's, on the CPU.

  * the canary example's state built by the reference's ``init_state`` and
    carried across: 200 1-row requests through both gateways with one seed
    pick the same predictor sequence, their answers agree within MNIST's
    tolerance and their meta carries the same keys;
  * every route of the JAX ``make_gateway_app``: the same status codes and
    document keys for the same calls (the OAuth flow, predictions over JSON
    and the binary wire, feedback, the stream route, the observability and
    fleet surfaces, the profile window's manifest);
  * SSE: examples/generator_deployment.json in f32 streamed through the
    gateway in process and relayed from a remote port engine gives the JAX
    gateway's greedy tokens of the JAX engine; a shed answers 503 before
    any frame; a stream whose engine dies mid-generation re-homes to a peer
    by re-prefill, and with federation off relays the break in band;
  * the firehose's lines read by the JAX consumer and replayer unchanged;
  * shadow: ``prediction_delta`` against the JAX one, a candidate identical
    to the live predictor (same node name, hence same weights) reads
    disagreement 0.0 in both packages, and the caps, the deadline clamp,
    the kill switch and ``GET /shadow``;
  * the hedged unary re-dispatch, the gRPC front's bearer token, gateway_main
    booted in process, and tests/test_mesh_kill.py's drill on two in-process
    port gateways over one sqlite file.

Remote engines are in-process stand-ins on the port's FastHttpServer, every
server listens on port 0 and every wait has its own timeout."""

import asyncio
import base64
import io
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

WAIT_S = 60
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_ATOL = 2e-2  # bf16 weights: the reference's tolerance (tests/test_ops_pallas.py:56)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


def run(coro, timeout: float = WAIT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _package(name: str) -> SimpleNamespace:
    """One package's gateway pieces under the same names; ``serve(gw)``
    listens on port 0 and returns (port, stop coroutine function)."""
    if name == "jax":
        from seldon_core_tpu.gateway import apife, firehose, shadow
        from seldon_core_tpu.graph import spec
        from seldon_core_tpu.messages import Feedback, SeldonMessage, prediction_delta
        from seldon_core_tpu.runtime import wire
        from seldon_core_tpu.runtime.engine import EngineService
        from seldon_core_tpu.runtime.rest import serve_app

        def engine(spec_, pred=None, **kw):
            return EngineService(spec_, pred, **kw)

        async def serve(gw):
            runner = await serve_app(apife.make_gateway_app(gw), "127.0.0.1", 0)
            return runner.addresses[0][1], runner.cleanup
    else:
        from seldon_core_tpu_torch.gateway import apife, firehose, shadow
        from seldon_core_tpu_torch.graph import spec
        from seldon_core_tpu_torch.messages import Feedback, SeldonMessage, prediction_delta
        from seldon_core_tpu_torch.runtime import wire
        from seldon_core_tpu_torch.runtime.engine import EngineService

        def engine(spec_, pred=None, **kw):
            return EngineService(spec_, pred, device="cpu", **kw)

        async def serve(gw):
            server = await apife.serve_gateway(gw, "127.0.0.1", 0)

            async def stop():
                await server.stop()
                await gw.close()

            return server.port, stop
    return SimpleNamespace(name=name, apife=apife, firehose=firehose, shadow=shadow, spec=spec,
                           Feedback=Feedback, SeldonMessage=SeldonMessage, wire=wire,
                           prediction_delta=prediction_delta, engine=engine, serve=serve)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


def _client():
    from seldon_core_tpu_torch.runtime.client import HttpClient

    return HttpClient()


def _basic(key: str, secret: str) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(f"{key}:{secret}".encode()).decode()}


def mnist_pair_doc(name="canary-dep", hidden=32) -> dict:
    """Main + canary MNIST predictors (the JAX test's two_predictor_spec)."""
    def predictor(pname, seed, replicas):
        return {"name": pname, "replicas": replicas,
                "components": [{"name": "m", "runtime": "inprocess",
                                "class_path": "MnistClassifier",
                                "parameters": [{"name": "hidden", "value": str(hidden),
                                                "type": "INT"},
                                               {"name": "seed", "value": str(seed),
                                                "type": "INT"}]}],
                "graph": {"name": "m", "type": "MODEL"}}

    return {"spec": {"name": name, "oauth_key": "key1", "oauth_secret": "secret1",
                     "predictors": [predictor("main", 0, 3), predictor("canary", 1, 1)]}}


def canary_picks(seed: int, weights, n: int) -> list:
    """The predictor indices a gateway seeded ``seed`` draws for its first
    ``n`` weighted picks: one ``default_rng(seed).choice`` a pick
    (chip_smoke.py pins the card's split to the same rule)."""
    rng = np.random.default_rng(seed)
    p = np.asarray(weights, dtype=np.float64)
    return [int(rng.choice(len(p), p=p / p.sum())) for _ in range(n)]


class StubEngines:
    """In-process stand-ins for remote engines on the port's FastHttpServer:
    ``/api/v0.1/predictions`` answers its row sums, ``/stats`` a minimal
    document, and ``/api/v0.1/generate/stream`` the arithmetic run
    prompt[-1]+1 .. +max_new, one event a token ``delay_s`` apart (the JAX
    package's toy engine's contract).  ``die_after`` tokens of a fresh
    stream, the connection is cut with no terminal event."""

    def __init__(self, delay_s=0.0, die_after=None):
        self.delay_s, self.die_after = delay_s, die_after
        self.bodies, self.servers = [], []

    def routes(self):
        stub = self

        class Routes:
            any = {}
            post_only = frozenset()

            def __init__(self):
                self.post = {b"/api/v0.1/predictions": self.predictions,
                             b"/api/v0.1/generate/stream": self.stream}
                self.get = {b"/stats": self.stats}

            async def predictions(self, body, ctype):
                from seldon_core_tpu_torch.messages import SeldonMessage

                if ctype.startswith("application/x-seldon-tensor"):
                    # JSON only: the gateway negotiates the binary wire down
                    return 415, b'{"status": {"status": "FAILURE", "code": 415}}', \
                        "application/json"
                msg = SeldonMessage.from_json(body.decode())
                out = msg.with_array(np.asarray(msg.array()).sum(axis=1, keepdims=True))
                return 200, out.to_json().encode(), "application/json"

            async def stats(self, body, ctype):
                return 200, b'{"telemetry": {"batch": {"inflight_dispatches": 0}}}', \
                    "application/json"

            async def stream(self, body, ctype):
                from seldon_core_tpu_torch.runtime.rest import StreamResult

                doc = json.loads(body)
                stub.bodies.append(doc)
                prompt = doc["data"]["ndarray"][0]
                fresh = stub.die_after is not None and len(stub.bodies) == 1

                async def events():
                    for j in range(1, int(doc.get("max_new", 5)) + 1):
                        if fresh and j > stub.die_after:
                            return  # the engine died: no terminal event
                        await asyncio.sleep(stub.delay_s)
                        yield json.dumps({"tokens": [[prompt[-1] + j]], "done": False})
                    yield json.dumps({"done": True})

                return StreamResult(200, "text/event-stream", events())

        return Routes()

    async def start(self, n: int) -> list:
        from seldon_core_tpu_torch.runtime.rest import FastHttpServer

        for _ in range(n):
            server = FastHttpServer(routes=self.routes())
            await server.start("127.0.0.1", 0)
            self.servers.append(server)
        return [f"http://127.0.0.1:{s.port}" for s in self.servers]

    async def stop(self):
        for s in self.servers:
            await s.stop()


def simple_remote_spec(pkg_or_spec_module, name="dep", key="key", predictors=("p",)):
    spec_mod = getattr(pkg_or_spec_module, "spec", pkg_or_spec_module)
    return spec_mod.SeldonDeploymentSpec.from_json_dict({"spec": {
        "name": name, "oauth_key": key, "oauth_secret": "s",
        "predictors": [{"name": p, "replicas": 1,
                        "graph": {"name": "m", "type": "MODEL",
                                  "implementation": "SIMPLE_MODEL"}} for p in predictors]}})


# -- auth ------------------------------------------------------------------------


def test_oauth_token_flow(pkg):
    spec = pkg.spec.SeldonDeploymentSpec.from_json_dict(mnist_pair_doc())
    store = pkg.apife.DeploymentStore()
    store.register(spec, {"main": "http://main:1", "canary": "http://canary:1"})
    with pytest.raises(pkg.apife.AuthError):
        store.issue_token("key1", "wrong")
    with pytest.raises(pkg.apife.AuthError):
        store.principal_for_token("garbage")
    token = store.issue_token("key1", "secret1")
    assert store.principal_for_token(token).deployment_id == "canary-dep"
    assert store.weights("canary-dep") == {"main": 3, "canary": 1}
    store.set_weights("canary-dep", {"canary": 2})
    assert store.weights("canary-dep") == {"main": 3, "canary": 2}
    with pytest.raises(KeyError):
        store.set_weights("canary-dep", {"nope": 1})
    store.unregister("key1")
    with pytest.raises(pkg.apife.AuthError):
        store.principal_for_token(token)


# -- the canary, against the reference ------------------------------------------


def test_canary_picks_answers_and_meta_match_jax():
    """examples/canary_deployment.json: the reference's ``init_state`` builds
    each predictor's MNIST, ``params_from_jax`` carries it into the port's
    engines, and 200 1-row requests through both gateways seeded alike pick
    the same predictors (the seed's draws exactly) with answers within
    MNIST's tolerance and the same meta keys."""
    from seldon_core_tpu_torch.convert import params_from_jax

    doc = json.load(open(os.path.join(ROOT, "examples", "canary_deployment.json")))
    jx, tx = _package("jax"), _package("torch")
    jspec = jx.spec.SeldonDeploymentSpec.from_json_dict(doc)
    tspec = tx.spec.SeldonDeploymentSpec.from_json_dict(doc)
    x = np.random.default_rng(5).random((200, 784))

    async def drive():
        out = {}
        jengines = {p.name: jx.engine(jspec, p.name) for p in jspec.predictors}
        tengines = {}
        for p in tspec.predictors:
            e = tx.engine(tspec, p.name)
            e.load_states({"mnist": params_from_jax(
                {k: np.asarray(v) for k, v in jengines[p.name].compiled.states["mnist"].items()},
                device="cpu")})
            tengines[p.name] = e
        for p, engines in ((jx, jengines), (tx, tengines)):
            store = p.apife.DeploymentStore()
            spec = jspec if p is jx else tspec
            store.register(spec, engines)
            gw = p.apife.ApiGateway(store=store, seed=7)
            token = store.issue_token("canary-key", "canary-secret")
            seq, ys, metas = [], [], []
            for row in x:
                resp = await gw.predict(p.SeldonMessage.from_array(row[None, :]), token)
                seq.append(resp.meta.requestPath["predictor"])
                ys.append(np.asarray(resp.array(), dtype=np.float64))
                metas.append(set(resp.to_json_dict()["meta"]))
            with pytest.raises(p.apife.AuthError):
                await gw.predict(p.SeldonMessage.from_array(x[:1]), None)
            await gw.close()
            out[p.name] = (seq, np.concatenate(ys), metas)
        for e in tengines.values():
            e.close()
        return out

    out = run(drive())
    (jseq, jy, jmeta), (tseq, ty, tmeta) = out["jax"], out["torch"]
    want = [("main", "canary")[i] for i in canary_picks(7, [3, 1], 200)]
    assert tseq == jseq == want
    assert 120 < tseq.count("main") < 180 and tseq.count("canary") > 20
    np.testing.assert_allclose(ty, jy, atol=MNIST_ATOL)
    assert tmeta == jmeta and all({"puid", "requestPath"} <= m for m in tmeta)


# -- every route, against the reference -----------------------------------------


def test_routes_status_codes_and_keys_match_jax():
    """The same calls to the JAX app and the port's route table answer the
    same status codes and documents with the same keys."""

    async def calls(p):
        spec = p.spec.SeldonDeploymentSpec.from_json_dict(mnist_pair_doc())
        engines = {q.name: p.engine(spec, q.name) for q in spec.predictors}
        store = p.apife.DeploymentStore()
        store.register(spec, engines)
        gw = p.apife.ApiGateway(store=store, seed=3)
        port, stop = await p.serve(gw)
        base = f"http://127.0.0.1:{port}"
        cl = _client()
        seen = []

        async def call(method, path, body=b"", headers=None):
            r = await cl.request(method, base + path, body, headers)
            try:
                doc = json.loads(r.body)
                keys = sorted(doc) if isinstance(doc, dict) else type(doc).__name__
            except ValueError:
                doc, keys = None, r.ctype
            seen.append((method, path.split("=")[0], r.status, keys))
            return r, doc

        try:
            _, tok = await call("POST", "/oauth/token", headers=_basic("key1", "secret1"))
            await call("POST", "/oauth/token", headers=_basic("key1", "nope"))
            await call("POST", "/oauth/token", b"client_id=key1&client_secret=secret1",
                       {"Content-Type": "application/x-www-form-urlencoded"})
            bearer = {"Authorization": "Bearer " + tok["access_token"],
                      "Content-Type": "application/json"}
            req = json.dumps({"data": {"ndarray": np.zeros((1, 784)).tolist()}}).encode()
            _, resp = await call("POST", "/api/v0.1/predictions", req, bearer)
            await call("POST", "/api/v0.1/predictions", req, {"Content-Type": "application/json"})
            await call("POST", "/api/v0.1/predictions", b"{not json", bearer)
            frame = p.wire.join_parts(p.wire.encode_frame(np.zeros((1, 784), np.float32)))
            r, _ = await call("POST", "/api/v0.1/predictions", frame,
                              {**bearer, "Content-Type": p.wire.WIRE_CONTENT_TYPE})
            assert r.ctype == p.wire.WIRE_CONTENT_TYPE
            fb = json.dumps({"request": json.loads(req), "response": resp, "reward": 1.0})
            await call("POST", "/api/v0.1/feedback", fb.encode(), bearer)
            await call("POST", "/api/v0.1/feedback", fb.encode(),
                       {"Content-Type": "application/json"})
            await call("POST", "/api/v0.1/feedback", b"[]", bearer)
            await call("POST", "/api/v0.1/generate/stream", req,
                       {"Content-Type": "application/json"})
            await call("POST", "/api/v0.1/generate/stream", req, bearer)
            for path in ("/ping", "/ready", "/prometheus", "/stats", "/shadow", "/rollouts",
                         "/quality", "/overhead", "/trace", "/trace/export", "/fleet",
                         "/corpus", "/costs", "/postmortems", "/profile"):
                await call("GET", path)
            await call("GET", "/trace?puid=" + resp["meta"]["puid"])
            await call("POST", "/profile/stop")  # no window opened yet: 404
            # a window over a deployment with no engine opens no profiler
            await call("POST", "/profile/start", b'{"deployment": "none", "duration_s": 1}',
                       {"Content-Type": "application/json"})
            await call("POST", "/profile/stop")
            await call("GET", "/oauth/token")
            await call("GET", "/nowhere")
            store.unregister("key1")
            await call("GET", "/ready")
        finally:
            await cl.close()
            await stop()
            if p.name == "torch":
                for e in engines.values():
                    e.close()
        return seen

    jseen = run(calls(_package("jax")))
    tseen = run(calls(_package("torch")))
    assert [s[:3] for s in tseen] == [s[:3] for s in jseen]
    assert tseen == jseen
    codes = {(m, path): st for m, path, st, _ in tseen}
    assert codes[("GET", "/rollouts")] == 404 and codes[("GET", "/nowhere")] == 404
    assert codes[("GET", "/oauth/token")] == 405


def test_feedback_routes_to_serving_predictor(pkg):
    class Recorder:
        def __init__(self, name):
            self.name, self.feedback = name, []

        async def predict(self, msg):
            return msg.with_array(np.ones((1, 2)))

        async def send_feedback(self, fb):
            self.feedback.append(fb.reward)
            return pkg.SeldonMessage()

    async def drive():
        spec = pkg.spec.SeldonDeploymentSpec.from_json_dict(mnist_pair_doc())
        engines = {"main": Recorder("main"), "canary": Recorder("canary")}
        store = pkg.apife.DeploymentStore()
        store.register(spec, engines)
        gw = pkg.apife.ApiGateway(store=store, seed=0)
        token = store.issue_token("key1", "secret1")
        served = []
        for i in range(12):
            msg = pkg.SeldonMessage.from_array(np.zeros((1, 4)))
            resp = await gw.predict(msg, token)
            ack = await gw.send_feedback(pkg.Feedback(request=msg, response=resp,
                                                      reward=float(i)), token)
            assert ack.status is None or ack.status.status == "SUCCESS"
            served.append(resp.meta.requestPath["predictor"])
        stats = gw.stats()["feedback"]
        await gw.close()
        return served, engines, stats

    served, engines, stats = run(drive())
    for name in ("main", "canary"):
        assert engines[name].feedback == [float(i) for i, s in enumerate(served) if s == name]
    assert stats == {"count": 12, "mean_reward": 5.5, "truth_provided": 0}


# -- the firehose ----------------------------------------------------------------


def test_firehose_lines_read_by_the_jax_consumer_and_replayer(tmp_path):
    """The port gateway's firehose writes the JAX gateway's line layout:
    the same keys for the same traffic, read back by the JAX consumer CLI
    and ``runtime/replay.py`` unchanged."""
    from seldon_core_tpu.gateway import firehose as jfh
    from seldon_core_tpu.runtime.replay import load_firehose_events

    class Echo:
        async def predict(self, msg):
            return msg.with_array(np.asarray(msg.array()) * 2)

    async def drive(p, d):
        spec = simple_remote_spec(p)
        store = p.apife.DeploymentStore()
        store.register(spec, {"p": Echo()})
        fh = p.firehose.Firehose(base_dir=str(d))
        gw = p.apife.ApiGateway(store=store, firehose=fh, seed=1)
        fh.start()
        token = store.issue_token("key", "s")
        for i in range(5):
            await gw.predict(p.SeldonMessage.from_array(np.full((1, 3), float(i))), token)
        fh.publish_event("dep", "rollout_stage", percent=10)
        await fh.stop()
        await gw.close()
        return [json.loads(line) for line in (d / "dep.jsonl").read_text().splitlines()]

    lines = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        lines[name] = run(drive(_package(name), d))
    assert [sorted(e) for e in lines["torch"]] == [sorted(e) for e in lines["jax"]]
    assert [e["request"] for e in lines["torch"][:5]] == [e["request"] for e in lines["jax"][:5]]
    events = load_firehose_events(str(tmp_path / "torch" / "dep.jsonl"))
    assert len(events) == 5  # the control-plane line is skipped
    out, old = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        jfh.main(["dep", "--dir", str(tmp_path / "torch")])
    finally:
        sys.stdout = old
    assert out.getvalue().count("status=SUCCESS") == 6


def test_firehose_consumer_holds_back_partial_lines(pkg, tmp_path):
    log = tmp_path / "dep.jsonl"
    full = '{"puid":"a","ts":1.0,"response":{"status":{"status":"SUCCESS"}}}\n'
    log.write_text(full + '{"puid":"b","ts":2.0')
    out, old = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        pkg.firehose.main(["dep", "--dir", str(tmp_path)])
    finally:
        sys.stdout = old
    assert "puid=a" in out.getvalue() and "puid=b" not in out.getvalue()


# -- SSE ---------------------------------------------------------------------------


def _generator_doc() -> dict:
    doc = json.load(open(os.path.join(ROOT, "examples", "generator_deployment.json")))
    comp = doc["spec"]["predictors"][0]["components"][0]
    comp["parameters"].append({"name": "dtype", "value": "float32", "type": "STRING"})
    return doc


async def _sse(cl, url, payload, headers=None):
    """(status, events) of a stream request read whole."""
    up = await cl.stream(url, json.dumps(payload).encode(),
                         {"Content-Type": "application/json", **(headers or {})})
    try:
        raw = await up.read()
    finally:
        up.close()
    if up.status != 200:
        return up.status, json.loads(raw)
    return 200, [json.loads(e.partition(b"data:")[2]) for e in raw.split(b"\n\n") if e.strip()]


def _tokens(events):
    return np.concatenate([np.asarray(e["tokens"]) for e in events if "tokens" in e], axis=1)


def test_sse_tokens_match_the_jax_gateway_in_process_and_relayed():
    from seldon_core_tpu_torch.convert import params_from_jax
    from seldon_core_tpu_torch.runtime.rest import serve_fast

    doc = _generator_doc()
    prompt = np.random.default_rng(9).integers(0, 256, size=(2, 6)).astype(float)
    payload = {"data": {"ndarray": prompt.tolist()}, "chunk": 4}

    async def drive():
        import jax

        jx, tx = _package("jax"), _package("torch")
        jspec = jx.spec.SeldonDeploymentSpec.from_json_dict(doc)
        tspec = tx.spec.SeldonDeploymentSpec.from_json_dict(doc)
        jengine = jx.engine(jspec)
        state = jax.tree_util.tree_map(np.asarray, jengine.compiled.states["gen"])
        tengines = []
        for _ in range(2):  # one in process, one remote
            e = tx.engine(tspec)
            e.load_states({"gen": params_from_jax(state, device="cpu")})
            tengines.append(e)
        remote = await serve_fast(tengines[1], "127.0.0.1", 0)
        cl = _client()
        out = {}
        try:
            for name, p, spec, target in (
                    ("jax", jx, jspec, jengine), ("torch", tx, tspec, tengines[0]),
                    ("relayed", tx, tspec, f"http://127.0.0.1:{remote.port}")):
                store = p.apife.DeploymentStore()
                store.register(spec, {"main": target})
                gw = p.apife.ApiGateway(store=store)
                port, stop = await p.serve(gw)
                url = f"http://127.0.0.1:{port}/api/v0.1/generate/stream"
                try:
                    st, _ = await _sse(cl, url, payload)
                    assert st == 401
                    token = store.issue_token("gen-key", "gen-secret")
                    st, events = await _sse(cl, url, payload,
                                            {"Authorization": "Bearer " + token})
                    assert st == 200 and events[-1].get("done") is True, events[-1:]
                    assert not any("error" in e for e in events)
                    out[name] = _tokens(events)
                finally:
                    await stop()
        finally:
            await cl.close()
            await remote.stop()
            for e in tengines:
                e.close()
        return out

    out = run(drive(), timeout=120)
    assert out["jax"].shape == (2, 16)
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["relayed"], out["jax"])


def test_sse_shed_answers_503_before_any_frame():
    """An admission shed on the first chunk answers a typed 503, not a 200
    that carries the failure in band; a failure after the first chunk ends
    the 200's stream with the in-band terminal event."""
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore, serve_gateway
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import LoadShedError

    class Streamer:
        def __init__(self, fail_at):
            self.fail_at, self.closed = fail_at, 0

        def prepare_stream_request(self, text):
            return json.loads(text)

        async def predict(self, msg):
            return msg

        async def generate_stream(self, request):
            try:
                for i in range(3):
                    if i == self.fail_at:
                        raise (LoadShedError("generation queue full: shed") if i == 0
                               else RuntimeError("scheduler died"))
                    yield json.dumps({"tokens": [[float(i)]], "done": False})
                yield json.dumps({"done": True})
            finally:
                self.closed += 1

    async def drive():
        shed, broken = Streamer(0), Streamer(2)
        spec = SeldonDeploymentSpec.from_json_dict(mnist_pair_doc())
        store = DeploymentStore()
        store.register(spec, {"main": shed})
        gw = ApiGateway(store=store, require_auth=False)
        server = await serve_gateway(gw, "127.0.0.1", 0)
        cl = _client()
        url = f"http://127.0.0.1:{server.port}/api/v0.1/generate/stream"
        try:
            st, doc = await _sse(cl, url, {"data": {"ndarray": [[1.0]]}})
            assert st == 503 and "shed" in doc["status"]["info"] and shed.closed == 1
            store.register(spec, {"main": broken})
            st, events = await _sse(cl, url, {"data": {"ndarray": [[1.0]]}})
            assert st == 200 and [e.get("tokens") for e in events[:2]] == [[[0.0]], [[1.0]]]
            assert events[-1]["done"] is True and "scheduler died" in events[-1]["error"]
            assert broken.closed == 1
            rs = gw._replica_sets[("canary-dep", "main")][1]
            assert rs.endpoints[0].inflight == 0  # the stream's load released
        finally:
            await cl.close()
            await server.stop()
            await gw.close()

    run(drive())


@pytest.mark.parametrize("federation", ["1", "0"])
def test_stream_broken_mid_generation(federation, monkeypatch):
    """An engine dies two tokens into a five-token stream: with federation
    on the gateway re-homes it to the peer with prompt + emitted as the
    prompt and the budget cut by what was served (tokens 10..14 exactly
    once, then the terminal event); with SELDON_TPU_FEDERATION=0 the break
    reaches the client in band and no resume is tried."""
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore, serve_gateway

    monkeypatch.setenv("SELDON_TPU_FEDERATION", federation)

    async def drive():
        stubs = StubEngines(die_after=2)
        urls = await stubs.start(2)
        store = DeploymentStore()
        store.register(simple_remote_spec(_package("torch")), {"p": urls})
        gw = ApiGateway(store=store, require_auth=False)
        server = await serve_gateway(gw, "127.0.0.1", 0)
        cl = _client()
        try:
            st, events = await _sse(cl, f"http://127.0.0.1:{server.port}/api/v0.1/generate/"
                                        f"stream", {"data": {"ndarray": [[1.0, 2.0, 9.0]]},
                                                    "max_new": 5})
            assert st == 200
            toks = [e["tokens"][0][0] for e in events if "tokens" in e]
            if federation == "1":
                assert toks == [10.0, 11.0, 12.0, 13.0, 14.0]
                assert events[-1] == {"done": True}
                assert gw.failovers.get("stream") == 1
                resume = stubs.bodies[1]
                assert resume["data"]["ndarray"] == [[1.0, 2.0, 9.0, 10.0, 11.0]]
                assert resume["max_new"] == 3
            else:
                assert toks == [10.0, 11.0]  # the raw relay: what the engine sent
                assert len(stubs.bodies) == 1 and gw.failovers.get("stream", 0) == 0
            rs = gw._replica_sets[("dep", "p")][1]
            assert [ep.inflight for ep in rs.endpoints] == [0, 0]
        finally:
            await cl.close()
            await server.stop()
            await gw.close()
            await stubs.stop()

    run(drive())


# -- unary hedging -------------------------------------------------------------------


@pytest.mark.parametrize("federation", ["1", "0"])
def test_dead_engine_unary_rehomed_to_peer(federation, monkeypatch):
    """A predict routed at a dead engine re-dispatches once to the live
    peer (the failover counter ticks); SELDON_TPU_FEDERATION=0 surfaces the
    failure to the caller."""
    import socket

    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.messages import SeldonMessage

    monkeypatch.setenv("SELDON_TPU_FEDERATION", federation)
    monkeypatch.setenv("SELDON_TPU_REPROBE_S", "0")  # no re-probe of the idle peer
    monkeypatch.setenv("SELDON_TPU_GW_SCRAPE_S", "60")  # one scrape pass, at the start

    async def drive():
        stubs = StubEngines()
        [live] = await stubs.start(1)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"http://127.0.0.1:{s.getsockname()[1]}"  # nothing listens there
        store = DeploymentStore()
        store.register(simple_remote_spec(_package("torch")), {"p": [dead, live]})
        gw = ApiGateway(store=store, require_auth=False)
        try:
            msg = SeldonMessage.from_array(np.ones((1, 4)))
            await gw.predict(msg)
            [(_fp, rs)] = list(gw._replica_sets.values())
            d, h = rs.endpoints
            # steer the pick at the corpse, in the window before its failed
            # scrape and failures degrade it
            d.ewma_ms, d.consec_failures, d.fail_degraded_until = 0.1, 0, 0.0
            d.scrape_failed, h.ewma_ms = False, 1000.0
            before = dict(gw.failovers)
            resp = await gw.predict(msg)
            if federation == "1":
                assert resp.status is None or resp.status.status == "SUCCESS"
                assert float(np.asarray(resp.array())[0, 0]) == 4.0
                assert gw.failovers["unary"] == before.get("unary", 0) + 1
            else:
                assert resp.status.status == "FAILURE" and resp.status.code == 503
                assert gw.failovers == {}
        finally:
            await gw.close()
            await stubs.stop()

    run(drive())


# -- the gRPC front ---------------------------------------------------------------


def test_grpc_front_bearer_token():
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
    from seldon_core_tpu_torch.runtime.grpcfast import (
        FastGrpcChannel,
        FastGrpcServer,
        GrpcCallError,
    )

    class Echo:
        async def predict(self, msg):
            return msg.with_array(np.asarray(msg.array()) + 1)

        async def send_feedback(self, fb):
            return SeldonMessage()

    async def drive():
        spec = SeldonDeploymentSpec.from_json_dict(mnist_pair_doc())
        store = DeploymentStore()
        store.register(spec, {"main": Echo(), "canary": Echo()})
        gw = ApiGateway(store=store)
        token = store.issue_token("key1", "secret1")
        server = FastGrpcServer.for_gateway(gw)
        await server.start("127.0.0.1", 0)
        ch = await FastGrpcChannel().connect("127.0.0.1", server.port)
        req = protoconv.msg_to_proto(SeldonMessage.from_array(np.zeros((1, 3))))
        try:
            for md in (((b"oauth_token", token.encode()),),
                       ((b"authorization", b"Bearer " + token.encode()),)):
                out = protoconv.msg_from_proto(await ch.call(b"/seldon.protos.Seldon/Predict",
                                                             req, md))
                assert np.array_equal(out.array(), np.ones((1, 3)))
                assert out.meta.requestPath["predictor"] in ("main", "canary")
            with pytest.raises(GrpcCallError) as e:
                await ch.call(b"/seldon.protos.Seldon/Predict", req)
            assert e.value.code_name == "UNAUTHENTICATED"
            with pytest.raises(GrpcCallError) as e:
                await ch.call(b"/seldon.protos.Seldon/Predict", req,
                              ((b"oauth_token", b"bad"),))
            assert e.value.code_name == "UNAUTHENTICATED"
            fb = protoconv.feedback_to_proto(Feedback(request=SeldonMessage.from_array(
                np.zeros((1, 3))), response=out, reward=1.0))
            ack = protoconv.msg_from_proto(await ch.call(
                b"/seldon.protos.Seldon/SendFeedback", fb, ((b"oauth_token", token.encode()),)))
            assert ack.status is None or ack.status.status == "SUCCESS"
            assert gw.feedback_count == 1
            bad = await ch.call(b"/seldon.protos.Seldon/Predict", b"\xff\xff",
                                ((b"oauth_token", token.encode()),))
            assert protoconv.msg_from_proto(bad).status.status == "FAILURE"
        finally:
            ch.close_nowait()
            await server.stop()
            await gw.close()

    run(drive())


# -- shadow ----------------------------------------------------------------------------


DELTA_CASES = {
    "argmax": lambda r: (r.random((8, 3)), r.random((8, 3))),
    "argmax_same": lambda r: (np.eye(3)[[0, 1, 2, 0]] + 0.1, np.eye(3)[[0, 1, 2, 0]] + 0.2),
    "elementwise": lambda r: (r.random((6, 1)), r.random((6, 1)) * 1e-7),
    "elementwise_within": lambda r: (np.ones((5,)), np.ones((5,)) + 1e-7),
    "shape": lambda r: (r.random((4, 2)), r.random((2, 4))),
    "empty": lambda r: (np.zeros((0, 2)), np.zeros((0, 2))),
    "one_sided": lambda r: (r.random((2, 2)), None),
    "matched_failures": lambda r: (None, None),
    "str": lambda r: ("a", "b"),
    "str_same": lambda r: ("a", "a"),
    "kind": lambda r: (r.random((2, 2)), "a"),
}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_prediction_delta_matches_jax(case):
    jx, tx = _package("jax"), _package("torch")
    a, b = DELTA_CASES[case](np.random.default_rng(sorted(DELTA_CASES).index(case)))

    def msg(p, v):
        if v is None:
            return p.SeldonMessage.failure("boom", code=503)
        if isinstance(v, str):
            return p.SeldonMessage(str_data=v)
        return p.SeldonMessage.from_array(v)

    want = jx.prediction_delta(msg(jx, a), msg(jx, b))
    got = tx.prediction_delta(msg(tx, a), msg(tx, b))
    assert got == want
    assert tx.prediction_delta(None, msg(tx, a)) == jx.prediction_delta(None, msg(jx, a))


def _shadow_doc(sample="1.0", extra_ann=None, cand_seed=1, same_node=False) -> dict:
    ann = {"seldon.io/shadow-sample": sample, "seldon.io/shadow-budget-per-s": "10000"}
    ann.update(extra_ann or {})

    def predictor(name, seed, replicas, annotations=None):
        node = "clf" if same_node else f"clf-{name}"
        return {"name": name, "replicas": replicas, "annotations": annotations or {},
                "graph": {"name": node, "type": "MODEL"},
                "components": [{"name": node, "runtime": "inprocess",
                                "class_path": "SigmoidPredictor",
                                "parameters": [{"name": "n_features", "value": "8",
                                                "type": "INT"},
                                               {"name": "seed", "value": str(seed),
                                                "type": "INT"},
                                               {"name": "train_steps", "value": "30",
                                                "type": "INT"}]}]}

    return {"spec": {"name": "life-dep", "oauth_key": "k", "oauth_secret": "s",
                     "annotations": ann,
                     "predictors": [predictor("main", 0, 3),
                                    predictor("cand", cand_seed, 1,
                                              {"seldon.io/shadow": "true"})]}}


def test_shadow_config_from_spec_and_weight_zero_registration(pkg):
    spec = pkg.spec.SeldonDeploymentSpec.from_json_dict(_shadow_doc(extra_ann={
        "seldon.io/shadow-deadline-ms": "750", "seldon.io/shadow-max-concurrency": "3"}))
    cfg = pkg.shadow.shadow_config_from_spec(spec)
    assert cfg == pkg.shadow.ShadowConfig(predictor="cand", sample=1.0, max_concurrency=3,
                                          budget_per_s=10000.0, deadline_ms=750.0)
    store = pkg.apife.DeploymentStore()
    store.register(spec, {"main": "http://a", "cand": "http://b"})
    reg = store._by_key["k"]
    assert {n: w for n, w, _ in reg.engines} == {"main": 3, "cand": 0} and reg.shadow == cfg
    doc = _shadow_doc()
    doc["spec"]["predictors"][1]["annotations"] = {}
    store.register(pkg.spec.SeldonDeploymentSpec.from_json_dict(doc),
                   {"main": "http://a", "cand": "http://b"})
    reg = store._by_key["k"]
    assert {n: w for n, w, _ in reg.engines} == {"main": 3, "cand": 1} and reg.shadow is None


def test_shadow_identical_candidate_reads_zero_disagreement(pkg):
    """A candidate identical to the live predictor — same seed AND same node
    name, since a unit's weights are seeded from its node name
    (``unit_rngs``) — reads disagreement 0.0 in both packages.  The JAX
    test's candidate is named ``clf-cand`` against ``clf-main``: different
    weights, so one of its 8 mirrored rows flips its argmax (0.125)."""

    async def drive():
        spec = pkg.spec.SeldonDeploymentSpec.from_json_dict(
            _shadow_doc(cand_seed=0, same_node=True))
        engines = {p.name: pkg.engine(spec, p.name, max_batch=16, max_wait_ms=0.5)
                   for p in spec.predictors}
        store = pkg.apife.DeploymentStore()
        store.register(spec, engines)
        gw = pkg.apife.ApiGateway(store=store, seed=7)
        token = store.issue_token("k", "s")
        rng = np.random.default_rng(0)
        for _ in range(20):
            resp = await gw.predict(pkg.SeldonMessage.from_array(rng.normal(size=(1, 8))), token)
            assert resp.meta.requestPath["predictor"] == "main"
        await gw.shadow.drain()
        row = gw.shadow.document()["deployments"]["life-dep"]
        stats = gw.stats()["shadow"]["deployments"]["life-dep"]
        await gw.close()
        if pkg.name == "torch":
            for e in engines.values():
                e.close()
        return row, stats

    row, stats = run(drive())
    assert row["mirrored"] + row["capped"] == 20 and row["mirrored"] > 0
    assert row["disagreement"]["mean"] == 0.0
    assert row["error_delta"] == {"live": 0, "shadow": 0, "live_rate": 0.0, "shadow_rate": 0.0}
    assert stats["mirrored"] == row["mirrored"] and stats["mean_disagreement"] == 0.0


def test_shadow_divergent_candidate_scores_disagreement():
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.engine import EngineService

    async def drive():
        spec = SeldonDeploymentSpec.from_json_dict(_shadow_doc(cand_seed=1))
        engines = {p.name: EngineService(spec, p.name, device="cpu") for p in spec.predictors}
        store = DeploymentStore()
        store.register(spec, engines)
        gw = ApiGateway(store=store, seed=7)
        token = store.issue_token("k", "s")
        rng = np.random.default_rng(1)
        for _ in range(30):
            await gw.predict(SeldonMessage.from_array(rng.normal(size=(4, 8))), token)
            await gw.shadow.drain()
        rate = gw.shadow.disagreement_rate("life-dep")
        await gw.close()
        for e in engines.values():
            e.close()
        return rate

    rate = run(drive())
    assert rate is not None and rate > 0.0


class _Slow:
    """A stand-in predictor answering after ``delay_s`` (or never)."""

    def __init__(self, delay_s=0.0, hang=False, out=1.0):
        self.delay_s, self.hang, self.out, self.calls = delay_s, hang, out, 0

    async def predict(self, msg):
        self.calls += 1
        if self.hang:
            await asyncio.Event().wait()
        await asyncio.sleep(self.delay_s)
        return msg.with_array(np.full((1, 2), self.out))


def _stub_shadow_gateway(extra_ann=None, seed=7, main=None, cand=None, sample="1.0"):
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec

    spec = SeldonDeploymentSpec.from_json_dict(_shadow_doc(sample=sample, extra_ann=extra_ann))
    store = DeploymentStore()
    main, cand = main or _Slow(), cand or _Slow()
    store.register(spec, {"main": main, "cand": cand})
    return ApiGateway(store=store, seed=seed), store.issue_token("k", "s"), main, cand


def test_shadow_never_on_the_live_path_and_caps():
    """A shadow 0.3 s slower than live does not move live latency; at most
    ``max_concurrency`` mirrors run at once (the rest are counted capped,
    never queued); a wedged shadow fails at its deadline clamp."""
    from seldon_core_tpu_torch.messages import SeldonMessage

    async def drive():
        gw, token, _m, cand = _stub_shadow_gateway(
            {"seldon.io/shadow-max-concurrency": "2", "seldon.io/shadow-deadline-ms": "100"},
            cand=_Slow(delay_s=0.3))
        t0 = time.perf_counter()
        for _ in range(6):
            await gw.predict(SeldonMessage.from_array(np.zeros((1, 2))), token)
        live_s = time.perf_counter() - t0
        await gw.shadow.drain()
        row = gw.shadow.document()["deployments"]["life-dep"]
        await gw.close()
        gw2, token2, _m2, _c2 = _stub_shadow_gateway(
            {"seldon.io/shadow-deadline-ms": "50"}, cand=_Slow(hang=True))
        await gw2.predict(SeldonMessage.from_array(np.zeros((1, 2))), token2)
        await gw2.shadow.drain(timeout_s=5.0)
        row2 = gw2.shadow.document()["deployments"]["life-dep"]
        await gw2.close()
        return live_s, row, row2

    live_s, row, row2 = run(drive())
    assert live_s < 0.25
    assert (row["mirrored"], row["capped"]) == (2, 4)
    # the 100 ms clamp cut the 300 ms shadow: both mirrors are shadow errors
    assert row["error_delta"]["shadow"] == 2 and "deadline" in row["last_error"]
    assert row2["mirrored"] == 1 and row2["error_delta"]["shadow"] == 1
    assert row2["disagreement"]["mean"] == 1.0  # a one-sided failure


def test_shadow_kill_switch_and_http_route(monkeypatch):
    from seldon_core_tpu_torch.gateway.apife import serve_gateway
    from seldon_core_tpu_torch.messages import SeldonMessage

    async def drive():
        monkeypatch.setenv("SELDON_TPU_SHADOW", "0")
        gw, token, _m, cand = _stub_shadow_gateway()
        for _ in range(3):
            await gw.predict(SeldonMessage.from_array(np.zeros((1, 2))), token)
        await gw.shadow.drain()
        off = (cand.calls, gw.shadow.document())
        monkeypatch.delenv("SELDON_TPU_SHADOW")
        for _ in range(3):
            await gw.predict(SeldonMessage.from_array(np.zeros((1, 2))), token)
        await gw.shadow.drain()
        server = await serve_gateway(gw, "127.0.0.1", 0)
        cl = _client()
        try:
            r = await cl.get(f"http://127.0.0.1:{server.port}/shadow")
            stats = (await cl.get(f"http://127.0.0.1:{server.port}/stats")).json()
        finally:
            await cl.close()
            await server.stop()
            await gw.close()
        return off, r.status, r.json(), stats, cand.calls

    (calls_off, doc_off), status, doc, stats, calls_on = run(drive())
    assert calls_off == 0 and doc_off == {"enabled": False, "deployments": {}}
    assert status == 200 and doc["enabled"] is True and calls_on == 3
    row = doc["deployments"]["life-dep"]
    assert row["mirrored"] == 3 and row["disagreement"]["mean"] == 0.0
    assert stats["shadow"]["deployments"]["life-dep"]["predictor"] == "cand"


# -- gateway_main ---------------------------------------------------------------------


def test_gateway_main_boots_registers_and_federates(tmp_path, monkeypatch, capsys):
    """gateway_main in process: its env contract, the spec directory
    registered at boot, the HTTP routes and the gRPC front up, and with a
    sqlite state file the replica its own coordinator."""
    from seldon_core_tpu_torch.gateway import gateway_main

    spec_dir = tmp_path / "specs"
    spec_dir.mkdir()
    (spec_dir / "dep.json").write_text(json.dumps(mnist_pair_doc()))
    (spec_dir / "bad.json").write_text("{")

    async def drive():
        stubs = StubEngines()
        urls = await stubs.start(2)
        monkeypatch.setenv("GATEWAY_REST_PORT", "0")
        monkeypatch.setenv("GATEWAY_GRPC_PORT", "0")
        monkeypatch.setenv("GATEWAY_STATE_PATH", str(tmp_path / "state" / "gw.db"))
        monkeypatch.setenv("SELDON_TPU_LEASE_TTL_S", "0.3")
        monkeypatch.setenv("GATEWAY_ENGINE_URL_MAP", json.dumps(
            {"canary-dep/main": urls, "canary-dep/canary": urls[0]}))
        monkeypatch.setenv("SELDON_TPU_WIRE", "0")
        ready, stop = asyncio.Event(), asyncio.Event()
        task = asyncio.create_task(gateway_main.serve(str(spec_dir), "127.0.0.1", ready, stop))
        await asyncio.wait_for(ready.wait(), 20)
        line = [ln for ln in capsys.readouterr().out.splitlines() if "gateway up" in ln][0]
        port = int(line.split("rest=:")[1].split()[0])
        cl = _client()
        base = f"http://127.0.0.1:{port}"
        try:
            tok = (await cl.post(base + "/oauth/token", b"", _basic("key1", "secret1"))).json()
            r = await cl.post(base + "/api/v0.1/predictions",
                              json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode(),
                              {"Authorization": "Bearer " + tok["access_token"],
                               "Content-Type": "application/json"})
            for _ in range(50):
                stats = (await cl.get(base + "/stats")).json()
                if stats["federation"].get("coordinator"):
                    break
                await asyncio.sleep(0.05)
        finally:
            await cl.close()
            stop.set()
            await asyncio.wait_for(task, 20)
            await stubs.stop()
        return r, stats

    r, stats = run(drive())
    assert r.status == 200 and r.json()["data"]["ndarray"] == [[3.0]]
    assert stats["gateway"]["deployments"] == ["canary-dep"]
    fed = stats["federation"]
    assert fed["enabled"] and fed["coordinator"] and fed["lease_ttl_s"] == 0.3
    out = capsys.readouterr().out
    assert "gateway stopped" in out


# -- the mesh-kill drill on in-process gateways ------------------------------------------


def test_mesh_kill_drill_on_in_process_gateways(tmp_path):
    """tests/test_mesh_kill.py's drill on the port: two gateways federated
    over one sqlite file front two stand-in engines under unary and SSE
    load; one engine dies mid-stream (every stream still delivers its exact
    run and its terminal event, unary loses nothing), then the coordinator
    gateway crashes (stops ticking, its listener gone) and the survivor
    takes the lease within one TTL."""
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, serve_gateway
    from seldon_core_tpu_torch.gateway.federation import GatewayFederation
    from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

    TTL, STREAMS, MAX_NEW = 0.3, 8, 8
    db = str(tmp_path / "gw.db")

    async def drive():
        stubs = StubEngines(delay_s=0.02)
        urls = await stubs.start(2)
        sa, sb = SqliteDeploymentStore(db), SqliteDeploymentStore(db)
        sa.register(simple_remote_spec(_package("torch"), predictors=("baseline", "candidate")),
                    {"baseline": list(urls), "candidate": list(urls)})
        gws, feds, servers = [], [], []
        for name, store in (("gw-a", sa), ("gw-b", sb)):
            gw = ApiGateway(store=store, require_auth=False)
            gw.federation = GatewayFederation(store, name, ttl_s=TTL, base_url="http://x:0")
            gws.append(gw)
            feds.append(gw.federation)
            servers.append(await serve_gateway(gw, "127.0.0.1", 0))
        assert feds[0].tick() is True and feds[1].tick() is False
        a_dead, b_stop = asyncio.Event(), asyncio.Event()

        async def ticker(fed, evt):
            while not evt.is_set():
                fed.tick()
                try:
                    await asyncio.wait_for(evt.wait(), TTL / 3)
                except asyncio.TimeoutError:
                    pass

        tickers = [asyncio.create_task(ticker(feds[0], a_dead)),
                   asyncio.create_task(ticker(feds[1], b_stop))]
        cl = _client()
        targets = [f"http://127.0.0.1:{s.port}" for s in servers]
        unary_fail, streams = [], []

        async def unary(n):
            body = json.dumps({"data": {"ndarray": [[0.1, 0.2, 0.3, 0.4]]}}).encode()
            for _ in range(n):
                for base in list(targets):
                    try:
                        r = await cl.post(base + "/api/v0.1/predictions", body,
                                          {"Content-Type": "application/json"}, timeout=10)
                    except (OSError, asyncio.TimeoutError):
                        continue  # the LB takes a dead gateway out
                    if r.status != 200:
                        unary_fail.append(r.status)
                    break
                await asyncio.sleep(0.02)

        async def stream(k):
            prompt = [float(100 * k), float(100 * k + 1), float(100 * k + 2)]
            st, events = await _sse(cl, targets[1] + "/api/v0.1/generate/stream",
                                    {"data": {"ndarray": [prompt]}, "max_new": MAX_NEW})
            toks = [e["tokens"][0][0] for e in events if "tokens" in e]
            ok = (st == 200 and toks == [prompt[-1] + j for j in range(1, MAX_NEW + 1)]
                  and events[-1].get("done") and not any("error" in e for e in events))
            streams.append(ok)

        load = [asyncio.create_task(unary(15)) for _ in range(2)]
        running = [asyncio.create_task(stream(k)) for k in range(STREAMS)]
        await asyncio.sleep(0.06)
        await stubs.servers[0].stop()  # an engine dies with streams on it
        await asyncio.sleep(0.1)
        t_kill = time.monotonic()
        a_dead.set()                    # the coordinator gateway crashes
        await tickers[0]
        await servers[0].stop()
        while not feds[1].is_coordinator and time.monotonic() - t_kill < 4 * TTL:
            await asyncio.sleep(0.02)
        t_over = time.monotonic() - t_kill
        coordinator = feds[1].is_coordinator
        await asyncio.gather(*load, *running)
        b_stop.set()
        await tickers[1]
        await servers[1].stop()
        await cl.close()
        for gw in gws:
            await gw.close()
        await stubs.stop()
        hedges = sum(gw.failovers.get("unary", 0) + gw.failovers.get("stream", 0)
                     for gw in gws)
        return coordinator, t_over, unary_fail, streams, hedges

    coordinator, t_over, unary_fail, streams, hedges = run(drive())
    assert coordinator and t_over <= TTL + TTL / 3 + 0.4, t_over
    assert not unary_fail and len(streams) == 8 and all(streams), streams
    assert hedges >= 1
