"""The port's replica sets and power-of-two-choices balancing
(seldon_core_tpu_torch/gateway/balancer.py) and the gateway's pick
(apife._pick_engine), held to the JAX package's: the host-only cases of
tests/test_replica_balancer.py, each run against both packages
(``package`` "jax" and "torch"), the same seeded picks side by side, the
scrape pass on the port's own HTTP client against a real engine's
``/stats``, and the gateway end to end over in-process port engines on
the CPU."""

import asyncio
import json
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

WAIT_S = 30


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


def _package(name: str) -> SimpleNamespace:
    """The gateway modules of one package under the same names."""
    if name == "jax":
        from seldon_core_tpu.gateway import apife, balancer, gateway_main, state
        from seldon_core_tpu.graph import spec
        from seldon_core_tpu.messages import SeldonMessage
        from seldon_core_tpu.utils.telemetry import RECORDER
    else:
        from seldon_core_tpu_torch.gateway import apife, balancer, gateway_main, state
        from seldon_core_tpu_torch.graph import spec
        from seldon_core_tpu_torch.messages import SeldonMessage
        from seldon_core_tpu_torch.utils.telemetry import RECORDER
    return SimpleNamespace(name=name, apife=apife, balancer=balancer, state=state,
                           gateway_main=gateway_main, spec=spec, SeldonMessage=SeldonMessage,
                           RECORDER=RECORDER)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


def sigmoid_doc(name="rs-dep", replicas=2, n_predictors=1) -> dict:
    def predictor(pname, seed, reps):
        return {
            "name": pname, "replicas": reps,
            "graph": {"name": "m", "type": "MODEL"},
            "components": [{
                "name": "m", "runtime": "inprocess", "class_path": "SigmoidPredictor",
                "parameters": [{"name": "n_features", "value": "4", "type": "INT"},
                               {"name": "seed", "value": str(seed), "type": "INT"},
                               {"name": "train_steps", "value": "5", "type": "INT"}],
            }],
        }

    return {"spec": {"name": name, "oauth_key": "k", "oauth_secret": "s",
                     "predictors": [predictor(f"p{i}" if n_predictors > 1 else "p", i, replicas)
                                    for i in range(n_predictors)]}}


def sigmoid_spec(pkg, **kw):
    return pkg.spec.SeldonDeploymentSpec.from_json_dict(sigmoid_doc(**kw))


# -- endpoints and the score --------------------------------------------------


def test_parse_endpoint_spec_three_forms(pkg):
    parse = pkg.balancer.parse_endpoint_spec
    assert parse("http://h:8000") == ("http://h:8000", None)
    assert parse("http://h:8000/") == ("http://h:8000", None)
    assert parse("uds:/run/e.sock") == (None, "/run/e.sock")
    assert parse("http://h:8000+uds:/run/e.sock") == ("http://h:8000", "/run/e.sock")
    ep = pkg.balancer.ReplicaEndpoint("http://h:1+role:decode+uds:/run/e.sock")
    assert (ep.base_url, ep.uds_path, ep.role) == ("http://h:1", "/run/e.sock", "decode")


def test_score_is_expected_wait(pkg):
    b = pkg.balancer
    ep = b.ReplicaEndpoint("http://a:1")
    assert ep.score(0.0, 10.0) == pytest.approx(b._EWMA_FLOOR_MS)
    ep.ewma_ms, ep.inflight, ep.scraped_inflight = 8.0, 2, 3
    assert ep.score(0.0, 10.0) == pytest.approx(6 * 8.0)


def test_ewma_update_and_failure_counting(pkg):
    b = pkg.balancer
    ep = b.ReplicaEndpoint("http://a:1")
    ep.begin()
    ep.complete(0.010)
    assert ep.ewma_ms == pytest.approx(10.0)
    ep.begin()
    ep.complete(0.020)
    assert ep.ewma_ms == pytest.approx((1 - b._EWMA_ALPHA) * 10.0 + b._EWMA_ALPHA * 20.0)
    before = ep.ewma_ms
    ep.begin()
    ep.complete(5.0, ok=False)
    assert (ep.ewma_ms, ep.failures, ep.inflight) == (before, 1, 0)


def test_degraded_penalty_and_fast_failure_degradation(pkg):
    b = pkg.balancer
    rs = b.ReplicaSet(["http://a:1", "http://b:1"], rng=random.Random(0))
    a, c = rs.endpoints
    a.ewma_ms, c.ewma_ms, c.breaker_open = 100.0, 1.0, True
    assert a.score(0.0, rs.stale_after_s) < c.score(0.0, rs.stale_after_s)
    assert c.score(0.0, rs.stale_after_s) >= b._UNHEALTHY_PENALTY
    rs = b.ReplicaSet(["uds:/run/a.sock", "http://b:1"], rng=random.Random(0))
    a, c = rs.endpoints
    c.ewma_ms = 50.0
    for _ in range(2):
        a.begin()
        a.complete(0.0001, ok=False)
    assert not a.degraded(time.monotonic(), rs.stale_after_s)
    a.begin()
    a.complete(0.0001, ok=False)
    now = time.monotonic()
    assert a.degraded(now, rs.stale_after_s)
    assert a.score(now, rs.stale_after_s) > c.score(now, rs.stale_after_s)
    a.fail_degraded_until = now - 0.001
    assert not a.degraded(time.monotonic(), rs.stale_after_s)
    a.begin()
    a.complete(0.001, ok=True)
    assert a.consec_failures == 0 and a.fail_degraded_until == 0.0
    # never scraped: not stale; scraped once, then stale
    ep = b.ReplicaEndpoint("http://a:1")
    assert not ep.degraded(1000.0, 6.0)
    ep.scrape_ts = 1.0
    assert ep.degraded(1000.0, 6.0) and not ep.degraded(5.0, 6.0)


def test_stale_ewma_reprobe_floors_score_and_reseeds(pkg, monkeypatch):
    b = pkg.balancer
    ep = b.ReplicaEndpoint("http://a:1")
    ep.begin()
    ep.complete(0.400)
    now = time.monotonic()
    assert ep.score(now, 10.0) == pytest.approx(400.0)
    ep.last_sample_ts = now - 1.0
    assert ep.score(now, 10.0) == pytest.approx(b._EWMA_FLOOR_MS)
    ep.begin()
    assert ep.score(now, 10.0) == pytest.approx(2 * 400.0)
    ep.complete(0.002)
    assert (ep.ewma_ms, ep.ewma_reseeds) == (pytest.approx(2.0), 1)
    ep.last_sample_ts = time.monotonic() - 1.0
    ep.begin()
    ep.complete(0.003)
    assert ep.ewma_ms == pytest.approx((1 - b._EWMA_ALPHA) * 2.0 + b._EWMA_ALPHA * 3.0)
    monkeypatch.setenv("SELDON_TPU_REPROBE_S", "0")
    ep.last_sample_ts = time.monotonic() - 99.0
    assert ep.score(time.monotonic(), 10.0) == pytest.approx(ep.ewma_ms)
    # a degraded endpoint keeps its penalty however stale its EWMA
    ep.fail_degraded_until = time.monotonic() + 60.0
    monkeypatch.delenv("SELDON_TPU_REPROBE_S")
    assert ep.score(time.monotonic(), 10.0) > b._UNHEALTHY_PENALTY


def test_batcher_inflight_tracks_only_batcher_dispatches(pkg):
    ep = pkg.balancer.ReplicaEndpoint("http://a:1")
    ep.begin()
    ep.begin(batcher=False)
    assert (ep.inflight, ep.batcher_inflight) == (2, 1)
    ep.release()
    assert (ep.inflight, ep.batcher_inflight) == (1, 1)
    ep.complete(0.01)
    assert (ep.inflight, ep.batcher_inflight) == (0, 0)
    ep.begin()
    ep.release(batcher=True)
    assert (ep.inflight, ep.batcher_inflight) == (0, 0)


# -- the p2c pick ---------------------------------------------------------------


def test_p2c_picks_lower_score_and_records_decision(pkg):
    b = pkg.balancer
    pkg.RECORDER.reset()
    rs = b.ReplicaSet(["http://a:1", "http://b:1"], rng=random.Random(3))
    a, c = rs.endpoints
    a.ewma_ms, c.ewma_ms = 50.0, 2.0
    chosen, decision = rs.pick()
    assert chosen is c and decision.replica == "http://b:1"
    assert set(decision.candidates) == {"http://a:1", "http://b:1"}
    assert decision.loser_ewma_ms == pytest.approx(50.0)
    assert pkg.RECORDER.snapshot()["replicas"]["picks"]["default"]["http://b:1"] == 1


def test_same_seed_same_picks_in_both_packages():
    """A replica set seeded alike picks the same endpoints in both
    packages, load for load: 200 picks with completions of seeded
    latencies."""
    seqs = []
    for name in ("jax", "torch"):
        b = _package(name).balancer
        rs = b.ReplicaSet([f"http://r{i}:1" for i in range(5)], rng=random.Random("7:d:p"))
        lat = np.random.default_rng(3).random(200) * 0.01
        picks = []
        for i in range(200):
            ep, dec = rs.pick(rows=1 + i % 7)
            ep.begin()
            rs.complete(ep, dec, float(lat[i]), ok=i % 11 != 0, rows=1 + i % 7)
            picks.append(ep.name)
        seqs.append((picks, rs.mispicks, [e.ewma_ms for e in rs.endpoints]))
    assert seqs[0][0] == seqs[1][0] and seqs[0][1] == seqs[1][1]
    assert seqs[0][2] == pytest.approx(seqs[1][2])


def test_single_endpoint_and_kill_switch_bypass_p2c(pkg, monkeypatch):
    b = pkg.balancer
    ep, decision = b.ReplicaSet(["http://a:1"]).pick()
    assert ep.name == "http://a:1" and decision is None
    rs = b.ReplicaSet(["http://a:1", "http://b:1"], rng=random.Random(0))
    rs.endpoints[0].ewma_ms = 1e6
    monkeypatch.setenv("SELDON_TPU_REPLICAS", "0")
    for _ in range(8):
        ep, decision = rs.pick()
        assert ep is rs.endpoints[0] and decision is None
    assert rs.endpoints[0].picks == 0


def test_mispick_hindsight_accounting(pkg):
    b = pkg.balancer
    pkg.RECORDER.reset()
    rs = b.ReplicaSet(["http://a:1", "http://b:1"], rng=random.Random(0))
    ep = rs.endpoints[0]
    decision = b.PickDecision(replica=ep.name, candidates=[ep.name, "http://b:1"],
                              scores=[1.0, 2.0], loser_ewma_ms=5.0)
    for lat, ok in ((0.050, True), (0.001, True), (9.9, False)):
        ep.begin()
        rs.complete(ep, decision, latency_s=lat, ok=ok)
    assert rs.mispicks == 1
    assert pkg.RECORDER.snapshot()["replicas"]["mispicks"] == 1
    # a degraded loser never judges the pick
    rs = b.ReplicaSet(["http://a:1", "http://b:1"], rng=random.Random(3))
    a, c = rs.endpoints
    a.ewma_ms, c.ewma_ms, c.breaker_open = 50.0, 2.0, True
    chosen, decision = rs.pick()
    assert chosen is a and decision.loser_ewma_ms == 0.0


def test_pick_eligibility_filter_lands_picks_on_capable_endpoint(pkg):
    rs = pkg.balancer.ReplicaSet(["uds:/run/a.sock", "http://b:1"], rng=random.Random(7))
    for _ in range(8):
        ep, decision = rs.pick(lambda e: e.base_url is not None)
        assert ep.base_url == "http://b:1" and decision.replica == ep.name
    assert (rs.endpoints[1].picks, rs.endpoints[0].picks) == (8, 0)
    ep, _ = rs.pick(lambda _ep: False)
    assert ep in rs.endpoints


def test_replica_set_snapshot_imbalance(pkg):
    rs = pkg.balancer.ReplicaSet(["http://a:1", "http://b:1"])
    rs.endpoints[0].inflight, rs.endpoints[1].inflight = 3, 1
    snap = rs.snapshot()
    assert snap["inflight_max_over_mean"] == pytest.approx(1.5)
    assert [e["endpoint"] for e in snap["endpoints"]] == ["http://a:1", "http://b:1"]


def test_apply_leases_marks_lapsed_dead_and_resets_on_boot_id(pkg):
    b = pkg.balancer
    rs = b.ReplicaSet(["http://a:1", "http://b:1"], rng=random.Random(0))
    a, c = rs.endpoints
    a.ewma_ms = 9.0
    a.boot_id = "boot-1"
    now = time.time()
    rs.apply_leases({"http://a:1": ("boot-2", now + 5.0), "http://b:1": ("x", now - 1.0)})
    assert (a.lease_state, c.lease_state) == ("live", "dead")
    assert a.ewma_ms == 0.0 and a.epoch_resets == 1  # a new boot epoch
    assert c.degraded(time.monotonic(), rs.stale_after_s)
    rs.apply_leases({"http://b:1": ("x", now + 5.0)})
    assert (a.lease_state, c.lease_state) == ("dead", "live")  # a's row dropped


# -- the gateway's pick -----------------------------------------------------------


def test_pick_engine_weighted_split_named_and_uniform(pkg):
    apife = pkg.apife
    spec = sigmoid_spec(pkg, n_predictors=2)
    spec.predictors[0].replicas, spec.predictors[1].replicas = 3, 1
    store = apife.DeploymentStore()
    store.register(spec, {"p0": "http://p0:1", "p1": "http://p1:1"})
    gw = apife.ApiGateway(store, require_auth=False, seed=11)
    reg = store._by_key["k"]
    served = [gw._pick_engine(reg)[0] for _ in range(200)]
    assert served.count("p0") > served.count("p1") > 0 and served.count("p0") > 100
    name, _rs, ep, _ = gw._pick_engine(reg, predictor="p1")
    assert name == "p1" and ep.base_url == "http://p1:1"
    for p in spec.predictors:
        p.replicas = 0
    store.register(spec, {"p0": "http://p0:1", "p1": "http://p1:1"})
    gw = apife.ApiGateway(store, require_auth=False, seed=5)
    served = [gw._pick_engine(store._by_key["k"])[0] for _ in range(100)]
    assert served.count("p0") > 20 and served.count("p1") > 20


def test_pick_engine_sequence_identical_across_packages():
    """The same registration and seed give the same predictor and replica
    sequence in both gateways (np.random.default_rng(seed) for the
    split, random.Random(f"{seed}:{deployment}:{predictor}") per set)."""
    seqs = []
    for name in ("jax", "torch"):
        pk = _package(name)
        spec = sigmoid_spec(pk, n_predictors=2)
        spec.predictors[0].replicas, spec.predictors[1].replicas = 3, 1
        store = pk.apife.DeploymentStore()
        store.register(spec, {"p0": ["http://a:1", "http://b:1", "http://c:1"],
                              "p1": ["http://d:1", "http://e:1"]})
        gw = pk.apife.ApiGateway(store, require_auth=False, seed=23)
        seq = []
        for i in range(120):
            pred, rs, ep, dec = gw._pick_engine(store._by_key["k"], rows=1 + i % 3)
            ep.begin()
            rs.complete(ep, dec, 0.001 * (1 + i % 5), rows=1 + i % 3)
            seq.append((pred, ep.name))
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_replica_sets_cache_prune_and_rebuild(pkg):
    apife = pkg.apife
    spec = sigmoid_spec(pkg, n_predictors=2)
    store = apife.DeploymentStore()
    store.register(spec, {"p0": ["http://a:1", "http://b:1"], "p1": ["http://c:1", "http://d:1"]})
    gw = apife.ApiGateway(store, require_auth=False)
    reg = store._by_key["k"]
    _, rs1, _, _ = gw._pick_engine(reg, "p0")
    assert gw._pick_engine(reg, "p0")[1] is rs1
    gw._pick_engine(reg, "p1")
    # a re-registration that drops a predictor prunes its set
    store.register(spec, {"p0": ["http://a:1", "http://e:1"]})
    gw.stats()
    assert ("rs-dep", "p1") not in gw._replica_sets
    _, rs3, _, _ = gw._pick_engine(store._by_key["k"], "p0")
    assert rs3 is not rs1 and [e.name for e in rs3.endpoints] == ["http://a:1", "http://e:1"]
    store.unregister("k")
    assert gw.stats()["replicas"] == {} and gw._replica_sets == {}


def test_decision_attrs_shape(pkg):
    apife, b = pkg.apife, pkg.balancer
    assert apife.ApiGateway._decision_attrs(None) == {}
    assert apife.ApiGateway._decision_attrs(b.PickDecision(
        replica="http://b:1", candidates=["http://a:1", "http://b:1"], scores=[3.2, 1.1],
        loser_ewma_ms=4.0)) == {"replica": "http://b:1",
                                "p2c_candidates": "http://a:1,http://b:1",
                                "p2c_scores": "3.2,1.1"}


def test_sqlite_store_replica_lists_clamps_and_revisions(pkg, tmp_path):
    db = str(tmp_path / "gw.db")
    SqliteStore = pkg.state.SqliteDeploymentStore
    spec = sigmoid_spec(pkg, replicas=3)
    store = SqliteStore(db)
    assert store.revision() == 0
    store.register(spec, {"p": ["http://e0:8000", "http://e1:8000+uds:/run/e1.sock"]})
    other = SqliteStore(db)
    assert other._registration("k").engines == [
        ("p", 3, ["http://e0:8000", "http://e1:8000+uds:/run/e1.sock"])]
    r1 = store.revision()
    spec.predictors[0].replicas = -2
    store.register(spec, {"p": "http://e0:8000"})
    assert store._registration("k").engines == [("p", 0, "http://e0:8000")]
    with pytest.raises(TypeError, match="non-empty list"):
        store.register(spec, {"p": []})
    with pytest.raises(TypeError, match="in-process"):
        store.register(spec, {"p": object()})
    store.unregister("k")
    assert r1 < other.revision()
    store.close()
    other.close()


def test_gateway_main_env_contract(pkg, monkeypatch):
    gm = pkg.gateway_main
    monkeypatch.setenv("GATEWAY_ENGINE_URL_TEMPLATE", "http://{namespace}.{name}:8000")
    with pytest.raises(SystemExit, match="GATEWAY_ENGINE_URL_TEMPLATE"):
        gm._engine_url_template()
    monkeypatch.setenv("GATEWAY_ENGINE_URL_TEMPLATE", "http://{name}-{predictor}:9000")
    assert gm._engine_url_template() == "http://{name}-{predictor}:9000"
    monkeypatch.setenv("GATEWAY_ENGINE_REPLICAS", "3")
    assert gm._engine_replicas() == 3
    for bad in ("0", "x"):
        monkeypatch.setenv("GATEWAY_ENGINE_REPLICAS", bad)
        with pytest.raises(SystemExit):
            gm._engine_replicas()
    tpl = "http://{name}-{predictor}-{replica}:8000"
    assert gm._render_endpoints(tpl, "d", "p", 2) == ["http://d-p-0:8000", "http://d-p-1:8000"]
    assert gm._check_replica_template(4, tpl) == 4
    with pytest.raises(SystemExit, match="needs a .replica."):
        gm._check_replica_template(4, "http://{name}:8000")
    monkeypatch.setenv("GATEWAY_ENGINE_URL_MAP",
                       json.dumps({"d/p": ["http://a:1", "uds:/run/a.sock"]}))
    assert gm._engine_url_map() == {"d/p": ["http://a:1", "uds:/run/a.sock"]}
    monkeypatch.setenv("GATEWAY_ENGINE_URL_MAP", json.dumps({"d/p": []}))
    with pytest.raises(SystemExit, match="non-empty"):
        gm._engine_url_map()


# -- the scrape, and the gateway over port engines ------------------------------


def test_scrape_subtracts_only_own_batcher_inflight_over_http():
    """The port's scrape reads a real ``/stats`` through its own HTTP
    client: the engine's figure less this gateway's batcher-bound
    inflight; a dead endpoint marks itself failed within the 1 s
    timeout."""
    from seldon_core_tpu_torch.gateway.balancer import ReplicaSet
    from seldon_core_tpu_torch.runtime.client import HttpClient
    from seldon_core_tpu_torch.runtime.rest import FastHttpServer

    class Routes:
        post, any = {}, {}

        def __init__(self):
            self.get = {b"/stats": self.stats}

        async def stats(self, body, ctype):
            doc = {"boot_id": "b1", "telemetry": {"batch": {"inflight_dispatches": 5}},
                   "resilience": {"breakers": {"m": {"state": "open"}}},
                   "genserver": {"role": "prefill", "kv_blocks": {"total": 10, "used": 4}}}
            return 200, json.dumps(doc).encode(), "application/json"

    async def run():
        server = FastHttpServer(routes=Routes())
        await server.start("127.0.0.1", 0)
        client = HttpClient()
        try:
            rs = ReplicaSet([f"http://127.0.0.1:{server.port}", "http://127.0.0.1:9"])
            ep, dead = rs.endpoints
            ep.begin()
            ep.begin(batcher=False)
            t0 = time.monotonic()
            assert await rs.scrape_once(client) == 1
            assert time.monotonic() - t0 < 1.5
            assert ep.scraped_inflight == 4 and ep.breaker_open and ep.boot_id == "b1"
            assert (ep.role, ep.scraped_free_kv) == ("prefill", 6)
            assert dead.scrape_failed and not ep.scrape_failed
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(run(), WAIT_S))


def test_gateway_steers_around_slow_inprocess_replica():
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.testing.faults import FaultSpec, FaultyEngine
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    RECORDER.reset()
    msg = lambda: SeldonMessage.from_array(np.zeros((1, 4), np.float32))

    async def run():
        spec = SeldonDeploymentSpec.from_json_dict(sigmoid_doc())
        fast = EngineService(spec, max_batch=8, max_wait_ms=0.5, device="cpu")
        slow = FaultyEngine(EngineService(spec, max_batch=8, max_wait_ms=0.5, device="cpu"),
                            FaultSpec(delay_s=0.03))
        store = DeploymentStore()
        store.register(spec, {"p": [fast, slow]})
        gw = ApiGateway(store, require_auth=False)
        await fast.predict(msg())
        await slow.inner.predict(msg())

        async def worker(n):
            for _ in range(n):
                resp = await gw.predict(msg())
                assert resp.status is None or resp.status.status != "FAILURE"

        await asyncio.gather(*(worker(12) for _ in range(6)))
        picks = [e["picks"] for e in gw.stats()["replicas"]["rs-dep/p"]["endpoints"]]
        assert sum(picks) == 72 and picks[1] / sum(picks) < 0.3
        assert RECORDER.snapshot()["replicas"]["lanes"].get("inprocess", 0) >= 72
        await gw.close()
        fast.close()
        slow.inner.close()

    asyncio.run(asyncio.wait_for(run(), WAIT_S))


def test_kill_switch_and_cancelled_predict_are_neutral(monkeypatch):
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    RECORDER.reset()
    msg = lambda: SeldonMessage.from_array(np.zeros((1, 4), np.float32))

    class Wedged:
        def __init__(self):
            self.gate = asyncio.Event()

        async def predict(self, m):
            await self.gate.wait()
            return m

    async def run():
        spec = SeldonDeploymentSpec.from_json_dict(sigmoid_doc())
        e0 = EngineService(spec, max_batch=8, max_wait_ms=0.5, device="cpu")
        e1 = EngineService(spec, max_batch=8, max_wait_ms=0.5, device="cpu")
        store = DeploymentStore()
        store.register(spec, {"p": [e0, e1]})
        gw = ApiGateway(store, require_auth=False)
        monkeypatch.setenv("SELDON_TPU_REPLICAS", "0")
        for _ in range(4):
            resp = await gw.predict(msg())
            assert resp.status is None or resp.status.status != "FAILURE"
        snap = gw.stats()["replicas"]["rs-dep/p"]
        assert [e["picks"] for e in snap["endpoints"]] == [0, 0]
        assert RECORDER.snapshot()["replicas"]["picks"] == {}
        monkeypatch.delenv("SELDON_TPU_REPLICAS")
        await gw.close()
        e0.close()
        e1.close()
        # a client hanging up is neutral for the replica's health
        store = DeploymentStore()
        store.register(spec, {"p": [Wedged()]})
        gw = ApiGateway(store, require_auth=False)
        task = asyncio.create_task(gw.predict(msg()))
        await asyncio.sleep(0.05)
        ep = gw._replica_sets[("rs-dep", "p")][1].endpoints[0]
        assert (ep.inflight, ep.batcher_inflight) == (1, 1)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert (ep.inflight, ep.batcher_inflight, ep.consec_failures, ep.failures) == (0, 0, 0, 0)
        await gw.close()

    asyncio.run(asyncio.wait_for(run(), WAIT_S))
