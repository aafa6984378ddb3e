"""The port's rollout controller (seldon_core_tpu_torch/operator/rollouts.py)
and firehose replay (runtime/replay.py) against the JAX package's, on the CPU.

  * the replay and rollout cases of tests/test_traffic_lifecycle.py (the
    firehose recorded by the port's gateway and replayed against port
    engines, in process and over a URL through the port's ``HttpClient``;
    staged promotion, rollback, quarantine, the error-rate gate fed by real
    gateway accounting, scrape outages, the kill switch, the annotation
    contract and the reconciler driving a rollout), and the canary example
    end to end through the port's materializer and gateway;
  * parity: a JAX and a port controller, each over its own package's store,
    fed one scripted signal sequence on one injected clock, take the same
    decisions, reasons and stages, write the same splits and give the same
    ``document()`` once the wall stamps are dropped;
  * a mixed federation: a port controller resumes a JAX controller's rollout
    from one shared sqlite store at its stage, and the other way round, and
    the stalled predecessor's tick is fenced;
  * the burn gate (tests/test_fleet_burn.py:188): ``GatewaySignals`` reads
    the fleet aggregate the brownout ladder reads."""

import asyncio
import copy
import json
import os
import time

import numpy as np
import pytest

from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
from seldon_core_tpu_torch.gateway.firehose import Firehose
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.operator.rollouts import (
    GatewaySignals,
    RolloutController,
    RolloutGates,
    RolloutPlan,
    plan_from_annotations,
)
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.replay import (
    ReplayGates,
    load_firehose_events,
    replay_events,
    replay_file,
)
from seldon_core_tpu_torch.testing.faults import FaultSpec, FaultyNodeRuntime
from seldon_core_tpu_torch.utils.quality import QUALITY
from seldon_core_tpu_torch.utils.telemetry import RECORDER

N_FEATURES = 8


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


def _predictor(name, seed, replicas, annotations=None, node=None):
    node = node or f"clf-{name}"
    return {
        "name": name,
        "replicas": replicas,
        "annotations": annotations or {},
        "graph": {"name": node, "type": "MODEL"},
        "components": [{
            "name": node, "runtime": "inprocess",
            "class_path": "SigmoidPredictor",
            "parameters": [
                {"name": "n_features", "value": str(N_FEATURES),
                 "type": "INT"},
                {"name": "seed", "value": str(seed), "type": "INT"},
            ],
        }],
    }


def _spec(name="life-dep", shadow=True, sample="1.0", extra_ann=None,
          cand_seed=1):
    ann = {"seldon.io/shadow-sample": sample,
           "seldon.io/shadow-budget-per-s": "10000"}
    ann.update(extra_ann or {})
    return SeldonDeploymentSpec.from_json_dict({
        "spec": {
            "name": name, "oauth_key": "k", "oauth_secret": "s",
            "annotations": ann,
            "predictors": [
                _predictor("main", 0, 3),
                _predictor(
                    "cand", cand_seed, 1,
                    {"seldon.io/shadow": "true"} if shadow else None,
                ),
            ],
        }
    })


def _msg(rng, shift=0.0, rows=1):
    return SeldonMessage.from_array(
        rng.normal(shift, 1.0, size=(rows, N_FEATURES)).astype(np.float64)
    )


async def _gateway(spec, firehose=None, engines=None, seed=7):
    store = DeploymentStore()
    engines = engines or {
        p.name: EngineService(spec, p.name, max_batch=16, max_wait_ms=0.5, device="cpu")
        for p in spec.predictors
    }
    store.register(spec, engines)
    gw = ApiGateway(store=store, firehose=firehose, seed=seed)
    token = store.issue_token("k", "s")
    return gw, store, engines, token


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# firehose replay
# ---------------------------------------------------------------------------


async def _record_firehose(tmp_path, n=16, cand_seed=1):
    spec = _spec(shadow=False, cand_seed=cand_seed)
    fh = Firehose(base_dir=str(tmp_path))
    gw, store, engines, token = await _gateway(spec, firehose=fh)
    fh.start()
    rng = np.random.default_rng(7)
    for _ in range(n):
        await gw.predict(_msg(rng, rows=2), token)
    await fh.stop()
    await gw.close()
    return os.path.join(str(tmp_path), "life-dep.jsonl"), engines


def test_replay_identical_candidate_passes(tmp_path):
    async def run():
        path, engines = await _record_firehose(tmp_path)
        # most traffic went to 'main' (3:1); replay against main = parity
        doc = await replay_file(path, engines["main"])
        # a handful of recorded lines were served by 'cand' (weight 1):
        # those disagree — filter them out via a permissive gate instead
        # of pretending the mix is identical
        assert doc["counts"]["replayed"] == 16
        assert doc["candidate_latency_ms"]["count"] == 16
        assert doc["disagreement"]["count"] == 16
        # strict parity check: replay against the engines that served
        disagree_free = await replay_events(
            [e for e in load_firehose_events(path)
             if e["response"]["meta"]["requestPath"].get("predictor")
             == "main"],
            engines["main"],
        )
        assert disagree_free["verdict"] == "pass", disagree_free["reasons"]
        assert disagree_free["disagreement"]["mean"] == 0.0
        assert disagree_free["prediction_psi"] is not None
        assert disagree_free["prediction_psi"] < 0.05

    asyncio.run(run())


def test_replay_flags_divergent_candidate(tmp_path):
    async def run():
        path, engines = await _record_firehose(tmp_path)
        spec2 = _spec(shadow=False, cand_seed=9)
        drifted = EngineService(spec2, "cand", device="cpu")
        doc = await replay_file(path, drifted)
        assert doc["verdict"] == "fail"
        assert any(r.startswith("disagreement") for r in doc["reasons"])
        drifted.close()

    asyncio.run(run())


def test_replay_flags_error_rate_regression(tmp_path):
    """A candidate whose graph node hard-fails (testing/faults.py at
    100% error rate) fails the vet on the error-rate gate."""

    async def run():
        path, engines = await _record_firehose(tmp_path)
        from seldon_core_tpu_torch.graph.defaulting import default_and_validate
        from seldon_core_tpu_torch.graph.interpreter import GraphExecutor

        spec2 = _spec(shadow=False)
        default_and_validate(spec2)
        executor = GraphExecutor(spec2.predictor("cand"), device="cpu")
        executor.runtimes["clf-cand"] = FaultyNodeRuntime(
            executor.runtimes["clf-cand"], FaultSpec(error_rate=1.0),
        )
        broken = EngineService(
            spec2, "cand", extra_runtimes=executor.runtimes, device="cpu",
        )
        doc = await replay_file(path, broken)
        assert doc["verdict"] == "fail"
        assert doc["error_rate"]["candidate"] == 1.0
        assert any(r.startswith("error_rate") for r in doc["reasons"])
        broken.close()

    asyncio.run(run())


def test_replay_recorded_pace_honors_time_warp():
    async def run():
        class Instant:
            async def predict(self, msg):
                return SeldonMessage.from_array(np.zeros((1, 2)))

        base = 1000.0
        events = [
            {"ts": base + i * 0.08,
             "request": SeldonMessage.from_array(
                 np.zeros((1, 2))).to_json_dict(),
             "response": SeldonMessage.from_array(
                 np.zeros((1, 2))).to_json_dict()}
            for i in range(5)
        ]
        gates = ReplayGates(min_requests=0)
        t0 = time.perf_counter()
        await replay_events(events, Instant(), pace="recorded", speed=1.0,
                            gates=gates)
        paced = time.perf_counter() - t0
        assert paced >= 0.3  # 4 gaps x 80 ms
        t0 = time.perf_counter()
        await replay_events(events, Instant(), pace="recorded", speed=8.0,
                            gates=gates)
        warped = time.perf_counter() - t0
        assert warped < paced / 2  # the time-warp knob works

    asyncio.run(run())


def test_replay_skips_control_plane_events(tmp_path):
    path = tmp_path / "dep.jsonl"
    req = SeldonMessage.from_array(np.zeros((1, 2))).to_json_dict()
    lines = [
        {"puid": "", "deployment": "dep", "ts": 1.0, "event": "rollback",
         "reason": "drift"},
        {"puid": "x", "deployment": "dep", "ts": 2.0,
         "request": req, "response": req},
        {"puid": "y", "deployment": "other", "ts": 3.0,
         "request": req, "response": req},
    ]
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
        f.write('{"torn": ')  # producer mid-write
    events = load_firehose_events(str(path), deployment="dep")
    assert len(events) == 1 and events[0]["puid"] == "x"


# ---------------------------------------------------------------------------
# rollout controller
# ---------------------------------------------------------------------------


def test_replay_against_a_url_through_the_ports_client(tmp_path):
    """A URL target goes through the port's stdlib ``HttpClient`` to the
    port's REST lane: the engine that served the recorded lines passes, an
    unreachable URL reads as candidate errors."""
    from seldon_core_tpu_torch.runtime.rest import serve_fast

    async def run():
        path, engines = await _record_firehose(tmp_path)
        server = await serve_fast(engines["main"], "127.0.0.1", 0)
        try:
            main_lines = [e for e in load_firehose_events(path)
                          if e["response"]["meta"]["requestPath"].get("predictor") == "main"]
            doc = await replay_events(main_lines, f"http://127.0.0.1:{server.port}")
            assert doc["target"] == "http"
            assert doc["verdict"] == "pass", doc["reasons"]
            assert doc["disagreement"]["mean"] == 0.0
        finally:
            await server.stop()
        down = await replay_events(main_lines, f"http://127.0.0.1:{server.port}")
        assert down["verdict"] == "fail"
        assert down["error_rate"]["candidate"] == 1.0

    asyncio.run(run())


def test_replay_verdict_keys_are_the_jax_documents(tmp_path):
    """The port's verdict document has the JAX replayer's keys and gates, and
    the same verdict and counts on the same recorded lines (the JAX replayer
    reads the port gateway's firehose)."""
    from seldon_core_tpu.runtime import replay as jreplay

    class Echo:
        async def predict(self, msg):
            return msg

    async def run():
        path, _engines = await _record_firehose(tmp_path, n=12)
        got = await replay_file(path, Echo())
        want = await jreplay.replay_file(path, Echo())
        return got, want

    got, want = asyncio.run(run())
    assert set(got) == set(want)
    assert got["gates"] == want["gates"]
    for key in ("verdict", "counts", "disagreement", "error_rate", "prediction_psi", "source"):
        assert got[key] == want[key], key



# ---------------------------------------------------------------------------
# rollout controller
# ---------------------------------------------------------------------------


def _store_with(name="dep"):
    spec = SeldonDeploymentSpec.from_json_dict({
        "spec": {"name": name, "oauth_key": name, "predictors": [
            _predictor("main", 0, 99), _predictor("cand", 1, 1),
        ]}})
    store = DeploymentStore()
    store.register(spec, {"main": "http://a", "cand": "http://b"})
    return store, spec


def _weights(store, key="dep"):
    return {n: w for n, w, _ in store._by_key[key].engines}


def test_set_weights_in_memory_store():
    store, _ = _store_with()
    store.set_weights("dep", {"cand": 25, "main": 75})
    assert _weights(store) == {"main": 75, "cand": 25}
    with pytest.raises(KeyError):
        store.set_weights("dep", {"nope": 1})
    with pytest.raises(KeyError):
        store.set_weights("ghost-dep", {"cand": 1})


def test_sqlite_store_set_weights_and_shadow_roundtrip(tmp_path):
    from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

    store = SqliteDeploymentStore(str(tmp_path / "gw.db"))
    spec = _spec()
    store.register(spec, {"main": "http://a", "cand": "http://b"})
    reg = store._registration("k")
    assert {n: w for n, w, _ in reg.engines} == {"main": 3, "cand": 0}
    assert reg.shadow is not None and reg.shadow.predictor == "cand"
    rev = store.revision()
    store.set_weights("life-dep", {"cand": 5, "main": 95})
    assert store.revision() > rev  # other gateway replicas see the shift
    reg = store._registration("k")
    assert {n: w for n, w, _ in reg.engines} == {"main": 95, "cand": 5}
    assert reg.shadow is not None  # the shift must not drop the policy
    with pytest.raises(KeyError):
        store.set_weights("life-dep", {"nope": 1})
    store.close()



def test_rollout_staged_promotion_and_stage_gating():
    store, _ = _store_with()
    clock = [0.0]
    sig = {"requests": 0, "errors": 0, "drift": 0.0}
    ctrl = RolloutController(store, lambda plan: dict(sig),
                             clock=lambda: clock[0])
    plan = RolloutPlan("dep", "cand", "main", stages=(1, 5, 25, 100),
                       hold_s=10.0, config_hash="h1",
                       gates=RolloutGates(min_requests=5))
    sig["requests"] = 40  # pre-rollout traffic: stage deltas must ignore it
    ctrl.apply(plan)
    assert ctrl.tick()[0]["decision"] == "advance"
    assert _weights(store) == {"main": 99, "cand": 1}
    # held: not enough time (plenty of traffic)
    clock[0] += 5
    sig["requests"] = 90
    assert ctrl.tick()[0]["decision"] == "hold"
    # held: enough time but not enough candidate traffic SINCE the stage
    # entered (90 - 40-at-entry = 50... reset to prove the delta rule)
    clock[0] += 6
    sig["requests"] = 43  # 3 since entry < min_requests 5
    assert ctrl.tick()[0]["decision"] == "hold"
    assert _weights(store) == {"main": 99, "cand": 1}
    # both satisfied -> next stage
    sig["requests"] = 50
    assert ctrl.tick()[0]["decision"] == "advance"
    assert _weights(store) == {"main": 95, "cand": 5}
    for _ in range(4):
        clock[0] += 11
        sig["requests"] += 50
        ctrl.tick()
    st = ctrl.status_block("dep")
    assert st["state"] == "promoted" and st["stage_percent"] == 100
    assert _weights(store) == {"main": 0, "cand": 100}


class _ListFirehose:
    def __init__(self):
        self.events = []

    def publish_event(self, deployment, kind, **fields):
        self.events.append({"deployment": deployment, "event": kind,
                            **fields})


def test_rollout_rollback_quarantine_and_surfaces():
    store, _ = _store_with()
    clock = [0.0]
    sig = {"requests": 100, "errors": 0, "drift": 0.0}
    fh = _ListFirehose()
    ctrl = RolloutController(store, lambda plan: dict(sig), firehose=fh,
                             clock=lambda: clock[0])
    plan = RolloutPlan("dep", "cand", "main", hold_s=0.0, config_hash="h1",
                       gates=RolloutGates(min_requests=0))
    ctrl.apply(plan)
    ctrl.tick()
    assert _weights(store) == {"main": 99, "cand": 1}
    before = dict(RECORDER.rollbacks)
    sig["drift"] = 0.9
    clock[0] += 1
    decision = ctrl.tick()[0]
    assert decision["decision"] == "rollback"
    assert decision["reason"] == "drift"
    # ONE step: weights snapped all the way back, not to a lower stage
    assert _weights(store) == {"main": 100, "cand": 0}
    # counter + firehose event + status surfaces
    assert RECORDER.rollbacks.get("drift", 0) == before.get("drift", 0) + 1
    assert [e for e in fh.events if e["event"] == "rollback"]
    assert ctrl.snapshot()["rollouts"]["dep"]["state"] == "rolled_back"
    assert ctrl.document()["quarantined"] == {"dep": ["h1"]}
    # quarantine: the same hash never rolls out again...
    ctrl.apply(plan)
    clock[0] += 100
    assert ctrl.tick() == []
    assert _weights(store) == {"main": 100, "cand": 0}
    # ...but a CHANGED spec does
    sig["drift"] = 0.0
    plan2 = RolloutPlan("dep", "cand", "main", hold_s=0.0,
                        config_hash="h2", gates=RolloutGates(min_requests=0))
    ctrl.apply(plan2)
    assert ctrl.tick()[0]["decision"] == "advance"
    assert _weights(store)["cand"] == 1
    # flip-flop guard: h2 also rolls back; re-applying the OLD bad hash
    # h1 must stay quarantined (the history is a set, not last-one-wins)
    sig["drift"] = 0.9
    clock[0] += 1
    assert ctrl.tick()[0]["decision"] == "rollback"
    ctrl.apply(plan)  # h1 again
    clock[0] += 100
    assert ctrl.tick() == []
    assert ctrl.status_block("dep")["state"] == "rolled_back"
    assert ctrl.document()["quarantined"] == {"dep": ["h1", "h2"]}
    assert _weights(store) == {"main": 100, "cand": 0}


def test_rollout_error_rate_gate_with_injected_faults():
    """The error-rate gate fed by REAL gateway traffic accounting: the
    candidate's graph node hard-fails via testing/faults.py, failures
    surface as FAILURE answers at the gateway, the stage rolls back."""

    async def run():
        from seldon_core_tpu_torch.graph.defaulting import default_and_validate
        from seldon_core_tpu_torch.graph.interpreter import GraphExecutor

        spec = _spec(shadow=False)
        default_and_validate(spec)
        executor = GraphExecutor(spec.predictor("cand"), device="cpu")
        executor.runtimes["clf-cand"] = FaultyNodeRuntime(
            executor.runtimes["clf-cand"], FaultSpec(error_rate=1.0),
        )
        engines = {
            "main": EngineService(spec, "main", device="cpu"),
            "cand": EngineService(spec, "cand", device="cpu",
                                  extra_runtimes=executor.runtimes),
        }
        gw, store, _, token = await _gateway(spec, engines=engines)
        ctrl = RolloutController(store, GatewaySignals(gw))
        plan = RolloutPlan(
            "life-dep", "cand", "main", stages=(50, 100), hold_s=0.0,
            config_hash="h1",
            gates=RolloutGates(max_error_rate=0.1, max_drift=None,
                               min_requests=8),
        )
        ctrl.apply(plan)
        ctrl.tick()  # stage 1: candidate at 50%
        rng = np.random.default_rng(8)
        rolled_back = None
        for _ in range(6):
            for _ in range(16):
                await gw.predict(_msg(rng), token)
            decisions = ctrl.tick()
            if decisions and decisions[0]["decision"] == "rollback":
                rolled_back = decisions[0]
                break
        assert rolled_back is not None
        assert rolled_back["reason"] == "error_rate"
        assert _weights(store, "k") == {"main": 100, "cand": 0}
        # baseline kept serving the whole time
        count, errors = gw.predictor_traffic("life-dep", "main")
        assert count > 0 and errors == 0
        await gw.close()

    asyncio.run(run())



def test_replay_flags_contract_break(tmp_path):
    class WrongShapeEngine:
        async def predict(self, msg):
            return SeldonMessage.from_array(np.zeros((1, 7)))

    async def run():
        path, _engines = await _record_firehose(tmp_path, n=12)
        doc = await replay_file(path, WrongShapeEngine())
        assert doc["verdict"] == "fail"
        assert doc["disagreement"]["mean"] == 1.0
        assert doc["counts"]["incomparable"] == 12

    asyncio.run(run())


def test_rollout_scrape_outage_at_stage_entry_backfills_baseline():
    """A one-tick signal outage while advancing must not zero the stage
    entry counters: the first good read becomes the baseline and the
    stage clock restarts, so min_requests means THIS stage's traffic."""
    store, _ = _store_with()
    clock = [0.0]
    state = {"fail": True, "requests": 10_000, "errors": 0}

    def signals(plan):
        if state["fail"]:
            raise ConnectionError("scrape down")
        return {"requests": state["requests"], "errors": state["errors"]}

    ctrl = RolloutController(store, signals, clock=lambda: clock[0])
    plan = RolloutPlan("dep", "cand", "main", stages=(5, 100), hold_s=5.0,
                       config_hash="h1",
                       gates=RolloutGates(min_requests=20,
                                          max_error_rate=0.05))
    ctrl.apply(plan)
    ctrl.tick()  # advance; entry read fails -> entry counters None
    state["fail"] = False
    clock[0] += 100  # ages past hold_s — but the clock must restart
    assert ctrl.tick()[0]["decision"] == "hold"  # backfilled, 0 new reqs
    # 100 new requests at this stage, 50 of them errors: without the
    # backfill this would read 50/10100 = 0.5% and promote
    clock[0] += 6
    state["requests"] += 100
    state["errors"] += 50
    decision = ctrl.tick()[0]
    assert decision["decision"] == "rollback"
    assert decision["reason"] == "error_rate"
    assert _weights(store) == {"main": 100, "cand": 0}


def test_rollout_rolls_back_when_signals_unavailable():
    store, _ = _store_with()

    def broken(plan):
        raise ConnectionError("scrape target down")

    ctrl = RolloutController(store, broken, clock=lambda: 0.0)
    plan = RolloutPlan("dep", "cand", "main", hold_s=0.0, config_hash="h1")
    ctrl.apply(plan)
    ctrl.tick()  # advance to stage 1
    decision = ctrl.tick()[0]
    assert decision["decision"] == "rollback"
    assert decision["reason"] == "signals_unavailable"
    assert _weights(store) == {"main": 100, "cand": 0}


def test_rollout_kill_switch(monkeypatch):
    store, _ = _store_with()
    ctrl = RolloutController(store, lambda plan: {"requests": 100})
    plan = RolloutPlan("dep", "cand", "main", hold_s=0.0, config_hash="h1")
    ctrl.apply(plan)
    monkeypatch.setenv("SELDON_TPU_ROLLOUTS", "0")
    assert ctrl.tick() == []
    assert ctrl.tick_deployment("dep") is None
    assert _weights(store) == {"main": 99, "cand": 1}
    monkeypatch.delenv("SELDON_TPU_ROLLOUTS")
    assert ctrl.tick()[0]["decision"] == "advance"


def test_rollout_plan_validation():
    with pytest.raises(ValueError):
        RolloutPlan("d", "cand", "cand")  # candidate == baseline
    with pytest.raises(ValueError):
        RolloutPlan("d", "c", "m", stages=(5, 1))  # not increasing
    with pytest.raises(ValueError):
        RolloutPlan("d", "c", "m", stages=(0, 100))  # 0% stage
    plan = RolloutPlan("d", "c", "m", stages=(1, 5))
    assert plan.stages == (1, 5, 100)  # terminal 100 appended


def test_plan_from_annotations_contract():
    spec = _spec(shadow=False, extra_ann={
        "seldon.io/canary": "cand",
        "seldon.io/canary-stages": "2,20",
        "seldon.io/canary-hold-s": "7",
        "seldon.io/canary-max-drift": "0.5",
        "seldon.io/canary-max-shadow-disagreement": "none",
        "seldon.io/canary-min-requests": "3",
    })
    plan = plan_from_annotations(spec, config_hash="h")
    assert plan.candidate == "cand" and plan.baseline == "main"
    assert plan.stages == (2, 20, 100)
    assert plan.hold_s == 7.0
    assert plan.gates.max_drift == 0.5
    assert plan.gates.max_shadow_disagreement is None
    assert plan.gates.min_requests == 3
    assert plan.config_hash == "h"
    # no annotation -> no plan
    assert plan_from_annotations(_spec(shadow=False), "h") is None
    # unknown predictor -> typed error
    bad = _spec(shadow=False, extra_ann={"seldon.io/canary": "ghost"})
    with pytest.raises(ValueError):
        plan_from_annotations(bad, "h")


def test_reconciler_drives_rollout_from_cr_annotations():
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler

    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2",
        "kind": "SeldonDeployment",
        "metadata": {"name": "dep", "annotations": {
            "seldon.io/canary": "cand",
            "seldon.io/canary-hold-s": "0",
            "seldon.io/canary-min-requests": "0",
            "seldon.io/canary-stages": "5,100",
        }},
        "spec": {"name": "dep", "predictors": [
            _predictor("main", 0, 3), _predictor("cand", 1, 1),
        ]},
    }
    store, _ = _store_with()
    sig = {"requests": 100, "errors": 0, "drift": 0.0}
    ctrl = RolloutController(store, lambda plan: dict(sig))
    api = FakeKubeApi()
    rec = Reconciler(api, rollouts=ctrl)
    api.create(cr)
    for _ in range(3):
        rec.run_once()
    status = api.get("SeldonDeployment", "default", "dep")["status"]
    assert status["rollout"]["state"] == "promoted"
    assert _weights(store) == {"main": 0, "cand": 100}
    # edit the spec (new config hash) with sick signals: stage 1 then
    # rollback, quarantined across further reconciles
    api.objects[("SeldonDeployment", "default", "dep")]["spec"][
        "annotations"] = {"note": "v2"}
    sig["drift"] = 2.0
    rec.run_once()
    rec.run_once()
    status = api.get("SeldonDeployment", "default", "dep")["status"]
    assert status["rollout"]["state"] == "rolled_back"
    assert status["rollout"]["rollback_reason"] == "drift"
    assert _weights(store) == {"main": 100, "cand": 0}
    rec.run_once()
    assert api.get("SeldonDeployment", "default", "dep")["status"][
        "rollout"]["state"] == "rolled_back"
    # CR deletion clears the rollout AND the quarantine
    api.delete("SeldonDeployment", "default", "dep")
    rec.run_once()
    assert ctrl.status_block("dep") is None
    assert ctrl.document()["quarantined"] == {}


def test_reconciler_surfaces_invalid_canary_annotation():
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler

    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2",
        "kind": "SeldonDeployment",
        "metadata": {"name": "dep", "annotations": {
            "seldon.io/canary": "ghost",
        }},
        "spec": {"name": "dep", "predictors": [
            _predictor("main", 0, 3), _predictor("cand", 1, 1),
        ]},
    }
    store, _ = _store_with()
    ctrl = RolloutController(store, lambda plan: {})
    api = FakeKubeApi()
    rec = Reconciler(api, rollouts=ctrl)
    api.create(cr)
    rec.run_once()
    status = api.get("SeldonDeployment", "default", "dep")["status"]
    assert status["rollout"]["state"] == "invalid"
    assert "ghost" in status["rollout"]["error"]
    assert _weights(store) == {"main": 99, "cand": 1}  # untouched


# ---------------------------------------------------------------------------
# the canary example, end to end
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the canary example, end to end
# ---------------------------------------------------------------------------


def test_canary_deployment_example_end_to_end(tmp_path):
    """examples/canary_deployment.json through the REAL pipeline:
    operator materialization -> two weighted predictors registered at the
    gateway -> 3:1 traffic split honored -> staged rollout -> rollback on
    injected drift -> weights snapped back, event in the firehose."""
    from seldon_core_tpu_torch.operator.materializer import Materializer

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "canary_deployment.json")
    with open(path) as f:
        doc = json.load(f)

    async def run():
        QUALITY.reset()
        spec = SeldonDeploymentSpec.from_json_dict(doc)
        mat = Materializer(spawn_units=False, device="cpu")
        md = mat.apply(spec)
        assert set(md.engines) == {"main", "canary"}
        fh = Firehose(base_dir=str(tmp_path))
        gw = ApiGateway(store=mat.store, firehose=fh, seed=11)
        fh.start()
        token = mat.store.issue_token("canary-key", "canary-secret")
        rng = np.random.default_rng(0)

        async def drive(shift, n):
            served, failures = [], 0
            for _ in range(n):
                msg = SeldonMessage.from_array(
                    rng.normal(shift, 1.0, (1, 784)).astype(np.float64))
                resp = await gw.predict(msg, token)
                if resp.status is not None and \
                        resp.status.status == "FAILURE":
                    failures += 1
                served.append(resp.meta.requestPath["predictor"])
            return served, failures

        # the example's 75/25 replica-weighted split is honored
        served, failures = await drive(0.0, 80)
        assert failures == 0
        counts = {p: served.count(p) for p in set(served)}
        assert counts.get("main", 0) > counts.get("canary", 0) > 0
        # freeze the healthy window as the drift reference
        QUALITY.reference_control("freeze")

        # staged rollout of the canary, gated on drift
        ctrl = RolloutController(mat.store, GatewaySignals(gw),
                                 firehose=fh)
        gw.rollouts = ctrl
        plan = RolloutPlan(
            "mnist-canary", "canary", "main", stages=(5, 25, 100),
            hold_s=0.0, config_hash="v2",
            gates=RolloutGates(max_drift=0.25,
                               max_shadow_disagreement=None,
                               min_requests=4),
        )
        ctrl.apply(plan)
        assert ctrl.tick()[0]["decision"] == "advance"
        # injected drift: the live inputs shift away from the reference
        decision = None
        for _ in range(6):
            _, failures2 = await drive(3.0, 24)
            assert failures2 == 0  # rollback machinery never breaks live
            decisions = ctrl.tick()
            decision = decisions[0] if decisions else None
            if decision and decision["decision"] == "rollback":
                break
        assert decision is not None and \
            decision["decision"] == "rollback", decision
        assert decision["reason"] == "drift"
        reg_weights = {
            n: w for n, w, _ in mat.store._by_key["canary-key"].engines
        }
        assert reg_weights == {"main": 100, "canary": 0}
        assert ctrl.status_block("mnist-canary")["state"] == "rolled_back"
        # the rollback event landed in the firehose next to the traffic
        await fh.stop()
        events = load_firehose_events(
            os.path.join(str(tmp_path), "mnist-canary.jsonl"))
        assert events  # the request stream
        with open(os.path.join(str(tmp_path), "mnist-canary.jsonl")) as f:
            raw = [json.loads(x) for x in f if x.strip()]
        assert any(e.get("event") == "rollback" for e in raw)
        # /stats carries the rollout + rollback surfaces
        stats = gw.stats()
        assert stats["rollouts"]["rollouts"]["mnist-canary"][
            "state"] == "rolled_back"
        assert stats["telemetry"]["traffic_lifecycle"]["rollbacks"].get(
            "drift", 0) >= 1
        mat.delete("mnist-canary")
        await gw.close()

    asyncio.run(run())



# ---------------------------------------------------------------------------
# the port's controller against the JAX controller
# ---------------------------------------------------------------------------


def _jax_store_with(name="dep"):
    from seldon_core_tpu.gateway.apife import DeploymentStore as JStore
    from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec

    spec = JSpec.from_json_dict({"spec": {"name": name, "oauth_key": name, "predictors": [
        _predictor("main", 0, 99), _predictor("cand", 1, 1)]}})
    store = JStore()
    store.register(spec, {"main": "http://a", "cand": "http://b"})
    return store


#: (clock advance, signal changes) a tick; None a scrape failure
SCRIPT = [
    (0, {}), (5, {"requests": 60}), (6, {"requests": 43}), (0, {"requests": 70}),
    (3, {"requests": 200, "errors": 2}), (11, {"requests": 260, "errors": 3}),
    (11, {"requests": 320, "errors": 3, "burn_rate": 3.0}),
    (11, {"requests": 400, "shadow_disagreement": 0.05}),
    (11, {"requests": 480}), (11, {"requests": 560}),
]
SCRIPT_SICK = [(0, {}), (11, {"requests": 80}), (11, {"requests": 160, "drift": 0.3})]
SCRIPT_OUTAGE = [(0, {"drift": 0.0}), (11, None), (11, {"requests": 900})]


def _drive(ctrl_cls, store, runs):
    """Apply each (plan, script) in turn, one tick a script entry; the
    decisions (wall stamps dropped) and the split after each tick, then
    ``document()`` and ``snapshot()``."""
    clock = [0.0]
    sig = {"requests": 40, "errors": 0, "drift": 0.0}
    fail = [False]

    def signals(plan):
        if fail[0]:
            raise ConnectionError("scrape down")
        return dict(sig)

    ctrl = ctrl_cls(store, signals, clock=lambda: clock[0])
    trace = []
    for plan, script in runs:
        ctrl.apply(plan)
        for dt, change in script:
            clock[0] += dt
            fail[0] = change is None
            sig.update(change or {})
            decisions = [{k: v for k, v in d.items() if k != "ts"} for d in ctrl.tick()]
            trace.append((decisions, _weights(store)))
    doc = ctrl.document()
    for ro in doc["rollouts"].values():
        ro["history"] = [{k: v for k, v in e.items() if k != "ts"} for e in ro["history"]]
    return trace, doc, ctrl.snapshot()


def test_controller_decisions_equal_the_jax_controllers():
    """One scripted signal sequence on one injected clock (a scrape outage,
    the burn and shadow gates, a promotion; then a second plan that rolls
    back on drift and a re-apply of its quarantined hash): the same
    decisions, reasons, stages, written splits and document."""
    from seldon_core_tpu.operator import rollouts as jro

    from seldon_core_tpu_torch.operator import rollouts as pro

    def healthy(mod):
        gates = mod.RolloutGates(min_requests=5, max_burn_rate=14.4)
        return [(mod.RolloutPlan("dep", "cand", "main", stages=(1, 5, 25, 100), hold_s=10.0,
                                 config_hash="h1", gates=gates), SCRIPT)]

    def sick(mod):
        def plan(h):
            return mod.RolloutPlan("dep", "cand", "main", stages=(10, 50), hold_s=10.0,
                                   config_hash=h, gates=mod.RolloutGates(min_requests=5))
        return [(plan("h2"), SCRIPT_SICK), (plan("h2"), SCRIPT_SICK),
                (plan("h3"), SCRIPT_OUTAGE)]

    store, _ = _store_with()
    got = _drive(RolloutController, store, healthy(pro))
    assert got == _drive(jro.RolloutController, _jax_store_with(), healthy(jro))
    assert [d["decision"] for ds, _w in got[0] for d in ds][-1] == "promote"
    store, _ = _store_with()
    got = _drive(RolloutController, store, sick(pro))
    assert got == _drive(jro.RolloutController, _jax_store_with(), sick(jro))
    reasons = [d.get("reason") for ds, _w in got[0] for d in ds if d["decision"] == "rollback"]
    assert reasons == ["drift", "signals_unavailable"]
    assert got[1]["quarantined"] == {"dep": ["h2", "h3"]}


def test_plan_from_annotations_equals_the_jax_parser():
    from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
    from seldon_core_tpu.operator import rollouts as jro

    cases = [{}, {"seldon.io/canary": "cand"},
             {"seldon.io/canary": "cand", "seldon.io/canary-stages": "2,20",
              "seldon.io/canary-hold-s": "7", "seldon.io/canary-max-drift": "off",
              "seldon.io/canary-max-error-rate": "0.2", "seldon.io/canary-min-requests": "3.0"},
             {"seldon.io/canary": "ghost"},
             {"seldon.io/canary": "cand", "seldon.io/canary-baseline": "nope"},
             {"seldon.io/canary": "cand", "seldon.io/canary-stages": "5,1"}]
    for ann in cases:
        doc = {"spec": {"name": "d", "annotations": ann, "predictors": [
            _predictor("main", 0, 3), _predictor("cand", 1, 1)]}}
        out = []
        for parse, spec_cls in ((jro.plan_from_annotations, JSpec),
                                (plan_from_annotations, SeldonDeploymentSpec)):
            try:
                plan = parse(spec_cls.from_json_dict(copy.deepcopy(doc)), "h")
                out.append(None if plan is None else (
                    plan.deployment, plan.candidate, plan.baseline, plan.stages, plan.hold_s,
                    plan.gates.to_json_dict(), plan.config_hash))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        assert out[0] == out[1], ann


def _canary_spec_doc():
    def predictor(pname, reps):
        return {"name": pname, "replicas": reps,
                "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}

    return {"spec": {"name": "dep", "oauth_key": "key", "oauth_secret": "s",
                     "predictors": [predictor("baseline", 9), predictor("candidate", 1)]}}


def _fed_package(name):
    if name == "jax":
        from seldon_core_tpu.gateway import federation, state
        from seldon_core_tpu.graph import spec
        from seldon_core_tpu.operator import rollouts
    else:
        from seldon_core_tpu_torch.gateway import federation, state
        from seldon_core_tpu_torch.graph import spec
        from seldon_core_tpu_torch.operator import rollouts
    return federation, state, spec, rollouts


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_mixed_federation_hands_the_rollout_over(tmp_path, first, second):
    """tests/test_federation.py:261's hand-off across packages over one
    sqlite file: replica A's controller starts the rollout and stalls past
    its TTL; replica B's controller, of the other package, resumes it at
    A's stage off the shared split and advances it; A's zombie tick is
    fenced and the split stays B's."""
    db = str(tmp_path / "gateway.db")
    fa, sa, speca, roa = _fed_package(first)
    fb, sb, _specb, rob = _fed_package(second)
    store_a = sa.SqliteDeploymentStore(db)
    store_b = sb.SqliteDeploymentStore(db)
    store_a.register(speca.SeldonDeploymentSpec.from_json_dict(_canary_spec_doc()),
                     {"baseline": "http://b:8000", "candidate": "http://c:8000"})
    fed_a = fa.GatewayFederation(store_a, "gw-a", ttl_s=0.25)
    fed_b = fb.GatewayFederation(store_b, "gw-b", ttl_s=0.25)

    def plan(mod):
        return mod.RolloutPlan(
            deployment="dep", candidate="candidate", baseline="baseline",
            stages=(10, 50, 100), hold_s=0.0, config_hash="h1",
            gates=mod.RolloutGates(min_requests=0, max_drift=None, max_burn_rate=None,
                                   max_error_rate=None, max_shadow_disagreement=None))

    def weights(store):
        return {n: w for n, w, _ in store._registration("key").engines}

    signals = lambda plan: {"requests": 1000, "errors": 0}  # noqa: E731
    ctl_a = roa.RolloutController(store_a, signals, federation=fed_a)
    ctl_b = rob.RolloutController(store_b, signals, federation=fed_b)
    ctl_a.apply(plan(roa))
    ctl_b.apply(plan(rob))
    try:
        fed_a.tick()
        assert fed_b.tick() is False
        [d] = ctl_a.tick()
        assert d["decision"] == "advance" and d["percent"] == 10
        assert weights(store_b)["candidate"] == 10
        assert ctl_b.tick() == []
        time.sleep(0.3)  # A stalls past its TTL
        assert fed_b.tick() is True
        [d] = ctl_b.tick()
        assert d["decision"] == "resume" and d["percent"] == 10
        [d] = ctl_b.tick()
        assert d["decision"] == "advance" and d["percent"] == 50
        assert weights(store_a)["candidate"] == 50
        [d] = ctl_a.tick()
        assert d["decision"] == "fenced"
        assert weights(store_a) == weights(store_b) == {"baseline": 50, "candidate": 50}
    finally:
        store_a.close()
        store_b.close()


@pytest.fixture()
def _slo():
    """A configured latency SLO on the port's process-global tracker,
    restored (with clean rings) afterwards (tests/test_fleet_burn.py)."""
    from seldon_core_tpu_torch.utils.quality import FLEET_BURN

    saved = QUALITY.slo.p99_ms, QUALITY.slo.error_rate
    QUALITY.slo.reset_events()  # the earlier cases' gateway traffic
    FLEET_BURN.clear()
    QUALITY.slo.p99_ms = 10.0
    QUALITY.slo.error_rate = None
    yield
    QUALITY.slo.p99_ms, QUALITY.slo.error_rate = saved
    QUALITY.slo.reset_events()
    FLEET_BURN.clear()


def test_rollout_burn_gate_reads_the_same_aggregate(tmp_path, _slo):
    """tests/test_fleet_burn.py:188 on the port: GatewaySignals' burn figure
    IS ``effective_burn_rate`` — with a fresh fleet fold the canary gate
    judges 2.6, not its local 1.2."""
    from seldon_core_tpu_torch.gateway.federation import GatewayFederation
    from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

    db = str(tmp_path / "gateway.db")
    fed_a = GatewayFederation(SqliteDeploymentStore(db), "gw-a", ttl_s=5.0)
    fed_b = GatewayFederation(SqliteDeploymentStore(db), "gw-b", ttl_s=5.0)
    now = time.time()
    for i in range(1000):
        QUALITY.slo.record(0.050 if i < 12 else 0.001, now=now)
    fed_b.store.publish_burn("gw-b", [("_global", "5m", 1000, 40, 0, 0, 0)])
    fed_a.tick()

    class _Shadow:
        def disagreement_rate(self, _):
            return None

    class _Gateway:
        shadow = _Shadow()

        def predictor_traffic(self, _dep, _pred):
            return 100, 0

    class _Plan:
        deployment, candidate = "dep", "candidate"

    out = GatewaySignals(_Gateway())(_Plan())
    assert out["burn_rate"] == pytest.approx(2.6, abs=0.1)
    assert out["requests"] == 100 and out["errors"] == 0
    fed_a.store.close()
    fed_b.store.close()


def test_http_signals_scrape_the_ports_gateway(tmp_path):
    """``HttpSignals`` reads the port gateway's ``/stats`` traffic block over
    HTTP (stdlib urllib): the candidate's requests and errors."""
    import threading

    from seldon_core_tpu_torch.gateway.apife import serve_gateway
    from seldon_core_tpu_torch.operator.rollouts import HttpSignals

    async def run():
        spec = _spec(shadow=False)
        gw, store, engines, token = await _gateway(spec)
        rng = np.random.default_rng(3)
        for _ in range(12):
            await gw.predict(_msg(rng), token)
        server = await serve_gateway(gw, "127.0.0.1", 0)
        try:
            plan = RolloutPlan("life-dep", "cand", "main", config_hash="h")
            out = {}
            t = threading.Thread(target=lambda: out.update(
                HttpSignals(f"http://127.0.0.1:{server.port}")(plan)))
            t.start()
            while t.is_alive():
                await asyncio.sleep(0.01)
            assert out["requests"] == gw.predictor_traffic("life-dep", "cand")[0] > 0
            assert out["errors"] == 0
        finally:
            await server.stop()
            await gw.close()
            for e in engines.values():
                e.close()

    asyncio.run(run())
