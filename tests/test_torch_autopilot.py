"""The port's learned cost-model autopilot
(``seldon_core_tpu_torch/runtime/autopilot.py``) and its decision sites
against the JAX package's, on the same inputs made with numpy from a seed:

  * the model: ``observe`` / ``predict_s`` sequences with outliers, the seed
    blend and ``MAX_KEYS`` (estimates equal to 1e-12), ``warm_start``,
    ``pad_bucket``, ``branch_key``, ``message_rows`` and ``document()``;
  * the flush planner: ``_plan_flush`` and ``predicted_latency_s`` on the
    same queues, deadlines and injected ``predict_s_fn``, and the legacy take
    under the kill switch;
  * admission: both engines, built from ``examples/mnist_deployment.json``
    with the same injected predictions and deadlines, shed the same requests
    with the same prefix, before any dispatch;
  * demotion: host mode (``GraphExecutor``) and fused mode (``FusedGraph``)
    give the reference's ``meta.routing`` and reroute tags;
  * the key the batcher prices is the key the spine trains, and a fused
    branch learns the wall that ends at the readback."""

import asyncio
import json
from collections import deque
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import units as jax_units
from seldon_core_tpu.graph.fuse import FusedGraph as JaxFusedGraph
from seldon_core_tpu.graph.interpreter import GraphExecutor as JaxExecutor
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.messages import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime import autopilot as jap
from seldon_core_tpu.runtime.batching import MicroBatcher as JaxBatcher
from seldon_core_tpu.runtime.brownout import BROWNOUT as JAX_BROWNOUT
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.runtime.qos import qos_scope as jax_qos_scope
from seldon_core_tpu.runtime.resilience import deadline_scope as jax_deadline_scope
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.fuse import FusedGraph
from seldon_core_tpu_torch.graph.interpreter import GraphExecutor, InProcessNodeRuntime
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime import autopilot as pap
from seldon_core_tpu_torch.runtime.batching import MicroBatcher
from seldon_core_tpu_torch.runtime.brownout import BROWNOUT, BROWNOUT_INFO_PREFIX
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.qos import qos_scope
from seldon_core_tpu_torch.runtime.resilience import deadline_scope
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.telemetry import RECORDER

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    pap.reset_learned_singletons()
    yield
    pap.reset_learned_singletons()


# ---------------------------------------------------------------------------
# units registered on both sides for the demotion graphs
# ---------------------------------------------------------------------------


@jax_units.register_unit("tap.Scale")
class _JaxScale(jax_units.Unit):
    def __init__(self, factor: float = 2.0):
        self.factor = factor

    def predict(self, state, X):
        return X * self.factor


@tunits.register_unit("tap.Scale")
class _Scale(tunits.Unit):
    def __init__(self, factor: float = 2.0):
        self.factor = factor

    def predict(self, state, X):
        return X * self.factor


@jax_units.register_unit("tap.SignRouter")
class _JaxSignRouter(jax_units.Unit):
    """Branch 1 when the first value is positive, else branch 0."""

    def route(self, state, X):
        return (X[0, 0] > 0).astype(jnp.int32)


@tunits.register_unit("tap.SignRouter")
class _SignRouter(tunits.Unit):
    def route(self, state, X):
        return int(X[0, 0] > 0)


ROUTER_GRAPH = {"name": "r", "type": "ROUTER", "children": [
    {"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
ROUTER_COMPS = [{"name": "r", "runtime": "inprocess", "class_path": "tap.SignRouter"},
                {"name": "a", "runtime": "inprocess", "class_path": "tap.Scale",
                 "parameters": [{"name": "factor", "value": "10.0", "type": "FLOAT"}]},
                {"name": "b", "runtime": "inprocess", "class_path": "tap.Scale",
                 "parameters": [{"name": "factor", "value": "-10.0", "type": "FLOAT"}]}]


def _router_preds():
    doc = {"spec": {"name": "ap", "predictors": [
        {"name": "p", "graph": ROUTER_GRAPH, "components": ROUTER_COMPS}]}}
    return (JaxSpec.from_json_dict(json.loads(json.dumps(doc))).predictor(None),
            SeldonDeploymentSpec.from_json_dict(json.loads(json.dumps(doc))).predictor(None))


def _seed(key):
    """A deterministic seed prior: some keys have none."""
    n = sum(map(ord, key))
    return None if n % 5 == 0 else 1e-3 * (1 + n % 7)


def _pair():
    j, p = jap.Autopilot(), pap.Autopilot()
    j.seed_fn = p.seed_fn = _seed
    return j, p


def _train(ap, key, seconds, n):
    for _ in range(n):
        ap.observe(key, seconds)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observe_predict_sequences_match(seed):
    """Huber-clipped EWMA with outliers and the seed blend: every prediction
    before and after each observation equals the reference's to 1e-12."""
    rng = np.random.default_rng(seed)
    j, p = _pair()
    keys = [f"predict[{b}x784/float32]" for b in (1, 2, 4, 8, 16)] + ["branch:r/0[1]"]
    for _ in range(400):
        key = keys[int(rng.integers(len(keys)))]
        s = float(rng.gamma(2.0, 1e-3))
        if rng.random() < 0.05:
            s *= 50.0  # a straggler
        if rng.random() < 0.02:
            s = -s  # not a measurement: ignored by both
        jp_, pp_ = j.observe(key, s), p.observe(key, s)
        assert (jp_ is None) == (pp_ is None)
        if jp_ is not None:
            assert abs(jp_ - pp_) <= 1e-12
        for k in keys + ["never-seen"]:
            a, b = j.predict_s(k), p.predict_s(k)
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(a - b) <= 1e-12
    for k in keys:
        assert (j._models[k].n, j._models[k].scale_s) == pytest.approx(
            (p._models[k].n, p._models[k].scale_s), abs=1e-12)


def test_max_keys_and_warm_start_match():
    j, p = _pair()
    for i in range(jap.Autopilot.MAX_KEYS + 20):
        assert j.observe(f"k{i}", 0.001 + i * 1e-6) == p.observe(f"k{i}", 0.001 + i * 1e-6)
    assert len(j._models) == len(p._models) == pap.Autopilot.MAX_KEYS
    assert p.predict_s("k300") == j.predict_s("k300")  # beyond the cap: the seed
    entries = [{"key": "w1", "n": 3, "est_s": 0.002, "scale_s": 0.0005, "last_s": 0.0021},
               {"key": "w2", "n": 400, "est_s": 0.004},
               {"key": "bad", "est_s": "x"}, {"key": "", "est_s": 1.0},
               {"key": "zero", "est_s": 0.0}]
    j2, p2 = _pair()
    assert j2.warm_start(entries) == p2.warm_start(entries) == 2
    for k in ("w1", "w2"):
        mj, mp = j2._models[k], p2._models[k]
        assert (mj.n, mj.est_s, mj.scale_s, mj.last_s) == (mp.n, mp.est_s, mp.scale_s, mp.last_s)
    assert j2.warm_keys == p2.warm_keys == 2


def test_helpers_match():
    for rows in (0, 1, 2, 3, 5, 64, 65, 1000, 1024, 1025):
        assert pap.pad_bucket(rows) == jap.pad_bucket(rows)
        for node, b in (("r", 0), ("eg-router", 3)):
            assert pap.branch_key(node, b, rows) == jap.branch_key(node, b, rows)
    assert pap.branch_key("r", 1, None) == jap.branch_key("r", 1, None) == "branch:r/1[1]"
    for body in ({"data": {"ndarray": [[1.0, 2.0], [3.0, 4.0]]}},
                 {"data": {"ndarray": [1.0, 2.0, 3.0]}},
                 {"data": {"tensor": {"shape": [3, 1], "values": [1, 2, 3]}}},
                 {"strData": "hello"}, {"jsonData": {"a": 1}}):
        text = json.dumps(body)
        assert pap.message_rows(SeldonMessage.from_json(text)) == \
            jap.message_rows(JaxMessage.from_json(text))
    # a device tensor's rows are read off its shape
    msg = SeldonMessage.from_json(json.dumps({"data": {"ndarray": [[1.0]] * 3}}))
    msg.data.array = torch.zeros(3, 1)
    assert pap.message_rows(msg) == 3


def test_document_fields_match():
    rng = np.random.default_rng(7)
    j, p = _pair()
    for _ in range(60):
        key = f"predict[{int(rng.choice([1, 4, 16]))}x784/float32]"
        s = float(rng.gamma(2.0, 1e-3))
        j.observe(key, s)
        p.observe(key, s)
    jd, pd = j.document(), p.document()
    assert set(jd) == set(pd)
    for k in ("enabled", "knobs", "keys", "mispredict_pct"):
        assert jd[k] == pd[k], k
    assert p.snapshot() == j.snapshot()
    assert isinstance(pd["sheds"], dict) and isinstance(pd["decisions"], dict)


# ---------------------------------------------------------------------------
# the flush planner
# ---------------------------------------------------------------------------


class _Dl:
    def __init__(self, rem):
        self.rem = rem

    def remaining_s(self):
        return self.rem


def _queues(seed):
    """A seeded queue: (rows, remaining deadline or None) per request."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(2, 12))):
        rows = int(rng.integers(1, 40))
        rem = None if rng.random() < 0.5 else float(rng.choice([0.0005, 0.002, 0.01, 1.0]))
        out.append((rows, rem))
    return out


def _predict_fn(seed):
    rng = np.random.default_rng(seed + 100)
    fixed = float(rng.uniform(2e-4, 1e-3))
    per_row = float(rng.uniform(1e-6, 5e-5))
    return lambda padded, x: fixed + per_row * padded


def _batchers(fn, max_batch=64, max_inflight=2):
    async def never(x):  # the planner never dispatches here
        raise AssertionError

    return (JaxBatcher(never, max_batch=max_batch, max_inflight=max_inflight, predict_s_fn=fn),
            MicroBatcher(never, max_batch=max_batch, max_inflight=max_inflight,
                         predict_s_fn=fn))


def _entries(queue):
    j, p = deque(), deque()
    for rows, rem in queue:
        x = np.zeros((rows, 4))
        dl = None if rem is None else _Dl(rem)
        j.append((x, None, 0.0, None, dl, ""))
        p.append((x, None, 0.0, None, None, "", "interactive", dl))
    return j, p


@pytest.mark.parametrize("seed", range(12))
def test_plan_flush_matches(seed):
    fn = _predict_fn(seed)
    jb, pb = _batchers(fn, max_batch=int(np.random.default_rng(seed).choice([16, 64, 1024])))
    jq, pq = _entries(_queues(seed))
    k_j, t_j = jb._plan_flush(jq)
    k_p, t_p = pb._plan_flush(pq)
    assert (k_p, t_p) == (k_j, t_j)
    # planned unless the head request alone fills max_batch
    assert (t_p is not None) == (pb._take_count(pq) > 1)


def test_plan_flush_legacy_take(monkeypatch):
    """The kill switch, no model and an unmodelled bucket take what fits
    under max_batch, unplanned, in both packages."""
    queue = [(3, None), (5, 0.0001), (9, None), (2, None)]
    for fn, env in ((_predict_fn(0), "0"), (None, "1"),
                    (lambda padded, x: None if padded > 4 else 1e-3, "1")):
        monkeypatch.setenv("SELDON_TPU_AUTOPILOT", env)
        jb, pb = _batchers(fn, max_batch=16)
        jq, pq = _entries(queue)
        assert pb._plan_flush(pq) == jb._plan_flush(jq) == (pb._take_count(pq), None)


@pytest.mark.parametrize("seed", range(6))
def test_predicted_latency_matches(seed):
    rng = np.random.default_rng(seed)
    fn = _predict_fn(seed)
    jb, pb = _batchers(fn, max_batch=32, max_inflight=2)
    jq, pq = _entries(_queues(seed))
    key_tail = ((4,), np.dtype(np.float64), "interactive")
    jb._buckets[key_tail] = jq
    pb._buckets[key_tail] = pq
    busy = int(rng.integers(0, 3))
    jb._inflight, pb._inflight = set(range(busy)), set(range(busy))
    ewma = float(rng.choice([0.0, 0.003]))
    jb._flush_ewma_s = pb._flush_ewma_s = ewma
    for rows in (1, 7, 40):
        x = np.zeros((rows, 4))
        assert pb.predicted_latency_s(x) == jb.predicted_latency_s(x)
    jb.predict_s_fn = pb.predict_s_fn = lambda padded, x: None
    assert pb.predicted_latency_s(np.zeros((1, 4))) is None


def test_tier_buckets_and_snapshot_label():
    """Tiers never share a flush; a lower tier's bucket is labelled by
    tier, and the interactive pump takes the freed slot first."""
    async def run():
        order, sizes = [], []
        release = asyncio.Event()

        async def batch_fn(x):
            sizes.append(len(x))
            if x[0, 0] == 0:
                await release.wait()
            else:
                order.append(int(x[0, 0]))
            return x, {}

        mb = MicroBatcher(batch_fn, max_inflight=1, coalesce_ms=0.0)
        blocker = asyncio.create_task(mb.submit(np.zeros((1, 2))))
        await asyncio.sleep(0.02)
        with qos_scope(None, "offline"):
            offline = asyncio.create_task(mb.submit(np.full((1, 2), 2.0)))
        await asyncio.sleep(0.02)
        interactive = asyncio.create_task(mb.submit(np.full((1, 2), 1.0)))
        await asyncio.sleep(0.02)
        labels = set(mb.snapshot()["buckets"])
        release.set()
        await asyncio.gather(blocker, offline, interactive)
        return order, labels, sizes

    order, labels, sizes = asyncio.run(run())
    assert order == [1, 2]
    assert labels == {"(2,)/float64", "(2,)/float64/offline"}
    assert sizes == [1, 1, 1]


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def _mnist_engines():
    doc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
    jax_engine = JaxEngine(JaxSpec.from_json_dict(json.loads(json.dumps(doc))))
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    return jax_engine, engine


def _body(rows, seed):
    x = np.random.default_rng(seed).random((rows, 784))
    return x, json.dumps({"data": {"ndarray": x.tolist()}})


def test_admission_sheds_the_same_requests():
    """The same injected dispatch predictions and deadlines: the same
    requests answer 503 with SHED_INFO_PREFIX in both engines, before any
    dispatch (the port's dispatch count does not move on a shed), and the
    shed counter and span are the reference's."""
    jax_engine, engine = _mnist_engines()
    calls = []
    orig = engine._batched_predict_sync

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    engine._batched_predict_sync = counted
    table = {1: 10.0, 2: 10.0, 4: 1e-4, 8: 1e-4, 16: 6.0}
    fn = (lambda padded, x: table.get(padded))
    jax_engine.batcher.predict_s_fn = fn
    engine.batcher.predict_s_fn = fn
    # (rows, deadline s, status): a 16-row request predicted at 6 s fits a
    # 5 s budget under the 1.25 margin and not a 4 s one
    cases = [(1, 5.0, 503), (2, 5.0, 503), (3, 5.0, 200), (8, 5.0, 200), (1, None, 200),
             (16, 5.0, 200), (16, 4.0, 503)]
    try:
        for rows in (1, 2, 3, 8, 16):  # no deadline: nothing sheds, every shape warm
            _, body = _body(rows, 99)
            assert asyncio.run(jax_engine.predict_json(body))[1] == 200
            assert asyncio.run(engine.predict_json(body))[1] == 200
        sheds0 = RECORDER.autopilot_counters()[0].get("admission", 0)
        for i, (rows, dl, want) in enumerate(cases):
            _, body = _body(rows, i)

            async def one(eng, scope):
                with scope(dl) if dl is not None else _null():
                    return await eng.predict_json(body)

            jtext, jstatus = asyncio.run(one(jax_engine, jax_deadline_scope))
            before = len(calls)
            text, status = asyncio.run(one(engine, deadline_scope))
            assert status == jstatus == want, (rows, dl, text, jtext)
            if status == 503:
                assert json.loads(text)["status"]["info"].startswith(pap.SHED_INFO_PREFIX)
                assert json.loads(jtext)["status"]["info"].startswith(jap.SHED_INFO_PREFIX)
                assert len(calls) == before  # no dispatch
            else:
                assert len(calls) > before
        assert RECORDER.autopilot_counters()[0].get("admission", 0) - sheds0 == 3
    finally:
        engine.close()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_brownout_tier_shed_and_kill_switches(monkeypatch):
    """A tier the ladder sheds answers 503 with BROWNOUT_INFO_PREFIX in both
    engines; SELDON_TPU_BROWNOUT=0 serves it, and SELDON_TPU_AUTOPILOT=0
    serves a request the model would shed."""
    jax_engine, engine = _mnist_engines()
    _, body = _body(1, 0)

    async def one(eng, qscope, dscope, tier, dl=None):
        with qscope(None, tier), (dscope(dl) if dl is not None else _null()):
            return await eng.predict_json(body)

    try:
        BROWNOUT._stage = JAX_BROWNOUT._stage = 1
        for tier, want in (("offline", 503), ("batch", 200), ("interactive", 200)):
            text, status = asyncio.run(one(engine, qos_scope, deadline_scope, tier))
            jtext, jstatus = asyncio.run(one(jax_engine, jax_qos_scope, jax_deadline_scope, tier))
            assert status == jstatus == want
            if want == 503:
                assert json.loads(text)["status"]["info"].startswith(BROWNOUT_INFO_PREFIX)
        monkeypatch.setenv("SELDON_TPU_BROWNOUT", "0")
        assert asyncio.run(one(engine, qos_scope, deadline_scope, "offline"))[1] == 200
        monkeypatch.delenv("SELDON_TPU_BROWNOUT")
        BROWNOUT._stage = JAX_BROWNOUT._stage = 0
        engine.batcher.predict_s_fn = lambda padded, x: 5.0
        assert asyncio.run(one(engine, qos_scope, deadline_scope, "interactive", 2.0))[1] == 503
        monkeypatch.setenv("SELDON_TPU_AUTOPILOT", "0")
        assert asyncio.run(one(engine, qos_scope, deadline_scope, "interactive", 2.0))[1] == 200
    finally:
        JAX_BROWNOUT.reset()
        engine.close()


# ---------------------------------------------------------------------------
# demotion
# ---------------------------------------------------------------------------


def _train_branches(slow=10.0, fast=1e-3, rows=1):
    for ap in (jap.AUTOPILOT, pap.AUTOPILOT):
        _train(ap, jap.branch_key("r", 0, rows), slow, 6)
        _train(ap, jap.branch_key("r", 1, rows), fast, 6)


def _host_predict(executor, msg_cls, scope, x, dl):
    msg = msg_cls.from_json(json.dumps({"data": {"ndarray": x.tolist()}}))

    async def go():
        with scope(dl) if dl is not None else _null():
            return await executor.predict(msg)

    return asyncio.run(go())


@pytest.mark.parametrize("first,dl,kill", [(-1.0, 1.0, False), (1.0, 1.0, False),
                                           (-1.0, None, False), (-1.0, 1.0, True),
                                           (-1.0, 50.0, False)])
def test_host_mode_demotion_matches(first, dl, kill, monkeypatch):
    """Branch 0 predicted at 10 s, branch 1 at 1 ms: a request the router
    sends to branch 0 under a 1 s deadline is served by branch 1 in both
    interpreters, with the same routing and reroute tag; no deadline, an
    ample one or the kill switch keep the router's branch."""
    jpred, pred = _router_preds()
    jex, ex = JaxExecutor(jpred), GraphExecutor(pred, device="cpu")
    for v in (-1.0, 1.0):  # both branches run once first (the JAX side compiles)
        _host_predict(jex, JaxMessage, jax_deadline_scope, np.full((1, 2), v), None)
        _host_predict(ex, SeldonMessage, deadline_scope, np.full((1, 2), v), None)
    jap.AUTOPILOT.reset()
    pap.AUTOPILOT.reset()
    if kill:
        monkeypatch.setenv("SELDON_TPU_AUTOPILOT", "0")
    _train_branches()
    x = np.full((1, 2), first)
    jresp = _host_predict(jex, JaxMessage, jax_deadline_scope, x, dl)
    resp = _host_predict(ex, SeldonMessage, deadline_scope, x, dl)
    assert resp.meta.routing == jresp.meta.routing
    ptags = {k: v for k, v in resp.meta.tags.items() if k.startswith("seldon.autopilot")}
    jtags = {k: v for k, v in jresp.meta.tags.items() if k.startswith("seldon.autopilot")}
    assert ptags == jtags
    demoted = first < 0 and dl == 1.0 and not kill
    assert ptags == ({"seldon.autopilot.reroute.r": 1} if demoted else {})
    np.testing.assert_allclose(np.asarray(resp.data.array), np.asarray(jresp.data.array))
    jap.AUTOPILOT.reset()


@pytest.mark.parametrize("first,budget", [(-1.0, 0.1), (1.0, 0.1), (-1.0, None), (-1.0, 50.0)])
def test_fused_demotion_matches(first, budget):
    """The fused walk's cost vectors from the learned branch walls and the
    request's budget: the same served branch, routing and tag as the
    reference's fused program; a demotion counts a route decision."""
    jap.AUTOPILOT.reset()
    _train_branches()
    jpred, pred = _router_preds()
    x = np.full((1, 2), first, np.float32)
    jy, jrouting, jtags = JaxFusedGraph(jpred).predict_arrays(x, budget_s=budget)
    routes0 = RECORDER.autopilot_counters()[1].get("route", 0)
    y, routing, tags = FusedGraph(pred, device="cpu").predict_arrays(x, budget_s=budget)
    assert routing == jrouting
    assert {k: v for k, v in tags.items() if k.startswith("seldon")} == \
        {k: int(v) for k, v in jtags.items() if k.startswith("seldon")}
    np.testing.assert_allclose(y.numpy(), np.asarray(jy))
    demoted = first < 0 and budget == 0.1
    assert RECORDER.autopilot_counters()[1].get("route", 0) - routes0 == int(demoted)
    jap.AUTOPILOT.reset()


def test_fused_engine_demotes_with_the_request_budget():
    """A fused-mode router engine reads the request's deadline on the
    request's side: the demoted request's meta names branch 1 and carries
    the tag; the served branch learned a wall."""
    doc = {"spec": {"name": "ap", "predictors": [
        {"name": "p", "graph": ROUTER_GRAPH, "components": ROUTER_COMPS}]}}
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    try:
        assert engine.mode == "fused"
        _train_branches()
        body = json.dumps({"data": {"ndarray": [[-1.0, -1.0]]}})

        async def go(dl):
            with deadline_scope(dl) if dl is not None else _null():
                return await engine.predict_json(body)

        n1 = pap.AUTOPILOT._models[pap.branch_key("r", 1, 1)].n
        text, status = asyncio.run(go(1.0))
        meta = json.loads(text)["meta"]
        assert status == 200 and meta["routing"] == {"r": 1}
        assert meta["tags"]["seldon.autopilot.reroute.r"] == 1
        assert pap.AUTOPILOT._models[pap.branch_key("r", 1, 1)].n == n1 + 1
        text, status = asyncio.run(go(None))
        assert json.loads(text)["meta"]["routing"] == {"r": 0}
    finally:
        engine.close()


def test_fused_branch_learns_the_wall_to_readback(monkeypatch):
    """A fused subtree with a router inside a host-mode engine (its root's
    runtime supplied, so the router's subtree fuses alone): the served
    branch's learned estimate is the subtree's recorded dispatch wall (its
    first sample), not less."""
    graph = {"name": "t", "type": "MODEL", "children": [ROUTER_GRAPH]}
    comps = ROUTER_COMPS + [{"name": "t", "runtime": "inprocess", "class_path": "tap.Scale",
                             "parameters": [{"name": "factor", "value": "1.0",
                                             "type": "FLOAT"}]}]
    doc = {"spec": {"name": "ap", "predictors": [
        {"name": "p", "graph": graph, "components": comps}]}}
    pred = SeldonDeploymentSpec.from_json_dict(doc).predictor(None)
    t = InProcessNodeRuntime(pred.graph, _Scale(1.0), device="cpu")
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu",
                           extra_runtimes={"t": t})
    walls = []
    orig = SPINE.record_dispatch

    def recorded(wants, **kw):
        walls.append(kw["seconds"])
        return orig(wants, **kw)

    monkeypatch.setattr(SPINE, "record_dispatch", recorded)
    try:
        assert engine.mode == "host" and engine.fusion_plan.fused_roots == ["r"]
        text, status = asyncio.run(engine.predict_json(
            json.dumps({"data": {"ndarray": [[2.0, 3.0]]}})))
        assert status == 200 and json.loads(text)["meta"]["routing"] == {"r": 1}
        m = pap.AUTOPILOT._models[pap.branch_key("r", 1, 1)]
        assert len(walls) == 1 and m.n == 1 and m.est_s >= walls[0] > 0
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# the key the batcher prices is the key the spine trains
# ---------------------------------------------------------------------------


def test_planned_key_is_the_trained_key():
    """After min_samples dispatches of each pad bucket, the batcher's
    prediction for that bucket reads the key's learned estimate: the
    /autopilot row of exactly that key is trusted."""
    doc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        for rows in (1, 3, 8):
            _, body = _body(rows, rows)
            for _ in range(pap.AUTOPILOT.min_samples):
                assert asyncio.run(engine.predict_json(body))[1] == 200
        doc = engine.autopilot_document()
        table = {r["key"]: r for r in doc["keys"]}
        for rows, bucket in ((1, 1), (3, 4), (8, 8)):
            x = np.zeros((rows, 784))
            key = engine.compiled.shape_key((bucket, 784), x.dtype)
            assert key == f"predict[{bucket}x784/float32]"
            assert table[key]["samples"] >= pap.AUTOPILOT.min_samples and table[key]["trusted"]
            learned = pap.AUTOPILOT._models[key].est_s
            assert engine._predict_dispatch_s(bucket, x) == learned
            assert engine.batcher.predicted_latency_s(x) == pytest.approx(
                learned + engine.batcher.coalesce_s, abs=1e-12)
        assert engine.stats()["autopilot"]["keys"] >= 3
    finally:
        engine.close()


def test_routes_serve_the_reference_documents():
    """``GET /autopilot`` and ``/corpus`` on the engine, ``/autopilot`` on the
    unit microservice, and ``/stats``' ``autopilot`` and ``brownout`` blocks
    carry the reference's fields."""
    from seldon_core_tpu_torch.graph.spec import Parameter
    from seldon_core_tpu_torch.runtime.microservice import build_runtime
    from seldon_core_tpu_torch.runtime.rest import _EngineRoutes, _UnitRoutes

    jax_engine, engine = _mnist_engines()
    try:
        routes = _EngineRoutes(engine)
        for path, jdoc in ((b"/autopilot", jax_engine.autopilot_document()),
                           (b"/corpus", jax_engine.corpus_document())):
            status, body, _ = asyncio.run(routes.get[path](b"", ""))
            doc = json.loads(body)
            assert status == 200 and set(doc) == set(jdoc), path
            assert set(doc["knobs"]) == set(jdoc["knobs"]) and doc["engine"] == jdoc["engine"]
        stats, jstats = engine.stats(), jax_engine.stats()
        assert set(stats["autopilot"]) == set(jstats["autopilot"])
        assert set(stats["brownout"]) == set(jstats["brownout"])
        unit = build_runtime("MnistClassifier", parameters=[Parameter.from_json_dict(
            {"name": "hidden", "value": "32", "type": "INT"})], unit_name="m", device="cpu")
        status, body, _ = asyncio.run(_UnitRoutes(unit).get[b"/autopilot"](b"", ""))
        doc = json.loads(body)
        assert status == 200 and doc["unit"]["name"] == "m"
        assert set(doc) - {"unit"} == set(jax_engine.autopilot_document()) - {"engine"}
    finally:
        engine.close()


def test_prewarm_runs_every_bucket():
    """``prewarm`` runs each power-of-two bucket of a width once (11 at a
    max_batch of 1,024), registers each in the perf observatory (the
    autopilot's seed prior for a bucket never dispatched) and counts the
    width as known-good; a width the graph rejects is skipped; the
    continuous lane prewarms through one probe request a width."""
    from seldon_core_tpu_torch.utils.perf import OBSERVATORY

    doc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        assert engine.prewarm([784, 16]) == 11
        keys = {r["executable"] for r in OBSERVATORY.document()["executables"]}
        assert {f"predict[{1 << i}x784/float32]" for i in range(11)} <= keys
        assert engine._known_good_widths == {(784,)}
        assert engine._predict_dispatch_s(512, np.zeros((1, 784))) is not None  # the seed
    finally:
        engine.close()
    gdoc = json.loads((ROOT / "examples" / "generator_deployment.json").read_text())
    gen = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(gdoc)),
                        device="cpu")
    try:
        assert gen.prewarm([8]) == 1
        assert gen.genserver.snapshot()["admitted_total"] == 1
    finally:
        gen.close()
