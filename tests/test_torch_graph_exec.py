"""The port's host interpreter (graph/interpreter.py) against the JAX
package's on the same graphs and inputs: the cases of
tests/test_graph_exec.py's host half, broadcast routing, the quorum and
fallback degradation policies, the deadline at every hop, the input
narrowing, user objects behind their adapter, and the engine's choice of
mode.  Inputs are integer-valued, made with numpy from a seed, so every
output is exact on both sides and compared bit for bit."""

import asyncio
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_graph_exec  # noqa: F401  (registers the JAX test.* units)
from seldon_core_tpu.graph import units as jax_units
from seldon_core_tpu.graph.interpreter import GraphExecutor as JaxExecutor
from seldon_core_tpu.graph.interpreter import NodeRuntime as JaxNodeRuntime
from seldon_core_tpu.graph.spec import GraphSpecError as JaxGraphSpecError
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.messages import DeadlineExceededError as JaxDeadlineExceeded
from seldon_core_tpu.messages import Feedback as JaxFeedback
from seldon_core_tpu.messages import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.runtime.resilience import deadline_scope as jax_deadline_scope
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.interpreter import GraphExecutor, NodeRuntime
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import DeadlineExceededError, Feedback, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.resilience import deadline_scope
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

ROOT = Path(__file__).resolve().parents[1]


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


# ---------------------------------------------------------------------------
# the port's copies of the test.* units (tests/test_graph_exec.py), and two
# more registered on both sides
# ---------------------------------------------------------------------------


@tunits.register_unit("test.Scale")
class Scale(tunits.Unit):
    def __init__(self, factor: float = 2.0):
        self.factor = factor

    def predict(self, state, X):
        return X * self.factor


@tunits.register_unit("test.AddTag")
class AddTag(tunits.Unit):
    def transform_input(self, state, X):
        return X, tunits.UnitAux(tags={"batch_mean": X.mean()})


@tunits.register_unit("test.CountingRouter")
class CountingRouter(tunits.Unit):
    def __init__(self, n_branches: int = 2):
        self.n = n_branches

    def init_state(self, rng):
        return {"rewards": torch.zeros(self.n), "counts": torch.zeros(self.n)}

    def route(self, state, X):
        return torch.argmax(state["rewards"]).int()

    def send_feedback(self, state, X, branch, reward, truth):
        onehot = (torch.arange(self.n) == branch).float()  # jax.nn.one_hot(-1) is all zeros
        return {"rewards": state["rewards"] + onehot * reward,
                "counts": state["counts"] + onehot}


@tunits.register_unit("test.BadRouter")
class BadRouter(tunits.Unit):
    def __init__(self, branch: int = 5):
        self.branch = branch

    def route(self, state, X):
        return torch.tensor(self.branch, dtype=torch.int32)


@tunits.register_unit("test.NamedModel")
class NamedModel(tunits.Unit):
    def __init__(self, label: str = "x", factor: float = 1.0):
        self.class_names = [f"{label}:0", f"{label}:1"]
        self.factor = factor

    def predict(self, state, X):
        return X[:, :2] * self.factor


@jax_units.register_unit("tport.Broadcast")
class _JaxBroadcast(jax_units.Unit):
    """Routes every request to all children (-1) and sums their answers."""

    def route(self, state, X):
        return jnp.int32(-1)

    def aggregate(self, state, Ys):
        return jnp.sum(Ys, axis=0)


@tunits.register_unit("tport.Broadcast")
class _Broadcast(tunits.Unit):
    def route(self, state, X):
        return -1

    def aggregate(self, state, Ys):
        return Ys.sum(dim=0)


@jax_units.register_unit("tport.Dtype")
class _JaxDtype(jax_units.Unit):
    """Tags the item size and kind of the rows it was fed."""

    def transform_input(self, state, X):
        return X, jax_units.UnitAux(tags={"itemsize": X.dtype.itemsize,
                                          "floating": bool(jnp.issubdtype(X.dtype,
                                                                          jnp.floating))})


@tunits.register_unit("tport.Dtype")
class _Dtype(tunits.Unit):
    def transform_input(self, state, X):
        return X, tunits.UnitAux(tags={"itemsize": X.dtype.itemsize,
                                       "floating": X.dtype.is_floating_point})


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _doc(graph, components=None, annotations=None):
    return {"spec": {"name": "t", "predictors": [{
        "name": "p", "graph": graph, "components": components or [],
        "annotations": annotations or {}}]}}


def _preds(graph, components=None):
    doc = _doc(graph, components)
    return (JaxSpec.from_json_dict(json.loads(json.dumps(doc))).predictor(),
            SeldonDeploymentSpec.from_json_dict(doc).predictor())


def _scale(name, factor):
    return {"name": name, "runtime": "inprocess", "class_path": "test.Scale",
            "parameters": [{"name": "factor", "value": str(factor), "type": "FLOAT"}]}


def _ints(seed, shape, lo=-8, hi=8):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.float64)


def _run_both(jax_ex, port_ex, x, puid="pp"):
    """The same request through both executors: (JAX answer, port answer)."""
    jreq, preq = JaxMessage.from_array(x), SeldonMessage.from_array(x)
    jreq.meta.puid = preq.meta.puid = puid
    return asyncio.run(jax_ex.predict(jreq)), asyncio.run(port_ex.predict(preq))


def _same(jresp, presp):
    """Bit-identical payload, the same names, routing, tags and puid."""
    np.testing.assert_array_equal(np.asarray(presp.array()), np.asarray(jresp.array()))
    assert presp.names() == jresp.names()
    assert presp.meta.routing == jresp.meta.routing
    assert presp.meta.tags == jresp.meta.tags
    assert presp.meta.puid == jresp.meta.puid
    assert presp.status.status == jresp.status.status == "SUCCESS"


def _executors(graph, components=None, **kw):
    jpred, ppred = _preds(graph, components)
    jkw = {k: v for k, v in kw.items() if k != "extra"}
    jax_ex = JaxExecutor(jpred, extra_runtimes=kw.get("extra", (None, None))[0], **jkw)
    port_ex = GraphExecutor(ppred, extra_runtimes=kw.get("extra", (None, None))[1],
                            device="cpu", **jkw)
    return jax_ex, port_ex


def _port_executor(graph, components, extra=None):
    return GraphExecutor(_preds(graph, components)[1], extra_runtimes=extra, device="cpu")


def _jax_ab_draws(key, count):
    us = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        us.append(float(jax.random.uniform(sub)))
    return us


class _Failing(NodeRuntime):
    """A remote node stand-in whose every call raises ``exc``."""

    def __init__(self, exc):
        self.exc = exc
        self.calls = 0

    async def predict(self, msg):
        self.calls += 1
        raise self.exc


class _JaxFailing(JaxNodeRuntime):
    def __init__(self, exc):
        self.exc = exc

    async def predict(self, msg):
        raise self.exc


COMB = {"name": "comb", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
        "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}


# ---------------------------------------------------------------------------
# the host half of tests/test_graph_exec.py
# ---------------------------------------------------------------------------


def test_simple_model_host_matches_the_jax_executor():
    """SIMPLE_MODEL answers [0.1, 0.9, 0.5] with class0..2, the puid kept
    (engine SimpleModelUnitTest.java:43-119)."""
    jax_ex, port_ex = _executors({"name": "m", "implementation": "SIMPLE_MODEL",
                                  "type": "MODEL"})
    jresp, presp = _run_both(jax_ex, port_ex, np.zeros((2, 4)))
    np.testing.assert_allclose(presp.array(), [[0.1, 0.9, 0.5]] * 2, atol=1e-6)
    _same(jresp, presp)


def test_average_combiner_host_matches_the_jax_executor():
    """The mean over children (engine AverageCombinerTest.java:41-228)."""
    jax_ex, port_ex = _executors(COMB, [_scale("s1", 2.0), _scale("s2", 4.0)])
    x = _ints(0, (3, 5))
    jresp, presp = _run_both(jax_ex, port_ex, x)
    np.testing.assert_array_equal(presp.array(), x * 3.0)
    _same(jresp, presp)


def test_abtest_routing_host_follows_the_reference_draws():
    """A seeded RANDOM_ABTEST routes as the JAX executor's for the same
    draws (its key's uniforms injected into the port's router), records
    meta.routing and serves the routed child's output."""
    g = {"name": "ab", "implementation": "RANDOM_ABTEST", "type": "ROUTER",
         "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
         "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}
    jpred, ppred = _preds(g, [_scale("s1", 1.0), _scale("s2", -1.0)])
    jax_ex = JaxExecutor(jpred, rng=jax.random.key(7))
    port_ex = GraphExecutor(ppred, rng=7, device="cpu")
    draws = iter(_jax_ab_draws(jax_ex.runtimes["ab"].state, 20))
    port_ex.runtimes["ab"].unit._draw = lambda key: (key, torch.tensor(next(draws)))
    seen = []
    for i in range(20):
        jresp, presp = _run_both(jax_ex, port_ex, _ints(i, (1, 2)))
        _same(jresp, presp)
        seen.append(presp.meta.routing["ab"])
    assert set(seen) == {0, 1}


def test_tags_merge_host_matches_the_jax_executor():
    g = {"name": "outlier", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}
    comps = [{"name": "outlier", "runtime": "inprocess", "class_path": "test.AddTag"},
             {"name": "m", "runtime": "inprocess", "class_path": "test.Scale"}]
    jax_ex, port_ex = _executors(g, comps)
    jresp, presp = _run_both(jax_ex, port_ex, np.full((1, 2), 3.0))
    assert presp.meta.tags["batch_mean"] == pytest.approx(3.0)
    np.testing.assert_array_equal(presp.array(), [[6.0, 6.0]])
    _same(jresp, presp)


def test_feedback_routed_branch_only_host_matches_the_jax_executor():
    """Feedback replays meta.routing: only the serving branch trains, and
    the router's learned preference moves as the reference's
    (engine PredictiveUnitBean.java:141-149)."""
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter"},
             _scale("s1", 2.0), _scale("s2", -2.0)]
    jax_ex, port_ex = _executors(g, comps)
    x = _ints(3, (2, 3))
    jresp, presp = _run_both(jax_ex, port_ex, x)
    _same(jresp, presp)
    assert presp.meta.routing == {"r": 0}
    for routing, reward in ((0, 5.0), (1, 9.0), (-1, 1.0)):
        jresp.meta.routing["r"] = presp.meta.routing["r"] = routing
        jfb = JaxFeedback(request=JaxMessage.from_array(x), response=jresp, reward=reward)
        pfb = Feedback(request=SeldonMessage.from_array(x), response=presp, reward=reward)
        jack = asyncio.run(jax_ex.send_feedback(jfb))
        pack = asyncio.run(port_ex.send_feedback(pfb))
        assert pack.meta.puid == jack.meta.puid == "pp"
        for k in ("rewards", "counts"):
            np.testing.assert_array_equal(port_ex.states()["r"][k].numpy(),
                                          np.asarray(jax_ex.states()["r"][k]))
    np.testing.assert_array_equal(port_ex.states()["r"]["rewards"].numpy(), [5.0, 9.0])
    jresp, presp = _run_both(jax_ex, port_ex, x)
    assert presp.meta.routing == {"r": 1}  # the learned preference
    _same(jresp, presp)


def test_mismatched_combiner_shapes_raise_on_both_sides():
    g = {"name": "comb", "implementation": "AVERAGE_COMBINER", "type": "COMBINER",
         "children": [{"name": "s1", "type": "MODEL"},
                      {"name": "sm", "implementation": "SIMPLE_MODEL", "type": "MODEL"}]}
    comps = [{"name": "s1", "runtime": "inprocess", "class_path": "test.Scale"}]
    jax_ex, port_ex = _executors(g, comps)
    with pytest.raises(JaxGraphSpecError, match="shapes differ"):
        asyncio.run(jax_ex.predict(JaxMessage.from_array(np.ones((1, 2)))))
    with pytest.raises(GraphSpecError, match="shapes differ"):
        asyncio.run(port_ex.predict(SeldonMessage.from_array(np.ones((1, 2)))))


@pytest.mark.parametrize("bad_branch", [5, -2])
def test_invalid_branch_raises_on_both_sides(bad_branch):
    """An out-of-range or negative (not broadcast) branch raises instead of
    picking a child, on both sides."""
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.BadRouter",
              "parameters": [{"name": "branch", "value": str(bad_branch), "type": "INT"}]},
             _scale("s1", 1.0), _scale("s2", 1.0)]
    jax_ex, port_ex = _executors(g, comps)
    with pytest.raises(JaxGraphSpecError, match="children"):
        asyncio.run(jax_ex.predict(JaxMessage.from_array(np.ones((1, 2)))))
    with pytest.raises(GraphSpecError, match=f"chose branch {bad_branch} but has 2 children"):
        asyncio.run(port_ex.predict(SeldonMessage.from_array(np.ones((1, 2)))))


def test_output_names_follow_the_routing_host():
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter"}] + [
        {"name": n, "runtime": "inprocess", "class_path": "test.NamedModel",
         "parameters": [{"name": "label", "value": n, "type": "STRING"}]} for n in "ab"]
    jax_ex, port_ex = _executors(g, comps)
    jresp, presp = _run_both(jax_ex, port_ex, _ints(4, (2, 3)))
    _same(jresp, presp)
    assert presp.names() == ["a:0", "a:1"]


# ---------------------------------------------------------------------------
# what only the host path does: broadcast, quorum, fallback, deadlines
# ---------------------------------------------------------------------------


def test_broadcast_routing_sends_every_child_and_aggregates():
    """A router's -1 is broadcast: every child runs, the router aggregates,
    and meta.routing records -1, as the JAX executor does."""
    g = {"name": "r", "type": "ROUTER", "methods": ["ROUTE", "AGGREGATE"],
         "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"},
                      {"name": "s3", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "tport.Broadcast"},
             _scale("s1", 1.0), _scale("s2", 2.0), _scale("s3", -4.0)]
    jax_ex, port_ex = _executors(g, comps)
    x = _ints(5, (4, 3))
    jresp, presp = _run_both(jax_ex, port_ex, x)
    _same(jresp, presp)
    assert presp.meta.routing == {"r": -1}
    np.testing.assert_array_equal(presp.array(), -x)


@pytest.mark.parametrize("exc", [ConnectionRefusedError("refused"), TimeoutError("slow")],
                         ids=["refused", "timeout"])
def test_quorum_drops_a_failed_branch_as_the_reference(exc):
    """A COMBINER with quorum 1 over a serving child and a failing remote
    stand-in aggregates the child that answered and names the dropped one
    in seldon.degraded.<node>; both sides agree."""
    g = dict(COMB, quorum=1)
    comps = [_scale("s1", 2.0), {"name": "s2", "runtime": "rest", "host": "127.0.0.1",
                                 "port": 9}]
    failing = _Failing(exc)
    jax_ex, port_ex = _executors(g, comps, extra=({"s2": _JaxFailing(exc)}, {"s2": failing}))
    x = _ints(6, (2, 4))
    jresp, presp = _run_both(jax_ex, port_ex, x)
    _same(jresp, presp)
    assert presp.meta.tags == {"seldon.degraded.comb": ["s2"]} and failing.calls == 1
    np.testing.assert_array_equal(presp.array(), x * 2.0)


def test_quorum_below_threshold_and_misconfiguration_propagate():
    """Below quorum the first failure propagates; a GraphSpecError is never
    absorbed, whatever the quorum."""
    both_down = dict(COMB, quorum=1)
    comps = [{"name": n, "runtime": "rest", "host": "127.0.0.1", "port": 9} for n in ("s1", "s2")]
    extra = {"s1": _Failing(ConnectionResetError("s1 down")),
             "s2": _Failing(ConnectionRefusedError("s2 down"))}
    port_ex = _port_executor(both_down, comps, extra)
    with pytest.raises(ConnectionResetError, match="s1 down"):
        asyncio.run(port_ex.predict(SeldonMessage.from_array(np.ones((1, 2)))))
    bug = {"s1": _Failing(GraphSpecError("a bug")), "s2": _Failing(OSError("down"))}
    port_ex = _port_executor(both_down, comps, bug)
    with pytest.raises(GraphSpecError, match="a bug"):
        asyncio.run(port_ex.predict(SeldonMessage.from_array(np.ones((1, 2)))))


def test_fallback_serves_the_declared_branch_as_the_reference():
    """A ROUTER whose routed branch fails serves its declared fallback: the
    routing names the fallback, the tags name it and the reason, as the
    JAX executor records them."""
    g = {"name": "r", "implementation": "SIMPLE_ROUTER", "type": "ROUTER", "fallback": 1,
         "children": [{"name": "remote", "type": "MODEL"}, {"name": "local", "type": "MODEL"}]}
    comps = [{"name": "remote", "runtime": "rest", "host": "127.0.0.1", "port": 9},
             _scale("local", 3.0)]
    exc = ConnectionRefusedError("refused")
    jax_ex, port_ex = _executors(g, comps, extra=({"remote": _JaxFailing(exc)},
                                                  {"remote": _Failing(exc)}))
    x = _ints(7, (3, 2))
    jresp, presp = _run_both(jax_ex, port_ex, x)
    _same(jresp, presp)
    assert presp.meta.routing == {"r": 1}
    assert presp.meta.tags["seldon.fallback.r"] == 1
    assert "ConnectionRefusedError" in presp.meta.tags["seldon.fallback.r.reason"]
    np.testing.assert_array_equal(presp.array(), x * 3.0)
    # a fallback that fails too fails the request
    bad = {"remote": _Failing(exc), "local": _Failing(ConnectionResetError("also down"))}
    port_ex = _port_executor(g, comps, bad)
    with pytest.raises(ConnectionResetError, match="also down"):
        asyncio.run(port_ex.predict(SeldonMessage.from_array(x)))


def test_an_expired_deadline_stops_before_the_next_hop():
    """The request's budget is checked at every node: an expired one raises
    DeadlineExceededError (504) on both sides, no unit run."""
    jax_ex, port_ex = _executors(COMB, [_scale("s1", 2.0), _scale("s2", 4.0)])

    async def jax_call():
        with jax_deadline_scope(-1.0):
            return await jax_ex.predict(JaxMessage.from_array(np.ones((1, 2))))

    async def port_call():
        with deadline_scope(-1.0):
            return await port_ex.predict(SeldonMessage.from_array(np.ones((1, 2))))

    with pytest.raises(JaxDeadlineExceeded, match="before node 'comb'"):
        asyncio.run(jax_call())
    with pytest.raises(DeadlineExceededError, match="before node 'comb'") as e:
        asyncio.run(port_call())
    assert e.value.http_code == 504


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_units_are_fed_rows_narrowed_as_jnp_asarray(dtype):
    """float64 rows reach a unit as float32 and int64 as int32, as
    jnp.asarray narrows them with 64-bit mode off."""
    g = {"name": "d", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}
    comps = [{"name": "d", "runtime": "inprocess", "class_path": "tport.Dtype"},
             _scale("m", 1.0)]
    jax_ex, port_ex = _executors(g, comps)
    jresp, presp = _run_both(jax_ex, port_ex, np.arange(6, dtype=dtype).reshape(2, 3))
    assert presp.meta.tags == {"itemsize": 4, "floating": dtype is np.float64}
    _same(jresp, presp)


def test_states_and_load_states_round_trip():
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter"},
             _scale("s1", 1.0), _scale("s2", -1.0)]
    port_ex = _port_executor(g, comps)
    port_ex.load_states({"r": {"rewards": torch.tensor([0.0, 2.0]),
                               "counts": torch.tensor([0.0, 1.0])}, "s9": None})
    st = port_ex.states()["r"]
    assert isinstance(st["rewards"], torch.Tensor) and st["rewards"].tolist() == [0.0, 2.0]
    resp = asyncio.run(port_ex.predict(SeldonMessage.from_array(np.ones((1, 2)))))
    assert resp.meta.routing == {"r": 1}


# ---------------------------------------------------------------------------
# user objects and the engine's mode
# ---------------------------------------------------------------------------


def _example(path):
    return json.loads((ROOT / path).read_text())


def test_custom_user_object_serves_host_mode_as_the_reference():
    """examples/custom_model/MyModel.py, a plain object, bound in-process:
    the engine serves it in host mode through the adapter, with the JAX
    engine's answer, names and a feedback ack."""
    doc = _doc({"name": "my", "type": "MODEL"}, [
        {"name": "my", "runtime": "inprocess",
         "class_path": "examples.custom_model.MyModel:MyModel",
         "parameters": [{"name": "scale", "value": "2.0", "type": "FLOAT"}]}])
    jax_engine = JaxEngine(JaxSpec.from_json_dict(json.loads(json.dumps(doc))))
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    body = json.dumps({"data": {"ndarray": _ints(8, (3, 4)).tolist()}, "meta": {"puid": "u"}})
    try:
        (text, status), (jtext, jstatus) = (asyncio.run(engine.predict_json(body)),
                                            asyncio.run(jax_engine.predict_json(body)))
        fb = Feedback(request=SeldonMessage.from_json(body), response=SeldonMessage.from_json(text),
                      reward=1.0)
        ack = asyncio.run(engine.send_feedback(fb))
    finally:
        engine.close()
    assert engine.mode == jax_engine.mode == "host"
    assert status == jstatus == 200
    assert json.loads(text)["data"] == json.loads(jtext)["data"]
    assert json.loads(text)["data"]["names"] == ["proba"]
    assert ack.status.status == "SUCCESS" and ack.meta.puid == "u"


def test_torch_mnist_user_object_answers_as_its_own_predict():
    """examples/torch_model/torch_mnist_deployment.json (a plain torch
    object) serves in host mode: the answer is the same object's predict
    on the same rows, bit for bit, and the JAX engine's."""
    doc = _example("examples/torch_model/torch_mnist_deployment.json")
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_example(
        "examples/torch_model/torch_mnist_deployment.json")))
    x = np.random.default_rng(9).random((3, 784))
    body = json.dumps({"data": {"ndarray": x.tolist()}})
    user = engine.executor.runtimes["tm"].unit.user
    try:
        # twice: the object's first CPU matmul in a process may round apart
        # from its later ones (torch's CPU kernels warming, not the engine)
        first, _ = asyncio.run(engine.predict_json(body))
        text, status = asyncio.run(engine.predict_json(body))
        jtext, _ = asyncio.run(jax_engine.predict_json(body))
        want = user.predict(x.astype(np.float32))
    finally:
        engine.close()
    assert engine.mode == "host" and status == 200
    np.testing.assert_allclose(np.asarray(json.loads(first)["data"]["ndarray"]), want,
                               rtol=0, atol=1e-6)
    got = np.asarray(json.loads(text)["data"]["ndarray"])
    np.testing.assert_array_equal(got, want)
    # the JAX engine's object is another instance, with a first call of its own
    np.testing.assert_allclose(got, np.asarray(json.loads(jtext)["data"]["ndarray"]),
                               rtol=0, atol=1e-6)
    assert json.loads(text)["data"]["names"] == [f"class:{i}" for i in range(10)]


CHAIN2 = {"name": "t", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}
CHAIN2_COMPS = [{"name": "t", "runtime": "inprocess", "class_path": "test.AddTag"},
                _scale("m", 2.0)]
MODES = {
    "single": ({"name": "m", "type": "MODEL"}, [_scale("m", 2.0)], {}, "0"),
    "chain": (CHAIN2, CHAIN2_COMPS, {}, "1"),
    "chain-kill-switch": (CHAIN2, CHAIN2_COMPS, {}, "0"),
    "chain-annotation": (CHAIN2, CHAIN2_COMPS, {"seldon.io/graph-fuse": "false"}, "1"),
    "quorum": (dict(COMB, quorum=1), [_scale("s1", 2.0), _scale("s2", 4.0)], {}, "1"),
    "rest-leaf": (COMB, [_scale("s1", 2.0), {"name": "s2", "runtime": "rest",
                                            "host": "127.0.0.1", "port": 9}], {}, "1"),
    "rest-leaf-kill-switch": (COMB, [_scale("s1", 2.0), {"name": "s2", "runtime": "rest",
                                                        "host": "127.0.0.1", "port": 9}],
                              {}, "0"),
    "user-object": ({"name": "my", "type": "MODEL"}, [
        {"name": "my", "runtime": "inprocess",
         "class_path": "examples.custom_model.MyModel:MyModel"}], {}, "1"),
}


@pytest.mark.parametrize("case", sorted(MODES))
def test_the_engine_picks_the_mode_the_jax_engine_picks(case, monkeypatch):
    """fused, compiled or host for the same spec and env as the JAX engine,
    the same fusion plan in /stats, and host mode's executor fuses only
    when the pass is on."""
    graph, comps, annotations, fuse = MODES[case]
    monkeypatch.setenv("SELDON_TPU_GRAPH_FUSE", fuse)
    doc = _doc(graph, comps, annotations)
    jax_engine = JaxEngine(JaxSpec.from_json_dict(json.loads(json.dumps(doc))))
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    engine.close()
    assert engine.mode == jax_engine.mode
    assert engine.stats()["engine"]["graph_fuse"] == jax_engine.stats()["engine"]["graph_fuse"]
    assert engine.open_breakers() == jax_engine.open_breakers() == []
    if engine.mode == "host":
        assert set(engine.breakers) == set(jax_engine.breakers)
    assert {"single": "compiled", "chain": "fused", "chain-kill-switch": "compiled",
            "chain-annotation": "compiled", "quorum": "compiled", "rest-leaf": "host",
            "rest-leaf-kill-switch": "host", "user-object": "host"}[case] == engine.mode
