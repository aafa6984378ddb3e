"""Routers, the feedback pass and the newly served examples on the CPU:
the port's CompiledGraph routing and feedback against the JAX package's
(the reference's random draws injected into the port's routers), the
batcher's per-row tags, the engine's send_feedback, the REST lane's
feedback and events routes, and the iris, mean_transformer, gbm,
outlier_pipeline and epsilon_greedy examples served over REST against the
JAX engine with its state carried across."""

import asyncio
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import units as jax_units
from seldon_core_tpu.graph.compiled import CompiledGraph as JaxCompiledGraph
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.messages import Feedback as JaxFeedback
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph.compiled import NOT_ROUTED, CompiledGraph
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import Feedback, Meta, SeldonMessage, Status
from seldon_core_tpu_torch.runtime.batching import MicroBatcher
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.rest import serve_fast
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

ROOT = Path(__file__).resolve().parents[1]
# bf16 MNIST weights: the reference's tolerance (tests/test_ops_pallas.py:56)
BF16_ATOL = 2e-2
# f32 units: the same f32 arithmetic in other summation orders
RTOL, ATOL = 1e-5, 1e-6
# outlierScore: eigh and solve of two LAPACK builds
SCORE_RTOL = 1e-3


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_eg_draws(key, n, count):
    """The reference EpsilonGreedyRouter's draws for ``count`` routes from
    ``key``: (explore uniform, index among the other branches)."""
    draws = []
    for _ in range(count):
        key, k_explore, k_choice = jax.random.split(key, 3)
        draws.append((float(jax.random.uniform(k_explore)),
                      int(jax.random.randint(k_choice, (), 0, max(n - 1, 1), jnp.int32))))
    return draws


def _inject_eg(unit, draws):
    it = iter(draws)

    def fake(key):
        u, other = next(it)
        return key, torch.tensor(u, dtype=torch.float32), torch.tensor(other)

    unit._draws = fake


def _jax_ab_draws(key, count):
    us = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        us.append(float(jax.random.uniform(sub)))
    return us


def _inject_ab(unit, us):
    it = iter(us)
    unit._draw = lambda key: (key, torch.tensor(next(it), dtype=torch.float32))


def _carry_router(port_state, jax_state):
    """A router's success / tries carried across; its key stays the port's."""
    return {**port_state, **params_from_jax(
        {k: np.asarray(v) for k, v in jax_state.items() if k != "key"}, device="cpu")}


def _eg_doc(n=2, epsilon=0.3):
    children = [{"name": f"m{i}", "type": "MODEL"} for i in range(n)]
    comps = [{"name": "eg", "runtime": "inprocess", "class_path": "EpsilonGreedyRouter",
              "parameters": [{"name": "n_branches", "value": str(n), "type": "INT"},
                             {"name": "epsilon", "value": str(epsilon), "type": "FLOAT"}]}]
    comps += [{"name": f"m{i}", "runtime": "inprocess", "class_path": "MnistClassifier",
               "parameters": [{"name": "hidden", "value": "32", "type": "INT"},
                              {"name": "seed", "value": str(i), "type": "INT"}]}
              for i in range(n)]
    return {"spec": {"name": "eg", "predictors": [{
        "name": "main", "components": comps,
        "graph": {"name": "eg", "type": "ROUTER", "children": children}}]}}


def _port_graph(doc):
    return CompiledGraph(SeldonDeploymentSpec.from_json_dict(doc).predictor(), device="cpu")


def test_epsilon_greedy_graph_routes_and_learns_as_the_reference():
    """Requests then feedback, several rounds: the same branches, outputs
    within the bf16 bar, the same success / tries, routing by name."""
    doc = _eg_doc(n=3, epsilon=0.4)
    ref = JaxCompiledGraph(JaxSpec.from_json_dict(doc).predictor())
    port = _port_graph(doc)
    for name, st in ref.states.items():
        port.states[name] = (_carry_router(port.states[name], st) if name == "eg"
                             else params_from_jax(_np(st), device="cpu"))
    _inject_eg(port.units["eg"], _jax_eg_draws(ref.states["eg"]["key"], 3, 10))
    rng = np.random.default_rng(0)
    seen = set()
    for i in range(10):
        x = rng.random((1 + i % 3, 784)).astype(np.float32)
        want, jrouting, _ = ref.predict_arrays(x)
        got, routing, tags = port.predict_arrays(x)
        assert routing == jrouting and tags == {}
        seen.add(routing["eg"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_ATOL)
        reward = float(rng.random())
        ref.feedback_arrays(x, jrouting, reward)
        port.feedback_arrays(x, routing, reward)
        for k in ("success", "tries"):
            np.testing.assert_array_equal(port.states["eg"][k].numpy(),
                                          np.asarray(ref.states["eg"][k]))
    assert len(seen) >= 2  # both exploit and explore happened
    # a feedback without routing reaches the router as branch -1: a no-op
    before = {k: v.clone() for k, v in port.states["eg"].items()}
    port.feedback_arrays(None, {}, 1.0)
    assert all(torch.equal(before[k], port.states["eg"][k]) for k in before)


def _nested_doc():
    """r1 (RANDOM_ABTEST) -> [r2 (SIMPLE_ROUTER) -> [a, b], c]."""
    return {"spec": {"name": "n", "predictors": [{"name": "p", "graph": {
        "name": "r1", "implementation": "RANDOM_ABTEST",
        "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
        "children": [
            {"name": "r2", "implementation": "SIMPLE_ROUTER", "children": [
                {"name": "a", "implementation": "SIMPLE_MODEL"},
                {"name": "b", "implementation": "SIMPLE_MODEL"}]},
            {"name": "c", "implementation": "SIMPLE_MODEL"}]}}]}}


def test_nested_routers_report_only_the_executed_path():
    """A router off the executed path is NOT_ROUTED and left out of
    routing, as in the reference; the output names follow the routing."""
    doc = _nested_doc()
    ref = JaxCompiledGraph(JaxSpec.from_json_dict(doc).predictor())
    port = _port_graph(doc)
    _inject_ab(port.units["r1"], _jax_ab_draws(ref.states["r1"], 12))
    x = np.ones((2, 3), np.float32)
    both = set()
    for _ in range(12):
        want, jrouting, _ = ref.predict_arrays(x)
        got, routing, _ = port.predict_arrays(x)
        assert routing == jrouting and NOT_ROUTED not in routing.values()
        both.add(tuple(sorted(routing)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert port._output_names(port.predictor.graph, routing) == ["class0", "class1",
                                                                     "class2"]
    assert both == {("r1", "r2"), ("r1",)}


@jax_units.register_unit("TEST_FEEDBACK_COUNTER")
class _JaxCounter(jax_units.Unit):
    """A MODEL that passes X through and adds each reward it is sent."""

    def init_state(self, rng):
        return {"n": jnp.float32(0.0)}

    def predict(self, state, X):
        return X

    def send_feedback(self, state, X, branch, reward, truth):
        return {"n": state["n"] + reward}


@tunits.register_unit("TEST_FEEDBACK_COUNTER")
class _PortCounter(tunits.Unit):
    def init_state(self, rng):
        return {"n": torch.tensor(0.0)}

    def predict(self, state, X):
        return X

    def send_feedback(self, state, X, branch, reward, truth):
        return {"n": state["n"] + reward}


def test_feedback_reaches_only_the_routed_subtree():
    """An A/B router over two units that count the rewards they are sent:
    a feedback reaches the child the router took, as the reference's
    replay does, and every child when the routing names no branch."""
    comps = [{"name": f"c{i}", "runtime": "inprocess", "class_path": "TEST_FEEDBACK_COUNTER"}
             for i in range(2)]
    doc = {"spec": {"name": "n", "predictors": [{"name": "p", "components": comps, "graph": {
        "name": "ab", "implementation": "RANDOM_ABTEST", "children": [
            {"name": f"c{i}", "type": "MODEL", "methods": ["TRANSFORM_INPUT", "SEND_FEEDBACK"]}
            for i in range(2)]}}]}}
    ref = JaxCompiledGraph(JaxSpec.from_json_dict(doc).predictor())
    port = _port_graph(doc)
    _inject_ab(port.units["ab"], _jax_ab_draws(ref.states["ab"], 8))
    x = np.ones((3, 2), np.float32)
    taken = set()
    for i in range(8):
        _, jrouting, _ = ref.predict_arrays(x)
        _, routing, _ = port.predict_arrays(x)
        assert routing == jrouting
        taken.add(routing["ab"])
        ref.feedback_arrays(x, jrouting, 2.0 ** i)
        port.feedback_arrays(x, routing, 2.0 ** i)
    ref.feedback_arrays(None, {}, 1000.0)
    port.feedback_arrays(None, {}, 1000.0)
    assert taken == {0, 1}
    for name in ("c0", "c1"):
        assert float(port.states[name]["n"]) == float(ref.states[name]["n"])


def test_out_of_range_branch_raises_and_leaves_the_state():
    port = _port_graph(_eg_doc(n=2))
    before = {k: v.clone() for k, v in port.states["eg"].items()}
    port.units["eg"].route = lambda state, X: torch.tensor(5)
    with pytest.raises(GraphSpecError, match="chose branch 5 but has 2 children"):
        port.predict_arrays(np.zeros((1, 784), np.float32))
    assert all(torch.equal(before[k], port.states["eg"][k]) for k in before)
    port.units["eg"].route = lambda state, X: -1
    with pytest.raises(GraphSpecError, match="broadcast routing is host-mode only"):
        port.predict_arrays(np.zeros((1, 784), np.float32))


def test_output_names_follow_the_routing():
    doc = {"spec": {"name": "n", "predictors": [{"name": "p", "components": [
        {"name": "m", "runtime": "inprocess", "class_path": "MeanClassifier"}],
        "graph": {"name": "r", "implementation": "RANDOM_ABTEST", "children": [
            {"name": "s", "implementation": "SIMPLE_MODEL"},
            {"name": "m", "type": "MODEL"}]}}]}}
    port = _port_graph(doc)
    ref = JaxCompiledGraph(JaxSpec.from_json_dict(doc).predictor())
    for routing in ({"r": 0}, {"r": 1}):
        assert (port._output_names(port.predictor.graph, routing)
                == ref._output_names(ref.predictor.graph, routing))
    assert port._output_names(port.predictor.graph, {"r": 1}) == ["proba"]


def test_feedback_routing_must_be_branch_indices():
    port = _port_graph(_eg_doc())
    with pytest.raises(GraphSpecError, match="not a branch index"):
        port.feedback_arrays(None, {"eg": "left"}, 1.0)


# -- the batcher's per-row tags ------------------------------------------------


@pytest.mark.parametrize("max_batch", [64, 4], ids=["one-dispatch", "chunked"])
def test_batcher_slices_per_row_tags_per_caller(max_batch):
    """Each caller gets its own rows of a per-row tag, whether the stack
    went out in one padded dispatch or in chunks (the 6-row request rides
    alone at max_batch 4, as chunks of 4 and 2 whose per-row tags are
    concatenated); shared tags and routing reach every caller whole."""
    calls = []

    async def batch_fn(x):
        calls.append(len(x))
        return x * 2.0, ({"r": 0}, {"score": x[:, 0].copy(), "shared": np.float32(7.0)})

    async def run():
        b = MicroBatcher(batch_fn, max_batch=max_batch, max_wait_ms=50.0, coalesce_ms=20.0)
        xs = [np.full((n, 2), float(i), np.float32) + np.arange(n)[:, None] / 10
              for i, n in enumerate((3, 2, 6))]
        return xs, await asyncio.gather(*(b.submit(x) for x in xs))

    xs, outs = asyncio.run(run())
    for x, (y, (routing, tags)) in zip(xs, outs):
        np.testing.assert_array_equal(y, x * 2.0)
        np.testing.assert_array_equal(tags["score"], x[:, 0])
        assert routing == {"r": 0} and float(tags["shared"]) == 7.0
    assert calls == ([16] if max_batch == 64 else [4, 2, 4, 2])


# -- the engine and the REST lane -----------------------------------------------


def _http(method, url, body=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _example(name):
    return json.loads((ROOT / "examples" / f"{name}_deployment.json").read_text())


def _engines(name, monkeypatch, fuse="0"):
    """The port's engine on the CPU and the JAX engine of one example, both
    compiled (``fuse`` "0") or both in their default mode ("1": fused for a
    multi-node graph), the JAX engine's state carried across (a router keeps
    its own key, with the reference's draws injected)."""
    monkeypatch.setenv("SELDON_TPU_GRAPH_FUSE", fuse)
    doc = _example(name)
    jax_engine = JaxEngine(JaxSpec.from_json_dict(doc))
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    assert engine.mode == jax_engine.mode
    states = {}
    for unit_name, st in jax_engine.states().items():
        if isinstance(st, dict) and "key" in st:
            states[unit_name] = _carry_router(engine.states()[unit_name], st)
            _inject_eg(engine.compiled.units[unit_name],
                       _jax_eg_draws(st["key"], len(st["success"]), 64))
        else:
            states[unit_name] = params_from_jax(_np(st), device="cpu")
    engine.load_states(states)
    return engine, jax_engine


def _inputs(name, rng):
    if name == "iris":
        return [rng.normal(size=(n, 4)) * 2 + 4 for n in (1, 3, 5)]
    if name == "gbm":
        return [rng.normal(size=(n, 8)) for n in (1, 4, 7)]
    if name == "mean_transformer":
        return [rng.random((n, 6)) * 10 for n in (1, 3, 4)]
    return [rng.random((n, 784)) for n in (1, 5, 6, 8)]  # outlier_pipeline, epsilon_greedy


@pytest.mark.parametrize("fuse", ["0", "1"], ids=["compiled", "default"])
@pytest.mark.parametrize("name", ["iris", "mean_transformer", "gbm", "outlier_pipeline",
                                  "epsilon_greedy"])
def test_new_example_served_over_rest_matches_the_jax_engine(name, fuse, monkeypatch):
    """Each newly served example over the port's REST lane against the JAX
    engine in process, both compiled or both in their default mode (the
    multi-node examples fused): the same mode, status, names, routing and
    tags, values within the units' tolerance; epsilon_greedy also takes a
    feedback a response and its router's counts move as the reference's."""
    engine, jax_engine = _engines(name, monkeypatch, fuse)
    xs = _inputs(name, np.random.default_rng(len(name)))
    bf16 = name in ("outlier_pipeline", "epsilon_greedy")

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        out = []
        try:
            for i, x in enumerate(xs):
                body = json.dumps({"data": {"ndarray": x.tolist()}})
                got = await loop.run_in_executor(
                    None, _http, "POST", f"{url}/api/v0.1/predictions", body.encode())
                want = await jax_engine.predict_json(body)
                fb = None
                if name == "epsilon_greedy":
                    fbody = json.dumps({"request": json.loads(body), "response": json.loads(
                        got[1]), "reward": 0.25 * (i % 4)})
                    fb = await loop.run_in_executor(
                        None, _http, "POST", f"{url}/api/v0.1/feedback", fbody.encode())
                    await jax_engine.send_feedback(JaxFeedback.from_json(fbody))
                out.append((got, want, fb))
        finally:
            await server.stop()
        return out

    try:
        results = asyncio.run(run())
        for (status, raw), (want_text, want_status), fb in results:
            doc, ref = json.loads(raw), json.loads(want_text)
            assert status == want_status == 200, raw
            assert doc["data"].get("names") == ref["data"].get("names")
            assert doc["meta"].get("routing", {}) == ref["meta"].get("routing", {})
            got, want = np.asarray(doc["data"]["ndarray"]), np.asarray(ref["data"]["ndarray"])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **({"atol": BF16_ATOL} if bf16 else
                                                     {"rtol": RTOL, "atol": ATOL}))
            tags, ref_tags = doc["meta"].get("tags", {}), ref["meta"].get("tags", {})
            assert set(tags) == set(ref_tags)
            if "outlierScore" in ref_tags:
                assert len(tags["outlierScore"]) == len(got)  # the caller's own rows
                np.testing.assert_allclose(tags["outlierScore"], ref_tags["outlierScore"],
                                           rtol=SCORE_RTOL, atol=1e-4)
            if fb is not None:
                assert fb[0] == 200 and json.loads(fb[1])["meta"]["puid"] == doc["meta"]["puid"]
        if name == "epsilon_greedy":
            jstate = jax_engine.states()["eg-router"]
            for k in ("success", "tries"):
                np.testing.assert_array_equal(engine.states()["eg-router"][k].numpy(),
                                              np.asarray(jstate[k]))
            assert float(engine.states()["eg-router"]["tries"].sum()) == sum(len(x) for x in xs)
    finally:
        engine.close()


def test_feedback_moves_the_routed_branch_and_bad_feedback_is_a_400():
    """The feedback pass on the fused engine, and on a host-mode engine
    (``force_host``: the GraphExecutor's routed replay) the same moves.
    Each mode acks as the JAX engine's does: the fused and compiled modes
    with no status, host mode with a SUCCESS status."""
    spec = SeldonDeploymentSpec.from_json_dict(_eg_doc(n=2, epsilon=0.0))
    engine = EngineService(spec, device="cpu")
    host_engine = EngineService(SeldonDeploymentSpec.from_json_dict(_eg_doc(n=2, epsilon=0.0)),
                                device="cpu", force_host=True)
    host_engine.load_states(engine.states())
    x = np.random.default_rng(1).random((3, 784))

    async def run(e):
        text, status = await e.predict_json(json.dumps({"data": {"ndarray": x.tolist()}}))
        resp = json.loads(text)
        fb = Feedback(request=SeldonMessage.from_json(json.dumps(
            {"data": {"ndarray": x.tolist()}})), response=SeldonMessage.from_json(text),
            reward=1.0)
        ack = await e.send_feedback(fb)
        bad = await e.send_feedback(Feedback(
            response=SeldonMessage(meta=Meta(routing={"eg": "left"})), reward=1.0))
        return status, resp, ack, bad

    try:
        runs = [asyncio.run(run(e)) for e in (engine, host_engine)]
    finally:
        engine.close()
        host_engine.close()
    assert (engine.mode, host_engine.mode) == ("fused", "host")
    for e, (status, resp, ack, bad) in zip((engine, host_engine), runs):
        branch = resp["meta"]["routing"]["eg"]
        assert status == 200 and branch == 0  # epsilon 0, no tries yet: branch 0 is best
        assert ack.meta.puid == resp["meta"]["puid"]
        state = e.states()["eg"]
        assert state["success"].tolist() == [3.0, 0.0] and state["tries"].tolist() == [3.0, 0.0]
        assert bad.status.code == 400 and "not a branch index" in bad.status.info
    assert runs[0][2].status is None and runs[1][2].status == Status()
    np.testing.assert_array_equal(np.asarray(runs[0][1]["data"]["ndarray"]),
                                  np.asarray(runs[1][1]["data"]["ndarray"]))


def test_rest_feedback_and_events_routes():
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_eg_doc(n=2, epsilon=0.0)),
                           device="cpu")
    x = np.random.default_rng(2).random((2, 784))

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()

        def client():
            pred = _http("POST", f"{url}/api/v0.1/predictions",
                         json.dumps({"data": {"ndarray": x.tolist()}}).encode())
            body = {"request": {"data": {"ndarray": x.tolist()}},
                    "response": json.loads(pred[1]), "reward": 0.5}
            return {
                "pred": pred,
                "fb": _http("POST", f"{url}/api/v0.1/feedback", json.dumps(body).encode()),
                "fb_bad_json": _http("POST", f"{url}/api/v0.1/feedback", b"{oops"),
                "fb_bad_reward": _http("POST", f"{url}/api/v0.1/feedback",
                                       b'{"reward": "lots"}'),
                "fb_bad_routing": _http("POST", f"{url}/api/v0.1/feedback", json.dumps(
                    {"response": {"meta": {"routing": {"eg": "x"}}}}).encode()),
                "fb_get": _http("GET", f"{url}/api/v0.1/feedback"),
                **{f"events_{m}": _http(m, f"{url}/api/v0.1/events",
                                        b"{}" if m in ("POST", "PUT") else None)
                   for m in ("GET", "POST", "PUT", "DELETE")},
            }

        try:
            return await loop.run_in_executor(None, client)
        finally:
            await server.stop()

    try:
        out = asyncio.run(run())
    finally:
        engine.close()
    assert out["pred"][0] == 200 and out["fb"][0] == 200
    assert json.loads(out["fb"][1])["meta"]["puid"] == json.loads(out["pred"][1])["meta"]["puid"]
    assert engine.states()["eg"]["tries"].tolist() == [2.0, 0.0]
    assert engine.states()["eg"]["success"].tolist() == [1.0, 0.0]
    for key in ("fb_bad_json", "fb_bad_reward", "fb_bad_routing"):
        status, raw = out[key]
        assert status == 400 and json.loads(raw)["status"]["status"] == "FAILURE", key
    assert out["fb_get"][0] == 404
    for m in ("GET", "POST", "PUT", "DELETE"):
        assert out[f"events_{m}"] == (200, b"Not Implemented"), m


# -- the examples the port builds --------------------------------------------------

EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*_deployment.json"))
# the two multi-device generators declare mesh_axes over four devices
MESH = {"generator_tp_deployment.json": {"tp": 4},
        "generator_ep_deployment.json": {"ep": 4}}
# the multi-node examples, all in-process and pure, serve fused as the JAX
# engine's do; every other example is a single node, served compiled
FUSED = {"ensemble4_deployment.json", "epsilon_greedy_deployment.json",
         "mean_transformer_deployment.json", "outlier_pipeline_deployment.json"}


@pytest.mark.parametrize("example", EXAMPLES)
def test_the_port_builds_fifteen_of_fifteen_examples(example, monkeypatch):
    """All fifteen examples build an engine on the CPU, in the mode the JAX
    engine picks: generator_int8 among them since [2q] was ported, and
    the two multi-device generators since [6a], on 8 CPU devices (their
    unit holds the mesh its binding declares)."""
    from seldon_core_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "_CPU_DEVICES", 8)
    assert len(EXAMPLES) == 15
    doc = json.loads((ROOT / "examples" / example).read_text())
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(doc))
    engine = EngineService(spec, device="cpu")
    engine.close()
    if example in MESH:
        assert engine.compiled.units["gen"].mesh.shape == MESH[example]
    assert engine.mode == ("fused" if example in FUSED else "compiled")
