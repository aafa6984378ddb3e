"""Whole-graph and partial fusion (graph/fuse.py) against the JAX package's:
the fused-equals-interpreted matrix of tests/test_graph_fusion.py
(:131-419), the plan and its block reasons, the annotation opt-out, the
kill switch, the branch-demotion rule against the JAX ``_jit_fused`` with
explicit cost vectors and budgets, and feedback through fused subtrees.
Inputs are integer-valued (numpy, from a seed), so every comparison is
bit for bit."""

import asyncio
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_graph_fusion  # noqa: F401  (registers the JAX fuse.* units)
import tests.test_torch_graph_exec  # noqa: F401  (registers the port's test.* units)
from seldon_core_tpu.graph.fuse import FusedGraph as JaxFusedGraph
from seldon_core_tpu.graph.fuse import build_partial_fusion as jax_build_partial_fusion
from seldon_core_tpu.graph.fuse import plan_fusion as jax_plan_fusion
from seldon_core_tpu.graph.interpreter import GraphExecutor as JaxExecutor
from seldon_core_tpu.graph.interpreter import InProcessNodeRuntime as JaxInProcess
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.graph.units import UNIT_REGISTRY as JAX_UNITS
from seldon_core_tpu.messages import Feedback as JaxFeedback
from seldon_core_tpu.messages import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph.compiled import CompiledGraph
from seldon_core_tpu_torch.graph.fuse import (
    FUSE_ANNOTATION,
    FusedGraph,
    FusedSubtreeRuntime,
    build_partial_fusion,
    demoted_branch,
    fuse_enabled,
    plan_fusion,
)
from seldon_core_tpu_torch.graph.interpreter import GraphExecutor, InProcessNodeRuntime
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons


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


@tunits.register_unit("fuse.Bias")
class BiasOutput(tunits.Unit):
    """The OUTPUT_TRANSFORMER leg of the chain case."""

    def __init__(self, bias: float = 1.0):
        self.bias = bias

    def transform_output(self, state, Y):
        return Y + self.bias, tunits.UnitAux(tags={"biased": torch.tensor(self.bias,
                                                                           dtype=torch.float32)})


@tunits.register_unit("fuse.Impure")
class ImpureUnit(tunits.Unit):
    pure = False

    def predict(self, state, X):
        return X


@tunits.register_unit("fuse.BoomInit")
class BoomInitUnit(tunits.Unit):
    """Pure at class level, unconstructable: the build-failure double."""

    pure = True

    def __init__(self):
        raise RuntimeError("constructor boom")

    def predict(self, state, X):
        return X


def _doc(graph, components=None, annotations=None):
    return {"spec": {"name": "fuse-t", "predictors": [{
        "name": "p", "graph": graph, "components": components or [],
        "annotations": annotations or {}}]}}


def _preds(graph, components=None, annotations=None):
    doc = _doc(graph, components, annotations)
    return (JaxSpec.from_json_dict(json.loads(json.dumps(doc))).predictor(),
            SeldonDeploymentSpec.from_json_dict(doc).predictor())


def scale(name, factor):
    return {"name": name, "runtime": "inprocess", "class_path": "test.Scale",
            "parameters": [{"name": "factor", "value": str(factor), "type": "FLOAT"}]}


CHAIN = {"name": "t1", "type": "TRANSFORMER", "children": [{
    "name": "t2", "type": "TRANSFORMER", "children": [{
        "name": "m", "type": "MODEL", "children": [{
            "name": "out", "type": "OUTPUT_TRANSFORMER"}]}]}]}
CHAIN_COMPS = [
    {"name": "t1", "runtime": "inprocess", "class_path": "test.AddTag"},
    {"name": "t2", "runtime": "inprocess", "class_path": "test.AddTag"},
    scale("m", 3.0),
    {"name": "out", "runtime": "inprocess", "class_path": "fuse.Bias",
     "parameters": [{"name": "bias", "value": "0.5", "type": "FLOAT"}]},
]
COMBINER = {"name": "comb", "implementation": "AVERAGE_COMBINER", "type": "COMBINER",
            "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"},
                         {"name": "s3", "type": "MODEL"}]}
COMBINER_COMPS = [scale("s1", 2.0), scale("s2", 4.0), scale("s3", -1.0)]
ROUTER = {"name": "ab", "implementation": "RANDOM_ABTEST", "type": "ROUTER",
          "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
          "children": [{"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}
ROUTER_COMPS = [scale("s1", 1.0), scale("s2", -1.0)]
MIXED = {"name": "comb", "implementation": "AVERAGE_COMBINER", "type": "COMBINER",
         "children": [{"name": "chain", "type": "TRANSFORMER",
                       "children": [{"name": "m1", "type": "MODEL"}]},
                      {"name": "rleaf", "type": "MODEL"}]}
MIXED_COMPS = [{"name": "chain", "runtime": "inprocess", "class_path": "test.AddTag"},
               scale("m1", 2.0), {"name": "rleaf", "runtime": "rest",
                                  "host": "127.0.0.1", "port": 9}]


def _ints(seed, shape, lo=-8, hi=8):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.float32)


def _host_predict(pred, x, **kw):
    return asyncio.run(GraphExecutor(pred, device="cpu", **kw).predict(
        SeldonMessage.from_array(x)))


# ---------------------------------------------------------------------------
# the equivalence matrix
# ---------------------------------------------------------------------------


def test_matrix_chain_fused_equals_interpreter_and_jax_bit_for_bit():
    """OUT_TRANSFORMER(MODEL(TRANSFORMER(TRANSFORMER(x)))): the fused walk,
    the port's interpreter and the JAX fused program answer the same bits,
    with the same tags."""
    jpred, pred = _preds(CHAIN, CHAIN_COMPS)
    x = _ints(0, (4, 5))
    fg = FusedGraph(pred, device="cpu")
    y, routing, tags = fg.predict_arrays(x)
    host = _host_predict(pred, x)
    jy, jrouting, jtags = JaxFusedGraph(jpred).predict_arrays(x)
    np.testing.assert_array_equal(y.numpy(), host.array())
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert routing == {} == jrouting
    assert float(tags["batch_mean"]) == host.meta.tags["batch_mean"] == float(jtags["batch_mean"])
    assert float(tags["biased"]) == float(jtags["biased"]) == 0.5


def test_matrix_combiner_fused_equals_interpreter_and_jax_bit_for_bit():
    jpred, pred = _preds(COMBINER, COMBINER_COMPS)
    x = _ints(1, (8, 16))
    y, _, _ = FusedGraph(pred, device="cpu").predict_arrays(x)
    np.testing.assert_array_equal(y.numpy(), _host_predict(pred, x).array())
    np.testing.assert_array_equal(y.numpy(), np.asarray(JaxFusedGraph(jpred).predict_arrays(x)[0]))


def test_matrix_router_routes_as_the_interpreter_and_the_jax_program():
    """A seeded RANDOM_ABTEST routes identically fused, interpreted and in
    the JAX fused program for the same draws (the JAX key's uniforms
    injected into the port's routers)."""
    jpred, pred = _preds(ROUTER, ROUTER_COMPS)
    x = np.ones((1, 2), np.float32)
    jfg = JaxFusedGraph(jpred, rng=jax.random.key(11))
    key, draws = jfg.states["ab"], []
    for _ in range(16):
        key, sub = jax.random.split(key)
        draws.append(float(jax.random.uniform(sub)))
    fg = FusedGraph(pred, rng=11, device="cpu")
    host = GraphExecutor(pred, rng=11, device="cpu")
    for unit in (fg.units["ab"], host.runtimes["ab"].unit):
        it = iter(draws)
        unit._draw = lambda k, it=it: (k, torch.tensor(next(it)))
    seqs = {"fused": [], "host": [], "jax": []}
    for _ in range(16):
        y, routing, _ = fg.predict_arrays(x)
        seqs["fused"].append((routing["ab"], float(y[0, 0])))
        resp = asyncio.run(host.predict(SeldonMessage.from_array(x)))
        seqs["host"].append((resp.meta.routing["ab"], float(resp.array()[0, 0])))
        jy, jrouting, _ = jfg.predict_arrays(x)
        seqs["jax"].append((jrouting["ab"], float(np.asarray(jy)[0, 0])))
    assert seqs["fused"] == seqs["host"] == seqs["jax"]
    assert {b for b, _ in seqs["fused"]} == {0, 1}


# the demotion rule's cases: (router's raw branch, predicted walls, budget)
DEMOTION = {
    "over-budget-moves": (0, [5.0, 0.001, math.nan], 0.5),
    "fits-stays": (0, [0.1, 0.001, 0.002], 0.5),
    "nan-never-triggers": (1, [0.001, math.nan, 0.002], 0.5),
    "nan-never-receives": (0, [5.0, math.nan, math.nan], 0.5),
    "nothing-fits-stays": (2, [6.0, 7.0, 5.0], 0.5),
    "cheapest-that-fits": (0, [5.0, 0.3, 0.2], 0.4),
    "ties-take-the-first": (2, [0.2, 5.0, 9.0], 0.2),
    "equal-to-budget-fits": (1, [0.5, 0.5, 0.1], 0.5),
    "no-budget": (0, [5.0, 0.1, 0.1], math.inf),
}


@pytest.mark.parametrize("case", sorted(DEMOTION))
def test_demotion_rule_matches_the_jax_program(case):
    """The port's branch demotion under explicit per-router cost vectors and
    a budget picks the branch the JAX ``_jit_fused`` picks, and serves its
    output; a demotion is stamped as seldon.autopilot.reroute.<router>."""
    raw, walls, budget = DEMOTION[case]
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": f"s{i}", "type": "MODEL"} for i in range(3)]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter",
              "parameters": [{"name": "n_branches", "value": "3", "type": "INT"}]}]
    comps += [scale(f"s{i}", f) for i, f in enumerate((10.0, -10.0, 3.0))]
    jpred, pred = _preds(g, comps)
    x = _ints(2, (2, 3))
    rewards = np.eye(3, dtype=np.float32)[raw]
    jfg = JaxFusedGraph(jpred)
    jfg.states["r"] = {**jfg.states["r"], "rewards": jnp.asarray(rewards)}
    jy, _, jraw, jeff, _ = jfg._jit_fused(jfg.states, jnp.asarray(x),
                                           {"r": jnp.asarray(walls, jnp.float32)},
                                           jnp.float32(budget))
    fg = FusedGraph(pred, device="cpu")
    fg.states["r"] = {**fg.states["r"], "rewards": torch.from_numpy(rewards)}
    y, routing, tags = fg.predict_arrays(x, costs={"r": walls}, budget=budget)
    assert int(jraw["r"]) == raw
    assert routing == {"r": int(jeff["r"])}
    assert demoted_branch(raw, np.asarray(walls, np.float32), np.float32(budget)) == routing["r"]
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert tags.get("seldon.autopilot.reroute.r") == (None if routing["r"] == raw
                                                      else routing["r"])


def test_default_costs_never_demote():
    """With no learned costs (NaN vectors, +inf budget) the fused walk is
    the compiled one: the router's own branch serves and no tag is added."""
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter"},
             scale("a", 10.0), scale("b", -10.0)]
    _, pred = _preds(g, comps)
    fg = FusedGraph(pred, device="cpu")
    costs, budget = fg._cost_args()
    assert np.isnan(costs["r"]).all() and costs["r"].shape == (2,) and budget == np.inf
    y, routing, tags = fg.predict_arrays(np.ones((1, 2), np.float32))
    assert routing == {"r": 0} and tags == {}
    np.testing.assert_array_equal(y.numpy(), [[10.0, 10.0]])
    cy, crouting, ctags = CompiledGraph(pred, device="cpu").predict_arrays(
        np.ones((1, 2), np.float32))
    assert (crouting, ctags) == (routing, tags)
    np.testing.assert_array_equal(cy.numpy(), y.numpy())


def test_matrix_partial_fusion_with_rest_bound_leaf():
    """A COMBINER over a fusible 2-node chain and a rest-bound leaf: the
    chain becomes one fused dispatch, the leaf stays on the interpreter,
    and the answer is the full interpreter's and the JAX fused executor's
    (the remote stood in for by the same in-process unit)."""
    jpred, pred = _preds(MIXED, MIXED_COMPS)

    def leaf():
        return InProcessNodeRuntime(pred.graph.find("rleaf"), tunits.UNIT_REGISTRY["test.Scale"](
            factor=4.0), device="cpu")

    plain = GraphExecutor(pred, extra_runtimes={"rleaf": leaf()}, device="cpu")
    assert not plain.fused  # a directly built executor is the pure interpreter
    fused_ex = GraphExecutor(pred, extra_runtimes={"rleaf": leaf()}, fuse=True, device="cpu")
    assert list(fused_ex.fused) == ["chain"]
    assert isinstance(fused_ex.fused["chain"], FusedSubtreeRuntime)
    assert fused_ex.fusion_plan.hops_eliminated == 1
    assert "chain" not in fused_ex.runtimes and "m1" not in fused_ex.runtimes
    jax_ex = JaxExecutor(jpred, extra_runtimes={"rleaf": JaxInProcess(
        jpred.graph.find("rleaf"), JAX_UNITS["test.Scale"](factor=4.0))}, fuse=True)
    assert fused_ex.fusion_plan.summary() == jax_ex.fusion_plan.summary()
    x = _ints(2, (3, 4))
    a = asyncio.run(plain.predict(SeldonMessage.from_array(x)))
    b = asyncio.run(fused_ex.predict(SeldonMessage.from_array(x)))
    c = asyncio.run(jax_ex.predict(JaxMessage.from_array(x)))
    np.testing.assert_array_equal(a.array(), b.array())
    np.testing.assert_array_equal(b.array(), np.asarray(c.array()))
    assert a.meta.tags["batch_mean"] == b.meta.tags["batch_mean"] == c.meta.tags["batch_mean"]


def test_fused_subtree_names_itself_when_it_rejects_an_input():
    _, pred = _preds(MIXED, MIXED_COMPS)
    frt = FusedSubtreeRuntime(pred, pred.graph.find("chain"), device="cpu")

    def bad(*a, **k):
        raise ValueError("width 3 is not 4")

    frt.graph.predict_arrays = bad
    with pytest.raises(GraphSpecError, match="fused subtree 'chain' rejected input"):
        asyncio.run(frt.run(SeldonMessage.from_array(np.ones((2, 3)))))


def test_matrix_kill_switch_restores_the_compiled_path_bit_for_bit(monkeypatch):
    """SELDON_TPU_GRAPH_FUSE=0: the engine serves compiled, with the fused
    engine's bits; a mixed graph under the switch runs the pure
    interpreter, as the JAX engine does."""
    monkeypatch.delenv("SELDON_TPU_GRAPH_FUSE", raising=False)
    assert fuse_enabled()
    doc = _doc(COMBINER, COMBINER_COMPS)
    payload = json.dumps({"data": {"ndarray": _ints(3, (3, 2)).tolist()},
                          "meta": {"puid": "pin"}})
    on = EngineService(SeldonDeploymentSpec.from_json_dict(doc), batching=False, device="cpu")
    assert on.mode == "fused" and isinstance(on.compiled, FusedGraph)
    text_on, code_on = asyncio.run(on.predict_json(payload))
    monkeypatch.setenv("SELDON_TPU_GRAPH_FUSE", "0")
    assert not fuse_enabled()
    off = EngineService(SeldonDeploymentSpec.from_json_dict(doc), batching=False, device="cpu")
    assert off.mode == "compiled" and not isinstance(off.compiled, FusedGraph)
    text_off, code_off = asyncio.run(off.predict_json(payload))
    assert (code_on, text_on) == (code_off, text_off)
    mixed = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(MIXED, MIXED_COMPS)),
                          device="cpu")
    jax_mixed = JaxEngine(JaxSpec.from_json_dict(_doc(MIXED, MIXED_COMPS)))
    for e in (on, off, mixed):
        e.close()
    assert mixed.mode == jax_mixed.mode == "host" and mixed.executor.fused == {}
    assert mixed.stats()["engine"]["graph_fuse"] == {"enabled": False, "plan": None}


# ---------------------------------------------------------------------------
# eligibility rules
# ---------------------------------------------------------------------------


def test_quorum_and_fallback_subtrees_never_fuse():
    """A quorum or fallback node blocks its subtree from every fused walk:
    the plan names it, FusedGraph refuses, and the engine serves the pure
    graph compiled (the JAX engine's choice), the plan in /stats."""
    quorum_graph = dict(COMBINER, quorum=2)
    jpred, pred = _preds(quorum_graph, COMBINER_COMPS)
    plan = plan_fusion(pred)
    assert not plan.full and plan.fused_roots == []
    assert "quorum" in plan.reasons["comb"]
    assert plan.summary() == jax_plan_fusion(jpred).summary()
    with pytest.raises(GraphSpecError, match="fuse-eligible"):
        FusedGraph(pred, device="cpu")
    fallback_graph = dict(ROUTER, fallback=1)
    jpred_fb, pred_fb = _preds(fallback_graph, ROUTER_COMPS)
    plan_fb = plan_fusion(pred_fb)
    assert not plan_fb.full and plan_fb.fused_roots == []
    assert "fallback" in plan_fb.reasons["ab"]
    assert plan_fb.summary() == jax_plan_fusion(jpred_fb).summary()
    e = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(quorum_graph, COMBINER_COMPS)),
                      device="cpu")
    e.close()
    assert e.mode == "compiled" and not isinstance(e.compiled, FusedGraph)
    assert "comb" in e.stats()["engine"]["graph_fuse"]["plan"]["blocked"]


def test_fuse_annotation_opts_a_predictor_out():
    jpred, pred = _preds(COMBINER, COMBINER_COMPS, {FUSE_ANNOTATION: "false"})
    plan = plan_fusion(pred)
    assert not plan.full and plan.fused_roots == []
    assert plan.summary() == jax_plan_fusion(jpred).summary()
    assert build_partial_fusion(pred, device="cpu")[0] == {}
    e = EngineService(SeldonDeploymentSpec.from_json_dict(
        _doc(COMBINER, COMBINER_COMPS, {FUSE_ANNOTATION: "false"})), batching=False,
        device="cpu")
    e.close()
    assert e.mode == "compiled"


def test_failed_subtree_build_falls_back_and_unwinds_the_plan():
    """A subtree that plans as fusible but fails to build stays on the
    interpreter, and the plan's counts carry no phantom saving."""
    g = {"name": "chain", "type": "TRANSFORMER", "children": [{"name": "boom", "type": "MODEL"}]}
    comps = [{"name": "chain", "runtime": "inprocess", "class_path": "test.AddTag"},
             {"name": "boom", "runtime": "inprocess", "class_path": "fuse.BoomInit"}]
    jpred, pred = _preds(g, comps)
    assert plan_fusion(pred).full  # eligibility is class-level only
    fused, plan = build_partial_fusion(pred, device="cpu")
    jfused, jplan = jax_build_partial_fusion(jpred)
    assert fused == {} == jfused
    assert (plan.fused_roots, plan.fused_nodes, plan.fused_dispatches,
            plan.hops_eliminated) == ([], 0, 0, 0)
    assert "build failed" in plan.reasons["chain"]
    assert plan.summary() == jplan.summary()


def test_impure_unit_blocks_its_subtree_only():
    g = {"name": "comb", "implementation": "AVERAGE_COMBINER", "type": "COMBINER",
         "children": [{"name": "chain", "type": "TRANSFORMER",
                       "children": [{"name": "m1", "type": "MODEL"}]},
                      {"name": "imp", "type": "MODEL"}]}
    comps = [{"name": "chain", "runtime": "inprocess", "class_path": "test.AddTag"},
             scale("m1", 2.0), {"name": "imp", "runtime": "inprocess",
                                "class_path": "fuse.Impure"}]
    jpred, pred = _preds(g, comps)
    plan = plan_fusion(pred)
    assert not plan.full and plan.fused_roots == ["chain"]
    assert "impure" in plan.reasons["imp"]
    assert plan.summary() == jax_plan_fusion(jpred).summary()


PLANS = {
    "chain": (CHAIN, CHAIN_COMPS),
    "combiner": (COMBINER, COMBINER_COMPS),
    "router": (ROUTER, ROUTER_COMPS),
    "mixed": (MIXED, MIXED_COMPS),
    "nested": ({"name": "top", "implementation": "AVERAGE_COMBINER", "type": "COMBINER",
                "children": [{"name": "r", "implementation": "SIMPLE_ROUTER", "type": "ROUTER",
                              "children": [{"name": "a", "type": "MODEL"},
                                           {"name": "b", "type": "TRANSFORMER", "children": [
                                               {"name": "c", "type": "MODEL"}]}]},
                             {"name": "rleaf", "type": "MODEL"}]},
               [scale("a", 1.0), scale("b", 2.0), scale("c", 3.0),
                {"name": "rleaf", "runtime": "rest", "host": "127.0.0.1", "port": 9}]),
    "user-object": ({"name": "t", "type": "TRANSFORMER", "children": [
        {"name": "my", "type": "MODEL"}]},
        [{"name": "t", "runtime": "inprocess", "class_path": "test.AddTag"},
         {"name": "my", "runtime": "inprocess",
          "class_path": "examples.custom_model.MyModel:MyModel"}]),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_the_plan_is_the_jax_plan(case):
    """Every count, root and block reason of the plan equals the JAX
    package's for the same graph."""
    jpred, pred = _preds(*PLANS[case])
    assert plan_fusion(pred).summary() == jax_plan_fusion(jpred).summary()
    skip = {"rleaf"} if case in ("mixed", "nested") else set()
    assert (plan_fusion(pred, skip=skip).summary()
            == jax_plan_fusion(jpred, skip=skip).summary())


# ---------------------------------------------------------------------------
# state and feedback through the fused paths
# ---------------------------------------------------------------------------


def test_fused_subtree_feedback_trains_as_the_interpreter_and_jax():
    """Feedback through a fused subtree replays meta.routing on the device
    and leaves the interpreter's state, and the JAX fused executor's."""
    g = {"name": "chain", "type": "TRANSFORMER", "children": [{
        "name": "r", "type": "ROUTER",
        "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}]}
    comps = [{"name": "chain", "runtime": "inprocess", "class_path": "test.AddTag"},
             {"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter"},
             scale("a", 1.0), scale("b", -1.0)]
    jpred, pred = _preds(g, comps)
    x = np.ones((1, 2), np.float32)
    host = GraphExecutor(pred, device="cpu")
    fused_ex = GraphExecutor(pred, fuse=True, device="cpu")
    assert list(fused_ex.fused) == ["chain"]
    for ex in (host, fused_ex):
        for reward in (7.0, 2.0):
            req = SeldonMessage.from_array(x)
            resp = asyncio.run(ex.predict(req))
            asyncio.run(ex.send_feedback(Feedback(request=req, response=resp, reward=reward)))
    jax_ex = JaxExecutor(jpred, fuse=True)
    for reward in (7.0, 2.0):
        req = JaxMessage.from_array(x)
        resp = asyncio.run(jax_ex.predict(req))
        asyncio.run(jax_ex.send_feedback(JaxFeedback(request=req, response=resp, reward=reward)))
    for k in ("rewards", "counts"):
        np.testing.assert_array_equal(host.states()["r"][k].numpy(),
                                      fused_ex.states()["r"][k].numpy())
        np.testing.assert_array_equal(fused_ex.states()["r"][k].numpy(),
                                      np.asarray(jax_ex.states()["r"][k]))
    np.testing.assert_array_equal(fused_ex.states()["r"]["rewards"].numpy(), [9.0, 0.0])


def test_fused_engine_states_round_trip_and_feedback():
    """A fused engine's states load back, and its feedback pass (the
    compiled one, inherited) moves a router as the compiled engine's."""
    e = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(COMBINER, COMBINER_COMPS)),
                      device="cpu")
    e.load_states(e.states())  # the persistence handoff stays symmetric
    e.close()
    assert e.mode == "fused"
    g = {"name": "r", "type": "ROUTER",
         "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    comps = [{"name": "r", "runtime": "inprocess", "class_path": "test.CountingRouter"},
             scale("a", 10.0), scale("b", -10.0)]
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(g, comps)), device="cpu")
    body = json.dumps({"data": {"ndarray": [[1.0, 1.0]]}})
    try:
        text, _ = asyncio.run(engine.predict_json(body))
        resp = SeldonMessage.from_json(text)
        resp.meta.routing["r"] = 1
        asyncio.run(engine.send_feedback(Feedback(request=SeldonMessage.from_json(body),
                                                  response=resp, reward=3.0)))
        text2, _ = asyncio.run(engine.predict_json(body))
    finally:
        engine.close()
    assert engine.mode == "fused"
    assert json.loads(text)["meta"]["routing"] == {"r": 0}
    assert json.loads(text2)["meta"]["routing"] == {"r": 1}
    assert json.loads(text2)["data"]["ndarray"] == [[-10.0, -10.0]]
