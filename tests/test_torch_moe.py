"""The port's MoE layers (seldon_core_tpu_torch/parallel/moe.py and their
use in models/transformer.py and models/generate.py) against the JAX
package's, on the same weights (drawn with ``jax.random`` and carried
across with convert.params_from_jax) and the same inputs (numpy, from a
seed), at small sizes on the CPU.

In f32 the routing (expert, slot, kept) is identical and the outputs agree
to the dense LM's parity tolerance; greedy tokens are identical.  In bf16 a
near-tie can flip an argmax between the packages: each flip's gate margin
is held to the rounding of the input that moved it."""

import asyncio
import copy
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seldon_core_tpu_torch.models.generate as tgen
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.ops.quant import quantize_lm_params
from seldon_core_tpu_torch.parallel import moe as tmoe
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.tree import leaves_with_paths

# the modules themselves: the packages re-export functions of the same names
jgen = importlib.import_module("seldon_core_tpu.models.generate")
jmoe = importlib.import_module("seldon_core_tpu.parallel.moe")
ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=48, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
            n_experts=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _moe_cfgs(dtype=jnp.float32, **kw):
    base = dict(d_model=16, d_ff=32, n_experts=4, k=2, capacity_factor=2.0)
    base.update(kw)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    return jmoe.MoEConfig(**base, dtype=dtype), tmoe.MoEConfig(**base, dtype=tdt)


def _moe_params(jcfg, seed):
    jp = jmoe.moe_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax(_np(jp), device="cpu")


def _dense_routing(r, T, E, C):
    """The port's index routing as the reference's [T, E, C] tensors."""
    dispatch = np.zeros((T, E, C), np.float32)
    combine = np.zeros((T, E, C), np.float32)
    for t in range(T):
        for j in range(r.expert.shape[1]):
            if bool(r.kept[t, j]):
                e, s = int(r.expert[t, j]), int(r.slot[t, j])
                dispatch[t, e, s] = 1.0
                combine[t, e, s] = float(r.weight[t, j])
    return dispatch, combine


def _lm(dims, dtype=jnp.float32, seed=0, **kw):
    jcfg = jtr.LMConfig(**dims, **kw, dtype=dtype)
    tcfg = ttr.LMConfig(**dims, **kw, dtype={jnp.float32: torch.float32,
                                             jnp.bfloat16: torch.bfloat16}[dtype])
    jp = jtr.lm_init(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), device="cpu")


# -- the layer -------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_routing_is_the_reference_s_on_the_same_gates(k, cf):
    """expert, slot and kept exactly, combine weights to f32 rounding, with
    capacity tight (0.5: choices dropped) and loose."""
    jcfg, tcfg = _moe_cfgs(k=k, capacity_factor=cf)
    T = 40
    gates = np.asarray(jax.nn.softmax(jnp.asarray(_normal((T, 4), k * 10 + int(cf * 4)) * 2)))
    C = jmoe._capacity(jcfg, T)
    assert tmoe._capacity(tcfg, T) == C
    jd, jc = jmoe._route(jnp.asarray(gates), jcfg, C)
    r = tmoe._route(torch.from_numpy(gates.copy()), tcfg, C)
    d, c = _dense_routing(r, T, 4, C)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(c, np.asarray(jc), atol=1e-7, rtol=1e-6)
    if cf == 0.5:
        assert not bool(r.kept.all())  # the tight case drops choices
    assert int(r.kept.sum()) == int(np.asarray(jd).sum())


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", [(24, 16), (3, 7, 16)], ids=["flat", "batched"])
def test_moe_apply_matches_the_reference(k, shape):
    """f32: the outputs at the dense LM's tolerance, the routing each side
    computes from its own gates identical, lb_loss and overflow."""
    jcfg, tcfg = _moe_cfgs(k=k, capacity_factor=1.0)
    jp, tp = _moe_params(jcfg, k)
    x = _normal(shape, 7 + k)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux["lb_loss"]), float(jaux["lb_loss"]), rtol=1e-6)
    assert float(taux["overflow"]) == pytest.approx(float(jaux["overflow"]), abs=1e-7)
    xt = x.reshape(-1, 16)
    T, C = xt.shape[0], jmoe._capacity(jcfg, xt.shape[0])
    jgates = jax.nn.softmax(jnp.asarray(xt) @ jp["wg"], axis=-1)
    tgates = torch.softmax(torch.from_numpy(xt) @ tp["wg"], dim=-1)
    jd, _ = jmoe._route(jgates, jcfg, C)
    d, _ = _dense_routing(tmoe._route(tgates, tcfg, C), T, 4, C)
    np.testing.assert_array_equal(d, np.asarray(jd))


def test_single_expert_equals_dense_ffn():
    jcfg, tcfg = _moe_cfgs(n_experts=1, k=1, capacity_factor=8.0)
    _, tp = _moe_params(jcfg, 0)
    x = torch.from_numpy(_normal((6, 16), 0))
    y, aux = tmoe.moe_apply(tp, x, tcfg)
    h = torch.nn.functional.gelu(x @ tp["w1"][0], approximate="tanh")
    torch.testing.assert_close(y, h @ tp["w2"][0], atol=1e-5, rtol=1e-5)
    assert float(aux["overflow"]) == pytest.approx(0.0, abs=1e-6)


def test_zero_capacity_passes_the_input_through():
    """capacity clamps to 1 slot an expert: most tokens keep their input,
    as the reference's."""
    jcfg, tcfg = _moe_cfgs(capacity_factor=1e-9)
    jp, tp = _moe_params(jcfg, 2)
    x = _normal((64, 16), 2)
    y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    assert float(aux["overflow"]) == pytest.approx(float(jaux["overflow"])) and float(aux["overflow"]) > 0
    same = (y.numpy() == x).all(axis=-1)
    assert same.sum() >= 48
    np.testing.assert_array_equal(same, (np.asarray(jy) == x).all(axis=-1))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_k_greater_than_experts_raises_the_reference_message():
    jcfg, tcfg = _moe_cfgs(n_experts=2, k=3)
    _, tp = _moe_params(jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=2, k=1,
                                       dtype=jnp.float32), 6)
    with pytest.raises(ValueError) as want:
        jmoe.moe_apply(_moe_params(jcfg, 6)[0], jnp.zeros((4, 16), jnp.float32), jcfg)
    with pytest.raises(ValueError) as got:
        tmoe.moe_apply(tp, torch.zeros(4, 16), tcfg)
    assert str(got.value) == str(want.value) == "k=3 > n_experts=2"


def test_moe_init_lays_the_leaves_out_as_the_reference():
    jcfg, tcfg = _moe_cfgs(dtype=jnp.bfloat16)
    jp = jmoe.moe_init(jax.random.key(0), jcfg)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert sorted(tp) == sorted(jp) == ["w1", "w2", "wg"]
    for name in tp:
        assert tuple(tp[name].shape) == jp[name].shape
    assert tp["wg"].dtype == torch.float32 and jp["wg"].dtype == jnp.float32
    assert tp["w1"].dtype == tp["w2"].dtype == torch.bfloat16
    # the reference's scales: std fan_in ** -0.5
    assert float(tp["w1"].float().std()) == pytest.approx(16 ** -0.5, rel=0.1)
    assert float(tp["w2"].float().std()) == pytest.approx(32 ** -0.5, rel=0.1)


@pytest.mark.parametrize("k", [1, 2])
def test_gradients_match_jax_grad(k):
    """The router learns through the combine weights (k = 1: the raw gate
    scale) and the load-balance loss's mean gates, as under jax.grad."""
    jcfg, tcfg = _moe_cfgs(k=k, capacity_factor=1.0)
    jp, tp = _moe_params(jcfg, 4 + k)
    x = _normal((2, 9, 16), 4)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(y * y) + 0.01 * aux["lb_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = {n: t.clone().requires_grad_() for n, t in tp.items()}
    xx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(live, xx, tcfg)
    grads = torch.autograd.grad(torch.sum(y * y) + 0.01 * aux["lb_loss"],
                                [live["wg"], live["w1"], live["w2"], xx])
    for name, g in zip(["wg", "w1", "w2"], grads):
        assert float(g.abs().sum()) > 1e-3, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), atol=5e-5, rtol=5e-5,
                                   err_msg=name)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(jgx), atol=5e-5, rtol=5e-5)


def test_bf16_routing_flips_are_within_the_input_s_rounding():
    """bf16 experts, f32 router: the two packages' logits differ by their
    f32 sums' order only, so a choice that differs between them is a
    near-tie whose gate margin is below that difference."""
    jcfg, tcfg = _moe_cfgs(dtype=jnp.bfloat16, k=2, capacity_factor=1.25)
    jp, tp = _moe_params(jcfg, 9)
    x = jnp.asarray(_normal((256, 16), 9)).astype(jnp.bfloat16)
    xt = params_from_jax({"x": np.asarray(x)}, device="cpu")["x"]
    jgates = np.asarray(jax.nn.softmax(x.astype(jnp.float32) @ jp["wg"], axis=-1))
    tgates = torch.softmax(xt.float() @ tp["wg"], dim=-1)
    C = jmoe._capacity(jcfg, 256)
    jd = np.asarray(jmoe._route(jnp.asarray(jgates), jcfg, C)[0])
    r = tmoe._route(tgates, tcfg, C)
    got = _dense_routing(r, 256, 4, C)[0]
    flips = np.nonzero((got.sum(2) != jd.sum(2)).any(axis=1))[0]
    delta = np.abs(tgates.numpy() - jgates).max(axis=1)
    for t in flips:  # a flipped token's two experts were within the gates' gap
        a, b = np.argsort(-jgates[t])[:2]
        assert jgates[t, a] - jgates[t, b] <= 2 * delta[t] + 1e-7, t
    assert len(flips) <= 2  # near-ties are rare
    y, _ = tmoe.moe_apply(tp, xt, tcfg)
    jy, _ = jmoe.moe_apply(jp, x, jcfg)
    assert y.dtype == torch.bfloat16
    same = [t for t in range(256) if t not in set(flips)]
    np.testing.assert_allclose(y.float().numpy()[same], np.asarray(jy, np.float32)[same],
                               atol=3e-2, rtol=3e-2)


# -- the LM ---------------------------------------------------------------------


@pytest.mark.parametrize("moe_every,k", [(1, 1), (2, 2)])
def test_lm_apply_return_lb_matches(moe_every, k):
    jcfg, tcfg, jp, tp = _lm(DIMS, moe_every=moe_every, moe_k=k)
    assert ("moe" in tp["l1"]) and (("moe" in tp["l0"]) == (moe_every == 1))
    assert tcfg.is_moe_layer(1) and tcfg.is_moe_layer(0) == (moe_every == 1)
    tokens = np.random.default_rng(1).integers(0, 48, (2, 9)).astype(np.int32)
    jl, jlb = jtr.lm_apply(jp, jnp.asarray(tokens), jcfg, return_lb=True)
    tl, tlb = ttr.lm_apply(tp, torch.from_numpy(tokens), tcfg, return_lb=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-5)
    assert float(tlb) >= 0.99 * (2 if moe_every == 1 else 1)
    assert torch.equal(ttr.lm_apply(tp, torch.from_numpy(tokens), tcfg), tl)


@pytest.mark.parametrize("k", [1, 2])
def test_lm_loss_gradients_match_jax_grad(k):
    """lm_loss with the load-balance term, every leaf's gradient (the
    router and the expert stacks included) against jax.grad."""
    jcfg, tcfg, jp, tp = _lm(DIMS, seed=k, moe_every=1, moe_k=k)
    tokens = np.random.default_rng(k).integers(0, 48, (2, 17)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, {"tokens": jnp.asarray(tokens)}, jcfg, use_flash=False))(jp)
    leaves = leaves_with_paths(tp)
    live = [t.clone().requires_grad_() for _, t in leaves]
    from seldon_core_tpu_torch.tree import tree_unflatten

    loss = ttr.lm_loss(tree_unflatten(tp, live), {"tokens": torch.from_numpy(tokens)}, tcfg)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(want) == [key for key, _ in leaves]
    for (key, _), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[key], atol=5e-4, rtol=5e-4, err_msg=key)
    for key in ("['l0']['moe']['wg']", "['l1']['moe']['w1']", "['l1']['moe']['w2']"):
        assert np.abs(want[key]).sum() > 0, key


def test_batch_coupled():
    assert ttr.TransformerLM(moe_every=2, device="cpu").batch_coupled is True
    assert ttr.TransformerLM(device="cpu").batch_coupled is False
    assert tgen.TransformerGenerator(moe_every=2, device="cpu").batch_coupled is True
    assert tgen.TransformerGenerator(device="cpu").batch_coupled is False
    unit = tgen.TransformerGenerator(moe_every=2, device="cpu")
    assert unit.updates_state_on_predict is False  # greedy: no counter to move
    assert unit.continuous_spec(unit.init_state(None)) is None


# -- generation -----------------------------------------------------------------


def _gen_units(max_new=7, **kw):
    args = dict(DIMS, moe_every=1, moe_k=2, dtype="float32", max_new_tokens=max_new, **kw)
    return tgen.TransformerGenerator(**args, device="cpu"), jgen.TransformerGenerator(**args)


@pytest.mark.parametrize("prefix", ["", "3,1,4,1,5,9"], ids=["plain", "prefix"])
def test_generator_unit_greedy_tokens_equal_the_reference(prefix):
    """With a prefix the port prefills it itself (its own capacity, T = P),
    and the suffix's T sets the request's."""
    unit, junit = _gen_units(prefix_tokens=prefix)
    jstate = junit.init_state(jax.random.key(3))
    state = {"params": params_from_jax(_np(jstate["params"]), device="cpu"),
             "requests": torch.zeros((), dtype=torch.int32)}
    if prefix:
        ids = torch.tensor([unit.prefix_ids], dtype=torch.int32)
        _, state["prefix_cache"] = tgen.prefill(
            state["params"], ids, tgen.init_cache(unit.cfg, 1, len(unit.prefix_ids), "cpu"),
            unit.cfg)
        for li, layer in jstate["prefix_cache"].items():
            for kk, arr in layer.items():
                np.testing.assert_allclose(state["prefix_cache"][li][kk].numpy(),
                                           np.asarray(arr), atol=2e-5, rtol=2e-5)
    for B, S in ((1, 5), (3, 8)):
        X = np.random.default_rng(B * S).integers(0, 48, (B, S)).astype(np.float32)
        want = np.asarray(junit.predict(jstate, jnp.asarray(X)))
        got = unit.predict(state, torch.from_numpy(X))
        np.testing.assert_array_equal(got.numpy(), want)
        streamed = torch.cat(list(unit.stream_tokens(state, X, chunk=3)), dim=1)
        np.testing.assert_array_equal(streamed.numpy(), want)


def test_generate_over_a_long_run_merges_chunks_like_the_reference(monkeypatch):
    """More new tokens than the chunk buffer: merges between chunks."""
    monkeypatch.setattr(tgen, "GEN_CHUNK_CAP", 4)
    monkeypatch.setattr(jgen, "GEN_CHUNK_CAP", 4)
    jcfg, tcfg, jp, tp = _lm(DIMS, seed=5, moe_every=2, moe_k=1)
    prompt = np.random.default_rng(5).integers(0, 48, (2, 6)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=11))
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_weights_leave_the_experts_unquantized_and_serve_the_reference_s_tokens():
    unit, junit = _gen_units(quant="int8")
    jstate = junit.init_state(jax.random.key(4))
    assert sorted(jstate["params"]["l0"]["moe"]) == ["w1", "w2", "wg"]
    state = params_from_jax(_np(jstate), device="cpu")
    assert "wqkv_q" in state["params"]["l0"] and state["params"]["l0"]["moe"]["w1"].dtype == \
        torch.float32
    X = np.random.default_rng(4).integers(0, 48, (2, 6)).astype(np.float32)
    np.testing.assert_array_equal(unit.predict(state, torch.from_numpy(X)).numpy(),
                                  np.asarray(junit.predict(jstate, jnp.asarray(X))))
    # the port's own quantizer on the float tree: the same leaves
    own = quantize_lm_params(unit.init_state(None)["params"])
    assert sorted(own["l1"]) == sorted(jstate["params"]["l1"])
    assert own["l1"]["moe"]["wg"].dtype == torch.float32


def test_an_moe_checkpoint_round_trips_through_weights_path(tmp_path):
    """bf16 training tree -> save_lm_weights -> a unit's weights_path: the
    leaves back bit for bit, wg still f32; a JAX f32 checkpoint loads into
    the port unit and serves the JAX unit's tokens."""
    dims = dict(DIMS, moe_every=2)
    tcfg = ttr.LMConfig(**dims, dtype=torch.bfloat16)
    params = ttr.lm_init(torch.Generator().manual_seed(7), tcfg, "cpu")
    assert params["l1"]["moe"]["wg"].dtype == torch.float32
    path = ttr.save_lm_weights(params, str(tmp_path / "moe.npz"))
    unit = tgen.TransformerGenerator(**dims, device="cpu", weights_path=path, seed=1)
    loaded = unit.init_state(None)["params"]
    for (key, want), (key2, got) in zip(leaves_with_paths(params), leaves_with_paths(loaded)):
        assert key == key2 and got.dtype == want.dtype and torch.equal(got, want), key
    jcfg = jtr.LMConfig(**dims, dtype=jnp.float32)
    jparams = jtr.lm_init(jax.random.key(8), jcfg)
    jpath = jtr.save_lm_weights(jparams, str(tmp_path / "jax.npz"))
    unit, junit = (cls(**dims, dtype="float32", max_new_tokens=5, weights_path=jpath, **extra)
                   for cls, extra in ((tgen.TransformerGenerator, {"device": "cpu"}),
                                      (jgen.TransformerGenerator, {})))
    X = np.random.default_rng(8).integers(0, 48, (2, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        unit.predict(unit.init_state(None), torch.from_numpy(X)).numpy(),
        np.asarray(junit.predict(jax.tree_util.tree_map(jnp.asarray,
                                                        junit.init_state(jax.random.key(0))),
                                 jnp.asarray(X))))


# -- the engine -----------------------------------------------------------------


def _ep_doc():
    return json.loads((ROOT / "examples" / "generator_ep_deployment.json").read_text())


def test_the_ep_example_is_refused_for_its_mesh_and_serves_without_it(monkeypatch):
    """As written, on one device it is refused for its mesh in the
    reference's words ("needs 4 devices, have 1"; tests/test_torch_mesh.py
    and test_torch_tensor_parallel.py serve it over 4 of 8 CPU devices);
    without ``mesh_axes`` both engines build, the continuous switch on, and
    on the same state answer the same tokens for a batch (capacity over
    both rows) and one row: the port serves on the static lane
    (``genserver`` null), with no batcher."""
    from seldon_core_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "1")
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", 1)
    with pytest.raises(ValueError, match=r"mesh \{'ep': 4\} needs 4 devices, have 1"):
        EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(_ep_doc())),
                      device="cpu")
    doc = _ep_doc()
    del doc["spec"]["predictors"][0]["components"][0]["mesh_axes"]
    jax_engine = JaxEngine(JaxSpec.from_json_dict(copy.deepcopy(doc)))
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        engine.load_states({"gen": params_from_jax(_np(jax_engine.states()["gen"]),
                                                   device="cpu")})
        rng = np.random.default_rng(12)
        for shape in ((3, 9), (1, 5)):
            body = json.dumps({"data": {"ndarray": rng.integers(0, 256, shape).tolist()}})

            async def both():
                return await asyncio.gather(jax_engine.predict_json(body),
                                            engine.predict_json(body))

            (jtext, jstatus), (text, status) = asyncio.run(both())
            assert status == jstatus == 200
            got = np.asarray(json.loads(text)["data"]["ndarray"])
            assert got.shape == (shape[0], 12)
            np.testing.assert_array_equal(got, np.asarray(json.loads(jtext)["data"]["ndarray"]))
        stats = engine.stats()
        assert stats["genserver"] is None and jax_engine.stats()["genserver"] is None
        assert engine.batcher is None
    finally:
        engine.close()
