"""The port's static generation path (seldon_core_tpu_torch/models/
generate.py) against the JAX package's ``generate``, on the same weights
(carried across with convert.params_from_jax) and prompts (numpy, from a
seed).  In f32 the greedy tokens must be identical."""

import asyncio
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seldon_core_tpu_torch.models.generate as tgen
from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models.mnist import mlp_init
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.models.transformer import lm_init as ttr_lm_init
from seldon_core_tpu_torch.runtime.engine import EngineService

# the modules themselves: the packages re-export functions of the same names
jgen = importlib.import_module("seldon_core_tpu.models.generate")
jfa = importlib.import_module("seldon_core_tpu.ops.flash_attention")
ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=48, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)
JCFG = JConfig(**DIMS, dtype=jnp.float32)
TCFG = TConfig(**DIMS, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """JAX's _attention imports flash_attention at call time: run it in
    interpret mode, as the JAX package's own tests do on the CPU."""
    orig = jfa.flash_attention
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda q, k, v, causal=True: orig(q, k, v, causal, True))


def _weights(seed=0):
    jp = jax_lm_init(jax.random.key(seed), JCFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(0, DIMS["vocab"], size=shape).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_cache_close(got, want):
    for li, layer in want.items():
        for kk, arr in layer.items():
            np.testing.assert_allclose(got[li][kk].numpy(), np.asarray(arr), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S", [5, 128])
def test_prefill_matches(S, jax_flash_interpret):
    jp, tp = _weights()
    prompt = _prompt((2, S), 1)
    use_flash = S % 128 == 0
    want_logits, want_cache = jax.jit(jgen.prefill, static_argnums=(3, 4))(
        jp, jnp.asarray(prompt), jgen.init_cache(JCFG, 2, S + 3), JCFG,
        "force" if use_flash else False)
    got_logits, got_cache = tgen.prefill(
        tp, torch.from_numpy(prompt), tgen.init_cache(TCFG, 2, S + 3, "cpu"), TCFG, use_flash=use_flash)
    # f32 through two layers, sums in another order
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=1e-4)
    _assert_cache_close(got_cache, want_cache)


def test_decode_step_two_tier_and_merge_chunk_match():
    jp, tp = _weights(1)
    S, C = 6, 4
    prompt = _prompt((2, S), 2)
    _, jmain = jax.jit(jgen.prefill, static_argnums=(3,))(
        jp, jnp.asarray(prompt), jgen.init_cache(JCFG, 2, S + C), JCFG)
    jstep = jax.jit(jgen.decode_step_two_tier, static_argnums=(6,))
    _, tmain = tgen.prefill(tp, torch.from_numpy(prompt), tgen.init_cache(TCFG, 2, S + C, "cpu"), TCFG)
    jchunk, tchunk = jgen.init_chunk(JCFG, 2, C), tgen.init_chunk(TCFG, 2, C, "cpu")
    token = np.array([3, 7], np.int32)
    for used in range(3):  # three steps: main not full (masked), chunk growing
        jl, jchunk = jstep(jp, jnp.asarray(token), jmain, jchunk, S, used, JCFG)
        tl, tchunk = tgen.decode_step_two_tier(tp, torch.from_numpy(token), tmain, tchunk, S,
                                               used, TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        _assert_cache_close(tchunk, jchunk)
        token = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    merged_j = jgen.merge_chunk(jmain, jchunk, S, JCFG)
    merged_t = tgen.merge_chunk(tmain, tchunk, S, TCFG)
    _assert_cache_close(merged_t, merged_j)


def test_single_tier_decode_step_matches():
    jp, tp = _weights(3)
    S = 6
    prompt = _prompt((2, S), 4)
    _, jcache = jax.jit(jgen.prefill, static_argnums=(3,))(
        jp, jnp.asarray(prompt), jgen.init_cache(JCFG, 2, S + 2), JCFG)
    _, tcache = tgen.prefill(tp, torch.from_numpy(prompt), tgen.init_cache(TCFG, 2, S + 2, "cpu"), TCFG)
    token = np.array([1, 9], np.int32)
    jl, jcache = jax.jit(jgen.decode_step, static_argnums=(4,))(
        jp, jnp.asarray(token), jcache, S, JCFG)
    tl, tcache = tgen.decode_step(tp, torch.from_numpy(token), tcache, S, TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("S,new", [(5, 9), (128, 7)])
def test_greedy_generate_is_token_identical(S, new, jax_flash_interpret):
    """S=128 takes the flash path (the JAX Pallas kernel in interpret mode,
    the port's plain flash version); S=5 the plain attention."""
    jp, tp = _weights(2)
    prompt = _prompt((2, S), 3)
    use_flash = S % 128 == 0
    want = np.asarray(jax.jit(lambda p, t: jgen.generate(
        p, t, JCFG, max_new_tokens=new, use_flash="force" if use_flash else False))(
        jp, jnp.asarray(prompt)))
    got = tgen.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=new,
                        use_flash=use_flash)
    assert got.dtype == torch.int32 and got.shape == (2, new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_merge_path_is_token_identical(monkeypatch):
    """GEN_CHUNK_CAP below max_new forces chunk merges on both sides (as
    tests/test_generate.py:46 does for the JAX package)."""
    jp, tp = _weights(5)
    prompt = _prompt((2, 6), 7)
    monkeypatch.setattr(jgen, "GEN_CHUNK_CAP", 4)
    monkeypatch.setattr(tgen, "GEN_CHUNK_CAP", 4)
    want = np.asarray(jax.jit(lambda p, t: jgen.generate(p, t, JCFG, max_new_tokens=13))(
        jp, jnp.asarray(prompt)))
    got = tgen.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=13)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_masking_and_prompt_clamping():
    toks = np.array([[1, 5, 2, 5, 3], [4, 4, 4, 4, 4]], np.int32)
    got = tgen.mask_after_eos(torch.from_numpy(toks), 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgen.mask_after_eos(jnp.asarray(toks), 5)))
    np.testing.assert_array_equal(got, [[1, 5, 5, 5, 5], [4, 4, 4, 4, 4]])
    assert tgen.mask_after_eos(torch.from_numpy(toks), -1) is not None
    X = np.array([[-3.0, 2.7, 99.0, np.nan, np.inf, -np.inf]], np.float32)
    got = tgen.sanitize_prompt(torch.from_numpy(X), 48).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgen.sanitize_prompt(jnp.asarray(X), 48)))
    np.testing.assert_array_equal(got, [[0, 2, 47, 0, 47, 0]])


@pytest.mark.parametrize("kw,match", [
    ({"temperature": 0.7}, r"item \[5d\] b"),
    ({"prefix_tokens": "1,2,3"}, r"item \[5d\] c"),
    ({"quant": "int8"}, "item 2"),
    ({"kv_quant": "int8"}, "item 2"),
    ({"moe_every": 2}, "item 5e"),
    ({"attention": "ring"}, "not supported"),
])
def test_constructor_refuses_what_is_not_served(kw, match):
    with pytest.raises(ValueError, match=match):
        tgen.TransformerGenerator(**DIMS, dtype="float32", device="cpu", **kw)


def test_missing_weights_path_raises_the_jax_message_at_init_state(tmp_path):
    path = str(tmp_path / "nonexistent.npz")
    unit = tgen.TransformerGenerator(**DIMS, dtype="float32", device="cpu", weights_path=path)
    junit = jgen.TransformerGenerator(**DIMS, dtype="float32", weights_path=path)
    with pytest.raises(FileNotFoundError) as want:
        junit.init_state(jax.random.key(0))
    with pytest.raises(FileNotFoundError) as got:
        unit.init_state(None)
    assert str(got.value) == str(want.value) == f"weights_path {path!r} does not exist"


@pytest.mark.parametrize("make", [
    lambda: ttr_lm_init(torch.Generator().manual_seed(0), TCFG),
    lambda: tgen.init_cache(TCFG, 1, 8),
    lambda: tgen.init_chunk(TCFG, 1, 8),
    lambda: mlp_init(torch.Generator().manual_seed(0), hidden=16),
], ids=["lm_init", "init_cache", "init_chunk", "mlp_init"])
def test_init_functions_default_to_cuda(make, monkeypatch):
    """Without a device they ask resolve_device for cuda, and raise its
    error where CUDA is absent instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_engine_serves_the_example_deployment_like_the_jax_unit(monkeypatch):
    # the static lane: one generate per dispatch, its prefill through the
    # flash path at S = 128 (the continuous lane has tests of its own)
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    doc = json.loads((ROOT / "examples" / "generator_deployment.json").read_text())
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        params = {p["name"]: p["value"] for p in
                  doc["spec"]["predictors"][0]["components"][0]["parameters"]}
        junit = jgen.TransformerGenerator(**{k: float(v) if k == "temperature" else int(v)
                                             for k, v in params.items()})
        jstate = junit.init_state(jax.random.key(11))
        engine.load_states({"gen": params_from_jax(_np(jstate), device="cpu")})
        for S in (5, 128):  # the plain attention, then the plain flash version
            X = _prompt((2, S), 20 + S).astype(np.float32)
            want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(X)))
            text, status = asyncio.run(engine.predict_json(
                json.dumps({"data": {"ndarray": X.tolist()}})))
            assert status == 200
            got = np.asarray(json.loads(text)["data"]["ndarray"])
            assert got.shape == want.shape == (2, 16)
            np.testing.assert_array_equal(got, want)
        assert engine.stats()["kernels"]["flash_attention"]["launches"] == 0  # CPU: no kernel
    finally:
        engine.close()
