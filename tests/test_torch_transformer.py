"""The port's transformer LM (seldon_core_tpu_torch/models/transformer.py)
against the JAX package's, on the same weights (carried across with
convert.params_from_jax) and the same inputs (numpy, from a seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
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


DIMS = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jtr.LMConfig(**DIMS, dtype=jdt), ttr.LMConfig(**DIMS, dtype=tdt)


def _carried(jcfg, seed=0):
    jp = jtr.lm_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _tokens(shape, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    pos = (rng.integers(0, 500, size=(2, 8)) if per_row else np.arange(5, 13)).astype(np.int32)
    got = ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jtr.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    # the rotate-half is exact on both sides; cos/sin/pow of the two
    # libraries may differ by an f32 ulp at angles up to ~500 rad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    got = ttr._rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    want = jtr._rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    # f32: sum order only; bf16: both round the normalised row, then the
    # bf16 product with w (one bf16 ulp, 2^-8 relative)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attention_matches(causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    got = ttr.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    want = jtr.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,use_flash", [("float32", False), ("float32", True),
                                             ("bfloat16", False), ("bfloat16", True)])
def test_lm_apply_matches_jax(dtype, use_flash):
    jcfg, tcfg = _configs(dtype)
    jp, tp = _carried(jcfg)
    toks = _tokens((2, 128), 3)
    # the JAX side runs its XLA attention (no TPU here); the port's plain
    # flash version and its plain attention must both give its logits
    want = np.asarray(jax.jit(jtr.lm_apply, static_argnums=(2,))(jp, jnp.asarray(toks), jcfg))
    got = ttr.lm_apply(tp, torch.from_numpy(toks), tcfg, use_flash=use_flash).numpy()
    assert got.shape == want.shape == (2, 128, 64)
    if dtype == "float32":
        # two layers of f32 with sums in another order
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        # bf16 rounds after every op on both sides, but the libraries round
        # some elementwise chains (gelu, softmax) at other places; the
        # logits (|x| up to ~4, bf16 ulp 2^-6 there) move by a few ulps:
        # 0.039 at most and 0.006 on average here, held to twice that
        np.testing.assert_allclose(got, want, atol=0.08)
        assert np.mean(np.abs(got - want)) < 0.012


def test_auto_and_xla_modes_agree_on_cpu():
    lm_auto = ttr.TransformerLM(**DIMS, dtype="float32", attention="auto", device="cpu")
    lm_xla = ttr.TransformerLM(**DIMS, dtype="float32", attention="xla", device="cpu")
    assert lm_auto.use_flash is True and lm_xla.use_flash is False
    state = lm_auto.init_state(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens((2, 128), 4)).float()
    torch.testing.assert_close(lm_auto.predict(state, toks), lm_xla.predict(state, toks),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="not supported"):
        ttr.TransformerLM(**DIMS, attention="ring", device="cpu")


def test_transformer_lm_predict_parity():
    junit = jtr.TransformerLM(**DIMS, dtype="float32", seed=3)
    jstate = junit.init_state(jax.random.key(7))
    tunit = ttr.TransformerLM(**DIMS, dtype="float32", seed=3, device="cpu")
    tstate = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    X = _tokens((3, 128), 5).astype(np.float32)
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(X)))
    got = tunit.predict(tstate, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# token ids the reference serves although they leave the table: past the
# vocab, negative, NaN and beyond the int32 range (vocab 64)
ODD_DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64)
ODD_ROW = [[1, 2, 70, -1, -70, float("nan"), 1e10, -1e10]]


def _odd_units():
    junit = jtr.TransformerLM(**ODD_DIMS, dtype="float32", attention="xla", seed=3)
    jstate = junit.init_state(jax.random.key(7))
    tunit = ttr.TransformerLM(**ODD_DIMS, dtype="float32", attention="xla", seed=3,
                              device="cpu")
    tstate = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    return junit, jstate, tunit, tstate


def test_predict_takes_out_of_range_and_nan_ids_as_the_reference_does():
    """The reference casts with astype(int32) (NaN -> 0, truncation,
    saturation) and JAX's gather wraps a negative index once and clamps;
    the port reads the same embedding rows instead of raising IndexError
    (or, on CUDA, a device-side assert)."""
    X = np.asarray(ODD_ROW, dtype=np.float32)
    assert ttr.token_rows(torch.from_numpy(X), 64).tolist() == [[1, 2, 63, 63, 0, 0, 63, 0]]
    junit, jstate, tunit, tstate = _odd_units()
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(X)))
    got = tunit.predict(tstate, torch.from_numpy(X)).numpy()
    assert got.shape == (1, 8, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("vocab", [64, 1000])
def test_token_rows_are_the_rows_jax_gathers(dtype, vocab):
    """token_rows against what the reference reads: ``table[X.astype(int32)]``
    over a table whose row i holds i."""
    rng = np.random.default_rng(vocab)
    vals = [0, 1, vocab - 1, vocab, vocab + 1, -1, -vocab, -vocab - 1, 2**31 - 1, -2**31]
    vals += rng.integers(-3 * vocab, 3 * vocab, 64).tolist()
    if dtype == "float32":
        vals += [float("nan"), float("inf"), float("-inf"), 1e10, -1e10, 2.7, -2.7, -0.5,
                 vocab - 0.5, -vocab - 0.5]
    X = np.asarray(vals, dtype=dtype).reshape(2, -1)
    want = np.asarray(jnp.arange(vocab)[jnp.asarray(X).astype(jnp.int32)])
    np.testing.assert_array_equal(ttr.token_rows(torch.from_numpy(X), vocab).numpy(), want)


def test_engine_serves_out_of_range_and_nan_ids_as_the_reference_does():
    import asyncio
    import json

    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.runtime.engine import EngineService

    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in ODD_DIMS.items()]
    params += [{"name": "dtype", "value": "float32", "type": "STRING"},
               {"name": "attention", "value": "xla", "type": "STRING"}]
    doc = {"spec": {"name": "lm", "predictors": [{
        "name": "p", "graph": {"name": "g", "type": "MODEL"},
        "components": [{"name": "g", "runtime": "inprocess", "class_path": "TransformerLM",
                        "parameters": params}]}]}}
    junit, jstate, _, tstate = _odd_units()
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    try:
        engine.load_states({"g": tstate})
        text, status = asyncio.run(engine.predict_json(json.dumps({"data": {"ndarray": ODD_ROW}})))
    finally:
        engine.close()
    assert status == 200, text
    got = np.asarray(json.loads(text)["data"]["ndarray"], dtype=np.float32)
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(ODD_ROW, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_config_keeps_the_jax_validation_messages():
    for kw, match in (({"d_model": 30}, "not divisible by n_heads"),
                      ({"quant": "int4"}, "not supported"),
                      ({"n_kv_heads": 3}, "not divisible by n_kv_heads"),
                      ({"d_model": 20, "n_heads": 4}, "even head dim")):
        with pytest.raises(ValueError, match=match):
            ttr.LMConfig(**{**DIMS, **kw})
        with pytest.raises(ValueError, match=match):
            jtr.LMConfig(**{**DIMS, **kw})
