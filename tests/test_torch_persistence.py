"""The port's checkpoint hand-off (seldon_core_tpu_torch/runtime/
persistence.py and models/transformer.py ``save_lm_weights`` /
``load_lm_weights``) against the JAX package's: the same ``.npz`` format,
files that cross between the packages in f32 both ways, the same strict
errors, and a generator served from a ``weights_path``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.models.generate import TransformerGenerator
from seldon_core_tpu_torch.runtime import persistence
from seldon_core_tpu_torch.tree import leaves_with_paths

# the module itself: the package re-exports a class of the same name
jgen = importlib.import_module("seldon_core_tpu.models.generate")

DIMS = dict(vocab=48, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_params(dtype, seed=0, **dims):
    cfg = ttr.LMConfig(**{**DIMS, **dims}, dtype=dtype)
    return ttr.lm_init(torch.Generator().manual_seed(seed), cfg, "cpu")


def _jax_params(seed=0, **dims):
    cfg = jtr.LMConfig(**{**DIMS, **dims}, dtype=jnp.float32)
    return jtr.lm_init(jax.random.key(seed), cfg)


def _same(a, b):
    for (ka, ta), (kb, tb) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        assert ka == kb and ta.dtype == tb.dtype and torch.equal(ta, tb), ka


def test_keys_are_jax_keystr_paths(tmp_path):
    params = _port_params(torch.float32)
    path = ttr.save_lm_weights(params, str(tmp_path / "w.npz"))
    with np.load(path) as data:
        keys = sorted(data.files)
    want = sorted(jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(_jax_params())[0])
    assert keys == want and "['l0']['wqkv']" in keys and "['embed']" in keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_in_the_port_is_bit_identical(dtype, tmp_path):
    trained = _port_params(dtype, seed=1)
    path = ttr.save_lm_weights(trained, str(tmp_path / "w.npz"))
    if dtype == torch.bfloat16:  # the bit pattern the JAX package writes
        with np.load(path) as data:
            assert data["['embed']"].dtype.str == "|V2"
    _same(ttr.load_lm_weights(_port_params(dtype, seed=2), path), trained)
    # state_to_host / state_from_host without a file, any nesting
    state = {"params": trained, "count": torch.tensor(3, dtype=torch.int32)}
    _same(persistence.state_from_host(persistence.state_to_host(state), state), state)


def test_bf16_checkpoint_serves_an_f32_config_and_f32_serves_bf16(tmp_path):
    bf = _port_params(torch.bfloat16, seed=3)
    path = ttr.save_lm_weights(bf, str(tmp_path / "bf.npz"))
    as_f32 = ttr.load_lm_weights(_port_params(torch.float32), path)
    _same(as_f32, {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                       else v.float()) for k, v in bf.items()})
    f32 = _port_params(torch.float32, seed=4)
    path = ttr.save_lm_weights(f32, str(tmp_path / "f32.npz"))
    as_bf16 = ttr.load_lm_weights(_port_params(torch.bfloat16), path)
    for (_, got), (_, src) in zip(leaves_with_paths(as_bf16), leaves_with_paths(f32)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, src.to(torch.bfloat16))  # RNE


def test_f32_checkpoints_cross_between_the_packages(tmp_path):
    # port -> JAX
    port = _port_params(torch.float32, seed=5)
    path = ttr.save_lm_weights(port, str(tmp_path / "port.npz"))
    loaded = jtr.load_lm_weights(_jax_params(seed=6), path)
    for (key, leaf) in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        want = dict(leaves_with_paths(port))[jax.tree_util.keystr(key)]
        np.testing.assert_array_equal(np.asarray(leaf), want.numpy())
    # JAX -> port
    jp = _jax_params(seed=7)
    path = jtr.save_lm_weights(jp, str(tmp_path / "jax.npz"))
    got = ttr.load_lm_weights(_port_params(torch.float32), path)
    _same(got, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))


def test_strict_errors_carry_the_jax_messages(tmp_path):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError) as got:
        ttr.load_lm_weights(_port_params(torch.float32), missing)
    with pytest.raises(FileNotFoundError) as want:
        jtr.load_lm_weights(_jax_params(), missing)
    assert str(got.value) == str(want.value)
    # a one-layer checkpoint does not cover a two-layer config
    short = ttr.save_lm_weights(_port_params(torch.float32, n_layers=1), str(tmp_path / "s.npz"))
    # a narrower d_ff: every w1/w2 leaf has another shape
    narrow = ttr.save_lm_weights(_port_params(torch.float32, d_ff=32), str(tmp_path / "n.npz"))
    for path, match in ((short, "does not cover"), (narrow, "shape mismatch")):
        with pytest.raises(ValueError, match=match) as got:
            ttr.load_lm_weights(_port_params(torch.float32), path)
        with pytest.raises(ValueError, match=match) as want:
            jtr.load_lm_weights(_jax_params(), path)
        assert str(got.value) == str(want.value)


def test_generator_serves_a_checkpoint_like_the_jax_unit(tmp_path):
    path = jtr.save_lm_weights(_jax_params(seed=8), str(tmp_path / "trained.npz"))
    kw = dict(**DIMS, max_new_tokens=6, dtype="float32", weights_path=path)
    junit = jgen.TransformerGenerator(**kw)
    jstate = junit.init_state(jax.random.key(0))
    unit = TransformerGenerator(**kw, device="cpu")
    state = unit.init_state(None)
    prompt = np.random.default_rng(9).integers(0, DIMS["vocab"], size=(2, 8)).astype(np.float32)
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(prompt)))
    got = unit.predict(state, torch.from_numpy(prompt)).numpy()
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_array_equal(got, want)  # greedy f32 tokens
    # the TransformerLM unit loads the same file
    lm = ttr.TransformerLM(**DIMS, dtype="float32", weights_path=path, device="cpu")
    _same(lm.init_state(None), state["params"])
