"""The port's static generation path (seldon_core_tpu_torch/models/
generate.py) against the JAX package's ``generate``, on the same weights
(carried across with convert.params_from_jax) and prompts (numpy, from a
seed).  In f32 the greedy tokens must be identical, with and without a
shared prefix.  Sampling is held to the reference's ``sample_token`` with
the reference's own Gumbel draws injected (the port's random source,
models/prng.py, has other bits by design), and the random source to what
sampling needs of it: determinism, rows independent of their batch, the
Gumbel distribution."""

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
import seldon_core_tpu_torch.models.prng as tprng
from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models.mnist import mlp_init
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.models.transformer import lm_init as ttr_lm_init
from seldon_core_tpu_torch.runtime.batching import MicroBatcher
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

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


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    # the autopilot's table, the brownout ladder, the fleet burn view and the
    # cost ledger are process-global and change decisions: what one test
    # trained must not steer the next
    reset_learned_singletons()
    yield


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
    ({"prefix_tokens": "1,2,99"}, r"prefix token 99 outside vocab \[0, 48\)"),
    ({"quant": "int8"}, None),
    ({"kv_quant": "int8"}, None),
    ({"moe_every": 2, "n_experts": 4}, None),
    ({"attention": "ring"}, "not supported"),
])
def test_constructor_refuses_what_is_not_served(kw, match):
    """What the port does not serve is refused naming its ROADMAP item;
    int8 weights and the int8 K/V cache (item [2q]) and MoE layers (item
    [5e]), each refused until it was ported, are served: the unit's greedy
    f32 tokens equal the JAX unit's on the same state."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            tgen.TransformerGenerator(**DIMS, dtype="float32", device="cpu", **kw)
        return
    unit = tgen.TransformerGenerator(**DIMS, dtype="float32", device="cpu", max_new_tokens=6, **kw)
    junit = jgen.TransformerGenerator(**DIMS, dtype="float32", max_new_tokens=6, **kw)
    jstate = junit.init_state(jax.random.key(0))
    X = _prompt((2, 5), 11).astype(np.float32)
    got = unit.predict(params_from_jax(_np(jstate), device="cpu"), torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), np.asarray(junit.predict(jstate, jnp.asarray(X))))


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


# -- sampled decoding ------------------------------------------------------------

V_SAMPLE = 64


@pytest.fixture
def reference_truncation(monkeypatch):
    """The logits the reference's ``sample_token`` hands to
    ``jax.random.categorical``: its truncation, read where it ends."""
    seen = []
    orig = jax.random.categorical

    def spy(key, logits, axis=-1, **kw):
        seen.append(np.asarray(logits))
        return orig(key, logits, axis=axis, **kw)

    monkeypatch.setattr(jax.random, "categorical", spy)
    return seen


@pytest.mark.parametrize("top_p", [0.0, 1e-6, 0.9, 1.0])
@pytest.mark.parametrize("top_k", [0, 1, 5, V_SAMPLE + 7])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_token_matches_the_reference_with_injected_gumbel(temperature, top_k, top_p,
                                                                 reference_truncation):
    """The reference's draw is argmax(gumbel(key, (B, V)) + truncated
    logits): with that same noise injected the port picks the same token in
    every row, exactly.  The kept masks agree too; the one difference
    allowed is a token whose mass before it lies within 1e-6 of top_p (f32
    cumsum order), counted and reported."""
    rng = np.random.default_rng(int(temperature * 10) + 7 * top_k + int(top_p * 100))
    logits = (rng.normal(size=(6, V_SAMPLE)) * 3).astype(np.float32)
    logits[0, :4] = logits[0].max() + 1.0  # a tie at the top: ties are kept alike
    key = jax.random.key(int(rng.integers(1 << 30)))
    g = jax.random.gumbel(key, logits.shape, jnp.float32)
    want = np.asarray(jgen.sample_token(jnp.asarray(logits), key, temperature, top_k, top_p))
    got = tgen.sample_token(torch.from_numpy(logits), None, temperature, top_k, top_p,
                            gumbel=torch.from_numpy(np.array(g)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_kept = np.isfinite(reference_truncation[-1])
    got_kept = torch.isfinite(tgen.truncate_logits(torch.from_numpy(logits), temperature,
                                                   top_k, top_p)).numpy()
    differ = got_kept != want_kept
    if 0.0 < top_p < 1.0 and differ.any():
        srt = -np.sort(-(logits / np.float32(temperature)), axis=-1)
        probs = np.exp(srt - srt.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        before = np.cumsum(probs, axis=-1) - probs
        near = np.abs(before - top_p) < 1e-6
        print(f"{int(differ.sum())} kept-mask differences, {int(near.sum())} tokens within "
              f"1e-6 of top_p")
        assert differ.sum() <= near.sum()
    else:
        np.testing.assert_array_equal(got_kept, want_kept)


def test_sample_token_at_temperature_zero_is_argmax():
    logits = np.random.default_rng(3).normal(size=(5, V_SAMPLE)).astype(np.float32)
    logits[1, [3, 9]] = 10.0  # ties break to the first index, as jnp.argmax
    want = np.asarray(jgen.sample_token(jnp.asarray(logits), jax.random.key(0)))
    got = tgen.sample_token(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
    with pytest.raises(ValueError, match="needs a key"):
        tgen.sample_token(torch.from_numpy(logits), None, 1.0)


@pytest.mark.parametrize("kw", [{"top_k": 1}, {"top_p": 1e-6}], ids=["top_k=1", "top_p=1e-6"])
def test_sampling_that_keeps_one_token_is_the_reference_greedy_answer(kw):
    """Truncation that keeps only the top token makes every draw the
    argmax, so the whole sampled path (keys, splits, noise) must give the
    reference's greedy tokens, through generate and the stream."""
    jp, tp = _weights(6)
    prompt = _prompt((3, 7), 8)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), JCFG, max_new_tokens=9))
    got = tgen.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=9, temperature=0.7,
                        rng=tprng.key(5), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    chunks = [c.numpy() for c in tgen.stream_chunks(tp, torch.from_numpy(prompt), TCFG, 9,
                                                    chunk=4, temperature=0.7,
                                                    rng=tprng.key(5), **kw)]
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), want)


def test_sampled_generate_is_seeded_and_the_stream_draws_the_same():
    """The same key gives the same sample, another key another one (the
    reference's tests/test_generate.py:161), every token in the vocab; a
    stream with the same key yields generate's tokens, over a grow_merge."""
    _, tp = _weights(1)
    prompt = torch.zeros(3, 4, dtype=torch.int32)
    a, b, c = (tgen.generate(tp, prompt, TCFG, max_new_tokens=8, temperature=1.0,
                             rng=tprng.key(s)) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 8) and int(a.min()) >= 0 and int(a.max()) < DIMS["vocab"]
    one = tgen.generate(tp, prompt, TCFG, max_new_tokens=20, temperature=1.0, top_k=5,
                        top_p=0.9, rng=tprng.key(9))
    streamed = torch.cat(list(tgen.stream_chunks(tp, prompt, TCFG, 20, chunk=6, temperature=1.0,
                                                 rng=tprng.key(9), top_k=5, top_p=0.9)), dim=1)
    assert torch.equal(streamed, one)


def test_prng_hash_is_exact_integer_arithmetic():
    """Every 32-bit product stays below 2^63 (no int64 wrap on any device):
    _mul and _fmix agree with Python's unbounded integers."""
    vals = np.random.default_rng(0).integers(0, 1 << 32, size=200, dtype=np.uint64)
    x = torch.from_numpy(vals.astype(np.int64))
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF):
        np.testing.assert_array_equal(tprng._mul(x, c).numpy(),
                                      [(int(v) * c) & 0xFFFFFFFF for v in vals])
    np.testing.assert_array_equal(tprng._fmix(x).numpy(), [tprng._fmix(int(v)) for v in vals])


def test_prng_same_key_same_noise_different_keys_different_noise():
    k = tprng.key(7)
    assert k.dtype == torch.int64 and k.shape == (2,)
    assert torch.equal(tprng.gumbel(k, 1000), tprng.gumbel(tprng.key(7), 1000))
    keys = [tprng.key(7), tprng.key(8), tprng.fold_in(k, 0), tprng.fold_in(k, 1),
            *tprng.split(k)]
    draws = [tprng.gumbel(x, 1000) for x in keys]
    for i in range(len(draws)):
        for j in range(i + 1, len(draws)):
            assert not torch.equal(draws[i], draws[j]), (i, j)
    # a tensor counter folds in as the int does (the request counter on the device)
    assert torch.equal(tprng.fold_in(k, torch.tensor(3, dtype=torch.int32)), tprng.fold_in(k, 3))
    a, b = tprng.split(k)
    both = tprng.split(torch.stack([k, tprng.key(8)]))
    assert torch.equal(both[0][0], a) and torch.equal(both[1][0], b)


def test_prng_row_draws_do_not_depend_on_the_batch():
    """Per-row keys [B, 2]: a row's noise, and its sampled token, are the
    same alone, among other rows, and at another place in the batch."""
    keys = torch.stack([tprng.fold_in(tprng.key(3), i) for i in range(5)])
    g = tprng.gumbel(keys, 97)
    for i in range(5):
        assert torch.equal(tprng.gumbel(keys[i:i + 1], 97)[0], g[i])
    perm = torch.tensor([3, 0, 4, 1, 2])
    assert torch.equal(tprng.gumbel(keys[perm], 97), g[perm])
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 97)).astype(np.float32))
    toks = tgen.sample_token(logits, keys, 1.0, 10, 0.9)
    assert torch.equal(tgen.sample_token(logits[perm], keys[perm], 1.0, 10, 0.9), toks[perm])
    assert torch.equal(tgen.sample_token(logits[2:3], keys[2:3], 1.0, 10, 0.9), toks[2:3])


def test_prng_gumbel_noise_is_standard_gumbel():
    """Kolmogorov-Smirnov against the standard Gumbel CDF exp(-exp(-x)) at a
    fixed sample of 20000 draws (the critical value at 1% is 1.63 /
    sqrt(n)), and its mean and variance (Euler's gamma, pi^2 / 6)."""
    n = 20000
    x = np.sort(tprng.gumbel(tprng.key(2024), n).double().numpy())
    cdf = np.exp(-np.exp(-x))
    d = max((np.arange(1, n + 1) / n - cdf).max(), (cdf - np.arange(n) / n).max())
    print(f"KS statistic {d:.5f} over {n} draws (1% critical value {1.63 / np.sqrt(n):.5f})")
    assert d < 1.63 / np.sqrt(n)
    assert abs(x.mean() - 0.5772157) < 0.03 and abs(x.var() - np.pi ** 2 / 6) < 0.06


def _unit(**kw):
    return tgen.TransformerGenerator(**DIMS, dtype="float32", device="cpu", **kw)


def test_sampled_predict_advances_the_request_counter_and_keeps_the_prefix_cache():
    """The reference's tests/test_generate.py:215, :224 and :415: a sampled
    unit declares batch coupling and state updates, each predict moves the
    counter (so repeated prompts draw anew) and keeps every other state
    key; a greedy unit declares neither and returns no state."""
    assert not _unit().batch_coupled and not _unit().updates_state_on_predict
    unit = _unit(max_new_tokens=8, temperature=1.0, prefix_tokens="4,9,2")
    assert unit.batch_coupled and unit.updates_state_on_predict
    state = unit.init_state(None)
    assert int(state["requests"]) == 0 and "prefix_cache" in state
    X = torch.zeros(2, 4)
    y1, aux1 = unit.predict(state, X)
    y2, aux2 = unit.predict(aux1.state, X)
    assert int(aux2.state["requests"]) == 2 and "prefix_cache" in aux2.state
    assert aux2.state["prefix_cache"] is state["prefix_cache"]
    assert not torch.equal(y1, y2)
    again, _ = unit.predict(state, X)  # the same counter replays the same answer
    assert torch.equal(again, y1)
    assert isinstance(_unit(max_new_tokens=4).predict(_unit().init_state(None), X), torch.Tensor)


def _sampled_doc(**params):
    params = {**{k: v for k, v in DIMS.items()}, "dtype": "float32", "max_new_tokens": 8,
              "temperature": 0.9, "top_k": 20, "top_p": 0.95, "seed": 4, **params}
    return {"spec": {"name": "sampled", "predictors": [{
        "name": "main", "graph": {"name": "gen", "type": "MODEL"},
        "components": [{"name": "gen", "runtime": "inprocess",
                        "class_path": "TransformerGenerator",
                        "parameters": [{"name": k, "value": str(v),
                                        "type": "FLOAT" if isinstance(v, float) else
                                        "STRING" if isinstance(v, str) else "INT"}
                                       for k, v in params.items()]}]}]}}


@pytest.mark.parametrize("lane", ["static", "continuous"])
def test_engine_sampled_requests_differ_and_a_fresh_engine_replays_them(lane, monkeypatch):
    """Two identical sampled requests get different tokens (the request
    counter on the static lane, the sequence counter on the continuous
    lane); a fresh engine with the same seed answers the same two.  The
    static lane serves a sampled unit without a MicroBatcher."""
    if lane == "static":
        monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    body = json.dumps({"data": {"ndarray": _prompt((2, 5), 3).astype(float).tolist()}})
    answers = []
    for _ in range(2):
        engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(
            _sampled_doc())), device="cpu")
        try:
            assert (engine.batcher is None) == (lane == "static")
            got = []
            for _ in range(2):
                text, status = asyncio.run(engine.predict_json(body))
                assert status == 200
                got.append(np.asarray(json.loads(text)["data"]["ndarray"]))
            if lane == "static":
                assert int(engine.states()["gen"]["requests"]) == 2
        finally:
            engine.close()
        assert got[0].shape == (2, 8) and (got[0] != got[1]).any()
        answers.append(got)
    np.testing.assert_array_equal(answers[0], answers[1])


def test_greedy_units_keep_the_batcher_and_its_padding(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(
        _sampled_doc(temperature=0.0))), device="cpu")
    try:
        assert isinstance(engine.batcher, MicroBatcher)
        assert engine.batcher.snapshot()["max_inflight"] > 1
    finally:
        engine.close()


def test_a_unit_that_updates_state_gets_no_padding_nor_pipelining():
    """Batchable but stateful (a unit that only counts its rows): no
    batcher, so no pad rows and no pipelining; dispatches one at a time,
    the state written back after each."""
    from seldon_core_tpu_torch.graph.units import Unit, UnitAux, register_unit

    @register_unit("_RowCounter")
    class RowCounter(Unit):
        updates_state_on_predict = True

        def init_state(self, rng):
            return {"rows": torch.zeros((), dtype=torch.int64)}

        def predict(self, state, X):
            return X[:, :1] + 0.0, UnitAux(state={"rows": state["rows"] + X.shape[0]})

    doc = {"spec": {"name": "count", "predictors": [{
        "name": "main", "graph": {"name": "c", "type": "MODEL"},
        "components": [{"name": "c", "runtime": "inprocess", "class_path": "_RowCounter"}],
    }]}}
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        assert engine.batcher is None

        async def burst():
            return await asyncio.gather(*(engine.predict_json(json.dumps(
                {"data": {"ndarray": [[1.0, 2.0]] * n}})) for n in (1, 2, 3)))

        assert all(status == 200 for _, status in asyncio.run(burst()))
        assert int(engine.states()["c"]["rows"]) == 6  # no pad row entered the state
    finally:
        engine.close()


# -- the shared prefix ---------------------------------------------------------------

def _prefix_units(prefix_tokens, **kw):
    """The reference's unit and the port's on the reference's weights; the
    port builds its own prefix cache from them in init_state."""
    junit = jgen.TransformerGenerator(**DIMS, dtype="float32", prefix_tokens=prefix_tokens, **kw)
    jstate = junit.init_state(jax.random.key(17))
    unit = _unit(prefix_tokens=prefix_tokens, **kw)
    state = unit.init_state(None)
    state["params"] = params_from_jax(_np(jstate["params"]), device="cpu")
    _, state["prefix_cache"] = tgen.prefill(
        state["params"], torch.tensor([unit.prefix_ids], dtype=torch.int32),
        tgen.init_cache(TCFG, 1, len(unit.prefix_ids), "cpu"), TCFG, unit.use_flash)
    return junit, jstate, unit, state


@pytest.mark.parametrize("prefix_tokens", ["4, 9, 2", "5,1,33,8,21,40,2,7,19"])
def test_prefix_cache_and_tokens_match_the_reference(prefix_tokens):
    """The prefix cache the port's init_state path builds equals the
    reference's within 1e-5; predict's tokens are identical (f32 greedy);
    the stream's concatenation equals predict."""
    junit, jstate, unit, state = _prefix_units(prefix_tokens, max_new_tokens=7)
    for li, layer in jstate["prefix_cache"].items():
        for kk, arr in layer.items():
            np.testing.assert_allclose(state["prefix_cache"][li][kk].numpy(), np.asarray(arr),
                                       atol=1e-5, rtol=1e-5)
    X = _prompt((3, 5), 12).astype(np.float32)
    want = np.asarray(junit.predict(jstate, jnp.asarray(X)))
    got = unit.predict(state, torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), want)
    streamed = np.concatenate([c.numpy() for c in unit.stream_tokens(state, X, chunk=3)], axis=1)
    np.testing.assert_array_equal(streamed, want)


def test_prefix_answer_equals_generating_over_the_concatenation():
    """The reference's own property (tests/test_generate.py:326): positions
    are global, so a prefix's answer is the concatenated prompt's."""
    _, tp = _weights(3)
    rng = np.random.default_rng(11)
    prefix_ids = rng.integers(0, 48, size=(6,)).tolist()
    sufs = torch.from_numpy(rng.integers(0, 48, size=(3, 5)).astype(np.int32))
    full = torch.cat([torch.tensor([prefix_ids], dtype=torch.int32).expand(3, 6), sufs], dim=1)
    want = tgen.generate(tp, full, TCFG, max_new_tokens=10)
    _, pc = tgen.prefill(tp, torch.tensor([prefix_ids], dtype=torch.int32),
                         tgen.init_cache(TCFG, 1, 6, "cpu"), TCFG)
    assert torch.equal(tgen.generate(tp, sufs, TCFG, max_new_tokens=10, prefix=pc), want)
    streamed = torch.cat(list(tgen.stream_chunks(tp, sufs, TCFG, 10, chunk=4, prefix=pc)), dim=1)
    assert torch.equal(streamed, want)


def test_prefix_chunked_merge_path_matches_the_reference(monkeypatch):
    """max_new past GEN_CHUNK_CAP: the P + S cache zero-padded to main_len
    and chunks merged into it, on both sides (tests/test_generate.py:378)."""
    jp, tp = _weights(3)
    rng = np.random.default_rng(21)
    prefix_ids = rng.integers(0, 48, size=(6,)).tolist()
    sufs = rng.integers(0, 48, size=(2, 5)).astype(np.int32)
    _, jpc = jgen.prefill(jp, jnp.asarray([prefix_ids], jnp.int32), jgen.init_cache(JCFG, 1, 6),
                          JCFG)
    _, tpc = tgen.prefill(tp, torch.tensor([prefix_ids], dtype=torch.int32),
                          tgen.init_cache(TCFG, 1, 6, "cpu"), TCFG)
    monkeypatch.setattr(jgen, "GEN_CHUNK_CAP", 4)
    monkeypatch.setattr(tgen, "GEN_CHUNK_CAP", 4)
    want = np.asarray(jgen.generate(jp, jnp.asarray(sufs), JCFG, max_new_tokens=13, prefix=jpc))
    got = tgen.generate(tp, torch.from_numpy(sufs), TCFG, max_new_tokens=13, prefix=tpc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_forward_matches_the_reference_segment():
    """A causal segment at offset P over a prefix-filled cache: logits of
    every position within 1e-4 and the written cache within 2e-5."""
    jp, tp = _weights(4)
    prefix = _prompt((1, 6), 30)
    sufs = _prompt((2, 5), 31)
    _, jpc = jgen.prefill(jp, jnp.asarray(prefix), jgen.init_cache(JCFG, 1, 6), JCFG)
    _, tpc = tgen.prefill(tp, torch.from_numpy(prefix), tgen.init_cache(TCFG, 1, 6, "cpu"), TCFG)
    jl, jmain = jgen.segment_forward(jp, jnp.asarray(sufs), jgen.build_prefix_main(jpc, 2, 11,
                                                                                     JCFG),
                                     6, JCFG, segment=True)
    tl, tmain = tgen.segment_forward(tp, torch.from_numpy(sufs),
                                     tgen.build_prefix_main(tpc, 2, 11, TCFG), 6, TCFG,
                                     segment=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    _assert_cache_close(tmain, jmain)
