"""The port's int8 serving paths (ROADMAP Queue 1 item [2q]) against the
JAX package on the CPU: ``ops/quant.py`` (weights, W8A16 and W8A8 products,
the quantized MNIST unit), the int8 K/V quantizer, the int8 two-tier and
paged attention's plain versions with their scale planes, and greedy f32
generation at ``quant`` / ``kv_quant`` int8 on the static lane.  Inputs are
numpy arrays from a seed; weights and states carry across with
``params_from_jax``.  Quantizers are held bit for bit, integer products
exactly, float products to an f32 tolerance stated at each test, greedy
f32 tokens exactly.  The int8-K/V kernels themselves are held to these
plain versions on the card (the ``cuda`` tests below, and chip_smoke.py
phase 10k)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.models.transformer import lm_apply as t_lm_apply
from seldon_core_tpu_torch.ops import flash_decode as fd
from seldon_core_tpu_torch.ops import kv_write as kw
from seldon_core_tpu_torch.ops import quant as tq

jq = importlib.import_module("seldon_core_tpu.ops.quant")
jgen = importlib.import_module("seldon_core_tpu.models.generate")
jtr = importlib.import_module("seldon_core_tpu.models.transformer")
jmnist = importlib.import_module("seldon_core_tpu.models.mnist")
tgen = importlib.import_module("seldon_core_tpu_torch.models.generate")
tmnist = importlib.import_module("seldon_core_tpu_torch.models.mnist")

DIMS = dict(vocab=48, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)
# f32 products summed in another order than XLA's
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tied_rows(rng, rows, hd):
    """Rows whose absmax is 127 (scale exactly 1), the rest halfway
    between codes: round-half-to-even decides every one."""
    x = rng.integers(-126, 126, size=(rows, hd)).astype(np.float32) + 0.5
    x[:, 0] = 127.0
    return x


# -- weights -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_is_bit_identical(dtype):
    """Host numpy on both sides: the codes and scales are the reference's
    bit for bit, for f32 weights, bf16 weights (widened exactly), a zero
    column (the 1e-12 floor) and columns of ties."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 4:8] = _tied_rows(rng, 4, 64).T
    jw = jnp.asarray(w, dtype)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    jw_q, js = jq.quantize_weight(jw)
    tw_q, ts = tq.quantize_weight(tw)
    assert tw_q.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    # a JAX bf16 array, as params_from_jax hands it over, by its bits
    aw_q, as_ = tq.quantize_weight(np.asarray(jw))
    np.testing.assert_array_equal(aw_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(as_.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_lm_params_is_bit_identical_and_carries_across(dtype):
    """Every layer's wqkv, wo, w1 and w2 become {name}_q / {name}_s, the
    rest passes through; the port's tree equals the reference's leaf for
    leaf, and the reference's quantized tree carries across unchanged
    (params_from_jax keeps int8 and f32 leaves)."""
    cfg = JConfig(**DIMS, dtype=getattr(jnp, dtype))
    jp = jax_lm_init(jax.random.key(1), cfg)
    want = _np(jq.quantize_lm_params(jp))
    got = tq.quantize_lm_params(params_from_jax(_np(jp), device="cpu"))
    carried = params_from_jax(want, device="cpu")
    assert set(got) == set(want)
    for key, val in want.items():
        if not isinstance(val, dict):
            continue
        assert set(got[key]) == set(val) == {"ln1", "ln2", "wqkv_q", "wqkv_s", "wo_q", "wo_s",
                                             "w1_q", "w1_s", "w2_q", "w2_s"}
        for name, arr in val.items():
            for tree in (got, carried):
                t = tree[key][name]
                if name.endswith("_q"):
                    assert t.dtype == torch.int8
                if name.endswith("_s"):
                    assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.float().numpy(), np.asarray(arr, np.float32))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 24), (2, 3, 24), (24,)], ids=["2d", "3d", "1d"])
def test_dequant_matmul_matches(x_dtype, shape):
    """bf16 operands (x rounds to bf16 where it is f32), exact products,
    f32 sums (in another order: ATOL), the scale on the f32 output, one
    cast; a rank-1 x gives a rank-1 result."""
    rng = np.random.default_rng(2)
    w_q, s = jq.quantize_weight(rng.normal(size=(24, 10)).astype(np.float32))
    x = rng.normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x, x_dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    tw_q, ts = torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(s))
    for out in (None, jnp.bfloat16):
        want = np.asarray(jq.dequant_matmul(jx, w_q, s, out_dtype=out), np.float32)
        got = tq.dequant_matmul(tx, tw_q, ts, out_dtype=None if out is None else torch.bfloat16)
        assert got.shape == want.shape and got.dtype == (torch.float32 if out is None
                                                         else torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL if out is None else 1e-2,
                                   rtol=ATOL if out is None else 1e-2)


def test_quant_matmul_is_exact():
    """The W8A8 product: the row codes and the integer sums are exact on
    both sides, so the f32 results are the same bits."""
    rng = np.random.default_rng(3)
    w_q, s = jq.quantize_weight(rng.normal(size=(40, 12)).astype(np.float32))
    x = rng.normal(size=(2, 3, 40)).astype(np.float32)
    x[0, 0] = _tied_rows(rng, 1, 40)[0]
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), w_q, s))
    got = tq.quant_matmul(torch.from_numpy(x), torch.from_numpy(np.array(w_q)),
                          torch.from_numpy(np.array(s)))
    assert got.shape == want.shape == (2, 3, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_matmul_dispatches_on_quantization():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    w_q, s = tq.quantize_weight(torch.from_numpy(w))
    h = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    dense = tq.lm_matmul({"wo": torch.from_numpy(w)}, "wo", h, out_dtype=torch.bfloat16)
    assert dense.dtype == torch.bfloat16
    np.testing.assert_allclose(dense.float().numpy(), (h.numpy() @ w), atol=5e-2, rtol=1e-2)
    quant = tq.lm_matmul({"wo_q": w_q, "wo_s": s}, "wo", h)
    np.testing.assert_array_equal(quant.numpy(), tq.dequant_matmul(h, w_q, s).numpy())


def test_quantized_mlp_matches_and_agrees_with_the_dense_unit():
    """QuantizedMnistClassifier: its state is the dense unit's quantized,
    its probabilities the JAX unit's (ATOL), and against the f32 dense
    unit, probabilities within 0.05 and argmax agreement >= 0.95 on random
    rows, as tests/test_quant.py:76 asks of the JAX units."""
    kwargs = dict(hidden=64, depth=2, dtype="float32", use_pallas="never")
    jf32 = jmnist.MnistClassifier(**kwargs)
    jqu = jmnist.QuantizedMnistClassifier(**kwargs)
    jstate = jf32.init_state(jax.random.key(0))
    jqstate = jqu.init_state(jax.random.key(0))
    tqu = tmnist.QuantizedMnistClassifier(**kwargs, device="cpu")
    tf32 = tmnist.MnistClassifier(**kwargs, device="cpu")
    dense = params_from_jax(_np(jstate), device="cpu")
    tqstate = tq.quantize_mlp_params(dense)
    for k, v in _np(jqstate).items():
        np.testing.assert_array_equal(tqstate[k].numpy(), v)
    X = np.random.default_rng(2).normal(size=(256, 784)).astype(np.float32)
    want = np.asarray(jqu.predict(jqstate, jnp.asarray(X)))
    got = tqu.predict(tqstate, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    p_f32 = tf32.predict(dense, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    assert np.abs(p_f32 - got).max() < 0.05
    assert (p_f32.argmax(1) == got.argmax(1)).mean() >= 0.95
    assert tqu.path == "int8"


# -- the int8 K/V cache --------------------------------------------------------


def test_quantize_kv_is_bit_identical():
    """Per token per head over hd, in f32, true divisions, half to even:
    codes and scales the reference's bit for bit (ties, a zero row, bf16
    and f32 inputs)."""
    rng = np.random.default_rng(5)
    t = rng.normal(size=(2, 3, 7, 16)).astype(np.float32) * 3
    t[0, 0, :4] = _tied_rows(rng, 4, 16)
    t[1, 2, 5] = 0.0
    for dtype in (jnp.float32, jnp.bfloat16):
        jt = jnp.asarray(t, dtype)
        want_q, want_s = jgen._quantize_kv(jt)
        tt = torch.from_numpy(np.array(jt.astype(jnp.float32)))
        if dtype == jnp.bfloat16:
            tt = tt.to(torch.bfloat16)
        got_q, got_s = kw.quantize_kv(tt)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                      np.asarray(want_s).view(np.uint32))


def _int8_layer(rng, B, KV, L, hd):
    q, s = jgen._quantize_kv(jnp.asarray(rng.normal(size=(B, KV, L, hd)).astype(np.float32)))
    return np.array(q), np.array(s)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_main,n_chunk", [(9, 3), (9, 0), (6, 4)])
def test_int8_two_tier_plain_version_matches_the_reference(q_dtype, n_main, n_chunk):
    """flash_decode_two_tier's plain version with scale planes against the
    reference's _attend_two_tier over int8 layers (main masked where n_main
    is short, the chunk's own slot written first through the quantizer):
    the write bit for bit, o to ATOL in f32 (bf16: one bf16 ulp)."""
    rng = np.random.default_rng(6)
    B, KV, G, hd, Lm, C = 2, 2, 3, 8, 9, 5
    mk, mks = _int8_layer(rng, B, KV, Lm, hd)
    mv, mvs = _int8_layer(rng, B, KV, Lm, hd)
    ck, cks = _int8_layer(rng, B, KV, C, hd)
    cv, cvs = _int8_layer(rng, B, KV, C, hd)
    q = rng.normal(size=(B, KV * G, 1, hd)).astype(np.float32)
    kn, vn = (3 * rng.normal(size=(B, KV, 1, hd)).astype(np.float32) for _ in range(2))
    jd = getattr(jnp, q_dtype)
    jq_, jkn, jvn = (jnp.asarray(a, jd) for a in (q, kn, vn))
    # the reference's block writes the step's row, then attends
    wk, wks = jgen._quantize_kv(jkn)
    wv, wvs = jgen._quantize_kv(jvn)
    main = {"k": mk, "v": mv, "k_s": mks, "v_s": mvs}
    chunk = {"k": ck, "v": cv, "k_s": cks, "v_s": cvs}
    slot = n_chunk - 1 if n_chunk else n_main - 1
    tgt = chunk if n_chunk else main
    want_layer = {"k": tgt["k"].copy(), "v": tgt["v"].copy(), "k_s": tgt["k_s"].copy(),
                  "v_s": tgt["v_s"].copy()}
    for name, val in (("k", wk), ("v", wv), ("k_s", wks), ("v_s", wvs)):
        want_layer[name][:, :, slot] = np.asarray(val)[:, :, 0]
    jmain = {k: jnp.asarray(want_layer[k] if tgt is main else v) for k, v in main.items()}
    jchunk = {k: jnp.asarray(want_layer[k] if tgt is chunk else v) for k, v in chunk.items()}
    want = jgen._attend_two_tier(jq_, jmain, jchunk, n_main, n_chunk if n_chunk else 0,
                                 main_full=n_main == Lm)
    td = getattr(torch, q_dtype)
    tl = {k: torch.from_numpy(v.copy()) for k, v in (("mk", mk), ("mv", mv), ("mks", mks),
                                                        ("mvs", mvs), ("ck", ck), ("cv", cv),
                                                        ("cks", cks), ("cvs", cvs))}
    qg = torch.from_numpy(np.array(jq_.astype(jnp.float32))).to(td).reshape(B, KV, G, hd)
    tkn, tvn = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(td) for a in (jkn, jvn))
    got = fd.flash_decode_two_tier(qg, tl["mk"], tl["mv"], n_main, tl["ck"], tl["cv"], n_chunk,
                                   tkn, tvn, (tl["mks"], tl["mvs"], tl["cks"], tl["cvs"]))
    written = ({"k": tl["ck"], "v": tl["cv"], "k_s": tl["cks"], "v_s": tl["cvs"]} if n_chunk
               else {"k": tl["mk"], "v": tl["mv"], "k_s": tl["mks"], "v_s": tl["mvs"]})
    for name, arr in want_layer.items():
        np.testing.assert_array_equal(written[name].numpy(), arr)
    tol = ATOL if q_dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().reshape(B, KV * G, 1, hd).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_int8_single_tier_plain_version_matches_the_reference():
    """flash_decode_reference with scales: the reference's _attend_cached
    over an int8 layer (p times v_s before its cast to q's dtype)."""
    rng = np.random.default_rng(7)
    B, KV, G, hd, L = 2, 2, 2, 8, 11
    k, ks = _int8_layer(rng, B, KV, L, hd)
    v, vs = _int8_layer(rng, B, KV, L, hd)
    q = rng.normal(size=(B, KV * G, 1, hd)).astype(np.float32)
    want = jgen._attend_cached(jnp.asarray(q), {"k": k, "v": v, "k_s": ks, "v_s": vs}, 7)
    got = fd.flash_decode_reference(torch.from_numpy(q).reshape(B, KV, G, hd),
                                    torch.from_numpy(k), torch.from_numpy(v), 7,
                                    torch.from_numpy(ks), torch.from_numpy(vs))
    np.testing.assert_allclose(got.reshape(B, KV * G, 1, hd).numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)


def test_int8_cache_layout_and_refusals():
    """init_cache / init_chunk at kv_quant int8: int8 K/V and f32 scale
    planes [B, KV, L], as the reference; the two-tier wrapper refuses int8
    caches without their scales, and float caches with scales."""
    cfg = TConfig(**DIMS, dtype=torch.float32, kv_quant="int8")
    cache = tgen.init_cache(cfg, 2, 5, "cpu")
    jcache = jgen.init_cache(JConfig(**DIMS, dtype=jnp.float32, kv_quant="int8"), 2, 5)
    for li, layer in jcache.items():
        assert set(cache[li]) == set(layer)
        for kk, arr in layer.items():
            assert tuple(cache[li][kk].shape) == arr.shape
            assert str(cache[li][kk].dtype).split(".")[-1] == str(arr.dtype)
    assert tgen.init_chunk(cfg, 2, 3, "cpu")["l1"]["v_s"].shape == (2, 2, 3)
    layer = cache["l0"]
    q = torch.zeros(2, 2, 2, 8)
    with pytest.raises(ValueError, match="take their scales"):
        fd.flash_decode_two_tier(q, layer["k"], layer["v"], 5, layer["k"][:, :, :0],
                                 layer["v"][:, :, :0], 0)
    f = torch.zeros(2, 2, 5, 8)
    with pytest.raises(ValueError, match="take their scales"):
        fd.flash_decode_two_tier(q, f, f, 5, f[:, :, :0], f[:, :, :0], 0,
                                 scales=(layer["k_s"],) * 4)


def _gen_weights(quant, seed=2):
    jcfg = JConfig(**DIMS, dtype=jnp.float32, quant=quant)
    jp = jax_lm_init(jax.random.key(seed), jcfg)
    tp = params_from_jax(_np(jp), device="cpu")
    if quant == "int8":
        jp, tp = jq.quantize_lm_params(jp), tq.quantize_lm_params(tp)
    return jp, tp


QUANTS = [("none", "int8"), ("int8", "none"), ("int8", "int8")]


@pytest.mark.parametrize("quant,kv_quant", QUANTS, ids=["kv", "weights", "both"])
@pytest.mark.parametrize("new", [9, 13], ids=["one-chunk", "merged"])
def test_int8_greedy_generate_is_token_identical(quant, kv_quant, new, monkeypatch):
    """f32 greedy tokens identical to the JAX generate at int8 weights, int8
    K/V and both; "merged" takes GEN_CHUNK_CAP 4 on both sides, so chunks
    (and their scale planes) merge into main."""
    if new == 13:
        monkeypatch.setattr(jgen, "GEN_CHUNK_CAP", 4)
        monkeypatch.setattr(tgen, "GEN_CHUNK_CAP", 4)
    jcfg = JConfig(**DIMS, dtype=jnp.float32, quant=quant, kv_quant=kv_quant)
    tcfg = TConfig(**DIMS, dtype=torch.float32, quant=quant, kv_quant=kv_quant)
    jp, tp = _gen_weights(quant)
    prompt = np.random.default_rng(8).integers(0, DIMS["vocab"], size=(3, 6)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jgen.generate(p, t, jcfg, max_new_tokens=new))(
        jp, jnp.asarray(prompt)))
    for use_flash in (False, True):  # on the CPU the wrappers run their plain versions
        got = tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=new,
                            use_flash=use_flash)
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_prefill_cache_and_stream_match_the_reference():
    """The prefill stores its exact K/V quantized (codes and scales bit for
    bit); the stream's grow_merge carries the scale planes and its tokens
    are generate's."""
    jcfg = JConfig(**DIMS, dtype=jnp.float32, kv_quant="int8")
    tcfg = TConfig(**DIMS, dtype=torch.float32, kv_quant="int8")
    jp, tp = _gen_weights("none", seed=4)
    prompt = np.random.default_rng(9).integers(0, DIMS["vocab"], size=(2, 7)).astype(np.int32)
    _, jcache = jax.jit(jgen.prefill, static_argnums=(3,))(
        jp, jnp.asarray(prompt), jgen.init_cache(jcfg, 2, 7), jcfg)
    _, tcache = tgen.prefill(tp, torch.from_numpy(prompt), tgen.init_cache(tcfg, 2, 7, "cpu"),
                             tcfg)
    for li, layer in jcache.items():
        for kk in ("k", "v", "k_s", "v_s"):
            got, want = tcache[li][kk].numpy(), np.asarray(layer[kk])
            if kk.endswith("_s"):
                # f32 scales of f32 K/V computed in another order upstream
                np.testing.assert_allclose(got, want, rtol=1e-5)
            else:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    want = np.asarray(tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=20))
    chunks = list(tgen.stream_chunks(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=20,
                                     chunk=8))
    np.testing.assert_array_equal(np.concatenate([c.numpy() for c in chunks], axis=1), want)


def test_int8_prefix_generate_matches_the_reference():
    """tests/test_generate.py:431's case: an int8 prefix cache (prefilled
    quantized) broadcast under the suffix's causal segment, which attends
    the stored codes; tokens identical to the reference's."""
    jcfg = JConfig(**DIMS, dtype=jnp.float32, quant="int8", kv_quant="int8")
    tcfg = TConfig(**DIMS, dtype=torch.float32, quant="int8", kv_quant="int8")
    jp, tp = _gen_weights("int8", seed=6)
    rng = np.random.default_rng(10)
    ids = rng.integers(0, DIMS["vocab"], size=(1, 9)).astype(np.int32)
    suffix = rng.integers(0, DIMS["vocab"], size=(2, 5)).astype(np.int32)
    _, jpc = jgen.prefill(jp, jnp.asarray(ids), jgen.init_cache(jcfg, 1, 9), jcfg)
    tpc = params_from_jax(_np(jpc), device="cpu")
    assert tpc["l0"]["k"].dtype == torch.int8 and tpc["l0"]["k_s"].shape == (1, 2, 9)
    want = np.asarray(jgen.generate(jp, jnp.asarray(suffix), jcfg, max_new_tokens=8,
                                    prefix=jpc))
    got = tgen.generate(tp, torch.from_numpy(suffix), tcfg, max_new_tokens=8, prefix=tpc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_teacher_forcing_and_the_lm_unit_match():
    """lm_apply over int8 weights (every layer matmul W8A16) against the
    reference's, and the TransformerLM unit quantizing after its load."""
    jcfg = JConfig(**DIMS, dtype=jnp.float32, quant="int8")
    tcfg = TConfig(**DIMS, dtype=torch.float32, quant="int8")
    jp, tp = _gen_weights("int8", seed=7)
    tokens = np.random.default_rng(11).integers(0, DIMS["vocab"], size=(2, 9)).astype(np.int32)
    want = np.asarray(jtr.lm_apply(jp, jnp.asarray(tokens), jcfg))
    got = t_lm_apply(tp, torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    from seldon_core_tpu_torch.models.transformer import TransformerLM

    unit = TransformerLM(**{k: v for k, v in DIMS.items()}, dtype="float32", quant="int8",
                         device="cpu")
    state = unit.init_state(None)
    assert state["l0"]["wqkv_q"].dtype == torch.int8 and "wqkv" not in state["l0"]


def test_lm_train_step_keeps_refusing_int8_weights():
    from seldon_core_tpu_torch.models.transformer import lm_train_step
    from seldon_core_tpu_torch.optim import adam

    tcfg = TConfig(**DIMS, dtype=torch.float32, quant="int8")
    with pytest.raises(ValueError, match="requires quant='none'"):
        lm_train_step({}, None, {"tokens": torch.zeros(1, 3, dtype=torch.int32)}, adam(1e-3),
                      tcfg)


def test_the_generator_unit_serves_int8_and_speculative_keeps_its_guard():
    """The unit at quant and kv_quant int8 quantizes after its load and
    answers the JAX unit's tokens on the same state; speculative decoding
    still refuses an int8 cache, in both packages' words."""
    unit = tgen.TransformerGenerator(**DIMS, dtype="float32", device="cpu", max_new_tokens=7,
                                     quant="int8", kv_quant="int8")
    junit = jgen.TransformerGenerator(**DIMS, dtype="float32", max_new_tokens=7, quant="int8",
                                      kv_quant="int8")
    jstate = junit.init_state(jax.random.key(0))
    state = params_from_jax(_np(jstate), device="cpu")
    X = np.random.default_rng(12).integers(0, DIMS["vocab"], size=(2, 6)).astype(np.float32)
    np.testing.assert_array_equal(unit.predict(state, torch.from_numpy(X)).numpy(),
                                  np.asarray(junit.predict(jstate, jnp.asarray(X))))
    own = unit.init_state(None)
    assert own["params"]["l1"]["w2_q"].dtype == torch.int8
    from seldon_core_tpu_torch.models.speculative import speculative_generate

    tcfg = TConfig(**DIMS, dtype=torch.float32, kv_quant="int8")
    with pytest.raises(NotImplementedError, match="float KV caches"):
        speculative_generate({}, {}, torch.zeros(1, 3, dtype=torch.int32), tcfg, tcfg)


# -- on the card -------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the int8-K/V kernels have no CPU mode)")
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


def _card_inputs(gen, B, KV, G, hd, dev):
    """q at twice the cache rows' spread (scores of std ~2, so the cache
    walk carries o), the fresh k at twice, the fresh v with a spike of 32
    at column 0 (its codes far from its exact values), as chip_smoke.py's
    int8 phase draws them."""
    q = (2 * torch.randn(B, KV, G, hd, generator=gen)).to(torch.bfloat16).to(dev)
    kn = (2 * torch.randn(B, KV, 1, hd, generator=gen)).to(torch.bfloat16).to(dev)
    vn = torch.randn(B, KV, 1, hd, generator=gen)
    vn[..., 0] = 32.0
    return q, kn, vn.to(torch.bfloat16).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4, 4, 64, 512, 512, 63, 32), (1, 4, 4, 64, 640, 640, 63, 0),
                                   (4, 2, 4, 16, 100, 100, 15, 9), (1, 4, 4, 64, 512, 150, 63, 3),
                                   (4, 2, 4, 128, 256, 201, 31, 7), (2, 4, 1, 256, 256, 130, 15, 5),
                                   (8, 8, 1, 64, 512, 333, 31, 11), (2, 1, 16, 64, 512, 250, 31, 6)],
                         ids=["served", "one-row-main", "hd16", "unaligned-main", "hd128",
                              "hd256-group1", "group1", "group16"])
def test_int8_two_tier_kernel_matches_plain_on_card(shape):
    """The int8-K/V variant of flash_decode_two_tier with the step's write
    fused in: the written codes and scales bit for bit, o within 2 bf16
    ulps of max(1, |o|) of the plain version (chip_smoke.py's FLASH_O_ATOL,
    relative above |o| = 1), a repeat the same bits."""
    _need_card()
    B, KV, G, hd, Lm, n_main, C, n_chunk = shape
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(sum(shape))
    caches = [t for L in (Lm, Lm, C, C) for t in kw.int8_kv_rows((B, KV, L, hd), gen, dev)]
    mk, mks, mv, mvs, ck, cks, cv, cvs = caches
    q, kn, vn = _card_inputs(gen, B, KV, G, hd, dev)
    ref = [t.clone() for t in caches]
    want = fd.flash_decode_two_tier_reference(q, ref[0], ref[2], n_main, ref[4], ref[6], n_chunk,
                                              kn, vn, (ref[1], ref[3], ref[5], ref[7]))
    before = fd.I8_LAUNCHES
    got = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, kn, vn,
                                   (mks, mvs, cks, cvs))
    again = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, kn, vn,
                                     (mks, mvs, cks, cvs))
    torch.cuda.synchronize()
    assert fd.I8_LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(caches, ref))
    err = ((got.float() - want.float()).abs() / want.float().abs().clamp_min(1.0)).max()
    assert float(err) <= 1.6e-2 and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mains", [(403, 298), (512, 517)], ids=["cluster", "served"])
def test_int8_two_tier_kernel_bits_do_not_depend_on_where_main_ends(n_mains):
    """One stream's positions, main[:n_main] ++ chunk[:n - n_main], with
    main ending at two points that are not multiples of 4 (the slots past
    them hold other codes): the int8 variant gives the same bits and
    writes the same fresh codes and scales, as its tiles start at fixed
    positions of the stream."""
    _need_card()
    B, n = (2, 440) if n_mains[0] == 403 else (32, 560)
    KV, G, hd = 4, 4, 64
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(n)
    (gk, gks), (gv, gvs) = (kw.int8_kv_rows((B, KV, n, hd), gen, dev) for _ in range(2))
    q, kn, vn = _card_inputs(gen, B, KV, G, hd, dev)
    outs, written = [], []
    for n_main in n_mains:
        segs = []
        for t in (gk, gv, gks, gvs):
            main, chunk = t.clone(), t.clone().roll(1, dims=2)
            main[:, :, n_main:] = t.roll(7, dims=2)[:, :, n_main:]
            chunk[:, :, :n - n_main] = t[:, :, n_main:]
            segs.append((main, chunk))
        (mk, ck), (mv, cv), (mks, cks), (mvs, cvs) = segs
        outs.append(fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n - n_main, kn, vn,
                                             (mks, mvs, cks, cvs)))
        written.append([t[:, :, n - n_main - 1] for t in (ck, cv, cks, cvs)])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*written))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(32, 4, 4, 64, 64, (560,) * 32), (5, 4, 4, 64, 64, (1, 17, 300, 560, 1009)),
                                  (4, 2, 4, 16, 16, (1, 60, 200, 256)),
                                  (4, 2, 4, 128, 32, (1, 100, 333, 512)),
                                  (3, 2, 2, 256, 16, (17, 250, 256)),
                                  (6, 8, 1, 64, 40, (1, 15, 16, 17, 600, 640)),
                                  (3, 1, 16, 64, 40, (64, 300, 640))],
                         ids=["served", "ragged", "hd16", "hd128", "hd256", "group1", "group16"])
def test_int8_paged_kernel_matches_plain_on_card(case):
    """The int8-K/V variant of flash_decode_paged with the step's write
    fused in (the last row inactive): the pools and scale planes bit for
    bit outside the scratch block, o of the active rows within 2 bf16 ulps
    of max(1, |o|), a repeat the same bits."""
    _need_card()
    B, KV, G, hd, nblk, lens = case
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(sum(case[:5]))
    N = B * nblk + 1
    pools = [t for _ in range(2) for t in kw.int8_kv_rows((N, KV, 16, hd), gen, dev)]
    pk, pks, pv, pvs = pools
    q, kn, vn = _card_inputs(gen, B, KV, G, hd, dev)
    tables = (torch.randperm(N - 1, generator=gen)[: B * nblk] + 1).reshape(B, nblk)
    tables = tables.to(torch.int32).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    valid = torch.arange(B, device=dev) < B - 1
    ref = [t.clone() for t in pools]
    want = fd.flash_decode_paged_reference(q, ref[0], ref[2], tables, lens_t, kn, vn, valid,
                                           (ref[1], ref[3]))
    got = fd.flash_decode_paged(q, pk, pv, tables, lens_t, kn, vn, valid, (pks, pvs))
    again = fd.flash_decode_paged(q, pk, pv, tables, lens_t, kn, vn, valid, (pks, pvs))
    torch.cuda.synchronize()
    assert all(torch.equal(a[1:], b[1:]) for a, b in zip(pools, ref))
    err = ((got[valid].float() - want[valid].float()).abs()
           / want[valid].float().abs().clamp_min(1.0)).max()
    assert float(err) <= 1.6e-2 and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("copy", [False, True], ids=["quantize", "copy"])
@pytest.mark.parametrize("KV,hd,W", [(4, 64, 1), (4, 64, 128), (4, 64, 512), (16, 64, 5),
                                     (4, 64, 127), (2, 128, 130), (8, 32, 130), (2, 256, 127),
                                     (16, 256, 5), (2, 16, 128)])
def test_int8_kv_write_paged_kernel_is_bit_exact_on_card(KV, hd, W, copy):
    """kv_write_paged's int8 variant: bf16 head views quantized in the
    launch, or int8 rows with their scales copied, at W = 1, 5, 127, 128,
    130 and 512 and hd 16 to 256, with starts a multiple of neither bs nor
    W, a row with every position invalid and a table entry outside the
    pool (kv_write.paged_write_inputs): codes and scales bit for bit with
    the plain version outside the scratch block, in place."""
    _need_card()
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(KV + hd + W + copy)
    x = kw.paged_write_inputs(32, KV, W, hd, -(-(W + 40) // 16), gen, dev, int8=True,
                              copy=copy)
    want = kw.paged_write_expected(x)
    pools = x.pools + x.planes
    ptrs, before = [t.data_ptr() for t in pools], kw.PAGED_I8_LAUNCHES
    kw.kv_write_paged(*x.pools, x.k, x.v, x.tables, x.start, x.valid, tuple(x.planes), x.k_s,
                      x.v_s)
    torch.cuda.synchronize()
    assert kw.PAGED_I8_LAUNCHES == before + 1 and [t.data_ptr() for t in pools] == ptrs
    assert all(torch.equal(a[1:], b[1:x.N]) for a, b in zip(pools, want))
