"""The port's decode-lane kernels' plain versions against the JAX package:
``flash_decode`` (seldon_core_tpu_torch/ops/flash_decode.py) against the
Pallas kernel in interpret mode, as tests/test_flash_decode.py runs it;
``flash_decode_two_tier`` against ``_attend_two_tier``; ``kv_write``
against ``jax.lax.dynamic_update_slice``; and the decode lane's wiring.

On the CPU the wrappers run their plain versions, so these tests hold
those to the TPU kernels' arithmetic.  The CUDA kernels themselves are
held to the plain versions on the card (the ``cuda`` tests below, and
chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from seldon_core_tpu_torch.ops import flash_decode as fd
from seldon_core_tpu_torch.ops import kv_write as kw

jgen = importlib.import_module("seldon_core_tpu.models.generate")
tgen = importlib.import_module("seldon_core_tpu_torch.models.generate")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("kv,g", [(8, 1), (2, 4)])
def test_flash_decode_matches_pallas_interpret(kv, g):
    rng = np.random.default_rng(0)
    B, hd, L = 2, 64, 256
    q, k, v = _normal(rng, B, kv, g, hd), _normal(rng, B, kv, L, hd), _normal(rng, B, kv, L, hd)
    n_valid = 130  # mid-block mask boundary
    want = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_valid,
                                       interpret=True))
    got = fd.flash_decode(*_t(q, k, v), n_valid)
    assert got.shape == (B, kv, g, hd) and got.dtype == torch.float32
    # the JAX test's tolerance (tests/test_flash_decode.py:26): f32
    # throughout, only the order of the f32 sums differs
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n_valid", [1, 256])
def test_flash_decode_full_valid_and_single_position(n_valid):
    rng = np.random.default_rng(1)
    B, kv, g, hd, L = 2, 2, 4, 64, 256
    q, k, v = _normal(rng, B, kv, g, hd), _normal(rng, B, kv, L, hd), _normal(rng, B, kv, L, hd)
    want = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_valid,
                                       interpret=True))
    got = fd.flash_decode(*_t(q, k, v), n_valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("q_shape,k_shape,match", [
    ((1, 1, 1, 32), (1, 1, 100, 32), "divisible"),
    ((1, 1, 1, 32), (1, 2, 128, 32), "mismatch"),
    ((1, 1, 1, 32), (1, 1, 128), "bad shapes"),
    ((1, 1, 1, 512), (1, 1, 128, 512), "head dim"),
])
def test_flash_decode_constraints_carry_the_jax_messages(q_shape, k_shape, match):
    """The ValueErrors of ``test_flash_decode_constraints`` (and the head-dim
    rule), raised by both packages with the same text."""
    q, k = np.zeros(q_shape, np.float32), np.zeros(k_shape, np.float32)
    with pytest.raises(ValueError, match=match) as want:
        jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), 5, interpret=True)
    with pytest.raises(ValueError, match=match) as got:
        fd.flash_decode(*_t(q, k, k), 5)
    assert str(got.value) == str(want.value)


# (B, KV, G, hd, main length, n_main, chunk slots, n_chunk): main full and
# not, ragged counts, main lengths that are not multiples of 128, MHA
TWO_TIER = [(2, 2, 4, 32, 100, 100, 63, 5), (2, 2, 4, 32, 200, 130, 8, 8),
            (1, 4, 1, 16, 257, 257, 16, 1), (3, 1, 8, 64, 37, 20, 12, 11)]


@pytest.mark.parametrize("case", TWO_TIER, ids=[str(c) for c in TWO_TIER])
def test_two_tier_matches_jax_attend_two_tier(case):
    B, KV, G, hd, Lm, n_main, C, n_chunk = case
    rng = np.random.default_rng(sum(case))
    q = _normal(rng, B, KV, G, hd)
    mk, mv = _normal(rng, B, KV, Lm, hd), _normal(rng, B, KV, Lm, hd)
    ck, cv = _normal(rng, B, KV, C, hd), _normal(rng, B, KV, C, hd)
    main_full = n_main == Lm
    want = np.asarray(jax.jit(jgen._attend_two_tier, static_argnums=(5,))(
        jnp.asarray(q).reshape(B, KV * G, 1, hd), {"k": jnp.asarray(mk), "v": jnp.asarray(mv)},
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, n_main, n_chunk, main_full))
    got = fd.flash_decode_two_tier(*_t(q, mk, mv), n_main, *_t(ck, cv), n_chunk)
    np.testing.assert_allclose(got.reshape(B, KV * G, 1, hd).numpy(), want, rtol=2e-5, atol=2e-6)


def test_two_tier_bf16_matches_jax_within_a_bf16_rounding():
    """bf16 caches: both cast the unnormalised p to bf16 before the f32 PV
    products and round o to bf16; their f32 sums run in other orders, which
    can move a rounding of p or o by one bf16 ulp (2^-7 at |o| ~ 1)."""
    B, KV, G, hd, Lm, n_main, C, n_chunk = 2, 2, 4, 64, 100, 100, 63, 17
    rng = np.random.default_rng(7)
    arrays = [_normal(rng, B, KV, G, hd), _normal(rng, B, KV, Lm, hd), _normal(rng, B, KV, Lm, hd),
              _normal(rng, B, KV, C, hd), _normal(rng, B, KV, C, hd)]
    jq, jmk, jmv, jck, jcv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays)
    tq, tmk, tmv, tck, tcv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    want = jgen._attend_two_tier(jq.reshape(B, KV * G, 1, hd), {"k": jmk, "v": jmv},
                                 {"k": jck, "v": jcv}, n_main, n_chunk, True)
    got = fd.flash_decode_two_tier(tq, tmk, tmv, n_main, tck, tcv, n_chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().reshape(B, KV * G, 1, hd).numpy(),
                               np.asarray(want, dtype=np.float32), atol=1.6e-2, rtol=1e-2)


def test_two_tier_over_one_segment_is_flash_decode():
    """A second segment of length 0 is ``flash_decode`` over the first."""
    rng = np.random.default_rng(3)
    q, k, v = _normal(rng, 2, 2, 4, 32), _normal(rng, 2, 2, 128, 32), _normal(rng, 2, 2, 128, 32)
    one = fd.flash_decode(*_t(q, k, v), 77)
    two = fd.flash_decode_two_tier(*_t(q, k[:, :, :77], v[:, :, :77]), 77, *_t(k, v), 0)
    torch.testing.assert_close(two, one, atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("n_main,n_chunk,match", [(101, 3, "n_main=101"), (5, 9, "n_chunk=9"),
                                                  (-1, 3, "n_main=-1")])
def test_two_tier_refuses_counts_outside_the_segments(n_main, n_chunk, match):
    q, main, chunk = torch.zeros(1, 1, 1, 16), torch.zeros(1, 1, 100, 16), torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match=match):
        fd.flash_decode_two_tier(q, main, main, n_main, chunk, chunk, n_chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 11])
def test_kv_write_matches_dynamic_update_slice_in_place(pos, dtype):
    """Bit-exact against ``jax.lax.dynamic_update_slice`` at the first, a
    middle and the last slot; the caches stay the same tensors, and k/v
    may be strided head views (a transpose of a slice of the qkv product)."""
    B, KV, C, hd = 2, 3, 12, 16
    rng = np.random.default_rng(pos)
    ck, cv = _normal(rng, B, KV, C, hd), _normal(rng, B, KV, C, hd)
    qkv = _normal(rng, B, 1, (1 + 2 * KV) * hd)
    tck, tcv = (torch.from_numpy(a).to(dtype) for a in (ck, cv))
    tqkv = torch.from_numpy(qkv).to(dtype)
    _, k, v = torch.split(tqkv, [hd, KV * hd, KV * hd], dim=-1)
    k, v = tgen.heads(k, B, 1, KV, hd), tgen.heads(v, B, 1, KV, hd)
    assert not k.is_contiguous()
    ids = (id(tck), tck.data_ptr(), id(tcv), tcv.data_ptr())
    out_k, out_v = kw.kv_write(tck, tcv, k, v, pos)
    assert (id(out_k), out_k.data_ptr(), id(out_v), out_v.data_ptr()) == ids
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for cache, new, got in ((ck, k, tck), (cv, v, tcv)):
        want = jax.lax.dynamic_update_slice(jnp.asarray(cache, jdt),
                                            jnp.asarray(new.float().numpy(), jdt), (0, 0, pos, 0))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("bad,match", [
    (dict(pos=12), "outside"), (dict(pos=-1), "outside"),
    (dict(k=torch.zeros(2, 3, 2, 16)), "k/v must be"),
    (dict(cache_v=torch.zeros(2, 3, 11, 16)), "one shape"),
    (dict(v=torch.zeros(2, 3, 1, 16, dtype=torch.float64)), "float64"),
])
def test_kv_write_refuses_bad_slots_and_shapes(bad, match):
    args = dict(cache_k=torch.zeros(2, 3, 12, 16), cache_v=torch.zeros(2, 3, 12, 16),
                k=torch.zeros(2, 3, 1, 16), v=torch.zeros(2, 3, 1, 16), pos=0)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        kw.kv_write(**args)


def test_decode_lane_takes_the_kernel_wrappers_only_with_use_flash(monkeypatch):
    """``use_flash`` picks the wrapper statically (which launches the
    kernel for CUDA tensors): one ``flash_decode_two_tier`` call a layer,
    the step's K/V write fused in, and no ``kv_write``; without it the
    decode step calls the plain version directly (which does the slot's
    slice assignment, then the plain attention).  On the CPU both give the
    same logits."""
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_init

    cfg = LMConfig(vocab=32, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
                   dtype=torch.float32)
    params = lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []
    for name in ("flash_decode_two_tier", "flash_decode_two_tier_reference",
                 "kv_write_reference"):
        orig = getattr(tgen, name)
        monkeypatch.setattr(tgen, name, lambda *a, _n=name, _f=orig: calls.append(_n) or _f(*a))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 32, (2, 5)).astype(np.int32))
    out = {}
    for use_flash in (True, False):
        calls.clear()
        _, main = tgen.prefill(params, prompt, tgen.init_cache(cfg, 2, 5, "cpu"), cfg)
        chunk = tgen.init_chunk(cfg, 2, 3, "cpu")
        logits, _ = tgen.decode_step_two_tier(params, torch.tensor([1, 2]), main, chunk, 5, 0, cfg,
                                              use_flash)
        out[use_flash] = logits
        want = (["flash_decode_two_tier"] if use_flash
                else ["flash_decode_two_tier_reference"])
        assert calls == want * cfg.n_layers
    torch.testing.assert_close(out[True], out[False], atol=0, rtol=0)
    assert fd.LAUNCHES == 0 and kw.LAUNCHES == 0  # CPU tensors: no kernel


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        orig = getattr(tgen, name)
        monkeypatch.setattr(tgen, name, lambda *a, _n=name, _f=orig: calls.append(_n) or _f(*a))
    return calls


@pytest.mark.parametrize("L", [100, 128])
def test_single_tier_decode_step_takes_the_wrapper_at_any_cache_length(monkeypatch, L):
    """``decode_step`` with ``use_flash`` calls the kernel wrapper in every
    layer whatever the cache length (no L % 128 gate), and gives the
    plain path's logits on the CPU."""
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_init

    cfg = LMConfig(vocab=32, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
                   dtype=torch.float32)
    params = lm_init(torch.Generator().manual_seed(1), cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (2, 7)).astype(np.int32))
    calls = _spy(monkeypatch, ("flash_decode_two_tier", "flash_decode_reference"))
    out = {}
    for use_flash in (True, False):
        calls.clear()
        _, cache = tgen.prefill(params, prompt, tgen.init_cache(cfg, 2, L, "cpu"), cfg)
        out[use_flash], _ = tgen.decode_step(params, torch.tensor([3, 4]), cache, 7, cfg,
                                             use_flash)
        want = "flash_decode_two_tier" if use_flash else "flash_decode_reference"
        assert calls == [want] * cfg.n_layers
    torch.testing.assert_close(out[True], out[False], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [6, 128])
def test_single_tier_decode_step_with_use_flash_matches_jax(S):
    """``decode_step`` with ``use_flash`` (``flash_decode_two_tier`` over
    the cache and an empty chunk, at any cache length, and ``kv_write``)
    against the JAX package's ``decode_step``."""
    from seldon_core_tpu.models.transformer import LMConfig as JConfig
    from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
    from seldon_core_tpu_torch.convert import params_from_jax
    from seldon_core_tpu_torch.models.transformer import LMConfig

    dims = dict(vocab=48, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)
    jcfg, tcfg = JConfig(**dims, dtype=jnp.float32), LMConfig(**dims, dtype=torch.float32)
    jp = jax_lm_init(jax.random.key(4), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    L = S + 2 if S % 128 else S + 128
    prompt = np.random.default_rng(5).integers(0, 48, (2, S)).astype(np.int32)
    _, jcache = jax.jit(jgen.prefill, static_argnums=(3,))(
        jp, jnp.asarray(prompt), jgen.init_cache(jcfg, 2, L), jcfg)
    _, tcache = tgen.prefill(tp, torch.from_numpy(prompt), tgen.init_cache(tcfg, 2, L, "cpu"), tcfg)
    token = np.array([1, 9], np.int32)
    jl, _ = jax.jit(jgen.decode_step, static_argnums=(4,))(jp, jnp.asarray(token), jcache, S, jcfg)
    tl, tcache = tgen.decode_step(tp, torch.from_numpy(token), tcache, S, tcfg, use_flash=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


# (B, KV, G, n_total): the served layer at the first and last decode step,
# the 1-row stream, short caches that stay whole, a long MHA cache, G = 5
SPLIT_CASES = [(32, 4, 4, 513), (32, 4, 4, 575), (1, 4, 4, 529), (1, 4, 4, 640), (1, 4, 4, 17),
               (1, 4, 4, 1), (4, 4, 4, 129), (8, 16, 1, 4096), (2, 2, 5, 300)]


def _bounds(split, span, n_total):
    """Block r's positions [r*span, min((r+1)*span, n_total)), as the kernel
    takes them (flash_decode.cu: p0 = rank * span)."""
    return [(r * span, min((r + 1) * span, n_total)) for r in range(split)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[str(c) for c in SPLIT_CASES])
def test_split_plan_covers_every_position_once(case):
    B, KV, G, n = case
    split, span = fd.decode_split_plan(B, KV, G, n, sm_count=132)
    bounds = _bounds(split, span, n)
    assert split in (1, 2, 4, 8)
    covered = [j for lo, hi in bounds for j in range(lo, hi)]
    assert covered == list(range(n))          # each position once, in order
    assert all(hi > lo for lo, hi in bounds)  # no block without positions
    assert all(hi - lo == span for lo, hi in bounds[:-1])
    if split > 1:
        assert span >= fd._MIN_SPAN


def _slot_of(n_main, n_chunk, span, slots):
    """(segment, index) -> (block, slot, step) as the kernel assigns them:
    by the global index j over main ++ chunk."""
    where = {}
    for j in range(n_main + n_chunk):
        seg = ("main", j) if j < n_main else ("chunk", j - n_main)
        where[seg] = (j // span, (j % span) % slots, (j % span) // slots)
    return where


@pytest.mark.parametrize("n_total", [529, 575, 640])
def test_split_plan_ignores_where_main_ends(n_total):
    """A stream whose chunk buffer is merged into main at another point
    asks the same plan, and every position lands on the same block, slot
    and step: the kernel's sums run in the same order, so the bits match."""
    plans, orders = set(), []
    for n_main in (n_total - 1, 512, 320, 64, 0):
        n_chunk = n_total - n_main
        split, span = fd.decode_split_plan(1, 4, 4, n_main + n_chunk, 132)
        plans.add((split, span, tuple(_bounds(split, span, n_total))))
        where = _slot_of(n_main, n_chunk, span, slots=32)
        orders.append([where[("main", j) if j < n_main else ("chunk", j - n_main)]
                       for j in range(n_total)])
    assert len(plans) == 1
    assert all(order == orders[0] for order in orders)


@pytest.mark.parametrize("B,n_total", [(1, 529), (1, 575), (2, 640)])
def test_split_plan_fills_more_than_the_kv_blocks_at_small_batch(B, n_total):
    """The 1-row stream: the unsplit grid is B x KV = 4 blocks on 132 SMs."""
    split, _ = fd.decode_split_plan(B, 4, 4, n_total, 132)
    assert B * 4 * split > 4 * B and split == 8


def test_split_plan_aims_at_one_and_a_half_blocks_per_sm_at_the_served_batch():
    split, span = fd.decode_split_plan(32, 4, 4, 544, 132)
    assert (split, span) == (2, 272) and 32 * 4 * split >= 1.5 * 132


def _partial(q, k, v):
    """One block's (m, l, acc) over its positions, f32: q [G, hd], k/v [n, hd]."""
    s = (q @ k.T) / np.sqrt(q.shape[-1])
    m = s.max(axis=-1)
    p = np.exp(s - m[:, None])
    return m, p.sum(axis=-1), p @ v


@pytest.mark.parametrize("case", [(1, 4, 4, 529), (1, 4, 4, 640), (32, 4, 4, 575), (4, 4, 4, 129)])
def test_split_then_combine_in_rank_order_is_the_unsplit_softmax(case):
    """The kernel's cluster combine, emulated in f32: each block's (m, l,
    acc) over its share, then M = max m_r, O = sum_r acc_r exp(m_r - M),
    L = sum_r l_r exp(m_r - M) in rank order, o = O / L, against one
    softmax over all positions."""
    B, KV, G, n = case
    rng = np.random.default_rng(n)
    hd = 64
    q = rng.standard_normal((G, hd)).astype(np.float32)
    k = rng.standard_normal((n, hd)).astype(np.float32)
    v = rng.standard_normal((n, hd)).astype(np.float32)
    split, span = fd.decode_split_plan(B, KV, G, n, 132)
    parts = [_partial(q, k[lo:hi], v[lo:hi]) for lo, hi in _bounds(split, span, n)]
    M = np.max([m for m, _, _ in parts], axis=0)
    L = np.zeros(G, np.float32)
    O = np.zeros((G, hd), np.float32)
    for m, l, acc in parts:
        w = np.exp(m - M).astype(np.float32)
        L = L + l * w
        O = O + acc * w[:, None]
    m, l, acc = _partial(q, k, v)
    np.testing.assert_allclose(O / L[:, None], acc / l[:, None], rtol=0, atol=1e-6)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


# the served layer, and MHA at hd 256 (8 slots and one row a block: the
# layout whose mbarriers are rounded up to 8 bytes)
ON_CARD = [(32, 4, 4, 64, 512, 512, 63, 32), (4, 16, 1, 256, 512, 512, 63, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TWO_TIER + ON_CARD,
                         ids=[str(c) for c in TWO_TIER] + ["served", "mha-hd256"])
def test_kernel_matches_plain_on_card(case):
    _need_card()
    B, KV, G, hd, Lm, n_main, C, n_chunk = case
    gen = torch.Generator().manual_seed(sum(case))
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16).to(dev)

    q, mk, mv, ck, cv = (rnd(B, KV, G, hd), rnd(B, KV, Lm, hd), rnd(B, KV, Lm, hd),
                         rnd(B, KV, C, hd), rnd(B, KV, C, hd))
    before = fd.LAUNCHES
    got = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk)
    again = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk)
    want = fd.flash_decode_two_tier_reference(q, mk, mv, n_main, ck, cv, n_chunk)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before + 2
    # p rounds to bf16 at running (kernel) vs global (plain) maxima, and o
    # to bf16: 2 bf16 ulps at |o| ~ 1, as FLASH_O_ATOL in chip_smoke.py
    assert float((got.float() - want.float()).abs().max()) <= 1.6e-2
    assert torch.equal(got, again)


# (B, KV, G, hd, main slots, n_main, chunk slots, n_chunk): the 1-row
# stream at 1 and 17 positions (a cluster of 1), 309 (4) and 529 and 640
# (8), and the served batch (a cluster of 2)
SPLIT_ON_CARD = [(1, 4, 4, 64, 512, 0, 63, 1), (1, 4, 4, 64, 512, 0, 63, 17),
                 (1, 4, 4, 64, 640, 640, 63, 0), (1, 4, 4, 64, 512, 512, 63, 17),
                 (1, 4, 4, 64, 512, 300, 63, 9), (32, 4, 4, 64, 512, 512, 63, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_ON_CARD, ids=[str(c) for c in SPLIT_ON_CARD])
def test_split_kernel_repeats_bits_and_launches_once(case):
    """Each call one launch, a repeat the same bits, and the same bits when
    main ends elsewhere (the positions moved from main into the chunk)."""
    _need_card()
    B, KV, G, hd, Lm, n_main, C, n_chunk = case
    gen = torch.Generator().manual_seed(sum(case))
    dev = torch.device("cuda")
    q = torch.randn(B, KV, G, hd, generator=gen).to(torch.bfloat16).to(dev)
    kk = torch.randn(B, KV, Lm + C, hd, generator=gen).to(torch.bfloat16).to(dev)
    vv = torch.randn(B, KV, Lm + C, hd, generator=gen).to(torch.bfloat16).to(dev)
    n = n_main + n_chunk
    before = fd.LAUNCHES
    got = fd.flash_decode_two_tier(q, kk, vv, n, kk[:, :, n:], vv[:, :, n:], 0)
    again = fd.flash_decode_two_tier(q, kk, vv, n, kk[:, :, n:], vv[:, :, n:], 0)
    cut = n // 3
    moved = fd.flash_decode_two_tier(q, kk, vv, cut, kk[:, :, cut:], vv[:, :, cut:], n - cut)
    want = fd.flash_decode_two_tier_reference(q, kk, vv, n, kk[:, :, n:], vv[:, :, n:], 0)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before + 3
    assert float((got.float() - want.float()).abs().max()) <= 1.6e-2
    assert torch.equal(got, again) and torch.equal(got, moved)


@pytest.mark.cuda
def test_kv_write_kernel_is_bit_exact_on_card():
    _need_card()
    dev = torch.device("cuda")
    ck = torch.randn(4, 2, 9, 64, device=dev).to(torch.bfloat16)
    cv = torch.randn(4, 2, 9, 64, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(4, 2, 1, 64, device=dev).to(torch.bfloat16) for _ in range(2))
    want_k, want_v = kw.kv_write_reference(ck.clone(), cv.clone(), k, v, 7)
    before = kw.LAUNCHES
    kw.kv_write(ck, cv, k, v, 7)
    torch.cuda.synchronize()
    assert kw.LAUNCHES == before + 1
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)


@pytest.mark.cuda
def test_decode_kernel_refuses_what_it_cannot_take():
    _need_card()
    assert "bfloat16" in fd.decode_kernel_shape_error(64, torch.float32)
    assert "multiple of 8" in fd.decode_kernel_shape_error(36, torch.bfloat16)
    assert fd.decode_kernel_shape_error(64, torch.bfloat16, 4) is None


@pytest.mark.cuda
def test_single_tier_decode_step_launches_once_per_layer_on_card():
    """At a cache length of 100 (not a multiple of 128) ``decode_step``
    with ``use_flash`` launches the decode kernel once per layer (the
    step's K/V write fused in: no ``kv_write`` launch), and its logits stay
    near the plain path's."""
    _need_card()
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_init

    dev = torch.device("cuda")
    cfg = LMConfig(vocab=64, d_model=128, n_heads=4, n_kv_heads=2, n_layers=3, d_ff=256,
                   dtype=torch.bfloat16)
    params = lm_init(torch.Generator().manual_seed(2), cfg, dev)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (2, 40)).astype(np.int32))
    out = {}
    for use_flash in (True, False):
        _, cache = tgen.prefill(params, prompt.to(dev), tgen.init_cache(cfg, 2, 100, dev), cfg)
        before = fd.LAUNCHES
        before_kw = kw.LAUNCHES
        out[use_flash], _ = tgen.decode_step(params, torch.tensor([3, 4], device=dev), cache, 40,
                                             cfg, use_flash)
        torch.cuda.synchronize()
        assert fd.LAUNCHES - before == (cfg.n_layers if use_flash else 0)
        assert kw.LAUNCHES == before_kw  # the step's write is fused into the decode launch
    assert torch.isfinite(out[True]).all()
    # bf16 logits: the kernel and the plain path round p and o differently
    assert float((out[True] - out[False]).abs().max()) <= 0.125


# (B, KV, G, hd, main length, n_main, chunk slots, n_chunk before the step):
# the fresh row into the chunk (at its first, a middle and its last slot),
# and with an empty chunk into main's last valid slot (n_chunk = -1: the
# step's position is n_main - 1, and the chunk takes nothing)
FUSED = [(2, 2, 4, 32, 100, 100, 8, 0), (2, 2, 4, 32, 200, 130, 8, 5), (1, 4, 1, 16, 64, 64, 16, 15),
         (2, 2, 4, 32, 100, 37, 8, -1), (3, 1, 8, 64, 40, 40, 4, -1)]


def _fused_case(case, dtype):
    """numpy inputs of one fused case, and the JAX side: the step's write by
    ``jax.lax.dynamic_update_slice`` (``_block_two_tier``,
    generate.py:305-320, into main's slot n_main - 1 for an empty chunk),
    then ``_attend_two_tier`` over main[:n_main] + chunk[:n_chunk + 1]."""
    B, KV, G, hd, Lm, n_main, C, n_chunk = case
    rng = np.random.default_rng(sum(case) + 11)
    arrays = [_normal(rng, B, KV, G, hd), _normal(rng, B, KV, Lm, hd), _normal(rng, B, KV, Lm, hd),
              _normal(rng, B, KV, C, hd), _normal(rng, B, KV, C, hd),
              _normal(rng, B, KV, 1, hd), _normal(rng, B, KV, 1, hd)]
    jq, jmk, jmv, jck, jcv, jkn, jvn = (jnp.asarray(a, dtype=dtype) for a in arrays)
    if n_chunk >= 0:
        jck = jax.lax.dynamic_update_slice(jck, jkn, (0, 0, n_chunk, 0))
        jcv = jax.lax.dynamic_update_slice(jcv, jvn, (0, 0, n_chunk, 0))
    else:
        jmk = jax.lax.dynamic_update_slice(jmk, jkn, (0, 0, n_main - 1, 0))
        jmv = jax.lax.dynamic_update_slice(jmv, jvn, (0, 0, n_main - 1, 0))
    want = jgen._attend_two_tier(jq.reshape(B, KV * G, 1, hd), {"k": jmk, "v": jmv},
                                 {"k": jck, "v": jcv}, n_main, n_chunk + 1, False)
    return arrays, (jmk, jmv, jck, jcv), want


@pytest.mark.parametrize("case", FUSED, ids=[str(c) for c in FUSED])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_two_tier_matches_jax_write_then_attend(case, dtype):
    """``flash_decode_two_tier`` with k_new/v_new (its plain version on the
    CPU) writes the step's row where ``_block_two_tier``'s
    ``dynamic_update_slice`` does, bit for bit, and attends as
    ``_attend_two_tier`` over the written caches: f32 within the JAX test's
    tolerance (only the order of the f32 sums differs), bf16 within a bf16
    rounding of p or o (2^-7 at |o| ~ 1)."""
    B, KV, G, hd, Lm, n_main, C, n_chunk = case
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    arrays, jcaches, want = _fused_case(case, jdt)
    q, mk, mv, ck, cv, kn, vn = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk + 1, kn, vn)
    for t, j in zip((mk, mv, ck, cv), jcaches):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, dtype=np.float32))
    got = got.float().reshape(B, KV * G, 1, hd).numpy()
    want = np.asarray(want, dtype=np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, atol=1.6e-2, rtol=1e-2)


@pytest.mark.parametrize("bad,match", [
    (dict(k_new=None), "go together"),
    (dict(v_new=None), "go together"),
    (dict(k_new=torch.zeros(2, 2, 2, 16)), r"k_new must be .*\(2, 2, 1, 16\)"),
    (dict(v_new=torch.zeros(2, 2, 1, 8)), r"v_new must be .*\(2, 2, 1, 16\)"),
    (dict(k_new=torch.zeros(2, 2, 1, 16, dtype=torch.float64)), "k_new must be torch.float32"),
    (dict(v_new=torch.zeros(2, 2, 1, 16, device="meta")), "v_new is on meta"),
    (dict(n_main=0, n_chunk=0), "needs a position"),
])
def test_fused_two_tier_refuses_bad_fresh_rows(bad, match):
    """The wrapper checks k_new/v_new before any launch: both or neither,
    [B, KV, 1, hd] in the caches' dtype, on q's device, and a position to
    write."""
    args = dict(q=torch.zeros(2, 2, 4, 16), main_k=torch.zeros(2, 2, 10, 16),
                main_v=torch.zeros(2, 2, 10, 16), n_main=10, chunk_k=torch.zeros(2, 2, 4, 16),
                chunk_v=torch.zeros(2, 2, 4, 16), n_chunk=2, k_new=torch.zeros(2, 2, 1, 16),
                v_new=torch.zeros(2, 2, 1, 16))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        fd.flash_decode_two_tier(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunk", [1, 32, 63, 0])
def test_fused_two_tier_call_on_card(n_chunk):
    """The served layer (B=32, 4 kv heads x 4, hd 64, main 512) with the
    step's write fused in: the caches bit-exact against ``kv_write_reference``
    (the chunk's slot n_chunk - 1, or main's last with an empty chunk), o
    within a bf16 rounding of write-then-attend, a repeat the same bits, one
    launch and no kv_write launch."""
    _need_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_chunk)
    q, mk, mv = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
                 for s in ((32, 4, 4, 64), (32, 4, 512, 64), (32, 4, 512, 64)))
    ck, cv = (torch.randn(32, 4, 63, 64, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    qkv = torch.randn(32, 1, 6 * 4 * 64, generator=g, device=dev).to(torch.bfloat16)
    kn = qkv[..., 4 * 256:5 * 256].reshape(32, 1, 4, 64).transpose(1, 2)  # strided head views
    vn = qkv[..., 5 * 256:].reshape(32, 1, 4, 64).transpose(1, 2)
    ref = [t.clone() for t in (mk, mv, ck, cv)]
    want = fd.flash_decode_two_tier_reference(q, *ref[:2], 512, *ref[2:], n_chunk, kn, vn)
    before = (fd.LAUNCHES, kw.LAUNCHES)
    got = fd.flash_decode_two_tier(q, mk, mv, 512, ck, cv, n_chunk, kn, vn)
    again = fd.flash_decode_two_tier(q, mk, mv, 512, ck, cv, n_chunk, kn, vn)
    torch.cuda.synchronize()
    assert (fd.LAUNCHES - before[0], kw.LAUNCHES - before[1]) == (2, 0)
    assert all(torch.equal(t, r) for t, r in zip((mk, mv, ck, cv), ref))
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= 1.6e-2
