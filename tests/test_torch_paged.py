"""The port's paged KV pool (seldon_core_tpu_torch/models/generate.py) and
the plain versions of the continuous lane's two kernels against the JAX
package's paged programs (``seldon_core_tpu/models/generate.py:985-1210``),
on the same pool contents, tables and positions, made with numpy from a
seed, and the same weights (carried across by ``params_from_jax``).

The port lays a pool out as [N, KV, bs, hd] (the reference as [N, bs, KV,
hd]), so pools are compared transposed and views as they are.  Writes are
held bit for bit, attention within an f32 tolerance, greedy tokens
exactly; so are the shared prefix's pool writes and the speculative
round's tokens, and a sampled round is held to the reference's greedy
round where truncation keeps one token, and to rows independent of their
batch.  The CUDA kernels are held to the plain versions on the card
(the ``cuda`` tests below, and chip_smoke.py)."""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import prng as tprng
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.ops import flash_decode as fd
from seldon_core_tpu_torch.ops import kv_write as kw

jgen = importlib.import_module("seldon_core_tpu.models.generate")
tgen = importlib.import_module("seldon_core_tpu_torch.models.generate")

# the reference's tests/test_genserver.py CFG (MHA), and a GQA variant
DIMS = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64)
GQA = dict(DIMS, n_kv_heads=2)
# f32 throughout; only the order of the f32 sums differs
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(dims):
    return JConfig(**dims, dtype=jnp.float32), TConfig(**dims, dtype=torch.float32)


def _weights(jcfg, seed=3):
    jp = jax_lm_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _pool_pair(tcfg, N, bs, rng):
    """The same random pool contents in both layouts: (jax pool, port pool)."""
    KV, hd = tcfg.kv_heads, tcfg.head_dim
    jpool, tpool = {}, {}
    for i in range(tcfg.n_layers):
        k = rng.normal(size=(N, KV, bs, hd)).astype(np.float32)
        v = rng.normal(size=(N, KV, bs, hd)).astype(np.float32)
        tpool[f"l{i}"] = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
        jpool[f"l{i}"] = {"k": jnp.asarray(k.transpose(0, 2, 1, 3)),
                          "v": jnp.asarray(v.transpose(0, 2, 1, 3))}
    return jpool, tpool


def _tables(rng, B, nblk, N):
    """Distinct non-scratch blocks for every row, in a random order."""
    ids = rng.permutation(np.arange(1, N))[: B * nblk]
    return ids.reshape(B, nblk).astype(np.int32)


def _same_pool(tpool, jpool):
    for li, layer in jpool.items():
        for name in ("k", "v"):
            np.testing.assert_array_equal(tpool[li][name].numpy(),
                                          np.asarray(layer[name]).transpose(0, 2, 1, 3))


def _t32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


def test_init_block_pool_layout_scratch_and_refusals(monkeypatch):
    _, tcfg = _cfgs(GQA)
    pool = tgen.init_block_pool(tcfg, 5, 4, "cpu")
    assert set(pool) == {"l0", "l1"}
    assert pool["l0"]["k"].shape == (5, 2, 4, 8) and pool["l0"]["k"].dtype == torch.float32
    assert not pool["l0"]["v"].any()
    # int8 pools (item [2q], refused until it was ported) carry scale
    # planes, [N, KV, bs] where the reference's are [N, bs, KV]
    ipool = tgen.init_block_pool(TConfig(**GQA, kv_quant="int8"), 5, 4, "cpu")
    jpool = jgen.init_block_pool(JConfig(**GQA, kv_quant="int8"), 5, 4)
    assert set(ipool["l0"]) == set(jpool["l0"]) == {"k", "v", "k_s", "v_s"}
    assert ipool["l0"]["k"].dtype == torch.int8 and ipool["l0"]["k"].shape == (5, 2, 4, 8)
    assert ipool["l0"]["v_s"].dtype == torch.float32 and ipool["l0"]["v_s"].shape == (5, 2, 4)
    assert jpool["l0"]["v_s"].shape == (5, 4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.init_block_pool(tcfg, 5, 4)


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
def test_paged_write_matches_bit_for_bit_with_scratch_rows(dims):
    """Row 1's positions are not valid: they land in the scratch block at
    distinct offsets, so even scratch is compared bit for bit; positions
    cross block boundaries."""
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(0)
    N, bs, B, W, nblk = 12, 8, 3, 5, 3
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    # scratch takes offsets 0-4 (row 1) and 7 (row 2's last position)
    start = np.array([6, 0, 3], np.int32)
    valid = np.ones((B, W), bool)
    valid[1] = False
    valid[2, 4] = False
    KV, hd = tcfg.kv_heads, tcfg.head_dim
    k = rng.normal(size=(B, KV, W, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, W, hd)).astype(np.float32)
    pos = start[:, None] + np.arange(W)[None, :]
    want = jgen._paged_write(jpool["l0"], jnp.asarray(tables), jnp.asarray(pos),
                             jnp.asarray(valid), jnp.asarray(k), jnp.asarray(v))
    got = tgen._paged_write(tpool["l0"], _t32(tables), _t32(start), torch.from_numpy(valid),
                            torch.from_numpy(k), torch.from_numpy(v))
    assert got is tpool["l0"]  # in place
    _same_pool({"l0": got}, {"l0": want})
    # the wrapper, on CPU tensors, is the same plain write
    again = {n: t.clone() for n, t in tpool["l0"].items()}
    kw.kv_write_paged(again["k"], again["v"], torch.from_numpy(k), torch.from_numpy(v),
                      _t32(tables), _t32(start), torch.from_numpy(valid))
    assert all(torch.equal(again[n], got[n]) for n in ("k", "v"))


def test_kv_write_paged_reference_against_the_reference_scatter():
    """``kv_write_paged_reference`` at W = 1 (the decode round's write,
    from strided head views) against ``_paged_write``, bit for bit, with an
    inactive row routed to scratch."""
    jcfg, tcfg = _cfgs(GQA)
    rng = np.random.default_rng(1)
    N, bs, B, nblk = 9, 4, 4, 2
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    n_valid = np.array([0, 5, 7, 3], np.int32)
    active = np.array([True, True, True, False])
    KV, hd = tcfg.kv_heads, tcfg.head_dim
    qkv = rng.normal(size=(B, 1, 3 * KV * hd)).astype(np.float32)
    k = torch.from_numpy(qkv)[..., :KV * hd].reshape(B, 1, KV, hd).transpose(1, 2)
    v = torch.from_numpy(qkv)[..., KV * hd:2 * KV * hd].reshape(B, 1, KV, hd).transpose(1, 2)
    assert not k.is_contiguous()
    want = jgen._paged_write(jpool["l0"], jnp.asarray(tables), jnp.asarray(n_valid[:, None]),
                             jnp.asarray(active[:, None]), jnp.asarray(k.numpy()),
                             jnp.asarray(v.numpy()))
    kw.kv_write_paged_reference(tpool["l0"]["k"], tpool["l0"]["v"], k, v, _t32(tables),
                                _t32(n_valid), torch.from_numpy(active[:, None]))
    _same_pool(tpool, {"l0": want, "l1": jpool["l1"]})


def test_kv_write_paged_refuses_bad_shapes_and_types():
    pk = torch.zeros(4, 2, 4, 8)
    k = torch.zeros(2, 2, 1, 8)
    ok = dict(tables=torch.zeros(2, 1, dtype=torch.int32), start=torch.zeros(2, dtype=torch.int32),
              valid=torch.ones(2, 1, dtype=torch.bool))
    for bad, match in (({"tables": torch.zeros(2, 1)}, "tables must be"),
                       ({"start": torch.zeros(3, dtype=torch.int32)}, "start must be"),
                       ({"valid": torch.ones(2, 2, dtype=torch.bool)}, "valid must be")):
        with pytest.raises(ValueError, match=match):
            kw.kv_write_paged(pk, pk.clone(), k, k, **{**ok, **bad})
    with pytest.raises(ValueError, match="k/v must be"):
        kw.kv_write_paged(pk, pk.clone(), torch.zeros(2, 3, 1, 8), torch.zeros(2, 3, 1, 8), **ok)


def test_paged_view_matches():
    jcfg, tcfg = _cfgs(GQA)
    rng = np.random.default_rng(2)
    jpool, tpool = _pool_pair(tcfg, 10, 4, rng)
    tables = _tables(rng, 3, 3, 10)
    want = jgen._paged_view(jpool["l1"], jnp.asarray(tables))
    got = tgen._paged_view(tpool["l1"], _t32(tables))
    for name in ("k", "v"):
        assert got[name].shape == (3, 2, 12, 8)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("W", [1, 5])
def test_attend_paged_matches(dims, W):
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(3 + W)
    jpool, tpool = _pool_pair(tcfg, 14, 4, rng)
    tables = _tables(rng, 3, 4, 14)
    start = np.array([0, 6, 10], np.int32)
    q = rng.normal(size=(3, tcfg.n_heads, W, tcfg.head_dim)).astype(np.float32)
    want = jgen._attend_paged(jnp.asarray(q), jgen._paged_view(jpool["l0"], jnp.asarray(tables)),
                              jnp.asarray(start))
    got = tgen._attend_paged(torch.from_numpy(q), tgen._paged_view(tpool["l0"], _t32(tables)),
                             _t32(start))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
def test_flash_decode_paged_reference_is_the_reference_decode_mask(dims):
    """The plain paged decode against ``_attend_paged`` at W = 1 with start
    = lens - 1, and against ``flash_decode_two_tier_reference`` over the
    same positions made dense; the wrapper on CPU tensors is the plain
    version, and a row's answer does not move when its blocks move."""
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(7)
    N, bs, B, nblk = 20, 4, 4, 4
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    lens = np.array([1, 7, 16, 9], np.int32)
    KV, G, hd = tcfg.kv_heads, tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    pk, pv = tpool["l0"]["k"], tpool["l0"]["v"]
    got = fd.flash_decode_paged_reference(torch.from_numpy(q), pk, pv, _t32(tables), _t32(lens))
    want = jgen._attend_paged(jnp.asarray(q.reshape(B, KV * G, 1, hd)),
                              jgen._paged_view(jpool["l0"], jnp.asarray(tables)),
                              jnp.asarray(lens - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, KV, G, hd), atol=ATOL,
                               rtol=ATOL)
    k, v = fd.paged_view(pk, pv, _t32(tables))
    for b in range(B):
        dense = fd.flash_decode_two_tier_reference(
            torch.from_numpy(q[b:b + 1]), k[b:b + 1, :, :lens[b]], v[b:b + 1, :, :lens[b]],
            int(lens[b]), k[b:b + 1, :, :0], v[b:b + 1, :, :0], 0)
        np.testing.assert_allclose(got[b:b + 1].numpy(), dense.numpy(), atol=ATOL, rtol=ATOL)
    assert torch.equal(fd.flash_decode_paged(torch.from_numpy(q), pk, pv, _t32(tables),
                                             _t32(lens)), got)
    # the same rows in other physical blocks
    perm = rng.permutation(np.arange(1, N))
    moved_k, moved_v = pk.clone(), pv.clone()
    moved_k[torch.from_numpy(perm)] = pk[1:]
    moved_v[torch.from_numpy(perm)] = pv[1:]
    moved_tables = perm[tables - 1].astype(np.int32)
    moved = fd.flash_decode_paged_reference(torch.from_numpy(q), moved_k, moved_v,
                                            _t32(moved_tables), _t32(lens))
    assert torch.equal(moved, got)


def test_flash_decode_paged_refuses_bad_arguments():
    q = torch.zeros(2, 2, 2, 8)
    pool = torch.zeros(4, 2, 4, 8)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    kn = torch.zeros(2, 2, 1, 8)
    for args, match in (((q, pool, pool, tables.long(), lens), "tables must be int32"),
                        ((q, pool, pool, tables, lens[:1]), "lens must be int32"),
                        ((q, torch.zeros(4, 3, 4, 8), torch.zeros(4, 3, 4, 8), tables, lens),
                         "q/pool mismatch"),
                        ((q, pool, pool, tables, lens, kn, None), "go together"),
                        ((q, pool, pool, tables, lens, None, None, torch.ones(2, dtype=torch.bool)),
                         "go together"),
                        ((q, pool, pool, tables, lens, kn[:, :, :, :4], kn), "k_new must be"),
                        ((q, pool, pool, tables, lens, kn, kn, torch.ones(2)), "valid must be")):
        with pytest.raises(ValueError, match=match):
            fd.flash_decode_paged(*args)


# the continuous lane's pool blocks (16 rows) and the cluster sizes the
# paged kernel plans
SHARE_NS = [1, 15, 16, 17, 560, 1024]


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("n", SHARE_NS)
def test_paged_shares_cover_the_row_in_whole_blocks(n, C):
    """Each rank's share of a row's own length: together they cover [0, n)
    once and in order, start on pool-block boundaries, the non-empty ones
    differ by at most one pool block and none holds fewer than _MIN_SPAN
    positions unless it is the only one; the empty ones sit at the end."""
    bs = 16
    shares = fd.paged_shares(n, C, bs)
    assert len(shares) == C
    assert shares[0][0] == 0 and shares[-1][1] == n
    for (_, end), (start, _) in zip(shares, shares[1:]):
        assert start == end
    full = [(a, b) for a, b in shares if b > a]
    assert full and shares[:len(full)] == full  # the empty ranks come last
    assert all(a % bs == 0 for a, _ in full)
    blocks = [-(-b // bs) - a // bs for a, b in full]
    assert max(blocks) - min(blocks) <= 1
    if len(full) > 1:
        assert min(b - a for a, b in full) >= fd._MIN_SPAN


def test_paged_shares_follow_the_row_not_the_table():
    """The split comes from the row's own length: the cluster size is the
    host's (from the table's width, the same for a 64- and a 128-block
    table at B=1), and the shares then depend on the length alone, so rank
    0 of a 560-position row takes 272 positions of a cluster of 2 where the
    table-width split gave it 512 of the 1,024 table positions."""
    for width in (64 * 16, 128 * 16):
        assert fd.paged_cluster(1, 4, 4, width, 132) == 8
    assert fd.paged_cluster(32, 4, 4, 64 * 16, 132) == 1
    assert fd.paged_cluster(16, 4, 4, 64 * 16, 132) == 2
    assert fd.paged_shares(560, 2, 16) == [(0, 272), (272, 560)]
    assert [b - a for a, b in fd.paged_shares(560, 8, 16)] == [64] * 5 + [80] * 3
    assert fd.paged_shares(17, 8, 16) == [(0, 17)] + [(17, 17)] * 7
    for n in SHARE_NS:
        assert fd.paged_shares(n, 4, 16)[0][0] == 0


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
def test_flash_decode_paged_fused_write_is_the_reference_write_and_attend(dims):
    """The fused call's plain version (the decode step's write, then the
    attention) against ``_paged_write`` + ``_attend_paged`` at W = 1 on the
    same numpy inputs, with two inactive rows (one on a scratch table, one
    on live blocks): the pools bit for bit outside the scratch block 0,
    which the reference writes for the inactive rows and the port leaves,
    and o of the active rows within ATOL; the wrapper on CPU tensors is the
    plain version."""
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(11)
    N, bs, B, nblk = 30, 4, 5, 4
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    tables[3] = 0
    lens = np.array([1, 7, 16, 5, 10], np.int32)
    active = np.array([True, True, True, False, False])
    KV, G, hd = tcfg.kv_heads, tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, 1, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, 1, hd)).astype(np.float32)
    layer = jgen._paged_write(jpool["l0"], jnp.asarray(tables), jnp.asarray(lens[:, None] - 1),
                              jnp.asarray(active[:, None]), jnp.asarray(k), jnp.asarray(v))
    want = jgen._attend_paged(jnp.asarray(q.reshape(B, KV * G, 1, hd)),
                              jgen._paged_view(layer, jnp.asarray(tables)),
                              jnp.asarray(lens - 1))
    want = np.asarray(want).reshape(B, KV, G, hd)
    pools = {}
    for name, fn in (("plain", fd.flash_decode_paged_reference), ("wrapper", fd.flash_decode_paged)):
        pk, pv = tpool["l0"]["k"].clone(), tpool["l0"]["v"].clone()
        got = fn(torch.from_numpy(q), pk, pv, _t32(tables), _t32(lens), torch.from_numpy(k),
                 torch.from_numpy(v), torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy()[active], want[active], atol=ATOL, rtol=ATOL)
        for t, ref in ((pk, layer["k"]), (pv, layer["v"])):
            np.testing.assert_array_equal(t.numpy()[1:],
                                          np.asarray(ref).transpose(0, 2, 1, 3)[1:])
        # an inactive row writes nothing: the scratch block is as it was
        np.testing.assert_array_equal(pk.numpy()[0], tpool["l0"]["k"].numpy()[0])
        pools[name] = (pk, pv, got)
    assert all(torch.equal(a, b) for a, b in zip(pools["plain"], pools["wrapper"]))


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
def test_paged_forward_matches(dims):
    """A chunked prefill step: rows at different offsets and widths (one a
    pad row of width 0), logits at each row's last valid position within
    1e-4, and the written pool as the reference's."""
    jcfg, tcfg = _cfgs(dims)
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(4)
    N, bs, B, W, nblk = 24, 4, 4, 6, 4
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    tables[3] = 0  # the pad row's table is scratch
    toks = rng.integers(0, dims["vocab"], size=(B, W)).astype(np.int32)
    start = np.array([0, 4, 9, 0], np.int32)
    width = np.array([6, 3, 5, 0], np.int32)
    for last_only in (True, False):
        jl, jpool2 = jgen.paged_forward(jp, jnp.asarray(toks), dict(jpool), jnp.asarray(tables),
                                        jnp.asarray(start), jnp.asarray(width), jcfg,
                                        last_only=last_only)
        tpool2 = {li: {n: t.clone() for n, t in layer.items()} for li, layer in tpool.items()}
        tl, tpool2 = tgen.paged_forward(tp, _t32(toks), tpool2, _t32(tables), _t32(start),
                                        _t32(width), tcfg, last_only=last_only)
        assert tl.shape == ((B, dims["vocab"]) if last_only else (B, W, dims["vocab"]))
        rows = slice(0, 3)  # the pad row's logits are garbage nobody reads
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], atol=1e-4, rtol=1e-4)
        for li, layer in jpool2.items():
            for name in ("k", "v"):
                got = tpool2[li][name].numpy()[1:]
                want = np.asarray(layer[name]).transpose(0, 2, 1, 3)[1:]
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("eos", [-1, "first"])
def test_paged_decode_round_tokens_identical(dims, eos, use_flash):
    """A round over rows at different lengths, an inactive pad row and (with
    eos) a row whose latch is already set: the same greedy tokens, and the
    same cache lengths and latches on the device afterwards.  With
    ``use_flash`` every step takes ``flash_decode_paged`` with its write
    fused in (on the CPU its plain version), where the inactive row writes
    nothing instead of the scratch block."""
    jcfg, tcfg = _cfgs(dims)
    jp, tp = _weights(jcfg, seed=5)
    rng = np.random.default_rng(5)
    N, bs, B, nblk, span = 40, 4, 4, 5, 4
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    tables[3] = 0
    token = rng.integers(0, dims["vocab"], size=(B,)).astype(np.int32)
    n_valid = np.array([3, 11, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    seen = np.array([False, True, False, False])
    if eos == "first":
        probe = jgen.paged_decode_round(
            jp, dict(jpool), jnp.asarray(tables), jnp.asarray(token), jnp.asarray(n_valid),
            jnp.asarray(active), jnp.zeros((B,), bool), jnp.zeros((B,), jnp.uint32), jcfg,
            span=span, temperature=0.0, top_k=0, top_p=0.0, eos_token=-1)[0]
        eos_token = int(np.asarray(probe)[0, 1])  # row 0 stops mid-round
    else:
        eos_token, seen = -1, np.zeros((B,), bool)
    jt, _, jtok, jnv, jseen, _ = jgen.paged_decode_round(
        jp, dict(jpool), jnp.asarray(tables), jnp.asarray(token), jnp.asarray(n_valid),
        jnp.asarray(active), jnp.asarray(seen), jnp.zeros((B,), jnp.uint32), jcfg, span=span,
        temperature=0.0, top_k=0, top_p=0.0, eos_token=eos_token)
    tt, _, ttok, tnv, tseen, _ = tgen.paged_decode_round(
        tp, tpool, _t32(tables), _t32(token), _t32(n_valid), torch.from_numpy(active),
        torch.from_numpy(seen), tcfg, span=span, eos_token=eos_token, use_flash=use_flash)
    assert tt.dtype == torch.int32 and tt.shape == (B, span)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))


def test_paged_decode_round_refuses_sampling():
    """A sampled round without the rows' keys is refused before any work:
    a shared draw would couple co-batched rows."""
    _, tcfg = _cfgs(DIMS)
    with pytest.raises(ValueError, match=r"needs per-row keys"):
        tgen.paged_decode_round({}, {}, None, None, None, None, None, tcfg, span=2,
                                temperature=0.5)


# rows of the f32 parity test: 1, 17 and 512 positions and a ragged one,
# then the float32 kernel's tiling edges (tiles of 8 positions, pool blocks
# of 16, shares of at least 64; 100 ends in a partial block)
F32_PARITY_LENGTHS = [(1, 17, 512, 300), (1, 7, 8, 9), (31, 32, 33), (63, 64, 65),
                      (511, 512, 2048), (100,)]


@pytest.mark.parametrize("lengths", F32_PARITY_LENGTHS,
                         ids=["-".join(map(str, n)) for n in F32_PARITY_LENGTHS])
@pytest.mark.parametrize("fused", [False, True], ids=["attend", "fused"])
def test_flash_decode_paged_f32_plain_is_the_reference_at_the_draft_shape(fused, lengths):
    """The plain paged decode in f32 (what the kernel's float32 path is held
    to on the card) at the speculative example's draft shape: 2 kv heads of
    hd 32, one query head each, pool blocks of 16, rows of ``lengths``,
    against ``_attend_paged`` (after ``_paged_write`` with the step's write
    fused in) at ATOL."""
    rng = np.random.default_rng(23 + sum(lengths))
    B, KV, G, hd, bs = len(lengths), 2, 1, 32, 16
    nblk = max(32, -(-max(lengths) // bs))
    N = B * nblk + 1
    k_pool = rng.normal(size=(N, KV, bs, hd)).astype(np.float32)
    v_pool = rng.normal(size=(N, KV, bs, hd)).astype(np.float32)
    jlayer = {"k": jnp.asarray(k_pool.transpose(0, 2, 1, 3)),
              "v": jnp.asarray(v_pool.transpose(0, 2, 1, 3))}
    tables = _tables(rng, B, nblk, N)
    lens = np.array(lengths, np.int32)
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    pk, pv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    extra = ()
    if fused:
        k = rng.normal(size=(B, KV, 1, hd)).astype(np.float32)
        v = rng.normal(size=(B, KV, 1, hd)).astype(np.float32)
        jlayer = jgen._paged_write(jlayer, jnp.asarray(tables), jnp.asarray(lens[:, None] - 1),
                                   jnp.ones((B, 1), bool), jnp.asarray(k), jnp.asarray(v))
        extra = (torch.from_numpy(k), torch.from_numpy(v))
    want = jgen._attend_paged(jnp.asarray(q.reshape(B, KV * G, 1, hd)),
                              jgen._paged_view(jlayer, jnp.asarray(tables)), jnp.asarray(lens - 1))
    got = fd.flash_decode_paged(torch.from_numpy(q), pk, pv, _t32(tables), _t32(lens), *extra)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, KV, G, hd), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jlayer["k"]).transpose(0, 2, 1, 3))


def _source_constants() -> dict:
    """The float32 walk's constants as ``flash_decode_paged.cu`` states them."""
    src = (Path(fd.__file__).parent / "csrc" / "flash_decode_paged.cu").read_text()
    found = dict(re.findall(r"constexpr int (\w+) = ([0-9 *]+);", src))
    warps = re.search(r"f32_warps\(int D\) \{ return D <= (\d+) \? (\d+) : (\d+); \}", src)
    return {**{k: eval(v) for k, v in found.items()},  # noqa: S307 - integer products
            "F32_WARPS_RULE": tuple(int(x) for x in warps.groups())}


def test_paged_f32_layout_is_the_sources_rule():
    """``paged_f32_layout`` (the host's statement of the float32 walk: tiles,
    warps, ring stages, shared memory) is pinned to the source's constants,
    and to a hand count at the draft's shape and the widest instance; the
    card holds its bytes to the source's at every head dim and group
    (chip_smoke.py)."""
    c = _source_constants()
    assert (fd._F32_TILE, fd._F32_BOX_COLS, fd._F32_RING_BUDGET, fd._F32_MAX_DEPTH,
            fd._MAX_SPLIT, fd._MIN_SPAN) == (c["F32_TILE"], c["F32_BOX_COLS"],
                                            c["F32_RING_BUDGET"], c["F32_MAX_DEPTH"],
                                            c["MAX_SPLIT"], c["MIN_SPAN"])
    assert c["F32_BOX_COLS"] * 4 == 128  # a box row is the 128-byte swizzle's row
    limit, many, few = c["F32_WARPS_RULE"]
    for hd in range(8, 257, 8):
        for g in (1, 2, 3, 4, 5, 8, 16):
            plan = fd.paged_f32_layout(hd, g)
            assert plan["warps"] == (many if hd <= limit else few)
            assert plan["rows"] == min(8, 1 << (g - 1).bit_length())
            assert 2 <= plan["depth"] <= c["F32_MAX_DEPTH"]
            assert plan["bytes"] <= 232448  # the opt-in limit of a block on sm_90
    # the draft (hd 32, group 1): 8 warps x 4 stages of a tile's K and V (one
    # 1 KB box each), q's 32 floats, 32 mbarriers and 1024 bytes of alignment
    draft = fd.paged_f32_layout(32, 1)
    assert (draft["warps"], draft["depth"], draft["stage"]) == (8, 4, 2048)
    assert draft["bytes"] == 8 * 4 * 2048 + 32 * 4 + 32 * 8 + 1024
    # hd 256, 8 rows: 4 warps x 2 stages of 8 boxes of K and V (128 KB; the
    # combine's scratch fits inside), q 8 x 256 floats, 8 mbarriers
    wide = fd.paged_f32_layout(256, 8)
    assert (wide["warps"], wide["depth"], wide["stage"]) == (4, 2, 16384)
    assert wide["bytes"] == 4 * 2 * 16384 + 8 * 256 * 4 + 8 * 8 + 1024


@pytest.mark.parametrize("n, C, want", [
    (512, 8, [[1] * 8] * 8),    # one row of 512 (B=1): every warp of every rank one tile
    (512, 2, [[4] * 8] * 2),    # B=32's cluster of 2: 4 tiles a warp, the ring's depth
    (64, 1, [[1] * 8]),         # a share of MIN_SPAN positions still busies all 8 warps
    (65, 8, [[2] + [1] * 7] + [[0] * 8] * 7),  # 65 < 2 x 64: one rank takes it all
    (9, 8, [[1, 1] + [0] * 6] + [[0] * 8] * 7),
    (2048, 2, [[16] * 8] * 2),
])
def test_paged_f32_warp_tiles_keep_the_warps_busy(n, C, want):
    """The float32 walk's split of a row among a cluster's warps (the
    source's rule: warp w of a rank walks tiles w, w + warps, ... of
    ``F32_TILE`` positions of its ``paged_shares`` share): every position
    in exactly one tile, and from a share of 64 positions every warp of
    the rank walks at least one."""
    warps = fd.paged_f32_layout(32, 1)["warps"]
    tiles = []
    for p0, p1 in fd.paged_shares(n, C, 16):
        count = -(-(p1 - p0) // _source_constants()["F32_TILE"])
        tiles.append([(count - 1 - w) // warps + 1 if w < count else 0 for w in range(warps)])
    assert tiles == want
    shares = fd.paged_shares(n, C, 16)
    for (p0, p1), row in zip(shares, tiles):
        assert sum(row) == -(-(p1 - p0) // fd._F32_TILE)
        if p1 - p0 >= fd._MIN_SPAN:
            assert min(row) >= 1


# -- the kernels on the card ---------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the paged kernels have no CPU mode)")
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


# (B, KV, G, hd, table blocks, lengths): the served decode layer (B=32, 64
# blocks of 16), one row, MHA at hd 128, and one batch whose lengths span
# the table (the split follows each row's own length)
PAGED_ON_CARD = [(32, 4, 4, 64, 64, None), (1, 4, 4, 64, 64, None), (4, 8, 1, 128, 16, None),
                 (5, 4, 4, 64, 64, (1, 17, 300, 560, 1009))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_ON_CARD, ids=[str(c) for c in PAGED_ON_CARD])
def test_flash_decode_paged_kernel_matches_plain_on_card(case):
    """Ragged lengths over a shuffled pool; one launch a call; a repeat and
    a permutation of the row's blocks give the same bits.  Then the call
    with the decode step's write fused in (the last row inactive): o of
    the active rows as the plain fused call's, the pools bit-exact outside
    the scratch block, a repeat the same bits."""
    _need_card()
    B, KV, G, hd, nblk, lengths = case
    bs, dev = 16, torch.device("cuda")
    gen = torch.Generator().manual_seed(sum(case[:5]))
    N = B * nblk + 1
    pk, pv = (torch.randn(N, KV, bs, hd, generator=gen).to(torch.bfloat16).to(dev)
              for _ in range(2))
    q = torch.randn(B, KV, G, hd, generator=gen).to(torch.bfloat16).to(dev)
    tables = (torch.randperm(N - 1, generator=gen)[: B * nblk] + 1).reshape(B, nblk)
    lens = (torch.tensor(lengths) if lengths else
            torch.randint(1, nblk * bs + 1, (B,), generator=gen))
    tables, lens = tables.to(torch.int32).to(dev), lens.to(torch.int32).to(dev)
    before = fd.PAGED_LAUNCHES
    got = fd.flash_decode_paged(q, pk, pv, tables, lens)
    again = fd.flash_decode_paged(q, pk, pv, tables, lens)
    want = fd.flash_decode_paged_reference(q, pk, pv, tables, lens)
    perm = torch.randperm(N - 1, generator=gen).to(dev) + 1
    mk, mv = pk.clone(), pv.clone()
    mk[perm], mv[perm] = pk[1:], pv[1:]
    moved = fd.flash_decode_paged(q, mk, mv, perm[(tables - 1).long()].to(torch.int32), lens)
    torch.cuda.synchronize()
    assert fd.PAGED_LAUNCHES == before + 3
    # FLASH_O_ATOL of chip_smoke.py: p rounds to bf16 at running (kernel)
    # vs global (plain) maxima, and o to bf16
    assert float((got.float() - want.float()).abs().max()) <= 1.6e-2
    assert torch.equal(got, again) and torch.equal(got, moved)
    # the fused write: fresh rows from strided head views
    qkv = torch.randn(B, 1, 3 * KV * hd, generator=gen).to(torch.bfloat16).to(dev)
    k_new = qkv[..., KV * hd:2 * KV * hd].reshape(B, 1, KV, hd).transpose(1, 2)
    v_new = qkv[..., 2 * KV * hd:].reshape(B, 1, KV, hd).transpose(1, 2)
    valid = torch.arange(B, device=dev) < max(B - 1, 1)
    pools = [(pk.clone(), pv.clone()) for _ in range(3)]
    got = fd.flash_decode_paged(q, *pools[0], tables, lens, k_new, v_new, valid)
    again = fd.flash_decode_paged(q, *pools[1], tables, lens, k_new, v_new, valid)
    want = fd.flash_decode_paged_reference(q, *pools[2], tables, lens, k_new, v_new, valid)
    torch.cuda.synchronize()
    assert fd.PAGED_LAUNCHES == before + 5
    assert float((got[valid].float() - want[valid].float()).abs().max()) <= 1.6e-2
    assert all(torch.equal(pools[0][i][1:], pools[2][i][1:]) for i in (0, 1))
    assert torch.equal(got, again) and all(torch.equal(pools[0][i], pools[1][i]) for i in (0, 1))


# the float32 walk's edges: tiles of 8 positions a warp, pool blocks of 16,
# shares of whole pool blocks (MIN_SPAN 64); 100 ends in a partial block
F32_EDGE_LENGTHS = (1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 511, 512, 2048, 100)
# (KV, G, hd, table blocks, lengths, pools): the draft's head shape (2 kv
# heads of hd 32, group 1) with every edge length in one batch (a cluster
# of 8), each of four alone (one row: a cluster of 8), 32 rows of 512 (a
# cluster of 2) from pools that are strided views, and 64 rows (a cluster
# of 1); then the other instances: 4 rows of hd 64, 8 of hd 256, and 3 of
# hd 40 (boxes past the head dim zero-filled, a partial row tile)
PAGED_F32_ON_CARD = [(2, 1, 32, 128, F32_EDGE_LENGTHS, "dense")]
PAGED_F32_ON_CARD += [(2, 1, 32, 128, (n,), "dense") for n in (9, 65, 511, 2048)]
PAGED_F32_ON_CARD += [(2, 1, 32, 64, (512,) * 32, "strided"),
                      (2, 1, 32, 128, tuple(range(1, 2048, 32)), "dense"),
                      (4, 4, 64, 16, (1, 60, 200, 256), "dense"),
                      (1, 8, 256, 16, (100, 256), "dense"),
                      (2, 3, 40, 16, (5, 77, 256), "dense")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_F32_ON_CARD,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-B{len(c[4])}-n{max(c[4])}-{c[5]}"
                              for c in PAGED_F32_ON_CARD])
def test_flash_decode_paged_f32_kernel_matches_plain_on_card(case):
    """The float32 path, unfused and with the step's write fused in from
    strided head views of a projection (the draft's layout; the last row
    inactive where there are several): o within 1e-5 of the plain f32
    call (f32 FMAs, no TF32), a repeat and the rows' blocks permuted in the
    pool the same bits, the pools bit-exact outside the scratch block,
    one launch a call."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in f32
    KV, G, hd, nblk, lengths, pools_as = case
    B, bs, dev = len(lengths), 16, torch.device("cuda")
    gen = torch.Generator().manual_seed(B * 1000 + hd + max(lengths))
    N = B * nblk + 1

    def pool(data):  # strided: every other kv head of a wider pool, rows of 2 hd
        if pools_as == "dense":
            return data.clone()
        wide = torch.zeros(N, 2 * KV, bs, 2 * hd, device=dev)
        view = wide[:, ::2, :, :hd]
        view.copy_(data)
        return view

    pk, pv = (pool(torch.randn(N, KV, bs, hd, generator=gen).to(dev)) for _ in range(2))
    q = torch.randn(B, KV, G, hd, generator=gen).to(dev)
    tables = (torch.randperm(N - 1, generator=gen)[: B * nblk] + 1).reshape(B, nblk)
    tables = tables.to(torch.int32).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=gen).to(dev) + 1
    mk, mv = pk.clone(), pv.clone()
    mk[perm], mv[perm] = pk[1:], pv[1:]
    moved_tables = perm[(tables - 1).long()].to(torch.int32)
    before = fd.PAGED_LAUNCHES
    got = fd.flash_decode_paged(q, pk, pv, tables, lens)
    again = fd.flash_decode_paged(q, pk, pv, tables, lens)
    moved = fd.flash_decode_paged(q, mk, mv, moved_tables, lens)
    want = fd.flash_decode_paged_reference(q, pk, pv, tables, lens)
    torch.cuda.synchronize()
    assert fd.PAGED_LAUNCHES == before + 3 and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, again) and torch.equal(got, moved)
    qkv = torch.randn(B, 1, (2 * G + 4) * KV * hd, generator=gen).to(dev)
    k_new = qkv[..., -2 * KV * hd:-KV * hd].reshape(B, 1, KV, hd).transpose(1, 2)
    v_new = qkv[..., -KV * hd:].reshape(B, 1, KV, hd).transpose(1, 2)
    valid = torch.arange(B, device=dev) < max(B - 1, 1)
    pools = [(pool(pk), pool(pv)) for _ in range(3)]
    fused = fd.flash_decode_paged(q, *pools[0], tables, lens, k_new, v_new, valid)
    fused_again = fd.flash_decode_paged(q, *pools[1], tables, lens, k_new, v_new, valid)
    fused_want = fd.flash_decode_paged_reference(q, *pools[2], tables, lens, k_new, v_new, valid)
    torch.cuda.synchronize()
    assert fd.PAGED_LAUNCHES == before + 5
    assert float((fused[valid] - fused_want[valid]).abs().max()) <= 1e-5
    assert all(torch.equal(pools[0][i][1:], pools[2][i][1:]) for i in (0, 1))
    assert torch.equal(fused, fused_again)
    assert all(torch.equal(pools[0][i], pools[1][i]) for i in (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("KV,hd,W,dtype,misalign", [
    (4, 64, 1, torch.bfloat16, 0), (4, 64, 128, torch.bfloat16, 0),
    (4, 64, 512, torch.bfloat16, 0), (16, 64, 5, torch.bfloat16, 0),
    (4, 64, 127, torch.bfloat16, 0), (4, 64, 130, torch.bfloat16, 0),
    (8, 32, 130, torch.bfloat16, 0), (4, 128, 127, torch.bfloat16, 0),
    (2, 256, 5, torch.bfloat16, 0), (4, 32, 5, torch.float32, 0),
    (4, 64, 130, torch.bfloat16, 1), (16, 64, 5, torch.bfloat16, 2),
    (2, 256, 127, torch.bfloat16, 4), (4, 32, 5, torch.float32, 1)])
def test_kv_write_paged_kernel_is_bit_exact_on_card(KV, hd, W, dtype, misalign):
    """The W = 1 write, a prefill tick's W = 128 and 512, a verify's W = 5,
    ragged widths (127, 130), hd 32 to 256, float32, and strided head views
    misaligned to units of 2, 4 and 8 bytes; starts a multiple of neither
    bs nor W, a row with every position invalid and a table entry outside
    the pool (kv_write.paged_write_inputs): the pools bit for bit with the
    plain version outside the scratch block, in place."""
    _need_card()
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(KV + hd + W + misalign)
    x = kw.paged_write_inputs(4, KV, W, hd, -(-(W + 40) // 16), gen, dev, dtype=dtype,
                              misalign=misalign)
    unit = hd * x.pools[0].element_size() // kw.paged_write_lanes(*x.pools, x.k, x.v)
    assert (unit == 16) == (misalign == 0)
    want = kw.paged_write_expected(x)
    ptrs, before = [t.data_ptr() for t in x.pools], kw.PAGED_LAUNCHES
    kw.kv_write_paged(*x.pools, x.k, x.v, x.tables, x.start, x.valid)
    torch.cuda.synchronize()
    assert kw.PAGED_LAUNCHES == before + 1 and [t.data_ptr() for t in x.pools] == ptrs
    # block 0 takes several scratch writes to one row: only live blocks are exact
    assert all(torch.equal(a[1:], b[1:x.N]) for a, b in zip(x.pools, want))


# -- sampling, the shared prefix and the speculative round ------------------------


def _round_args(tcfg, tp, seed, B=4, nblk=5, N=40, bs=4):
    rng = np.random.default_rng(seed)
    _, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    token = rng.integers(0, tcfg.vocab, size=(B,)).astype(np.int32)
    n_valid = rng.integers(0, 8, size=(B,)).astype(np.int32)
    return tpool, _t32(tables), _t32(token), _t32(n_valid)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "fused"])
def test_sampled_round_keeping_one_token_is_the_reference_greedy_round(use_flash):
    """top_k = 1 keeps only the argmax, so a sampled round (keys split once
    a step on the device) gives the reference's greedy tokens, and hands
    back keys split span times."""
    jcfg, tcfg = _cfgs(GQA)
    jp, tp = _weights(jcfg, seed=7)
    rng = np.random.default_rng(7)
    N, bs, B, nblk, span = 40, 4, 4, 5, 3
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    token = rng.integers(0, GQA["vocab"], size=(B,)).astype(np.int32)
    n_valid = np.array([3, 11, 7, 1], np.int32)
    active = np.array([True, True, True, False])
    jt = jgen.paged_decode_round(
        jp, dict(jpool), jnp.asarray(tables), jnp.asarray(token), jnp.asarray(n_valid),
        jnp.asarray(active), jnp.zeros((B,), bool), jnp.zeros((B,), jnp.uint32), jcfg,
        span=span, temperature=0.0, top_k=0, top_p=0.0, eos_token=-1)[0]
    keys = torch.stack([tprng.fold_in(tprng.key(1), i) for i in range(B)])
    tt, *_, keys_out = tgen.paged_decode_round(
        tp, tpool, _t32(tables), _t32(token), _t32(n_valid), torch.from_numpy(active),
        torch.zeros(B, dtype=torch.bool), tcfg, span=span, keys=keys, temperature=0.8,
        top_k=1, use_flash=use_flash)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    want_keys = keys
    for _ in range(span):
        want_keys = tprng.split(want_keys)[0]
    assert torch.equal(keys_out, want_keys)


def test_sampled_round_rows_do_not_depend_on_their_batch():
    """Each row draws from its own key: a row's sampled tokens are the same
    alone, beside other rows and at another place in the round."""
    _, tcfg = _cfgs(DIMS)
    _, tp = _weights(_cfgs(DIMS)[0], seed=8)
    tpool, tables, token, n_valid = _round_args(tcfg, tp, 8)
    keys = torch.stack([tprng.fold_in(tprng.key(2), i) for i in range(4)])

    def run(rows):
        pool = {li: {n: t.clone() for n, t in layer.items()} for li, layer in tpool.items()}
        idx = torch.tensor(rows)
        return tgen.paged_decode_round(
            tp, pool, tables[idx], token[idx], n_valid[idx], torch.ones(len(rows), dtype=torch.bool),
            torch.zeros(len(rows), dtype=torch.bool), tcfg, span=4, keys=keys[idx],
            temperature=1.0, top_k=20, top_p=0.95, use_flash=True)[0]

    whole = run([0, 1, 2, 3])
    assert torch.equal(run([2]), whole[2:3])
    assert torch.equal(run([3, 0, 2, 1]), whole[[3, 0, 2, 1]])
    assert torch.equal(run([1, 3]), whole[[1, 3]])


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "kernel-wrapper"])
@pytest.mark.parametrize("P", [6, 8, 3], ids=["blocks+tail", "blocks", "tail"])
def test_prefix_block_and_tail_writes_leave_the_reference_pool(P, use_flash):
    """paged_write_prefix_blocks (one B=1 write a layer: the full blocks as
    the table row, start 0) and paged_write_prefix_tail (the rest into one
    private block) leave the pool the reference's leave, bit for bit."""
    jcfg, tcfg = _cfgs(GQA)
    jp, _ = _weights(jcfg, seed=9)
    rng = np.random.default_rng(9)
    N, bs = 12, 4
    jpool, tpool = _pool_pair(tcfg, N, bs, rng)
    prefix = rng.integers(0, GQA["vocab"], size=(1, P)).astype(np.int32)
    _, jpc = jgen.prefill(jp, jnp.asarray(prefix), jgen.init_cache(jcfg, 1, P), jcfg)
    tpc = {li: {kk: torch.from_numpy(np.array(jpc[li][kk])) for kk in "kv"} for li in jpc}
    full = P // bs
    blocks = [7, 2][:full]
    before = kw.PAGED_LAUNCHES
    if full:
        jpool = jgen.paged_write_prefix_blocks(jpool, jpc, tuple(blocks), jcfg)
        tpool = tgen.paged_write_prefix_blocks(tpool, tpc, blocks, tcfg, use_flash)
    if P > full * bs:
        jpool = jgen.paged_write_prefix_tail(jpool, jpc, jnp.int32(5), jcfg, p0=full * bs)
        tpool = tgen.paged_write_prefix_tail(tpool, tpc, 5, tcfg, p0=full * bs,
                                             use_flash=use_flash)
    _same_pool(tpool, jpool)
    assert kw.PAGED_LAUNCHES == before  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("k", [2, 4])
def test_paged_spec_round_matches_the_reference(k, use_flash):
    """One draft/verify round on one pool state, rows at different lengths
    and an inactive row: new_toks, gained and corrected identical to the
    reference's, and both pools as the reference leaves them outside the
    scratch block (with ``use_flash`` an inactive row writes nothing)."""
    t_dims = dict(DIMS)
    d_dims = dict(vocab=48, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    (jt_cfg, tt_cfg), (jd_cfg, td_cfg) = _cfgs(t_dims), _cfgs(d_dims)
    jtp, ttp = _weights(jt_cfg, seed=11)
    jdp, tdp = _weights(jd_cfg, seed=12)
    rng = np.random.default_rng(13)
    N, bs, B, nblk = 48, 4, 4, 5
    jt_pool, tt_pool = _pool_pair(tt_cfg, N, bs, rng)
    jd_pool, td_pool = _pool_pair(td_cfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    d_tables = _tables(rng, B, nblk, N)
    token = rng.integers(0, 48, size=(B,)).astype(np.int32)
    n_valid = np.array([2, 9, 5, 0], np.int32)
    active = np.array([True, True, True, False])
    want = jgen.paged_spec_round(jtp, jdp, dict(jt_pool), dict(jd_pool), jnp.asarray(tables),
                                 jnp.asarray(d_tables), jnp.asarray(token), jnp.asarray(n_valid),
                                 jnp.asarray(active), jt_cfg, jd_cfg, k=k)
    got = tgen.paged_spec_round(ttp, tdp, tt_pool, td_pool, _t32(tables), _t32(d_tables),
                                _t32(token), _t32(n_valid), torch.from_numpy(active), tt_cfg,
                                td_cfg, k=k, use_flash=use_flash)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for tpool, jpool in ((got[3], want[3]), (got[4], want[4])):
        for li, layer in jpool.items():
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tpool[li][name].numpy()[1:],
                    np.asarray(layer[name]).transpose(0, 2, 1, 3)[1:], atol=ATOL, rtol=ATOL)


# -- the int8 K/V cache's pools (ROADMAP Queue 1 item [2q]) ------------------


def _i8_pool_pair(tcfg, N, bs, rng):
    """The same random int8 pool contents in both layouts: (jax pool [N,
    bs, KV, *], port pool [N, KV, bs, *]); N(0, 1) rows quantized as the
    served path quantizes them (codes and scale planes)."""
    KV, hd = tcfg.kv_heads, tcfg.head_dim
    jpool, tpool = {}, {}
    for i in range(tcfg.n_layers):
        t, j = {}, {}
        for name in ("k", "v"):
            rows = torch.from_numpy(rng.standard_normal(size=(N, KV, bs, hd)).astype(np.float32))
            t[name], t[name + "_s"] = kw.quantize_kv(rows.to(torch.bfloat16))
            j[name] = jnp.asarray(t[name].numpy().transpose(0, 2, 1, 3))
            j[name + "_s"] = jnp.asarray(t[name + "_s"].numpy().transpose(0, 2, 1))
        tpool[f"l{i}"], jpool[f"l{i}"] = t, j
    return jpool, tpool


def _same_i8_pool(tlayer, jlayer, skip_scratch=False):
    lo = 1 if skip_scratch else 0
    for name in ("k", "v"):
        np.testing.assert_array_equal(tlayer[name].numpy()[lo:],
                                      np.asarray(jlayer[name]).transpose(0, 2, 1, 3)[lo:])
        np.testing.assert_array_equal(tlayer[name + "_s"].numpy()[lo:],
                                      np.asarray(jlayer[name + "_s"]).transpose(0, 2, 1)[lo:])


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
def test_int8_paged_write_and_views_match_bit_for_bit(dims):
    """An int8 pool's write (each row quantized by _quantize_kv, codes and
    scales scattered through the table; invalid positions to the scratch
    block at distinct offsets) and its views (codes and scale planes)
    against the reference's, bit for bit; the wrapper on CPU tensors is the
    same plain write."""
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(20)
    N, bs, B, W, nblk = 12, 8, 3, 5, 3
    jpool, tpool = _i8_pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    start = np.array([6, 0, 3], np.int32)
    valid = np.ones((B, W), bool)
    valid[1] = False
    valid[2, 4] = False
    KV, hd = tcfg.kv_heads, tcfg.head_dim
    k = 3 * rng.normal(size=(B, KV, W, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, W, hd)).astype(np.float32)
    pos = start[:, None] + np.arange(W)[None, :]
    want = jgen._paged_write(jpool["l0"], jnp.asarray(tables), jnp.asarray(pos),
                             jnp.asarray(valid), jnp.asarray(k), jnp.asarray(v))
    again = {n: t.clone() for n, t in tpool["l0"].items()}
    got = tgen._paged_write(tpool["l0"], _t32(tables), _t32(start), torch.from_numpy(valid),
                            torch.from_numpy(k), torch.from_numpy(v))
    assert got is tpool["l0"]  # in place
    _same_i8_pool(got, want)
    kw.kv_write_paged(again["k"], again["v"], torch.from_numpy(k), torch.from_numpy(v),
                      _t32(tables), _t32(start), torch.from_numpy(valid),
                      (again["k_s"], again["v_s"]))
    assert all(torch.equal(again[n], got[n]) for n in got)
    jview = jgen._paged_view(want, jnp.asarray(tables))
    tview = tgen._paged_view(got, _t32(tables))
    assert set(tview) == set(jview) == {"k", "v", "k_s", "v_s"}
    for name, arr in jview.items():
        np.testing.assert_array_equal(tview[name].numpy(), np.asarray(arr))


def test_int8_kv_write_paged_refuses_mismatched_scales():
    pk = torch.zeros(4, 2, 4, 8, dtype=torch.int8)
    planes = (torch.zeros(4, 2, 4), torch.zeros(4, 2, 4))
    k = torch.zeros(2, 2, 1, 8)
    ok = dict(tables=torch.zeros(2, 1, dtype=torch.int32), start=torch.zeros(2, dtype=torch.int32),
              valid=torch.ones(2, 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="scale planes"):
        kw.kv_write_paged(pk, pk.clone(), k, k, **ok)
    with pytest.raises(ValueError, match="pool_ks must be"):
        kw.kv_write_paged(pk, pk.clone(), k, k, **ok, scales=(torch.zeros(4, 4, 2),) * 2)
    with pytest.raises(ValueError, match="come with their scales"):
        kw.kv_write_paged(pk, pk.clone(), k.to(torch.int8), k.to(torch.int8), **ok,
                          scales=planes)


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("W", [1, 5])
def test_int8_attend_paged_matches(dims, W):
    """The plain attention over an int8 view (scores times k_s, p times v_s
    before its cast) against _attend_paged over the reference's view."""
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(21 + W)
    jpool, tpool = _i8_pool_pair(tcfg, 14, 4, rng)
    tables = _tables(rng, 3, 4, 14)
    start = np.array([0, 6, 10], np.int32)
    q = rng.normal(size=(3, tcfg.n_heads, W, tcfg.head_dim)).astype(np.float32)
    want = jgen._attend_paged(jnp.asarray(q), jgen._paged_view(jpool["l0"], jnp.asarray(tables)),
                              jnp.asarray(start))
    got = tgen._attend_paged(torch.from_numpy(q), tgen._paged_view(tpool["l0"], _t32(tables)),
                             _t32(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("dims", [DIMS, GQA], ids=["mha", "gqa"])
def test_int8_flash_decode_paged_fused_is_the_reference_write_and_attend(dims):
    """The int8 fused call's plain version (the step's rows quantized into
    the pools, then the attention over codes and scales) against
    _paged_write + _attend_paged of the reference's int8 pool, two rows
    inactive: the pools and planes bit for bit outside the scratch block,
    o of the active rows within ATOL; the wrapper on CPU tensors is the
    plain version."""
    jcfg, tcfg = _cfgs(dims)
    rng = np.random.default_rng(23)
    N, bs, B, nblk = 30, 4, 5, 4
    jpool, tpool = _i8_pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    tables[3] = 0
    lens = np.array([1, 7, 16, 5, 10], np.int32)
    active = np.array([True, True, True, False, False])
    KV, G, hd = tcfg.kv_heads, tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    k = 5 * rng.normal(size=(B, KV, 1, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, 1, hd)).astype(np.float32)
    layer = jgen._paged_write(jpool["l0"], jnp.asarray(tables), jnp.asarray(lens[:, None] - 1),
                              jnp.asarray(active[:, None]), jnp.asarray(k), jnp.asarray(v))
    want = jgen._attend_paged(jnp.asarray(q.reshape(B, KV * G, 1, hd)),
                              jgen._paged_view(layer, jnp.asarray(tables)),
                              jnp.asarray(lens - 1))
    want = np.asarray(want).reshape(B, KV, G, hd)
    outs = []
    for fn in (fd.flash_decode_paged_reference, fd.flash_decode_paged):
        tl = {n: t.clone() for n, t in tpool["l0"].items()}
        got = fn(torch.from_numpy(q), tl["k"], tl["v"], _t32(tables), _t32(lens),
                 torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(active),
                 (tl["k_s"], tl["v_s"]))
        np.testing.assert_allclose(got.numpy()[active], want[active], atol=ATOL, rtol=ATOL)
        _same_i8_pool(tl, layer, skip_scratch=True)
        outs.append((got, tl))
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("quant", ["none", "int8"], ids=["kv", "both"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "fused"])
def test_int8_paged_decode_round_tokens_identical(use_flash, quant):
    """A round over int8 pools (rows at different lengths, an inactive pad
    row), with dense or int8 weights: the reference's greedy tokens, cache
    lengths and pools outside the scratch block."""
    dims = dict(GQA)
    jcfg = JConfig(**dims, dtype=jnp.float32, quant=quant, kv_quant="int8")
    tcfg = TConfig(**dims, dtype=torch.float32, quant=quant, kv_quant="int8")
    jp, tp = _weights(JConfig(**dims, dtype=jnp.float32), seed=7)
    if quant == "int8":
        from seldon_core_tpu.ops.quant import quantize_lm_params as jquant
        from seldon_core_tpu_torch.ops.quant import quantize_lm_params as tquant

        jp, tp = jquant(jp), tquant(tp)
    rng = np.random.default_rng(24)
    N, bs, B, nblk, span = 40, 4, 4, 5, 4
    jpool, tpool = _i8_pool_pair(tcfg, N, bs, rng)
    tables = _tables(rng, B, nblk, N)
    tables[3] = 0
    token = rng.integers(0, dims["vocab"], size=(B,)).astype(np.int32)
    n_valid = np.array([3, 11, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    jt, jpool, jtok, jnv, _, _ = jgen.paged_decode_round(
        jp, dict(jpool), jnp.asarray(tables), jnp.asarray(token), jnp.asarray(n_valid),
        jnp.asarray(active), jnp.zeros((B,), bool), jnp.zeros((B,), jnp.uint32), jcfg, span=span,
        temperature=0.0, top_k=0, top_p=0.0, eos_token=-1)
    tt, tpool, ttok, tnv, _, _ = tgen.paged_decode_round(
        tp, tpool, _t32(tables), _t32(token), _t32(n_valid), torch.from_numpy(active),
        torch.zeros(B, dtype=torch.bool), tcfg, span=span, use_flash=use_flash)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    for li in tpool:
        # codes within one step and scales to f32 rounding: the written
        # rows are computed in another order upstream
        for name in ("k", "v"):
            d = tpool[li][name].numpy()[1:].astype(int) - \
                np.asarray(jpool[li][name]).transpose(0, 2, 1, 3)[1:].astype(int)
            assert np.abs(d).max() <= 1
            np.testing.assert_allclose(tpool[li][name + "_s"].numpy()[1:],
                                       np.asarray(jpool[li][name + "_s"]).transpose(0, 2, 1)[1:],
                                       rtol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "kernel-wrapper"])
@pytest.mark.parametrize("P", [6, 8, 3], ids=["blocks+tail", "blocks", "tail"])
def test_int8_prefix_writes_copy_codes_and_scales(P, use_flash):
    """An int8 prefix cache (prefilled quantized) into int8 pools: the full
    blocks and the tail copy its codes and scales as they are, leaving the
    reference's pool bit for bit."""
    dims = dict(GQA)
    jcfg = JConfig(**dims, dtype=jnp.float32, kv_quant="int8")
    tcfg = TConfig(**dims, dtype=torch.float32, kv_quant="int8")
    jp, _ = _weights(JConfig(**dims, dtype=jnp.float32), seed=9)
    rng = np.random.default_rng(25)
    N, bs = 12, 4
    jpool, tpool = _i8_pool_pair(tcfg, N, bs, rng)
    prefix = rng.integers(0, dims["vocab"], size=(1, P)).astype(np.int32)
    _, jpc = jgen.prefill(jp, jnp.asarray(prefix), jgen.init_cache(jcfg, 1, P), jcfg)
    tpc = params_from_jax(jax.tree_util.tree_map(np.asarray, jpc), device="cpu")
    full = P // bs
    blocks = [7, 2][:full]
    if full:
        jpool = jgen.paged_write_prefix_blocks(jpool, jpc, tuple(blocks), jcfg)
        tpool = tgen.paged_write_prefix_blocks(tpool, tpc, blocks, tcfg, use_flash)
    if P > full * bs:
        jpool = jgen.paged_write_prefix_tail(jpool, jpc, jnp.int32(5), jcfg, p0=full * bs)
        tpool = tgen.paged_write_prefix_tail(tpool, tpc, 5, tcfg, p0=full * bs,
                                             use_flash=use_flash)
    for li in tpool:
        _same_i8_pool(tpool[li], jpool[li])
