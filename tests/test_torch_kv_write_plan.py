"""The paged write's launch plan (``kv_write.paged_write_plan``, the Python
statement of ``kv_write_paged_plan`` in ``ops/csrc/kv_write.cu``), checked
by enumerating every thread of it in numpy: every byte of every fresh K and
V row written exactly once, the int8 variant's shuffle groups inside one
warp and one row with one lane a row writing the scale, the grid within
CUDA's limits and no 32-bit index overflowing at a large pool; the int8
variant's rounding of a quotient to its code (``code_alu``) against
``kvq::code``'s, bit for bit, on every kind of float.  Then a
numpy model of both kernels (the plan's threads, the block's slot lookup
by its first P lanes, the stores of the live lanes) scatters through the
plan with unaligned and negative starts, invalid rows and out-of-pool
block ids, bit for bit against ``kv_write_paged_reference`` (the int8
variant quantizing as the reference's quantizer does, or copying)."""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.ops import kv_write as kw

INT32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _threads(plan, KV, W, lanes):
    """Every thread of one row's blocks (the plan's threads do not depend
    on the row, which is blockIdx.y): flat arrays of block x, block z,
    thread t, lane, position in the block, kv head, position, and live."""
    ls, ps, T, gx, _, gz = plan
    x = np.arange(gx, dtype=np.int64)[:, None, None]
    z = np.arange(gz, dtype=np.int64)[None, :, None]
    t = np.arange(T, dtype=np.int64)[None, None, :]
    i = z * T + t
    lane = i & ((1 << ls) - 1)
    pw = (i >> ls) & ((1 << ps) - 1)
    kvh = i >> (ls + ps)
    w = (x << ps) + pw
    shape = (gx, gz, T)
    x, z, t, lane, pw, kvh, w = (np.broadcast_to(a, shape).ravel()
                                 for a in (x, z, t, lane, pw, kvh, w))
    live = (kvh < KV) & (lane < lanes) & (w < W)
    return x, z, t, lane, pw, kvh, w, live


def _check_grid(plan, B):
    ls, ps, T, gx, gy, gz = plan
    assert T % 32 == 0 and 32 <= T <= kw.PAGED_THREADS
    assert gy == B <= 65535 and gz <= 65535 and 1 <= gx <= INT32_MAX
    assert (1 << ps) <= T and gz * T <= INT32_MAX and gx << ps <= INT32_MAX


@pytest.mark.parametrize("W", [1, 5, 127, 128, 130, 512])
@pytest.mark.parametrize("KV", [1, 4, 16])
def test_plan_writes_every_byte_of_every_row_once(KV, W):
    """For B in {1, 3, 32}, hd in {16, ..., 256} (and 40, 24: lanes that
    are not a power of two), elements of 1, 2 and 4 bytes and units of 16
    down to 1 byte: the live threads of one row's blocks hold each (kv
    head, position, unit) once, so each byte of the row's K and V (a
    thread stores one unit of each) is written once; the plan is B-free
    but for grid y, which is B."""
    seen = {}
    for hd in (16, 32, 64, 128, 256, 40, 24):
        for es in (1, 2, 4):
            row_bytes = hd * es
            for unit in (16, 8, 4, 2, 1):
                if row_bytes % unit:
                    continue
                lanes = row_bytes // unit
                for B in (1, 3, 32):
                    plan = kw.paged_write_plan(B, KV, W, lanes)
                    _check_grid(plan, B)
                    one = kw.paged_write_plan(1, KV, W, lanes)
                    assert plan[:4] + plan[5:] == one[:4] + one[5:]
                if lanes not in seen:
                    plan = kw.paged_write_plan(1, KV, W, lanes)
                    _, _, _, lane, _, kvh, w, live = _threads(plan, KV, W, lanes)
                    flat = (kvh[live] * W + w[live]) * lanes + lane[live]
                    seen[lanes] = np.bincount(flat, minlength=KV * W * lanes)
                counts = seen[lanes]
                assert counts.shape == (KV * W * lanes,) and (counts == 1).all()
                # a unit's bytes are [u * unit, (u + 1) * unit) of its row
                per_byte = np.repeat(counts.reshape(KV, W, lanes), unit, axis=2)
                assert per_byte.shape == (KV, W, row_bytes) and (per_byte == 1).all()


@pytest.mark.parametrize("W", [1, 5, 127, 128, 130, 512])
@pytest.mark.parametrize("KV", [1, 4, 16])
def test_int8_plan_groups_rows_inside_one_warp(KV, W):
    """The int8 variant (lanes = hd // 8): a row's lanes are one aligned
    group inside one warp, every group is one (kv head, position), each of
    a live row's 8-value groups is one lane's, and one lane a row (lane 0
    of its group) writes the scales."""
    for hd in (8, 16, 24, 32, 64, 128, 256):
        lanes = hd // 8
        plan = kw.paged_write_plan(32, KV, W, lanes)
        _check_grid(plan, 32)
        ls = plan[0]
        assert 1 << ls <= 32
        x, z, t, lane, pw, kvh, w, live = _threads(plan, KV, W, lanes)
        group = (x * plan[5] + z) * plan[2] + t >> ls  # a shuffle group's number
        warp = ((x * plan[5] + z) * plan[2] + t) // 32
        first = np.unique(group, return_index=True)[1]
        for a in (warp, kvh, w, pw):  # constant over each group
            assert (a == a[first][np.searchsorted(group[first], group)]).all()
        row_live = (kvh < KV) & (w < W)
        on = row_live & (lane * 8 < hd)
        flat = (kvh[on] * W + w[on]) * lanes + lane[on]
        assert (np.bincount(flat, minlength=KV * W * lanes) == 1).all()
        writers = row_live & (lane == 0)
        assert (np.bincount(kvh[writers] * W + w[writers], minlength=KV * W) == 1).all()


def test_plan_grid_limits_and_no_32_bit_overflow_at_a_large_pool():
    """At a pool of 4,096 blocks of 16 rows, 16 kv heads of hd 256 in f32
    (a 1 GiB pool) and B=32 rows of W=512: every 32-bit quantity of the
    kernels stays below 2^31 (the thread's number in its run, the
    position, b * nblk + idx, b * W + w and the lane's byte offset in the
    row), for units of 16 down to 1 byte; the pointer offsets are 64-bit.
    A shape past CUDA's grid limits has no plan."""
    N, KV, bs, hd, es, B, W = 4096, 16, 16, 256, 4, 32, 512
    nblk = N // B
    for unit in (16, 8, 4, 2, 1):
        lanes = hd * es // unit
        plan = kw.paged_write_plan(B, KV, W, lanes)
        _check_grid(plan, B)
        ls, ps, T, gx, gy, gz = plan
        assert gz * T - 1 <= INT32_MAX  # i, the thread's number in its run
        assert (gx << ps) - 1 + (N * bs) <= INT32_MAX  # start + w at a full table
        assert (B - 1) * nblk + nblk - 1 <= INT32_MAX and (B - 1) * W + W - 1 <= INT32_MAX
        assert ((1 << ls) - 1) * unit < hd * es <= INT32_MAX
    assert N * KV * bs * hd * es == 2**30
    for bad in ((70000, 4, 128, 8), (1, 70000, 8, 1 << 10), (0, 4, 128, 8), (1, 4, 0, 8),
                (1, 4, 128, 0)):
        with pytest.raises(ValueError):
            kw.paged_write_plan(*bad)


def _kvq_code(q):
    """kvq::code (ops/csrc/kv_int8.cuh) after its division: rintf (half to
    even), fmaxf / fminf (NaN to the other operand), the int's low byte."""
    with np.errstate(invalid="ignore"):
        r = np.rint(q)
        r = np.where(np.isnan(r), np.float32(-127), np.maximum(r, np.float32(-127)))
        r = np.minimum(r, np.float32(127))
    return r.astype(np.int32) & 0xFF


def _code_alu(q):
    """code_alu (ops/csrc/kv_write.cu) after its division: the clamp first,
    then 1.5 * 2^23 added in f32 and the sum's low byte."""
    c = np.where(np.isnan(q), np.float32(-127), np.maximum(q, np.float32(-127)))
    c = np.minimum(c, np.float32(127)).astype(np.float32)
    return (c + np.float32(12582912.0)).astype(np.float32).view(np.uint32).astype(np.int64) & 0xFF


def test_code_alu_rounds_every_quotient_as_kvq_code():
    """Every quarter, and each neighbouring float of every half, from -300
    to 300 (the ties round half to even both ways), random floats of every
    magnitude, the integers and halves past the clamp, +-0, denormals,
    +-inf and NaN: code_alu's code equals kvq::code's."""
    q = np.arange(-1200, 1201, dtype=np.float32) / np.float32(4)
    halves = np.arange(-600, 601, dtype=np.float32) + np.float32(0.5)
    around = np.concatenate([np.nextafter(halves, np.float32(-np.inf)), halves,
                             np.nextafter(halves, np.float32(np.inf))])
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, np.inf, -np.inf, np.nan, 126.5,
                        -126.5, 127.5, -127.5, 127.49999, -127.49999, 2.0**22, -(2.0**22),
                        2.0**31, -(2.0**31), 3e38, -3e38], dtype=np.float32)
    for x in (q, around, bits.view(np.float32), special):
        assert np.array_equal(_code_alu(x), _kvq_code(x))


# -- a numpy model of both kernels, scattering through the plan ----------------------


def _slots(tables, start, valid, bs, nblocks, b, ws):
    """The slot lookup of row b's positions ws, as paged_slot computes it in
    int32: (block, row), block -1 where the write is dropped."""
    pos = (np.int32(start[b]) + ws.astype(np.int32)).astype(np.int32)
    if bs & (bs - 1) == 0:
        shift = bs.bit_length() - 1
        q, off = pos >> shift, pos & (bs - 1)
    else:
        q = np.floor_divide(pos, bs)
        off = pos - q * bs
    idx = np.clip(q, 0, tables.shape[1] - 1)
    entry = tables[b, idx]  # loaded whatever valid says
    blk = np.where(valid[b, ws], entry, 0)
    return np.where((blk >= 0) & (blk < nblocks), blk, -1), off


def _model_bytes(pool, src, tables, start, valid, unit):
    """The bf16 kernel's copy by bytes: pool uint8 [N, KV, bs, row_bytes],
    src uint8 [B, KV, W, row_bytes], each live thread one unit of its row
    (for K and for V the same; the caller runs it on each)."""
    N, KV, bs, row_bytes = pool.shape
    B, _, W, _ = src.shape
    lanes = row_bytes // unit
    plan = kw.paged_write_plan(B, KV, W, lanes)
    ps = plan[1]
    x, z, t, lane, pw, kvh, w, live = _threads(plan, KV, W, lanes)
    for b in range(B):
        w0 = np.arange(plan[3]) << ps  # each block's first position
        look = np.arange(1 << ps)
        smem_blk = np.full((plan[3], 1 << ps), -2)
        smem_off = np.zeros((plan[3], 1 << ps), dtype=np.int64)
        for bx in range(plan[3]):  # lanes 0..P-1 of block bx look up its positions
            ws = w0[bx] + look
            ok = ws < W
            blk, off = _slots(tables, start, valid, bs, N, b, ws[ok])
            smem_blk[bx, ok], smem_off[bx, ok] = blk, off
        blk, off = smem_blk[x, pw], smem_off[x, pw]
        assert (blk[live] != -2).all()  # every live thread's slot was looked up
        go = live & (blk >= 0)
        for j in range(unit):
            pool[blk[go], kvh[go], off[go], lane[go] * unit + j] = \
                src[b, kvh[go], w[go], lane[go] * unit + j]


def _model_int8(pools, planes, src, scales, tables, start, valid):
    """The int8 kernel: src float32 [B, KV, W, hd] (quantized: each row's
    absmax over its group of lanes, then one IEEE f32 division a value and
    rint) or int8 codes with their scales [B, KV, W] (copied); lane 0 of a
    row's group writes the scale."""
    N, KV, bs, hd = pools[0].shape
    B, _, W, _ = src[0].shape
    lanes = hd // 8
    plan = kw.paged_write_plan(B, KV, W, lanes)
    ls, ps = plan[0], plan[1]
    x, z, t, lane, pw, kvh, w, live = _threads(plan, KV, W, lanes)
    on = live & (lane * 8 < hd)
    for b in range(B):
        smem_blk = np.full((plan[3], 1 << ps), -2)
        smem_off = np.zeros((plan[3], 1 << ps), dtype=np.int64)
        for bx in range(plan[3]):
            ws = (bx << ps) + np.arange(1 << ps)
            ok = ws < W
            smem_blk[bx, ok], smem_off[bx, ok] = _slots(tables, start, valid, bs, N, b, ws[ok])
        blk, off = smem_blk[x, pw], smem_off[x, pw]
        go = live & (blk >= 0)
        for h in range(2):
            vals = np.zeros((len(lane), 8), dtype=np.float32 if scales is None else np.int8)
            cols = lane[on, None] * 8 + np.arange(8)
            vals[on] = src[h][b, kvh[on, None], w[on, None], cols]
            if scales is None:
                a = np.abs(vals).max(axis=1)
                group = ((x * plan[5] + z) * plan[2] + t) >> ls
                gmax = np.zeros(group.max() + 1, dtype=np.float32)
                np.maximum.at(gmax, group, a)  # the shuffle reduction over the group
                scale = np.maximum(gmax[group], np.float32(1e-12)) / np.float32(127)
                codes = np.clip(np.rint(vals / scale[:, None]), -127, 127).astype(np.int8)
            else:
                codes = vals
                scale = np.zeros(len(lane), dtype=np.float32)
                scale[live] = scales[h][b, kvh[live], w[live]]
            st = go & on
            pools[h][blk[st, None], kvh[st, None], off[st, None], lane[st, None] * 8 +
                     np.arange(8)] = codes[st]
            sc = go & (lane == 0)
            planes[h][blk[sc], kvh[sc], off[sc]] = scale[sc]


def _scatter_inputs(rng, B, KV, W, bs, nblk, N):
    """Tables with one entry outside the pool (N + 1), starts unaligned and
    one negative, row 1 with every position invalid and random holes."""
    tables = rng.permutation(np.arange(1, N))[: B * nblk].reshape(B, nblk).astype(np.int32)
    tables[0, 1] = N + 1
    start = rng.integers(-bs - 3, nblk * bs - W // 2, size=B).astype(np.int32)
    start[0] = bs - 3  # its positions cross into table entry 1, out of the pool
    start[-1] = -5
    valid = rng.random((B, W)) < 0.85
    valid[0, 3] = True  # position bs of row 0: table entry 1
    valid[min(1, B - 1)] = False
    return tables, start, valid


def _padded(t, extra):
    """A reference pool with `extra` blocks past the pool's last, where the
    reference's scatter puts what the kernel drops."""
    return torch.cat([t, torch.zeros((extra,) + tuple(t.shape[1:]), dtype=t.dtype)])


@pytest.mark.parametrize("dtype,hd,unit", [(torch.bfloat16, 64, 16), (torch.bfloat16, 64, 2),
                                           (torch.bfloat16, 32, 8), (torch.float32, 40, 16),
                                           (torch.float32, 32, 4), (torch.bfloat16, 16, 1)])
@pytest.mark.parametrize("KV,W,bs", [(4, 5, 16), (3, 130, 16), (16, 5, 8), (2, 37, 24)])
def test_scatter_through_the_plan_matches_the_reference(dtype, hd, unit, KV, W, bs):
    """The bf16 kernel's model (bytes of any dtype, in units of 16 down to
    1 byte) against kv_write_paged_reference, bit for bit outside the
    scratch block, with the drops that the reference writes past the pool."""
    rng = np.random.default_rng(hd * 7 + W + KV + unit)
    B, nblk = 3, -(-(W + 2 * bs + 8) // bs) + 1
    N = B * nblk + 2
    tables, start, valid = _scatter_inputs(rng, B, KV, W, bs, nblk, N)
    pk, pv = (torch.from_numpy(rng.standard_normal((N, KV, bs, hd), dtype=np.float32)).to(dtype)
              for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, W, hd), dtype=np.float32)).to(dtype)
            for _ in range(2))
    ref = [_padded(t, 3) for t in (pk, pv)]
    kw.kv_write_paged_reference(ref[0], ref[1], k, v, torch.from_numpy(tables),
                                torch.from_numpy(start), torch.from_numpy(valid))
    es = pk.element_size()
    for pool, src in ((pk, k), (pv, v)):
        pb = pool.view(torch.uint8).numpy().reshape(N, KV, bs, hd * es)
        sb = src.contiguous().view(torch.uint8).numpy().reshape(B, KV, W, hd * es)
        _model_bytes(pb, sb, tables, start, valid, unit)
    assert torch.equal(pk[1:], ref[0][1:N]) and torch.equal(pv[1:], ref[1][1:N])
    # the out-of-pool entry took writes that the kernel drops
    assert not torch.equal(ref[0][N:], torch.zeros_like(ref[0][N:]))


@pytest.mark.parametrize("copy", [False, True], ids=["quantize", "copy"])
@pytest.mark.parametrize("KV,W,hd,bs", [(4, 5, 64, 16), (3, 130, 24, 16), (2, 37, 256, 24),
                                        (16, 5, 8, 8)])
def test_int8_scatter_through_the_plan_matches_the_reference(copy, KV, W, hd, bs):
    """The int8 kernel's model against kv_write_paged_reference: bf16 rows
    quantized (the reference's quantize_kv) or int8 rows with their scales
    copied; codes and scales bit for bit outside the scratch block."""
    rng = np.random.default_rng(hd + W + KV + copy)
    B, nblk = 3, -(-(W + 2 * bs + 8) // bs) + 1
    N = B * nblk + 2
    tables, start, valid = _scatter_inputs(rng, B, KV, W, bs, nblk, N)
    pools = [torch.from_numpy(rng.integers(-127, 128, (N, KV, bs, hd), dtype=np.int8))
             for _ in range(2)]
    planes = [torch.from_numpy(rng.random((N, KV, bs), dtype=np.float32)) for _ in range(2)]
    rows = [torch.from_numpy(3 * rng.standard_normal((B, KV, W, hd), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2)]
    k_s = v_s = None
    if copy:
        (k, k_s), (v, v_s) = (kw.quantize_kv(r) for r in rows)
    else:
        k, v = rows
    ref = [_padded(t, 3) for t in pools + planes]
    kw.kv_write_paged_reference(ref[0], ref[1], k, v, torch.from_numpy(tables),
                                torch.from_numpy(start), torch.from_numpy(valid),
                                (ref[2], ref[3]), k_s, v_s)
    src = [t.numpy() if copy else t.float().numpy() for t in (k, v)]
    scales = [t.numpy() for t in (k_s, v_s)] if copy else None
    _model_int8([p.numpy() for p in pools], [p.numpy() for p in planes], src, scales, tables,
                start, valid)
    for got, want in zip(pools + planes, ref):
        assert torch.equal(got[1:], want[1:N])
