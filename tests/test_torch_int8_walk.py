"""The int8-K/V tile walk of both decode kernels (``ops/csrc/int8_walk.cuh``)
in numpy, from the plan ``ops/flash_decode.py`` states for it: the codes'
widening to bf16 (``kvq::codes_bf16x2`` in ``kv_int8.cuh``) for every byte,
bit for bit; the staged tile's swizzle, q's k order, V's n order, the
fragment assembly and the un-permuting store, which must give Q K^T and
P V exactly (f64 sums of exact products) at hd 16, 64, 128 and 256; the
operand loads' shared-memory banks; the shared-memory plan and the
two-tier variant's split.  The kernels themselves are held to their plain
versions on the card (``tests/test_torch_quant.py``'s ``cuda`` tests and
chip_smoke.py phase 10k)."""

import numpy as np
import pytest

from seldon_core_tpu_torch.ops import flash_decode as fd

TILE = 16


def _bf16_value(h):
    """bf16 bit patterns (uint32 holding 16 bits) as f64."""
    return (np.asarray(h, dtype=np.uint32) << 16).view(np.float32).astype(np.float64)


def _codes_bf16x2(w):
    """kvq::codes_bf16x2 on uint32 words: (low half, high half) as f64, the
    result of fma.rn.bf16x2(a, 1.0, n), with a and n its two LOP3s'."""
    w = np.asarray(w, dtype=np.uint32)
    a = (w & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    n = (w & np.uint32(0x00800080)) | np.uint32(0xC300C300)
    halves = []
    for shift in (0, 16):
        exact = _bf16_value((a >> shift) & 0xFFFF) * 1.0 + _bf16_value((n >> shift) & 0xFFFF)
        halves.append(exact)
    return halves


def test_codes_widen_to_bf16_exactly_for_every_byte():
    """Every pair of bytes in positions 0 and 2 of a word (and 1 and 3,
    through w >> 8), all 65,536 of them: the two halves' sum is the int8
    value exactly, an integer in [-128, 127] that bf16 holds exactly, so the
    FMA's rounding leaves it as it is and its bits are the integer's bf16,
    the upper half of its f32, bit for bit."""
    lo, hi = np.meshgrid(np.arange(256, dtype=np.uint32), np.arange(256, dtype=np.uint32))
    lo, hi = lo.ravel(), hi.ravel()
    junk = np.random.default_rng(0).integers(0, 256, size=(2, lo.size)).astype(np.uint32)
    for word, shift in ((lo | junk[0] << 8 | hi << 16 | junk[1] << 24, 0),
                        (junk[0] | lo << 8 | junk[1] << 16 | hi << 24, 8)):
        got_lo, got_hi = _codes_bf16x2(word >> np.uint32(shift))
        for got, byte in ((got_lo, lo), (got_hi, hi)):
            want = byte.astype(np.uint8).view(np.int8).astype(np.float64)
            np.testing.assert_array_equal(got, want)
            f32 = want.astype(np.float32).view(np.uint32)
            assert not (f32 & 0xFFFF).any()  # exact in bf16: its bits are the f32's upper half


def _stage(codes, cols, rng):
    """A [TILE, hd] tile of codes staged as the lanes' cp.async write it:
    chunk c of row r at i8_stage_offset(cols, r, c); bytes past hd hold
    whatever the stage held (random here)."""
    hd = codes.shape[1]
    buf = rng.integers(0, 256, size=TILE * cols, dtype=np.uint8)
    seen = set()
    for r in range(TILE):
        for c in range(cols // 16):
            off = fd.i8_stage_offset(cols, r, c)
            assert off % 16 == 0 and 0 <= off < TILE * cols and off not in seen
            seen.add(off)
            if c < hd // 16:
                buf[off:off + 16] = codes[r, 16 * c:16 * c + 16].view(np.uint8)
    return buf


def _bytes_at(buf, cols, r, byte, width):
    """`width` bytes of row r from byte `byte` of the row (within one chunk)."""
    off = fd.i8_stage_offset(cols, r, byte // 16) + byte % 16
    assert byte % 16 + width <= 16
    return buf[off:off + width]


def _words(b):
    return b.view("<u4")


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode): byte i of the result is byte (sel >> 4
    i) & 7 of b:a."""
    src = np.concatenate([np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)])
    return np.uint32(sum(int(src[(sel >> 4 * i) & 7]) << 8 * i for i in range(4)))


def _bf16(x):
    """Round f32 values to bf16 (to nearest even), as f64."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return u.view(np.float32).astype(np.float64)


def _a_matrix(frag):
    """A (16x16) of m16n8k16 from each lane's (a0, a1, a2, a3), each a pair
    (low, high): a0 rows gid, k 2 tig + {0, 1}; a1 rows gid + 8; a2 k + 8;
    a3 both."""
    A = np.zeros((16, 16))
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            A[gid + dr, 2 * tig + dk:2 * tig + dk + 2] = frag[lane][i]
    return A


def _b_matrix(frag):
    """B (16x8) of m16n8k16 from each lane's (b0, b1): column gid, k 2 tig +
    {0, 1} and 2 tig + 8 + {0, 1}."""
    Bm = np.zeros((16, 8))
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        Bm[2 * tig:2 * tig + 2, gid] = frag[lane][0]
        Bm[2 * tig + 8:2 * tig + 10, gid] = frag[lane][1]
    return Bm


@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("rows", [4, 16])
def test_operand_maps_give_qk_and_pv_exactly(hd, rows):
    """The walk's per-tile products emulated lane by lane from the staged
    tile: q's A operand by i8_k_dims, each K B operand from the lane's
    cols/4-byte run of its position (bytes 0, 2 and 1, 3 of each word, by
    codes_bf16x2), S = Q K^T through m16n8k16's fragment layouts; P's A
    operand from the S accumulator's layout, each V B operand from the
    lane's cols/8 bytes of positions 2 tig + {0, 1, 8, 9} paired byte by
    byte, O = P V, stored back by i8_v_dims.  Q K^T and P V come out exactly
    (bf16 times int8 products, f64 sums), past hd nothing leaks in."""
    rng = np.random.default_rng(hd + rows)
    cols = fd.i8_walk_layout(hd, rows)["cols"]
    ks_, nt, qb = cols // 16, cols // 8, cols // 4
    k_codes = rng.integers(-128, 128, size=(TILE, hd)).astype(np.int8)
    v_codes = rng.integers(-128, 128, size=(TILE, hd)).astype(np.int8)
    q = np.zeros((16, hd))
    q[:rows] = _bf16(rng.standard_normal((rows, hd)).astype(np.float32))
    kt, vt = _stage(k_codes, cols, rng), _stage(v_codes, cols, rng)
    kdims = fd.i8_k_dims(cols)

    def qval(row, dim):
        return q[row, dim] if dim < hd else 0.0

    S = np.zeros((16, TILE))
    for t in range(2):
        for ks in range(ks_):
            afrag, bfrag = [], []
            for lane in range(32):
                gid, tig = lane // 4, lane % 4
                d = kdims[tig, ks]
                afrag.append([[qval(gid + dr, d[j]), qval(gid + dr, d[j + 1])]
                              for dr, j in ((0, 0), (8, 0), (0, 2), (8, 2))])
                run = np.concatenate([_bytes_at(kt, cols, 8 * t + gid, qb * tig + 16 * h, 16)
                                      for h in range(max(qb // 16, 1))])[:qb]
                w = _words(run.copy())[ks]
                bfrag.append([_codes_bf16x2(w), _codes_bf16x2(w >> np.uint32(8))])
            S[:, 8 * t:8 * t + 8] += _a_matrix(afrag) @ _b_matrix(bfrag)
    np.testing.assert_array_equal(S, q @ k_codes.T.astype(np.float64))

    # P V: P (bf16) of the S accumulator's layout, one k-step of 16 positions
    P = np.zeros((16, TILE))
    P[:rows] = _bf16(rng.random((rows, TILE)).astype(np.float32))
    afrag = []
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        afrag.append([P[gid + dr, 2 * tig + dk:2 * tig + dk + 2]
                      for dr, dk in ((0, 0), (8, 0), (0, 8), (8, 8))])
    A = _a_matrix(afrag)
    np.testing.assert_array_equal(A, P)
    vdims = fd.i8_v_dims(cols)
    O = np.full((16, cols), np.nan)
    acc = np.zeros((32, nt, 4))
    rows_of = [lambda tig, s=s: 2 * tig + (s & 1) + 8 * (s >> 1) for s in range(4)]
    for j in range(nt):
        bfrag = []
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            vw = [_bytes_at(vt, cols, rows_of[s](tig), nt * gid + 4 * (j // 4), 4)
                  for s in range(4)]
            sel = (j & 3) | (4 + (j & 3)) << 8  # byte j % 4 of each into bytes 0 and 2
            low, high = _prmt(vw[0], vw[1], sel), _prmt(vw[2], vw[3], sel)
            bfrag.append([_codes_bf16x2(low), _codes_bf16x2(high)])
        C = A @ _b_matrix(bfrag)  # [16, 8]: column gid of n-tile j
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            acc[lane, j] = [C[gid, 2 * tig], C[gid, 2 * tig + 1], C[gid + 8, 2 * tig],
                            C[gid + 8, 2 * tig + 1]]
            assert vdims[gid, j] == nt * gid + j
    for lane in range(32):  # the store: acc[j][e] to dim nt (2 tig + e) + j
        gid, tig = lane // 4, lane % 4
        for e in range(2):
            for j in range(nt):
                O[gid, nt * (2 * tig + e) + j] = acc[lane, j, e]
                O[gid + 8, nt * (2 * tig + e) + j] = acc[lane, j, 2 + e]
    np.testing.assert_array_equal(O[:, :hd], P @ v_codes.astype(np.float64))


def _conflicts(accesses):
    """The most distinct 4-byte words any bank serves in one phase of a
    shared-memory access: accesses are (byte address, width) per lane."""
    banks = {}
    for addr, width in accesses:
        for w in range(addr // 4, (addr + width) // 4):
            banks.setdefault(w % 32, set()).add(w)
    return max(len(ws) for ws in banks.values())


@pytest.mark.parametrize("cols,k_ways,v_ways", [(64, 1, 1), (128, 1, 1), (256, 1, 2)])
def test_operand_loads_are_bank_conflict_free(cols, k_ways, v_ways):
    """The walk's shared-memory loads, served 128 bytes at a time: a phase
    of 8 lanes for 16-byte loads, 16 for 8-byte ones.  K (a lane's cols / 4
    bytes of position 8 t + gid, one 16-byte load a chunk) and V (its cols /
    8 bytes of positions 2 tig + {0, 1, 8, 9}, one load a position and
    chunk) are conflict-free at 64 and 128 bytes a row; at 256, V is
    2-way."""
    qb, nt = cols // 4, cols // 8
    worst_k = worst_v = 0
    for t in range(2):
        for h in range(qb // 16):
            lanes = [(fd.i8_stage_offset(cols, 8 * t + lane // 4, (qb // 16) * (lane % 4) + h), 16)
                     for lane in range(32)]
            worst_k = max(worst_k, *(_conflicts(lanes[p:p + 8]) for p in range(0, 32, 8)))
    width = min(nt, 16)
    phase = 128 // width
    for s in range(4):
        for h in range(max(nt // 16, 1)):
            lanes = []
            for lane in range(32):
                gid, tig = lane // 4, lane % 4
                byte = nt * gid + 16 * h
                r = 2 * tig + (s & 1) + 8 * (s >> 1)
                lanes.append((fd.i8_stage_offset(cols, r, byte // 16) + byte % 16, width))
            worst_v = max(worst_v, *(_conflicts(lanes[p:p + phase]) for p in range(0, 32, phase)))
    assert (worst_k, worst_v) == (k_ways, v_ways)


def test_the_walks_shared_memory_plan():
    """i8_walk_layout, both variants' plan (the card holds it to both
    sources): 8 rows a block up to a group of 8, else 16; 8 warps up to hd
    128, else 4; stages of two [16, cols] code tiles and 32 scales; rings
    of 3 stages a warp at hd 64 (52 KB of a block: more than the ~20 KB of
    copies an SM must keep in flight) and 2 above (66-68 KB); within the
    227 KB a block may take at every head dim and group it serves."""
    lay = fd.i8_walk_layout(64, 4)
    assert (lay["rows"], lay["warps"], lay["cols"], lay["depth"], lay["stage"]) == (
        8, 8, 64, 3, 2176)
    assert lay["bytes"] == 52544
    for hd in range(16, 257, 16):
        for group in (1, 2, 4, 8, 12, 16):
            lay = fd.i8_walk_layout(hd, group)
            assert lay["rows"] == (16 if group > 8 else 8)
            assert lay["stage"] == 2 * TILE * lay["cols"] + 2 * TILE * 4 and lay["cols"] >= hd
            assert 2 <= lay["depth"] <= 4
            ring = lay["warps"] * lay["depth"] * lay["stage"]
            assert ring >= 20 * 1024 and lay["bytes"] <= 232448


@pytest.mark.parametrize("B,G,n,want", [(32, 4, 560, 1), (32, 4, 4160, 2), (1, 4, 153, 2),
                                        (1, 4, 640, 8), (2, 4, 440, 4), (1, 16, 256, 4),
                                        (1, 4, 1, 1), (8, 1, 344, 4), (1, 4, 505, 8),
                                        (8, 4, 8192, 4), (64, 4, 4160, 1)])
def test_the_int8_split(B, G, n, want):
    """i8_split_plan on 132 SMs: the bf16 plan's cluster size at the int8
    walk's row tile (16) and grid aim (0.9), doubled for long rows while two
    blocks an SM hold the grid and each keeps 2,048 positions (B=32 at
    4,160: 2; B=64 already fills the card); a span that is a multiple of 16,
    so every rank's share starts at a fixed multiple of 16 and covers n
    (the last ranks may take nothing)."""
    C, span = fd.i8_split_plan(B, 4, G, n, 132)
    assert C == want and span == TILE * -(-n // (TILE * C)) and C * span >= n
    base = fd.decode_split_plan(B, 4, G, n, 132, 16, 0.9)[0]
    assert C == base or -(-n // C) >= 2048


@pytest.mark.parametrize("width,want", [(1024, 1), (4224, 2), (8192, 2), (16384, 2)])
def test_the_int8_paged_cluster(width, want):
    """i8_paged_cluster at the served round's heads (B=32, 4 kv heads of 4)
    on 132 SMs: paged_cluster's 1, doubled once the table's width leaves
    each of two blocks 2,048 positions (a third doubling would not fit two
    blocks an SM); the bf16 paged kernel's own cluster stays 1."""
    assert fd.i8_paged_cluster(32, 4, 4, width, 132) == want
    assert fd.paged_cluster(32, 4, 4, width, 132) == 1
