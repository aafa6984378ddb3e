"""The port's disaggregated prefill/decode roles (seldon_core_tpu_torch/
runtime/servingmesh.py, runtime/kvstream.py, the genserver's role and
import machinery, the relay's OP_KVSTREAM and TCP lane) on the CPU: the
cases of tests/test_servingmesh.py, either role over a tp mesh among
them, the admission shed of a prefill replica, and the wire both ways
against the JAX package's kvstream.

The contracts: a hand-off is greedy-token-identical to the unified
scheduler (f32 and an int8 K/V pool, in process and over the unix and TCP
relays); a torn or aborted hand-off gives back every reserved block; role
faults answer typed 503s; ``SELDON_TPU_DISAGG=0`` serves unified; a frame
the port encodes decodes with the reference's kvstream into the same
arrays, bf16 by its bits, and the reverse."""

import asyncio
import json
import os
import tempfile
import threading
import time
import uuid

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.runtime import kvstream as jkv
from seldon_core_tpu.runtime.genserver import GenServer as JaxGenServer
from seldon_core_tpu.models.generate import TransformerGenerator as JaxGenerator
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import LoadShedError
from seldon_core_tpu_torch.models.generate import TransformerGenerator, init_block_pool
from seldon_core_tpu_torch.runtime import kvstream
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.genserver import BlockAllocator, GenServer
from seldon_core_tpu_torch.runtime.servingmesh import (
    DisaggCoordinator,
    HandoffError,
    RoleMismatchError,
    resolve_gen_role,
)
from seldon_core_tpu_torch.runtime.udsrelay import serve_relay_tcp, serve_uds

WAIT_S = 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


def _unit(**overrides):
    kw = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_new_tokens=16,
              dtype="float32", eos_token=-1)
    kw.update(overrides)
    return TransformerGenerator(**kw, device="cpu")


def _genserver(unit=None, role="unified", coordinator=None, **kw):
    unit = unit or _unit()
    spec = unit.continuous_spec(unit.init_state(None))
    defaults = dict(num_blocks=64, block_size=4, span=4, prefill_chunk=8)
    defaults.update(kw)
    return GenServer(**spec, role=role, coordinator=coordinator, **defaults)


class LoopbackCoordinator:
    """An in-process hand-off over the real wire format (encode
    and parse every frame) against a decode GenServer: the relay minus
    the socket."""

    def __init__(self, decode_gs, chunk=2):
        self.decode = decode_gs
        self.chunk = chunk

    def submit(self, export, done_cb):
        threading.Thread(target=self._run, args=(export, done_cb), daemon=True).start()

    def _run(self, export, done_cb):
        hid = uuid.uuid4().bytes
        try:
            _, h, body = kvstream.parse_frame(kvstream.begin_frame(export, hid))
            self.decode.kv_reserve(h, kvstream.parse_begin(body))
            for fr in kvstream.block_frames(export, hid, self.chunk):
                _, h2, b2 = kvstream.parse_frame(fr)
                first, layers = kvstream.parse_blocks(b2, self.decode._imports[h2].meta)
                self.decode.kv_receive(h2, first, layers)
            req = self.decode.kv_commit(h)
            done_cb(np.asarray(req.future.result(timeout=WAIT_S))[0])
        except BaseException as e:  # noqa: BLE001 - surfaced per request
            done_cb(e)

    def close(self):
        pass

    def snapshot(self):
        return {"loopback": True}

    def chain_estimate_s(self):
        return None


class Capture:
    """A coordinator that keeps the export instead of handing it off."""

    def __init__(self):
        self.got = {}

    def submit(self, export, done_cb):
        self.got["export"], self.got["done"] = export, done_cb

    def close(self):
        pass

    def snapshot(self):
        return {}

    def chain_estimate_s(self):
        return None


_PROMPT = (np.arange(22) % 13 + 1).reshape(1, -1)


def _wait_blocks_freed(gs, timeout_s=10.0):
    """Every block back, allowing the retire a tick after the answer."""
    deadline = time.monotonic() + timeout_s
    while gs._allocator.used != 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert gs._allocator.used == 0


def _export_for(gs, prompt):
    """Run a prefill-role scheduler up to its export, captured."""
    cap = Capture()
    gs.coordinator = cap
    cap.got["req"] = gs.submit(prompt)
    deadline = time.monotonic() + 60
    while "export" not in cap.got and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "export" in cap.got, "prefill never exported"
    return cap.got


def _stream_all(decode, export, hid, chunk=2):
    for fr in kvstream.block_frames(export, hid, chunk):
        _, h2, b2 = kvstream.parse_frame(fr)
        first, layers = kvstream.parse_blocks(b2, export.meta)
        decode.kv_receive(h2, first, layers)


# -- the hand-off, in process ----------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_disagg_token_identical_to_unified(kv_quant):
    """f32 and an int8 K/V pool; the unified answer is also the JAX
    scheduler's on the same weights."""
    unit = _unit(kv_quant=kv_quant)
    unified = _genserver(_unit(kv_quant=kv_quant))
    decode = _genserver(_unit(kv_quant=kv_quant), role="decode")
    prefill = _genserver(unit, role="prefill", coordinator=LoopbackCoordinator(decode))
    try:
        y0 = unified.submit(_PROMPT).future.result(timeout=WAIT_S)
        y1 = prefill.submit(_PROMPT).future.result(timeout=WAIT_S)
        np.testing.assert_array_equal(y0, y1)
        assert prefill.retired_total.get("handoff") == 1
        assert decode.imports_committed_total == 1
        assert prefill.snapshot()["role"] == "prefill" and decode.snapshot()["role"] == "decode"
        _wait_blocks_freed(prefill)
        _wait_blocks_freed(decode)
    finally:
        for gs in (unified, prefill, decode):
            gs.stop()
    if kv_quant == "none":
        junit = JaxGenerator(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                             max_new_tokens=16, dtype="float32", eos_token=-1)
        jstate = junit.init_state(jax.random.key(0))
        jgs = JaxGenServer(**junit.continuous_spec(jstate), num_blocks=64, block_size=4,
                           span=4, prefill_chunk=8)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                                 device="cpu")
        spec = {**_unit().continuous_spec(_unit().init_state(None)), "params": params}
        knobs = dict(num_blocks=64, block_size=4, span=4, prefill_chunk=8)
        decode = GenServer(**spec, role="decode", **knobs)
        prefill = GenServer(**spec, role="prefill", coordinator=LoopbackCoordinator(decode),
                            **knobs)
        try:
            want = jgs.submit(_PROMPT).future.result(timeout=WAIT_S)
            np.testing.assert_array_equal(prefill.submit(_PROMPT).future.result(timeout=WAIT_S),
                                          np.asarray(want))
        finally:
            for gs in (jgs, prefill, decode):
                gs.stop()


def test_disagg_multi_request_streams_match_unified():
    """Co-scheduled requests hand off one by one; every stream joins to the
    unified answer."""
    unified = _genserver()
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill", coordinator=LoopbackCoordinator(decode))
    try:
        prompts = [(np.arange(10 + 3 * i) % 17 + 1).reshape(1, -1) for i in range(3)]
        want = [unified.submit(p).future.result(timeout=WAIT_S) for p in prompts]
        reqs = [prefill.submit(p) for p in prompts]
        for w, r in zip(want, reqs):
            np.testing.assert_array_equal(w, r.future.result(timeout=WAIT_S))
        streamed = np.concatenate(list(prefill.stream(prompts[1], chunk=5)), axis=1)
        np.testing.assert_array_equal(streamed, want[1])
        assert prefill.retired_total.get("handoff") == 4
    finally:
        for gs in (unified, prefill, decode):
            gs.stop()


# -- torn hand-offs ---------------------------------------------------------------


def test_torn_handoff_reclaims_all_blocks():
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill")
    try:
        got = _export_for(prefill, _PROMPT)
        export = got["export"]
        hid = uuid.uuid4().bytes
        decode.kv_reserve(hid, export.meta)
        snap = decode._allocator.snapshot()
        assert snap["reserved"] == export.meta.n_blocks
        assert decode.snapshot()["kv_blocks"]["reserved"] == export.meta.n_blocks
        baseline_used = snap["used"] - snap["reserved"]
        # one chunk, then the tear
        _, _, b2 = kvstream.parse_frame(next(iter(kvstream.block_frames(export, hid, 2))))
        decode.kv_receive(hid, *kvstream.parse_blocks(b2, export.meta))
        assert decode.kv_abort(hid) is True
        snap = decode._allocator.snapshot()
        assert snap["reserved"] == 0 and snap["used"] == baseline_used
        assert decode.imports_reclaimed_total == 1
        # the prefill request fails typed once the coordinator says so
        got["done"](HandoffError("torn mid-stream"))
        with pytest.raises(HandoffError):
            got["req"].future.result(timeout=60)
    finally:
        prefill.stop()
        decode.stop()


def test_commit_before_all_blocks_is_torn_and_reclaims():
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill")
    try:
        export = _export_for(prefill, _PROMPT)["export"]
        hid = uuid.uuid4().bytes
        decode.kv_reserve(hid, export.meta)
        with pytest.raises(kvstream.KvWireError, match="torn"):
            decode.kv_commit(hid)
        assert decode._allocator.snapshot()["reserved"] == 0
        assert decode.imports_reclaimed_total == 1
    finally:
        prefill.stop()
        decode.stop()


def test_ttl_reaper_reclaims_stale_import():
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill")
    try:
        export = _export_for(prefill, _PROMPT)["export"]
        decode.kv_reserve(uuid.uuid4().bytes, export.meta)
        decode._import_ttl_s = 0.05
        assert decode._allocator.snapshot()["reserved"] > 0
        time.sleep(0.1)
        with decode._wake:
            decode._wake.notify_all()
        deadline = time.monotonic() + 10
        while decode.imports_reclaimed_total == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        snap = decode._allocator.snapshot()
        assert decode.imports_reclaimed_total == 1
        assert snap["reserved"] == 0 and snap["used"] == 0
    finally:
        prefill.stop()
        decode.stop()


def test_commit_racing_ttl_reap_answers_typed_not_corrupt():
    """A COMMIT after the reaper took the reservation answers "unknown or
    expired", never admits onto blocks back on the free list."""
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill")
    try:
        export = _export_for(prefill, _PROMPT)["export"]
        hid = uuid.uuid4().bytes
        decode.kv_reserve(hid, export.meta)
        _stream_all(decode, export, hid)
        imp = decode._imports.pop(hid)  # the reaper wins: the same pop-first claim
        decode._allocator.release_reserved(imp.blocks)
        with pytest.raises(kvstream.KvWireError, match="unknown"):
            decode.kv_commit(hid)
        assert not decode._remote_arrivals
    finally:
        prefill.stop()
        decode.stop()


def test_stop_fails_requests_with_handoff_in_flight():
    prefill = _genserver(role="prefill")
    got = _export_for(prefill, _PROMPT)  # parked at the coordinator, never done
    prefill.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        got["req"].future.result(timeout=30)


def test_fail_all_releases_committed_import_reservations():
    """A committed import not yet admitted holds RESERVED blocks: a failure
    before admission must give them back."""
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill")
    try:
        export = _export_for(prefill, _PROMPT)["export"]
        hid = uuid.uuid4().bytes
        decode.kv_reserve(hid, export.meta)
        _stream_all(decode, export, hid)
        req = decode.kv_commit(hid)
        if decode._remote_arrivals:  # a failure before the scheduler admitted it
            decode._fail_all(RuntimeError("boom"))
        # whichever won, no reservation may remain
        deadline = time.monotonic() + 30
        while decode._allocator.snapshot()["reserved"] > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert decode._allocator.snapshot()["reserved"] == 0
        try:
            req.future.result(timeout=60)
        except RuntimeError:
            pass
    finally:
        prefill.stop()
        decode.stop()


# -- role faults, the kill switch ---------------------------------------------------


def test_generation_at_decode_replica_is_typed_503():
    decode = _genserver(role="decode")
    try:
        with pytest.raises(RoleMismatchError) as ei:
            decode.submit(_PROMPT)
        assert ei.value.http_code == 503
        assert decode.prewarm() == 0
    finally:
        decode.stop()


def test_prefill_without_peers_fails_typed():
    prefill = _genserver(role="prefill")
    try:
        with pytest.raises(HandoffError):
            prefill.submit(_PROMPT).future.result(timeout=60)
    finally:
        prefill.stop()


def test_kill_switch_forces_unified_role(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_DISAGG", "0")
    assert resolve_gen_role("prefill") == "unified"
    assert resolve_gen_role("decode") == "unified"
    monkeypatch.delenv("SELDON_TPU_DISAGG")
    assert resolve_gen_role("prefill") == "prefill"
    with pytest.raises(ValueError, match="unknown generation role"):
        resolve_gen_role("both")


def test_speculative_mode_under_a_role_is_refused_in_the_reference_s_words():
    from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator

    unit = SpeculativeGenerator(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                                dtype="float32", device="cpu")
    spec = unit.continuous_spec(unit.init_state(None))
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="speculative decoding does not compose with "
                                             "disaggregated prefill/decode roles"):
            GenServer(**spec, role=role)


# -- the allocator ------------------------------------------------------------------


def test_reserved_blocks_refused_by_free_and_invisible_to_eviction():
    alloc = BlockAllocator(16)
    owned = alloc.alloc(5)
    reserved = alloc.reserve(4)
    alloc.free(reserved)  # refused: an in-flight import's blocks
    assert alloc.snapshot()["reserved"] == 4 and alloc.used == 9
    alloc.free(owned)
    assert alloc.used == 4
    got = alloc.alloc(11)
    assert got is not None and not set(got) & set(reserved)
    alloc.free(got)
    alloc.release_reserved(reserved)
    assert alloc.used == 0
    alloc.release_reserved(reserved)  # a double release is harmless
    assert alloc.used == 0


def test_pinned_blocks_never_freed():
    alloc = BlockAllocator(8)
    blocks = alloc.alloc(3)
    alloc.pin(blocks[:2])
    alloc.free(blocks)
    assert alloc.used == 2 and alloc.snapshot()["pinned"] == 2


def _submit_local(decode_gs, prompt):
    """Churn traffic at a decode replica: the role's guard is a routing
    contract, not a scheduler limit."""
    real, decode_gs.role = decode_gs.role, "unified"
    try:
        return decode_gs.submit(prompt)
    finally:
        decode_gs.role = real


def test_eviction_pressure_never_touches_reserved_import():
    unified = _genserver(num_blocks=20)
    decode = _genserver(role="decode", num_blocks=20, slots=2)
    prefill = _genserver(role="prefill", num_blocks=20)
    try:
        want = unified.submit(_PROMPT).future.result(timeout=WAIT_S)
        export = _export_for(prefill, _PROMPT)["export"]
        hid = uuid.uuid4().bytes
        decode.kv_reserve(hid, export.meta)
        reserved = set(decode._imports[hid].blocks)
        churn = [_submit_local(decode, (np.arange(12) % 7 + 1).reshape(1, -1)) for _ in range(3)]
        for r in churn:
            r.future.result(timeout=WAIT_S)
        assert set(decode._imports[hid].blocks) == reserved
        assert decode._allocator.snapshot()["reserved"] == len(reserved)
        _stream_all(decode, export, hid)
        got = np.asarray(decode.kv_commit(hid).future.result(timeout=WAIT_S))
        np.testing.assert_array_equal(want, got)
    finally:
        for gs in (unified, prefill, decode):
            gs.stop()


# -- the wire -----------------------------------------------------------------------


def test_wire_roundtrip_preserves_meta_and_tensors():
    meta = kvstream.KvBeginMeta(
        n_layers=2, block_size=4, kv_heads=2, head_dim=16, dtype="float32", n_blocks=3,
        n_valid=9, pending=42, max_new=16, prefix_len=0, prompt=np.arange(9, dtype=np.int32),
        emitted=[42], key_data=np.asarray([1, 2, 3, 4], np.uint32), tier="batch")
    rng = np.random.default_rng(0)
    layers = [{"k": rng.normal(size=(3, 4, 2, 16)).astype(np.float32),
               "v": rng.normal(size=(3, 4, 2, 16)).astype(np.float32)} for _ in range(2)]
    export = kvstream.KvExport(meta=meta, layers=layers)
    hid = uuid.uuid4().bytes
    sub, h, body = kvstream.parse_frame(kvstream.begin_frame(export, hid))
    assert (sub, h) == (kvstream.KV_BEGIN, hid)
    got = kvstream.parse_begin(body)
    assert (got.n_layers, got.block_size, got.kv_heads, got.head_dim, got.dtype, got.n_blocks,
            got.n_valid, got.pending, got.max_new, got.tier) == (
        2, 4, 2, 16, "float32", 3, 9, 42, 16, "batch")
    np.testing.assert_array_equal(got.prompt, meta.prompt)
    assert got.emitted == [42]
    np.testing.assert_array_equal(got.key_data, meta.key_data)
    frames = list(kvstream.block_frames(export, hid, 2))
    assert len(frames) == 2  # 3 blocks at chunk 2
    staged = [{n: np.zeros((3, 4, 2, 16), np.float32) for n in ("k", "v")} for _ in range(2)]
    for fr in frames:
        first, chunk = kvstream.parse_blocks(kvstream.parse_frame(fr)[2], got)
        for stage, lay in zip(staged, chunk):
            for name, arr in lay.items():
                stage[name][first:first + arr.shape[0]] = arr
    for stage, lay in zip(staged, layers):
        for name in ("k", "v"):
            np.testing.assert_array_equal(stage[name], lay[name])
    toks = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(kvstream.unpack_tokens(kvstream.pack_tokens(toks)), toks)
    s = kvstream.unpack_stats(kvstream.pack_stats(10, 63, 1, 2))
    assert s == {"free": 10, "total": 63, "waiting": 1, "inflight": 2}
    with pytest.raises(kvstream.KvWireError, match="short"):
        kvstream.parse_frame(b"\x01")
    bad = kvstream.block_frames(export, hid, 3).__next__()[:-5]
    with pytest.raises(kvstream.KvWireError, match="truncated"):
        kvstream.parse_blocks(kvstream.parse_frame(bad)[2], got)


def _ref_layers(dtype, rng, n=3, bs=4, kv=2, hd=16, n_layers=2):
    """Reference-side arrays of a pool's blocks: bf16 as ml_dtypes,
    int8 with f32 scale planes."""
    out = []
    for _ in range(n_layers):
        if dtype == "int8":
            layer = {nm: rng.integers(-127, 128, (n, bs, kv, hd)).astype(np.int8)
                     for nm in ("k", "v")}
            layer.update({nm: rng.random((n, bs, kv)).astype(np.float32) for nm in ("k_s", "v_s")})
        else:
            dt = np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.dtype(dtype)
            layer = {nm: rng.normal(size=(n, bs, kv, hd)).astype(dt) for nm in ("k", "v")}
        out.append(layer)
    return out


def _bits(a):
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind != "i" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frames_cross_between_the_packages(dtype):
    """The reference's frames decode with the port's kvstream and the
    port's with the reference's, into the same arrays (bf16 by its bits);
    the header fields and the frames' bytes are the same."""
    rng = np.random.default_rng(5)
    ref_layers = _ref_layers(dtype, rng)
    fields = dict(n_layers=2, block_size=4, kv_heads=2, head_dim=16, dtype=dtype, n_blocks=3,
                  n_valid=10, pending=7, max_new=12, prefix_len=4,
                  prompt=np.arange(6, dtype=np.int32), emitted=[7, 3],
                  key_data=np.asarray([5, 6], np.uint32), tier="offline")
    jexp = jkv.KvExport(meta=jkv.KvBeginMeta(**fields), layers=ref_layers)
    port_layers = [{nm: _bits(a) for nm, a in layer.items()} for layer in ref_layers]
    pexp = kvstream.KvExport(meta=kvstream.KvBeginMeta(**fields), layers=port_layers)
    hid = uuid.uuid4().bytes
    assert kvstream.begin_frame(pexp, hid) == jkv.begin_frame(jexp, hid)
    pframes = list(kvstream.block_frames(pexp, hid, 2))
    jframes = list(jkv.block_frames(jexp, hid, 2))
    assert pframes == jframes
    # reference -> port
    pmeta = kvstream.parse_begin(kvstream.parse_frame(jkv.begin_frame(jexp, hid))[2])
    assert pmeta.__dict__.keys() == fields.keys() | {"tier"}
    for fr in jframes:
        first, layers = kvstream.parse_blocks(kvstream.parse_frame(fr)[2], pmeta)
        for got, want in zip(layers, ref_layers):
            for nm, arr in got.items():
                np.testing.assert_array_equal(arr, _bits(want[nm])[first:first + arr.shape[0]])
    # port -> reference
    jmeta = jkv.parse_begin(jkv.parse_frame(kvstream.begin_frame(pexp, hid))[2])
    for fr in pframes:
        first, layers = jkv.parse_blocks(jkv.parse_frame(fr)[2], jmeta)
        for got, want in zip(layers, ref_layers):
            for nm, arr in got.items():
                assert arr.dtype == want[nm].dtype
                np.testing.assert_array_equal(_bits(arr), _bits(want[nm])[first:first + len(arr)])


@pytest.mark.parametrize("dtype,kv_quant", [(torch.float32, "none"), (torch.bfloat16, "none"),
                                            (torch.float32, "int8")])
def test_a_pool_exports_in_the_wire_layout_and_scatters_back(dtype, kv_quant):
    """``export_blocks`` gives the reference's [n, bs, KV, hd] (scales
    [n, bs, KV]) of the port's [n, KV, bs, hd] pool, and ``scatter_staged``
    puts it back into other blocks bit for bit."""
    from seldon_core_tpu_torch.models.transformer import LMConfig

    cfg = LMConfig(vocab=16, d_model=32, n_heads=2, n_layers=2, d_ff=32, dtype=dtype,
                   kv_quant=kv_quant)
    pool = init_block_pool(cfg, 8, 4, "cpu")
    g = torch.Generator().manual_seed(0)
    for layer in pool.values():
        for nm, t in layer.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    out = kvstream.export_blocks(pool, [3, 1], cfg.kv_heads, cfg.n_heads)
    for li, layer in enumerate(out):
        for nm, arr in layer.items():
            src = pool[f"l{li}"][nm][[3, 1]].transpose(1, 2)
            if dtype == torch.bfloat16 and nm in ("k", "v"):
                assert arr.dtype == np.uint16
                src = src.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(arr, np.asarray(src))
    assert out[0]["k"].shape == (2, 4, 2, 16)
    fresh = init_block_pool(cfg, 8, 4, "cpu")
    kvstream.scatter_staged(fresh, [5, 6], out, cfg.n_heads)
    for li in range(2):
        for nm in pool[f"l{li}"]:
            assert torch.equal(fresh[f"l{li}"][nm][[5, 6]].view(torch.uint8),
                               pool[f"l{li}"][nm][[3, 1]].view(torch.uint8))


@pytest.mark.parametrize("axes,kv", [({"tp": 4}, 2), ({"dp": 2, "tp": 2}, 4), ({"tp": 2}, 1)])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_a_sharded_pool_exports_each_head_once_and_scatters_into_every_copy(axes, kv,
                                                                           kv_quant):
    """A ``ShardedTree`` pool (each kv head on every shard of its ``tp``
    group, or split; ``shard_kv_heads``) exports the whole pool's wire
    arrays, and a scatter into the genserver's pool (``shard_gen_pool``,
    allocated by shard) writes each head into every shard that holds it,
    the int8 scale planes too."""
    from seldon_core_tpu_torch.models.transformer import (LMConfig, kv_head_range,
                                                           shard_kv_heads)
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.servingmesh import shard_gen_pool

    heads = max(kv, axes["tp"])
    cfg = LMConfig(vocab=16, d_model=8 * heads, n_heads=heads, n_kv_heads=kv, n_layers=2,
                   d_ff=32, dtype=torch.float32, kv_quant=kv_quant)
    whole = init_block_pool(cfg, 8, 4, "cpu")
    g = torch.Generator().manual_seed(1)
    for layer in whole.values():
        for t in layer.values():
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8)
                    if t.dtype == torch.int8 else torch.randn(t.shape, generator=g))
    mesh = build_mesh(axes, devices=["cpu"] * (2 if axes == {"tp": 2} else 4))
    pool = shard_kv_heads(whole, mesh, heads)
    want = kvstream.export_blocks(whole, [3, 1], kv, heads)
    got = kvstream.export_blocks(pool, [3, 1], kv, heads)
    for w, o in zip(want, got):
        assert w.keys() == o.keys()
        for nm in w:
            np.testing.assert_array_equal(o[nm], w[nm])
    fresh = shard_gen_pool(mesh, cfg, 8, 4)
    kvstream.scatter_staged(fresh, [5, 6], got, heads)
    tp = mesh.shape["tp"]
    for i, shard in enumerate(fresh.shards):
        lo, hi = kv_head_range(kv, tp, mesh.coords(i)["tp"], heads)
        for li in range(2):
            for nm, t in shard[f"l{li}"].items():
                assert t.shape[1] == hi - lo
                assert torch.equal(t[[5, 6]], whole[f"l{li}"][nm][[3, 1]][:, lo:hi]), (i, nm)


def test_an_uneven_tp_pool_exports_each_head_once_and_scatters_into_both_copies():
    """40 heads over 10 kv heads at ``{"tp": 4}``: each shard's pool
    (``shard_gen_pool``) holds the three kv heads its query heads read,
    kv heads 2 and 7 on two shards each (``kv_heads_held`` with the query
    heads).  A sharded pool exports the whole pool's wire arrays, each
    head read once, and a scatter into the genserver's pool writes each
    shared head into both shards that hold it."""
    from seldon_core_tpu_torch.models.transformer import (LMConfig, kv_head_range,
                                                           shard_kv_heads)
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.servingmesh import shard_gen_pool

    cfg = LMConfig(vocab=16, d_model=320, n_heads=40, n_kv_heads=10, n_layers=2, d_ff=32,
                   dtype=torch.float32)
    whole = init_block_pool(cfg, 8, 4, "cpu")
    g = torch.Generator().manual_seed(2)
    for layer in whole.values():
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=g))
    mesh = build_mesh({"tp": 4}, devices=["cpu"] * 4)
    pool = shard_kv_heads(whole, mesh, cfg.n_heads)
    assert [(s["l0"]["k"].shape[1]) for s in pool.shards] == [3] * 4
    want = kvstream.export_blocks(whole, [3, 1], cfg.kv_heads, cfg.n_heads)
    got = kvstream.export_blocks(pool, [3, 1], cfg.kv_heads, cfg.n_heads)
    for w, o in zip(want, got):
        for nm in w:
            np.testing.assert_array_equal(o[nm], w[nm])
    fresh = shard_gen_pool(mesh, cfg, 8, 4)
    kvstream.scatter_staged(fresh, [5, 6], got, cfg.n_heads)
    held = [kv_head_range(10, 4, t, 40) for t in range(4)]
    assert held == [(0, 3), (2, 5), (5, 8), (7, 10)]
    for (lo, hi), shard in zip(held, fresh.shards):
        for li in range(2):
            for nm, t in shard[f"l{li}"].items():
                assert torch.equal(t[[5, 6]], whole[f"l{li}"][nm][[3, 1]][:, lo:hi]), (lo, nm)


def test_geometry_mismatch_refused_typed():
    decode = _genserver(role="decode")
    prefill = _genserver(role="prefill")
    try:
        export = _export_for(prefill, _PROMPT)["export"]
        for field, val, match in (("kv_heads", 7, "geometry"), ("dtype", "bfloat16", "dtype"),
                                  ("prefix_len", 3, "shared-prefix")):
            bad = kvstream.KvBeginMeta(**{**export.meta.__dict__, field: val})
            with pytest.raises(kvstream.KvWireError, match=match):
                decode.kv_reserve(uuid.uuid4().bytes, bad)
        assert decode._allocator.snapshot()["reserved"] == 0
    finally:
        prefill.stop()
        decode.stop()


def test_pool_full_reserve_sheds_typed_retryable():
    decode = _genserver(role="decode", num_blocks=4)  # 3 usable blocks
    prefill = _genserver(role="prefill")
    try:
        export = _export_for(prefill, _PROMPT)["export"]
        assert export.meta.n_blocks > 3
        with pytest.raises(LoadShedError):
            decode.kv_reserve(uuid.uuid4().bytes, export.meta)
    finally:
        prefill.stop()
        decode.stop()


# -- engines over the relays ---------------------------------------------------------


def _gen_spec(kv_quant="none"):
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in
              dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                   max_new_tokens=16).items()]
    params += [{"name": "dtype", "value": "float32", "type": "STRING"},
               {"name": "kv_quant", "value": kv_quant, "type": "STRING"}]
    return SeldonDeploymentSpec.from_json_dict({"spec": {"name": "d", "predictors": [{
        "name": "p", "graph": {"name": "gen", "type": "MODEL"},
        "components": [{"name": "gen", "runtime": "inprocess",
                        "class_path": "TransformerGenerator", "parameters": params}]}]}})


@pytest.mark.parametrize("lane", ["uds", "tcp"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_disagg_over_the_relay_token_identical_and_kill_switch(lane, kv_quant, monkeypatch):
    """A prefill and a decode EngineService over a real relay answer a
    unified engine's predictions; /stats shows the hand-off on both sides;
    a generation at the decode replica and a BEGIN at a unified one answer
    503; SELDON_TPU_DISAGG=0 serves unified."""
    decode_engine = EngineService(_gen_spec(kv_quant), device="cpu", gen_role="decode")
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    if lane == "uds":
        sock = os.path.join(tempfile.mkdtemp(prefix="seldon-kv-"), "decode.sock")
        server = asyncio.run_coroutine_threadsafe(serve_uds(decode_engine, sock), loop).result(10)
        peer = f"uds:{sock}"
    else:
        server = asyncio.run_coroutine_threadsafe(
            serve_relay_tcp(decode_engine, "127.0.0.1", 0), loop).result(10)
        peer = f"tcp:127.0.0.1:{server.port}"
    prefill_engine = EngineService(_gen_spec(kv_quant), device="cpu", gen_role="prefill",
                                   decode_peers=[peer])
    unified_engine = EngineService(_gen_spec(kv_quant), device="cpu")
    payload = json.dumps({"data": {"ndarray": [list(range(1, 23)), list(range(30, 41)) * 2]}})
    try:
        t0, s0 = asyncio.run(unified_engine.predict_json(payload))
        t1, s1 = asyncio.run(prefill_engine.predict_json(payload))
        assert s0 == s1 == 200
        a0 = np.asarray(json.loads(t0)["data"]["ndarray"])
        np.testing.assert_array_equal(a0, np.asarray(json.loads(t1)["data"]["ndarray"]))
        disagg = prefill_engine.stats()["genserver"]["disagg"]
        assert disagg["handoffs"].get("ok") == 2 and disagg["bytes_per_tok"] > 0
        assert disagg["handoff_ms_p50"] > 0 and disagg["peers"] == [peer]
        dstats = decode_engine.stats()["genserver"]
        assert dstats["role"] == "decode" and dstats["imports"]["committed_total"] == 2
        assert prefill_engine.stats()["genserver"]["role"] == "prefill"
        t2, s2 = asyncio.run(decode_engine.predict_json(payload))
        assert s2 == 503 and "decode-only" in t2
        begin = kvstream.begin_frame(kvstream.KvExport(meta=kvstream.KvBeginMeta(
            n_layers=2, block_size=16, kv_heads=2, head_dim=16, dtype="float32", n_blocks=1,
            n_valid=4, pending=1, max_new=4, prefix_len=0, prompt=np.arange(4, dtype=np.int32),
            emitted=[1], key_data=None)), uuid.uuid4().bytes)
        status, body = asyncio.run(unified_engine.kv_frame(begin))
        assert status == 503 and b"role misconfig" in body
        status, body = asyncio.run(unified_engine.kv_frame(kvstream.stats_frame()))
        assert status == 200 and kvstream.unpack_stats(body)["total"] > 0
        monkeypatch.setenv("SELDON_TPU_DISAGG", "0")
        killed = EngineService(_gen_spec(kv_quant), device="cpu", gen_role="prefill",
                               decode_peers=[peer])
        try:
            assert killed.gen_role == "unified"
            t3, s3 = asyncio.run(killed.predict_json(payload))
            assert s3 == 200
            np.testing.assert_array_equal(np.asarray(json.loads(t3)["data"]["ndarray"]), a0)
        finally:
            killed.close()
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        for e in (decode_engine, prefill_engine, unified_engine):
            e.close()


def test_coordinator_p2c_prefers_freer_peer_and_walks_on_refusal():
    """Two decode peers over real unix relays, one too small to take the
    hand-off: the free-block p2c prefers the big one, and a refusal walks
    on, so the hand-off lands."""
    tmp = tempfile.mkdtemp(prefix="seldon-kv-")
    small_sock, big_sock = os.path.join(tmp, "small.sock"), os.path.join(tmp, "big.sock")
    small = _genserver(role="decode", num_blocks=4)
    big = _genserver(role="decode")

    class _Shim:
        """Engine-shaped: the relay dispatches its KV frames here."""

        def __init__(self, gs):
            self.genserver = gs

        async def kv_frame(self, payload):
            eng = EngineService.__new__(EngineService)
            eng.genserver = self.genserver
            return await EngineService.kv_frame(eng, payload)

    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    s1 = asyncio.run_coroutine_threadsafe(serve_uds(_Shim(small), small_sock), loop).result(10)
    s2 = asyncio.run_coroutine_threadsafe(serve_uds(_Shim(big), big_sock), loop).result(10)
    prefill = _genserver(role="prefill")
    coord = DisaggCoordinator([f"uds:{small_sock}", f"uds:{big_sock}"])
    prefill.coordinator = coord
    try:
        unified = _genserver()
        want = unified.submit(_PROMPT).future.result(timeout=WAIT_S)
        unified.stop()
        for _ in range(3):  # whichever order the p2c draws, every hand-off lands on big
            np.testing.assert_array_equal(want,
                                          prefill.submit(_PROMPT).future.result(timeout=WAIT_S))
        assert big.imports_committed_total == 3 and small.imports_committed_total == 0
        snap = coord.snapshot()
        assert snap["handoffs"].get("ok") == 3
        assert f"uds:{big_sock}" in snap["peer_free_blocks"]
    finally:
        asyncio.run_coroutine_threadsafe(s1.stop(), loop).result(10)
        asyncio.run_coroutine_threadsafe(s2.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        prefill.stop()
        small.stop()
        big.stop()


def test_inprocess_endpoint_reads_engine_role():
    """The reference gateway's in-process endpoint reads the port engine's
    role, so phase routing keeps client traffic off a decode replica."""
    from seldon_core_tpu.gateway.balancer import ReplicaEndpoint

    engine = EngineService(_gen_spec(), device="cpu", gen_role="decode")
    try:
        assert ReplicaEndpoint(engine).role == "decode"
    finally:
        engine.close()


# -- the admission shed of a prefill replica (Queue 3 item 8) -----------------------


class _Chain:
    """A stand-in genserver holding only a coordinator."""

    def __init__(self, coordinator):
        self.coordinator = coordinator


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_the_gen_lane_prices_the_chain_on_a_prefill_replica(package):
    """Both packages' ``GenLane``s answer their prefill coordinator's
    running chain mean (``chain_estimate_s``: None until a hand-off
    completed) and None on a replica with no coordinator."""
    if package == "jax":
        from seldon_core_tpu.runtime.batching import GenLane as Lane
        from seldon_core_tpu.runtime.servingmesh import DisaggCoordinator as Coordinator
    else:
        from seldon_core_tpu_torch.runtime.batching import GenLane as Lane
        Coordinator = DisaggCoordinator
    coord = Coordinator(["uds:/nonexistent/decode.sock"])
    try:
        lane = Lane(_Chain(coord))
        assert lane.predicted_latency_s(_PROMPT) is None
        coord.chain_ewma_s = 5.0
        assert lane.predicted_latency_s(_PROMPT) == 5.0
        assert Lane(_Chain(None)).predicted_latency_s(_PROMPT) is None
    finally:
        coord.close()


class _WarmLoopback(LoopbackCoordinator):
    def chain_estimate_s(self):
        return 50.0


@pytest.mark.parametrize("autopilot", ["1", "0"])
def test_a_prefill_replica_sheds_a_budget_below_its_chain(autopilot, monkeypatch):
    """A prefill engine whose coordinator prices the chain at 50 s sheds a
    request with a 20 s budget before any prefill: a typed 503 with the
    autopilot's prefix and no prefill tick.  ``SELDON_TPU_AUTOPILOT=0``
    admits it, and the hand-off answers the unified tokens."""
    from seldon_core_tpu_torch.runtime import autopilot as pap
    from seldon_core_tpu_torch.runtime.resilience import deadline_scope

    monkeypatch.setenv("SELDON_TPU_AUTOPILOT", autopilot)
    decode = _genserver(role="decode", block_size=16)  # the engine's default
    engine = EngineService(_gen_spec(), device="cpu", gen_role="prefill")
    engine.genserver.coordinator = _WarmLoopback(decode)
    payload = json.dumps({"data": {"ndarray": _PROMPT.tolist()}})

    async def ask():
        with deadline_scope(20.0):
            return await engine.predict_json(payload)

    try:
        text, status = asyncio.run(ask())
        if autopilot == "1":
            assert status == 503, text
            assert json.loads(text)["status"]["info"].startswith(pap.SHED_INFO_PREFIX)
            assert engine.genserver.prefill_dispatches_total == 0
        else:
            assert status == 200, text
            assert engine.genserver.prefill_dispatches_total >= 1
            assert decode.imports_committed_total == 1
    finally:
        engine.close()
        decode.stop()


# -- either role over a tensor-parallel mesh ([6b-disagg]) ---------------------------

_DIMS = {"mha": dict(n_heads=2, n_kv_heads=0, d_model=32),
         "gqa": dict(n_heads=8, n_kv_heads=2, d_model=64),
         "uneven": dict(n_heads=40, n_kv_heads=10, d_model=320)}


@pytest.fixture(scope="module")
def _reference_unified():
    """Per config: the JAX unit's params and its greedy f32 tokens for
    ``_PROMPT`` (its static lane, jitted: its unified scheduler answers the
    same tokens, ``tests/test_servingmesh.py``)."""
    out = {}
    for name, dims in _DIMS.items():
        junit = JaxGenerator(vocab=64, n_layers=2, d_ff=64, max_new_tokens=16,
                             dtype="float32", eos_token=-1, **dims)
        jstate = junit.init_state(jax.random.key(0))
        want = np.asarray(jax.jit(junit.predict)(jstate, _PROMPT.astype(np.float32)))
        out[name] = (jax.tree_util.tree_map(np.asarray, jstate["params"]), want)
    return out


def _replica(name, params, axes, role, coordinator=None):
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.models.transformer import shard_params

    mesh = None if axes is None else build_mesh(axes, devices=["cpu"] * 4)
    unit = _unit(**_DIMS[name], mesh=mesh)
    placed = params_from_jax(params, device="cpu")
    spec = {**unit.continuous_spec(unit.init_state(None)),
            "params": placed if mesh is None else shard_params(placed, mesh)}
    return GenServer(**spec, role=role, coordinator=coordinator, num_blocks=64, block_size=4,
                     span=4, prefill_chunk=8)


@pytest.mark.parametrize("name,prefill_axes,decode_axes", [
    ("mha", None, {"tp": 2}), ("mha", {"tp": 2}, None), ("gqa", None, {"tp": 4}),
    ("uneven", None, {"tp": 4}), ("uneven", {"tp": 4}, None)],
    ids=["decode_tp2", "prefill_tp2", "decode_tp4_kv2", "decode_tp4_uneven",
         "prefill_tp4_uneven"])
def test_mesh_disagg_composes(name, prefill_axes, decode_axes, _reference_unified):
    """``tests/test_servingmesh.py::test_mesh_disagg_composes`` on the
    port, with the reference unit's weights: a decode replica over ``tp=2``
    imports a one-device prefill's hand-off, a prefill replica over
    ``tp=2`` feeds a one-device decode replica, and a decode replica over
    ``tp=4`` at 8 heads and 2 kv heads (each head on the two shards of its
    group) does the same, and so do a decode and a prefill replica over
    ``tp=4`` at 40 heads and 10 kv heads (kv heads 2 and 7 shared by two
    shards: the hand-off reads each once and writes it into both); each
    answers the reference's f32 greedy tokens bit for bit."""
    params, want = _reference_unified[name]
    decode = _replica(name, params, decode_axes, "decode")
    prefill = _replica(name, params, prefill_axes, "prefill", LoopbackCoordinator(decode))
    try:
        got = prefill.submit(_PROMPT).future.result(timeout=WAIT_S)
        np.testing.assert_array_equal(got, want)
        assert decode.imports_committed_total == 1
        assert (prefill.mesh, decode.mesh) != (None, None)
        _wait_blocks_freed(prefill)
        _wait_blocks_freed(decode)
    finally:
        prefill.stop()
        decode.stop()


def test_a_mesh_still_refuses_speculative_mode():
    """Speculative mode over a mesh stays refused (the reference's
    ``SpeculativeGenerator`` takes no mesh)."""
    from seldon_core_tpu_torch.parallel.mesh import build_mesh

    unit = _unit(mesh=build_mesh({"tp": 2}, devices=["cpu"] * 2))
    spec = unit.continuous_spec(unit.init_state(None))
    draft = _unit()
    with pytest.raises(ValueError, match="non-speculative"):
        GenServer(**spec, draft_params=draft.init_state(None)["params"], draft_cfg=draft.cfg,
                  num_blocks=16, block_size=4)
