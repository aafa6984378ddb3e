"""The port's continuous-batching scheduler
(seldon_core_tpu_torch/runtime/genserver.py) against the contract the
reference's tests/test_genserver.py pins: the block allocator's
arithmetic, admission and retirement order, pool exhaustion that queues,
preemption that recomputes and leaks nothing, typed failures, cancelled
streams, batched and adaptive prefill, the engine's wiring and its kill
switch — and the defining equivalence: greedy f32 tokens identical to the
JAX package's ``generate`` on the same weights (carried across by
``params_from_jax``), for co-scheduled requests.

Everything that waits on the scheduler thread has a timeout of its own,
so a hang fails the test instead of running out the suite's clock."""

import asyncio
import importlib
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import LoadShedError, SeldonMessageError
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.runtime.batching import GenLane, MicroBatcher
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.genserver import BlockAllocator, GenRequest, GenServer, _Sequence
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

jgen = importlib.import_module("seldon_core_tpu.models.generate")

# the reference's CFG (tests/test_genserver.py:21)
DIMS = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG = JConfig(**DIMS, dtype=jnp.float32)
CFG = TConfig(**DIMS, dtype=torch.float32)
WAIT_S = 60  # any one wait on the scheduler thread


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


@pytest.fixture(scope="module")
def weights():
    jp = jax_lm_init(jax.random.key(3), JCFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _ref(jp, prompts, max_new, eos_token=-1):
    return np.asarray(jgen.generate(jp, jnp.asarray(prompts, jnp.int32), JCFG,
                                    max_new_tokens=max_new, eos_token=eos_token))


def _server(params, **kw):
    kw.setdefault("max_new_tokens", 10)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("slots", 8)
    kw.setdefault("span", 3)
    kw.setdefault("prefill_chunk", 4)
    return GenServer(params, kw.pop("cfg", CFG), **kw)


def _settle(srv, timeout=10.0):
    """The scheduler drained (retirement runs a beat after the last
    token is delivered)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = srv.snapshot()
        if not s["inflight_sequences"] and not s["waiting_sequences"]:
            return s
        time.sleep(0.01)
    raise AssertionError("scheduler did not settle")


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(0, DIMS["vocab"], size=shape)


# -- block allocator ---------------------------------------------------------


def test_allocator_alloc_free_reuse():
    a = BlockAllocator(8)          # block 0 is scratch
    assert a.capacity == 7
    x = a.alloc(3)
    y = a.alloc(2)
    assert x == [1, 2, 3] and y == [4, 5] and a.used == 5
    assert a.high_water == 5
    a.free(x)
    assert a.used == 2
    # freed ids are reused FIFO: any free block serves any sequence
    z = a.alloc(4)
    assert z == [6, 7, 1, 2] and a.used == 6
    assert a.high_water == 6
    with pytest.raises(ValueError, match="at least 2 blocks"):
        BlockAllocator(1)


def test_allocator_exhaustion_returns_none():
    a = BlockAllocator(4)
    assert a.alloc(3) is not None
    assert a.alloc(1) is None      # exhausted: the caller queues, no throw
    assert not a.can_alloc(1)


def test_allocator_pinned_blocks_never_freed():
    a = BlockAllocator(6)
    shared = a.alloc(2)
    a.pin(shared)
    a.free(shared)
    assert a.used == 2 and a.snapshot()["pinned"] == 2
    assert not any(b in (a.alloc(3) or []) for b in shared)


# -- the defining equivalence ------------------------------------------------


def test_scheduler_tokens_identical_to_jax_generate(weights):
    """Chunked prefill (a 7-token prompt in chunk-4 pieces) and paged
    decode rounds reproduce the JAX package's one-shot generate token for
    token, with two requests co-scheduled in one decode batch."""
    jp, tp = weights
    prompts = _prompts(0, (3, 7))
    ref = _ref(jp, prompts, 10)
    srv = _server(tp)
    try:
        r1 = srv.submit(prompts[:2].astype(float))
        r2 = srv.submit(prompts[2:].astype(float))
        got = np.concatenate([r1.future.result(timeout=WAIT_S), r2.future.result(timeout=WAIT_S)])
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        assert srv.snapshot()["decode_round_rows_max"] == 3
    finally:
        srv.stop()


def test_scheduler_stream_matches_unary(weights):
    jp, tp = weights
    prompts = _prompts(1, (2, 5))
    ref = _ref(jp, prompts, 10)
    srv = _server(tp)
    try:
        chunks = [c for c in srv.stream(prompts.astype(float), chunk=4)]
        assert [c.shape[1] for c in chunks] == [4, 4, 2]
        np.testing.assert_array_equal(np.concatenate(chunks, axis=1), ref)
        np.testing.assert_array_equal(srv.submit(prompts.astype(float)).future.result(WAIT_S),
                                      ref)
    finally:
        srv.stop()


def test_scheduler_eos_contract(weights):
    """A row that emits eos retires early, eos-padded as generate(eos_token)
    pads it, and its blocks go back."""
    jp, tp = weights
    prompt = _prompts(0, (1, 7))
    eos = int(_ref(jp, prompt, 10)[0, 0])
    ref = _ref(jp, prompt, 10, eos_token=eos)
    srv = _server(tp, eos_token=eos)
    try:
        got = srv.submit(prompt.astype(float)).future.result(timeout=WAIT_S)
        np.testing.assert_array_equal(got, ref)
        s = _settle(srv)
        assert s["retired_total"].get("eos", 0) == 1
        assert s["kv_blocks"]["used"] == 0
    finally:
        srv.stop()


def test_scheduler_refuses_sampling(weights):
    """Sampling is served, but not in speculative mode: the reference's
    guard (greedy, float KV), with its message."""
    _, tp = weights
    with pytest.raises(ValueError, match="speculative continuous mode is greedy/float-KV only"):
        _server(tp, temperature=0.7, draft_params=tp, draft_cfg=CFG)


# -- sampling ----------------------------------------------------------------


def test_sampled_uses_per_sequence_keys(weights):
    """The reference's tests/test_genserver.py:344: valid tokens, and
    repeated identical prompts draw different continuations (each sequence
    its own key).  A fresh scheduler with the same seed replays them, and a
    sequence's tokens do not depend on the sequences batched with it."""
    _, tp = weights
    prompt = _prompts(7, (1, 5)).astype(float)
    runs = []
    for _ in range(2):
        srv = _server(tp, temperature=1.0, top_k=10, top_p=0.95, seed=3, max_new_tokens=8)
        try:
            a = srv.submit(prompt).future.result(timeout=WAIT_S)
            b = srv.submit(prompt).future.result(timeout=WAIT_S)
        finally:
            srv.stop()
        for t in (a, b):
            assert t.shape == (1, 8) and (t >= 0).all() and (t < DIMS["vocab"]).all()
        assert (a != b).any()
        runs.append((a, b))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    # sequence 1 alone, then again as sequence 1 of a scheduler that also
    # runs sequences 2 and 3 in the same rounds
    srv = _server(tp, temperature=1.0, top_k=10, top_p=0.95, seed=3, max_new_tokens=8)
    try:
        both = srv.submit(np.concatenate([prompt, _prompts(8, (2, 5))])).future.result(WAIT_S)
        assert srv.snapshot()["decode_round_rows_max"] == 3
    finally:
        srv.stop()
    np.testing.assert_array_equal(both[:1], runs[0][0])


def test_sampling_that_keeps_one_token_gives_the_jax_greedy_tokens(weights):
    """top_k = 1: every draw is the argmax, through the first token's split
    after prefill and the rounds' per-row splits, co-scheduled."""
    jp, tp = weights
    prompts = _prompts(2, (3, 6))
    srv = _server(tp, temperature=0.8, top_k=1)
    try:
        r1 = srv.submit(prompts[:1].astype(float))
        r2 = srv.submit(prompts[1:].astype(float))
        got = np.concatenate([r1.future.result(WAIT_S), r2.future.result(WAIT_S)])
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, _ref(jp, prompts, 10))


# -- the shared prefix --------------------------------------------------------


def _prefix(jp, tp, n, seed=11):
    ids = np.random.default_rng(seed).integers(0, DIMS["vocab"], size=(1, n)).astype(np.int32)
    _, jpc = jgen.prefill(jp, jnp.asarray(ids), jgen.init_cache(JCFG, 1, n), JCFG)
    # the reference's cache carried across, so pool bytes compare exactly
    return ids, jpc, {li: {kk: torch.from_numpy(np.array(jpc[li][kk])) for kk in "kv"}
                      for li in jpc}


@pytest.mark.parametrize("P", [6, 8], ids=["blocks+tail", "blocks"])
def test_scheduler_prefix_cache_shared_blocks(weights, P):
    """The reference's tests/test_genserver.py:161: the full blocks written
    once and pinned, each sequence's tail copied into its first private
    block (none when P fills whole blocks), answers equal to the JAX
    generate with the same prefix; the pinned blocks' bytes unchanged after
    the run, and only they stay in use."""
    jp, tp = weights
    ids, jpc, tpc = _prefix(jp, tp, P)
    sufs = _prompts(12, (3, 5))
    ref = np.asarray(jgen.generate(jp, jnp.asarray(sufs, jnp.int32), JCFG, max_new_tokens=10,
                                   prefix=jpc))
    srv = _server(tp, prefix_cache=tpc)
    try:
        got = srv.submit(sufs.astype(float)).future.result(timeout=WAIT_S)
        pinned = list(srv._prefix_blocks)
        snap0 = {li: {kk: srv._pool[li][kk][pinned].clone() for kk in "kv"} for li in srv._pool}
        got2 = srv.submit(sufs[:1].astype(float)).future.result(timeout=WAIT_S)
        snap = _settle(srv)
        assert len(pinned) == P // 4 and snap["kv_blocks"]["pinned"] == P // 4
        assert snap["kv_blocks"]["used"] == P // 4  # only the pinned blocks stay
        assert snap["prefix_len"] == P
        assert snap["prefix_tail_writes_total"] == (4 if P % 4 else 0)
        for li in srv._pool:
            for kk in "kv":
                assert torch.equal(srv._pool[li][kk][pinned], snap0[li][kk])
                # the pinned blocks hold the prefix, in the port's [N, KV, bs, hd]
                want = tpc[li][kk][0, :, :len(pinned) * 4].reshape(
                    CFG.kv_heads, len(pinned), 4, CFG.head_dim).transpose(0, 1)
                assert torch.equal(srv._pool[li][kk][pinned], want)
        assert not set(pinned) & set(srv._allocator._free)
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got2, ref[:1])


def test_scheduler_prefix_preempted_sequence_rewrites_its_tail(weights):
    """A pool too small for every sequence at once: sequences are preempted
    and recomputed, each re-admission writes its tail again, the answers
    stay the JAX generate's and the pinned blocks are never freed."""
    jp, tp = weights
    ids, jpc, tpc = _prefix(jp, tp, 6, seed=13)
    sufs = _prompts(14, (4, 5))
    ref = np.asarray(jgen.generate(jp, jnp.asarray(sufs, jnp.int32), JCFG, max_new_tokens=10,
                                   prefix=jpc))
    srv = _server(tp, prefix_cache=tpc, num_blocks=12, slots=4)
    try:
        got = srv.submit(sufs.astype(float)).future.result(timeout=WAIT_S)
        snap = _settle(srv)
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)
    assert snap["preempted_total"] >= 1
    assert snap["prefix_tail_writes_total"] == 4 + snap["preempted_total"]
    assert snap["kv_blocks"]["used"] == snap["kv_blocks"]["pinned"] == 1


def test_scheduler_prefix_larger_than_the_pool_fails_every_request(weights):
    jp, tp = weights
    _, _, tpc = _prefix(jp, tp, 12, seed=15)
    srv = _server(tp, prefix_cache=tpc, num_blocks=3)
    try:
        with pytest.raises(RuntimeError, match="smaller than the shared prefix"):
            srv.submit(_prompts(1, (1, 3)).astype(float)).future.result(timeout=WAIT_S)
        assert srv._prefix_blocks == []
    finally:
        srv.stop()


# -- admission / retirement / exhaustion -------------------------------------


def test_admission_is_fifo_and_respects_slots(weights):
    """With one slot, requests are served strictly in arrival order."""
    jp, tp = weights
    prompts = _prompts(5, (3, 4))
    ref = _ref(jp, prompts, 6)
    srv = _server(tp, slots=1, max_new_tokens=6)
    try:
        reqs = [srv.submit(prompts[i:i + 1].astype(float)) for i in range(3)]
        done_order = []
        for i, r in enumerate(reqs):  # the scheduler thread resolves them in turn
            r.future.add_done_callback(lambda _f, i=i: done_order.append(i))
        for i, r in enumerate(reqs):
            np.testing.assert_array_equal(r.future.result(timeout=WAIT_S), ref[i:i + 1])
        assert done_order == [0, 1, 2]
        assert srv.snapshot()["admitted_total"] == 3
        assert srv.snapshot()["decode_round_rows_max"] == 1
    finally:
        srv.stop()


def test_pool_exhaustion_queues_not_crashes(weights):
    """A pool that holds about one sequence: the second request waits for
    the first one's blocks, then serves exactly."""
    jp, tp = weights
    prompts = _prompts(6, (2, 5))
    ref = _ref(jp, prompts, 8)
    srv = _server(tp, num_blocks=8, max_new_tokens=8)  # 7 usable
    try:
        r1 = srv.submit(prompts[:1].astype(float))
        r2 = srv.submit(prompts[1:].astype(float))
        np.testing.assert_array_equal(r1.future.result(timeout=WAIT_S), ref[:1])
        np.testing.assert_array_equal(r2.future.result(timeout=WAIT_S), ref[1:])
        assert _settle(srv)["kv_blocks"]["used"] == 0
    finally:
        srv.stop()


def test_preemption_under_pressure_recomputes_and_leaks_nothing(weights):
    """A pool too small for two whole sequences forces eviction in a decode
    round: the preempted sequence resumes exactly where it stopped (tokens
    still equal generate's) and no block leaks."""
    jp, tp = weights
    prompts = _prompts(13, (2, 4))
    ref = _ref(jp, prompts, 8)
    # each sequence ends needing 6 blocks of 2; 8 usable hold both
    # admissions but not both whole lengths
    srv = _server(tp, block_size=2, num_blocks=9, span=4, prefill_chunk=4, max_new_tokens=8)
    try:
        r1 = srv.submit(prompts[:1].astype(float))
        r2 = srv.submit(prompts[1:].astype(float))
        np.testing.assert_array_equal(r1.future.result(timeout=WAIT_S), ref[:1])
        np.testing.assert_array_equal(r2.future.result(timeout=WAIT_S), ref[1:])
        s = _settle(srv)
        assert s["preempted_total"] >= 1
        assert s["kv_blocks"]["used"] == 0
    finally:
        srv.stop()


def test_double_preemption_does_not_duplicate_context(weights):
    """The recompute prompt is rebuilt from the ORIGINAL prompt and the
    emitted tokens, so a second preemption does not repeat context."""
    _, tp = weights
    srv = _server(tp)
    try:
        req = GenRequest(None, 10)
        seq = _Sequence(0, req, np.arange(5, dtype=np.int32), 10)
        srv._active.append(seq)
        seq.emitted = [7, 8]
        srv._preempt(seq)
        np.testing.assert_array_equal(seq.prompt, [0, 1, 2, 3, 4, 7])
        assert seq.pending == 8
        srv._waiting.remove(seq)      # "readmit" and emit one more token
        srv._active.append(seq)
        seq.emitted = [7, 8, 9]
        srv._preempt(seq)
        np.testing.assert_array_equal(seq.prompt, [0, 1, 2, 3, 4, 7, 8])
        assert seq.pending == 9
        srv._waiting.remove(seq)
        assert srv.snapshot()["retired_total"].get("preempted", 0) == 2
        assert srv.snapshot()["preempted_total"] == 2
    finally:
        srv.stop()


def test_impossible_request_fails_typed_not_deadlocks(weights):
    """A request whose first prefill chunk can never fit fails with a
    clear error instead of blocking the queue."""
    _, tp = weights
    srv = _server(tp, num_blocks=2, prefill_chunk=8)  # 1 usable block
    try:
        req = srv.submit(np.zeros((1, 8)))
        with pytest.raises(RuntimeError, match="KV pool"):
            req.future.result(timeout=WAIT_S)
    finally:
        srv.stop()


def test_overlong_prompt_fails_typed_not_livelocks(weights):
    """A prompt whose first chunk fits but whose whole length exceeds the
    pool fails typed once the prefill has no victim left."""
    _, tp = weights
    srv = _server(tp, num_blocks=4)   # 3 usable blocks = 12 positions
    try:
        req = srv.submit(np.zeros((1, 20)))
        with pytest.raises(RuntimeError, match="KV pool"):
            req.future.result(timeout=WAIT_S)
        assert _settle(srv)["kv_blocks"]["used"] == 0
    finally:
        srv.stop()


def test_bad_prompts_and_a_full_queue_fail_typed(weights, monkeypatch):
    _, tp = weights
    srv = _server(tp)
    try:
        for rows in (np.zeros((0, 4)), np.zeros((1, 0)), np.zeros((1, 2, 3))):
            with pytest.raises(SeldonMessageError, match="prompt token rows"):
                srv.submit(rows)
    finally:
        srv.stop()
    monkeypatch.setenv("SELDON_TPU_GEN_MAX_WAITING", "2")
    srv = _server(tp)
    try:
        with pytest.raises(LoadShedError, match="admission queue full") as e:
            srv.submit(np.zeros((3, 4)))
        assert e.value.http_code == 503
    finally:
        srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(np.zeros((1, 4)))


def test_stream_cancel_frees_blocks(weights):
    """Abandoning a stream mid-flight retires its sequences and frees their
    blocks (the SSE disconnect path)."""
    _, tp = weights
    prompt = _prompts(8, (1, 5))
    srv = _server(tp, max_new_tokens=64, span=2)
    try:
        it = srv.stream(prompt.astype(float), chunk=2)
        next(it)          # the first chunk arrived: the stream is live
        it.close()        # the client went away
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s = srv.snapshot()
            if s["retired_total"].get("cancelled", 0) and s["kv_blocks"]["used"] == 0:
                break
            time.sleep(0.02)
        s = srv.snapshot()
        assert s["retired_total"].get("cancelled", 0) == 1
        assert s["kv_blocks"]["used"] == 0
    finally:
        srv.stop()


def test_stop_fails_what_is_in_flight(weights):
    _, tp = weights
    srv = _server(tp, max_new_tokens=64, span=1, slots=1)
    reqs = [srv.submit(_prompts(i, (1, 5)).astype(float)) for i in range(3)]
    srv.stop()
    for r in reqs:
        with pytest.raises(RuntimeError, match="stopped"):
            r.future.result(timeout=WAIT_S)


# -- batched prefill / adaptive chunk ----------------------------------------


def test_prefill_batches_across_sequences(weights):
    """Co-arriving prompts prefill together: one batched dispatch advances
    every prefilling sequence a tick, so the tick count stays near the
    longest prompt's chunk count, with per-row starts and widths exact."""
    jp, tp = weights
    rng = np.random.default_rng(9)
    long_p = rng.integers(0, 48, size=(2, 16))
    short_p = rng.integers(0, 48, size=(2, 13))
    ref_l, ref_s = _ref(jp, long_p, 6), _ref(jp, short_p, 6)
    srv = _server(tp, max_new_tokens=6)
    try:
        reqs = [srv.submit(p[None].astype(float))
                for p in (long_p[0], long_p[1], short_p[0], short_p[1])]
        outs = [r.future.result(timeout=WAIT_S) for r in reqs]
        np.testing.assert_array_equal(np.concatenate(outs[:2]), ref_l)
        np.testing.assert_array_equal(np.concatenate(outs[2:]), ref_s)
        s = _settle(srv)
        pf_ticks = s["steps_total"].get("prefill", 0) + s["steps_total"].get("mixed", 0)
        assert pf_ticks <= 8, s["steps_total"]
        assert s["prefill_dispatches_total"] <= 8
    finally:
        srv.stop()


def test_adaptive_chunk_probe_and_latch(weights, monkeypatch):
    """Probe upward while doubling the width leaves the tick wall under
    1.6x, shrink back and latch the first time compute dominates."""
    _, tp = weights
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK_MAX", "32")
    srv = _server(tp, prefill_chunk=4)
    try:
        assert srv.prefill_chunk_max == 32
        srv._adapt_chunk(4, 0.100)     # >= 2 ticks at a width before any move
        assert srv._chunk_eff == 4
        srv._adapt_chunk(4, 0.100)
        assert srv._chunk_eff == 8     # dispatch-bound: probe up
        srv._adapt_chunk(8, 0.105)
        srv._adapt_chunk(8, 0.105)
        assert srv._chunk_eff == 16
        srv._adapt_chunk(16, 0.400)
        srv._adapt_chunk(16, 0.400)    # > 1.6x the width-8 wall
        assert srv._chunk_eff == 8 and srv._chunk_latched
        srv._adapt_chunk(8, 0.050)
        assert srv._chunk_eff == 8     # latched
        assert srv.snapshot()["prefill_chunk_effective"] == 8
    finally:
        srv.stop()


def test_unsaturated_ticks_never_adapt(weights, monkeypatch):
    _, tp = weights
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK_MAX", "32")
    srv = _server(tp, prefill_chunk=8, max_new_tokens=4)
    try:
        srv.submit(_prompts(10, (1, 5)).astype(float)).future.result(timeout=WAIT_S)
        assert srv._chunk_wall == {}
        assert srv._chunk_eff == 8
    finally:
        srv.stop()


def test_chunk_growth_midflight_stays_exact(weights, monkeypatch):
    """The chunk can widen between two ticks of one prompt's prefill; the
    per-row starts and widths keep the tokens identical."""
    jp, tp = weights
    monkeypatch.setenv("SELDON_TPU_GEN_PREFILL_CHUNK_MAX", "8")
    prompt = _prompts(12, (1, 32))
    ref = _ref(jp, prompt, 6)
    srv = _server(tp, prefill_chunk=4, max_new_tokens=6)
    try:
        np.testing.assert_array_equal(
            srv.submit(prompt.astype(float)).future.result(timeout=WAIT_S), ref)
        assert srv.snapshot()["prefill_chunk_effective"] in (4, 8)
    finally:
        srv.stop()


def test_knobs_read_the_reference_env_names(weights, monkeypatch):
    _, tp = weights
    srv = GenServer(tp, CFG)
    assert (srv.block_size, srv.num_blocks, srv.slots, srv.span, srv.prefill_chunk,
            srv.prefill_chunk_max, srv.max_waiting) == (16, 1024, 64, 8, 128, 512, 4096)
    for name, value in (("BLOCK_SIZE", 8), ("POOL_BLOCKS", 32), ("SLOTS", 4), ("SPAN", 2),
                        ("PREFILL_CHUNK", 16), ("PREFILL_CHUNK_MAX", 64), ("MAX_WAITING", 9)):
        monkeypatch.setenv(f"SELDON_TPU_GEN_{name}", str(value))
    srv = GenServer(tp, CFG)
    assert (srv.block_size, srv.num_blocks, srv.slots, srv.span, srv.prefill_chunk,
            srv.prefill_chunk_max, srv.max_waiting) == (8, 32, 4, 2, 16, 64, 9)


# -- engine integration ------------------------------------------------------


def _gen_spec(max_new=8):
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in DIMS.items()]
    params += [{"name": "max_new_tokens", "value": str(max_new), "type": "INT"},
               {"name": "dtype", "value": "float32", "type": "STRING"}]
    return SeldonDeploymentSpec.from_json_dict({"spec": {"name": "cg", "predictors": [{
        "name": "p", "graph": {"name": "g", "type": "MODEL"},
        "components": [{"name": "g", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": params}]}]}})


def test_engine_serves_through_genserver(weights):
    """Default on: a generator engine routes unary predicts through the
    GenLane, streams join the scheduler and concatenate to the unary
    answer (the JAX generate's), max_new is honoured on the stream, and
    /stats shows the scheduler block."""
    jp, tp = weights
    engine = EngineService(_gen_spec(), device="cpu")
    try:
        assert engine.genserver is not None and isinstance(engine.batcher, GenLane)
        assert engine.can_stream()
        engine.load_states({"g": {"params": tp}})
        assert engine.genserver.params["embed"] is tp["embed"]  # rebuilt over the new weights
        X = [[3, 1, 4, 1, 5]]

        async def run():
            text, status = await asyncio.wait_for(
                engine.predict_json(json.dumps({"data": {"ndarray": X}})), WAIT_S)
            assert status == 200
            chunks = []
            for payload in ({"data": {"ndarray": X}, "chunk": 3},
                            {"data": {"ndarray": X}, "chunk": 2, "max_new": 3}):
                events = []
                req = engine.prepare_stream_request(json.dumps(payload))
                async for event in engine.generate_stream(req):
                    events.append(json.loads(event))
                chunks.append([np.asarray(e["tokens"]) for e in events[:-1]])
                assert events[-1]["done"]
            return np.asarray(json.loads(text)["data"]["ndarray"]), chunks

        full, (chunks, short) = asyncio.run(run())
        np.testing.assert_array_equal(full, _ref(jp, np.asarray(X), 8))
        assert [c.shape[1] for c in chunks] == [3, 3, 2]
        np.testing.assert_array_equal(np.concatenate(chunks, axis=1), full)
        assert [c.shape[1] for c in short] == [2, 1]
        np.testing.assert_array_equal(np.concatenate(short, axis=1), full[:, :3])
        stats = engine.stats()
        assert stats["genserver"]["admitted_total"] >= 3
        assert stats["batcher"] == {"mode": "genserver"}
        assert stats["kernels"]["flash_decode_paged"]["launches"] >= 0
        assert stats["kernels"]["kv_write_paged"]["launches"] >= 0
        assert engine.drained()
    finally:
        engine.close()
    assert not engine.genserver._thread.is_alive()


def test_kill_switch_restores_static_path(monkeypatch):
    """SELDON_TPU_GEN_CONTINUOUS=0: no scheduler, the MicroBatcher serves
    as before and streams run the unit's stream_tokens."""
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    engine = EngineService(_gen_spec(), device="cpu")
    try:
        assert engine.genserver is None
        assert isinstance(engine.batcher, MicroBatcher)
        assert engine.can_stream()
        assert engine.stats()["genserver"] is None
        text, status = asyncio.run(engine.predict_json(
            json.dumps({"data": {"ndarray": [[3, 1, 4, 1, 5]]}})))
        assert status == 200
        assert np.asarray(json.loads(text)["data"]["ndarray"]).shape == (1, 8)
    finally:
        engine.close()


@pytest.mark.parametrize("built_continuous", [True, False], ids=["continuous", "static"])
def test_load_states_keeps_the_lane_chosen_at_construction(weights, monkeypatch,
                                                           built_continuous):
    """ROADMAP Queue 3 item 2: load_states rebuilt the scheduler by reading
    SELDON_TPU_GEN_CONTINUOUS again, so an engine built on the continuous
    lane lost it (genserver None behind a GenLane, the next predict an
    AttributeError) when the switch had changed since.  The lane is the
    one chosen at construction, and so are the rebuilt scheduler's sizes."""
    jp, tp = weights
    if not built_continuous:
        monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    monkeypatch.setenv("SELDON_TPU_GEN_POOL_BLOCKS", "96")
    engine = EngineService(_gen_spec(), device="cpu")
    try:
        monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0" if built_continuous else "1")
        monkeypatch.setenv("SELDON_TPU_GEN_POOL_BLOCKS", "64")
        engine.load_states({"g": {"params": tp}})
        assert (engine.genserver is not None) == built_continuous
        if built_continuous:  # the pool's size too is the one it was built with
            assert engine.genserver.num_blocks == 96
        assert isinstance(engine.batcher, GenLane if built_continuous else MicroBatcher)
        X = [[3, 1, 4, 1, 5]]
        text, status = asyncio.run(engine.predict_json(json.dumps({"data": {"ndarray": X}})))
        assert status == 200
        np.testing.assert_array_equal(np.asarray(json.loads(text)["data"]["ndarray"]),
                                      _ref(jp, np.asarray(X), 8))
    finally:
        engine.close()


def test_engine_scheduler_failure_is_loud(monkeypatch):
    """No quiet fallback to the static lane: a scheduler that fails to
    build fails the engine."""
    import seldon_core_tpu_torch.runtime.engine as eng

    def broken(*a, **k):
        raise RuntimeError("paged kernel probe failed")

    monkeypatch.setattr(eng, "GenServer", broken)
    with pytest.raises(RuntimeError, match="probe failed"):
        EngineService(_gen_spec(), device="cpu")


def test_engine_answers_bad_prompts_with_400():
    engine = EngineService(_gen_spec(), device="cpu")
    try:
        text, status = asyncio.run(engine.predict_json(json.dumps({"data": {"ndarray": [[]]}})))
        assert status == 400 and "prompt token rows" in json.loads(text)["status"]["info"]
    finally:
        engine.close()


# -- int8 weights and the int8 K/V cache (ROADMAP Queue 1 item [2q]) ---------


def _int8_models(quant, kv_quant):
    """The module's weights at ``quant`` (quantized on both sides from the
    same dense tree) and the two configs."""
    jp = jax_lm_init(jax.random.key(3), JCFG)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    if quant == "int8":
        from seldon_core_tpu.ops.quant import quantize_lm_params as jquant
        from seldon_core_tpu_torch.ops.quant import quantize_lm_params as tquant

        jp, tp = jquant(jp), tquant(tp)
    return (jp, tp, JConfig(**DIMS, dtype=jnp.float32, quant=quant, kv_quant=kv_quant),
            TConfig(**DIMS, dtype=torch.float32, quant=quant, kv_quant=kv_quant))


def _jax_scheduler_tokens(jp, jcfg, prompts, **kw):
    """The reference scheduler's answer (runtime/genserver.py of the JAX
    package) at the port's test knobs: with an int8 cache the continuous
    lane attends a prefill's fresh tokens quantized (written, then
    viewed), where the static generate attends them exact, so the lane's
    reference is the reference's lane."""
    from seldon_core_tpu.runtime.genserver import GenServer as JGenServer

    kw = {"max_new_tokens": 10, "block_size": 4, "num_blocks": 64, "slots": 8, "span": 3,
          "prefill_chunk": 4, **kw}
    srv = JGenServer(jp, jcfg, **kw)
    try:
        return srv.submit(np.asarray(prompts, float)).future.result(timeout=WAIT_S)
    finally:
        srv.stop()


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "kernel-wrappers"])
@pytest.mark.parametrize("quant,kv_quant", [("none", "int8"), ("int8", "none"), ("int8", "int8")],
                         ids=["kv", "weights", "both"])
def test_scheduler_int8_tokens_identical_to_jax_generate(quant, kv_quant, use_flash):
    """int8 pools (scale planes beside them), int8 weights and both: the
    chunked prefill and the paged rounds reproduce the JAX scheduler at the
    same quantization token for token, two requests co-scheduled; with
    float pools also the JAX generate."""
    jp, tp, jcfg, tcfg = _int8_models(quant, kv_quant)
    prompts = _prompts(0, (3, 7))
    ref = _jax_scheduler_tokens(jp, jcfg, prompts)
    if kv_quant == "none":
        np.testing.assert_array_equal(ref, np.asarray(jgen.generate(
            jp, jnp.asarray(prompts, jnp.int32), jcfg, max_new_tokens=10)))
    srv = _server(tp, cfg=tcfg, use_flash=use_flash)
    try:
        r1 = srv.submit(prompts[:2].astype(float))
        r2 = srv.submit(prompts[2:].astype(float))
        got = np.concatenate([r1.future.result(timeout=WAIT_S), r2.future.result(timeout=WAIT_S)])
        if kv_quant == "int8":
            assert srv._pool["l0"]["k"].dtype == torch.int8 and "k_s" in srv._pool["l0"]
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)


def test_scheduler_int8_preemption_recomputes_and_leaks_nothing():
    """The allocator and preemption are the float pools': a pool too small
    for both whole sequences preempts one, which resumes on int8 pools with
    the reference's tokens, and no block leaks."""
    jp, tp, jcfg, tcfg = _int8_models("none", "int8")
    prompts = _prompts(13, (2, 4))
    ref = _jax_scheduler_tokens(jp, jcfg, prompts, max_new_tokens=8)
    srv = _server(tp, cfg=tcfg, block_size=2, num_blocks=9, span=4, prefill_chunk=4,
                  max_new_tokens=8)
    try:
        r1 = srv.submit(prompts[:1].astype(float))
        r2 = srv.submit(prompts[1:].astype(float))
        np.testing.assert_array_equal(r1.future.result(timeout=WAIT_S), ref[:1])
        np.testing.assert_array_equal(r2.future.result(timeout=WAIT_S), ref[1:])
        s = _settle(srv)
        assert s["preempted_total"] >= 1 and s["kv_blocks"]["used"] == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("P", [6, 8], ids=["blocks+tail", "blocks"])
def test_scheduler_int8_prefix_copies_codes_and_scales(P):
    """An int8 prefix cache: the pinned blocks hold its codes and scales
    bit for bit, the tails are copied as they are, and the answers equal
    the JAX scheduler's with the same int8 prefix."""
    jp, tp, jcfg, tcfg = _int8_models("int8", "int8")
    ids = np.random.default_rng(11).integers(0, DIMS["vocab"], size=(1, P)).astype(np.int32)
    _, jpc = jgen.prefill(jp, jnp.asarray(ids), jgen.init_cache(jcfg, 1, P), jcfg)
    tpc = params_from_jax(jax.tree_util.tree_map(np.asarray, jpc), device="cpu")
    sufs = _prompts(12, (3, 5))
    ref = _jax_scheduler_tokens(jp, jcfg, sufs, prefix_cache=jpc)
    srv = _server(tp, cfg=tcfg, prefix_cache=tpc)
    try:
        got = srv.submit(sufs.astype(float)).future.result(timeout=WAIT_S)
        pinned = list(srv._prefix_blocks)
        assert len(pinned) == P // 4
        for li in srv._pool:
            for kk in ("k", "v"):
                want = tpc[li][kk][0, :, :len(pinned) * 4].reshape(
                    tcfg.kv_heads, len(pinned), 4, tcfg.head_dim).transpose(0, 1)
                assert torch.equal(srv._pool[li][kk][pinned], want)
                want_s = tpc[li][kk + "_s"][0, :, :len(pinned) * 4].reshape(
                    tcfg.kv_heads, len(pinned), 4).transpose(0, 1)
                assert torch.equal(srv._pool[li][kk + "_s"][pinned], want_s)
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)
