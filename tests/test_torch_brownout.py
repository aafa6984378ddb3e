"""The port's brownout ladder (``seldon_core_tpu_torch/runtime/brownout.py``)
against the JAX package's: the same burn and depth sequences (made with
numpy from a seed) under one injected clock give the same stages,
transitions, dwell and revert timing, ``signals_unavailable`` and effects,
and the kill switch neutralizes every effect.  Then the generation
scheduler on the CPU: tier-ordered admission, the tier-aware preemption
victim, stage 2's ``max_new`` scale and prefill-chunk floor (on the engine's
continuous lane too), the queue's depth signal unregistered at ``stop``."""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.runtime import brownout as jbo
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import LoadShedError
from seldon_core_tpu_torch.models import transformer as T
from seldon_core_tpu_torch.runtime import autopilot as pap
from seldon_core_tpu_torch.runtime import brownout as pbo
from seldon_core_tpu_torch.runtime import genserver as gs
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.genserver import GenRequest, GenServer, _Sequence
from seldon_core_tpu_torch.runtime.qos import qos_scope
from seldon_core_tpu_torch.utils.telemetry import RECORDER

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    pap.reset_learned_singletons()
    yield
    pap.reset_learned_singletons()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ladders(burn, clock, **kw):
    args = dict(burn_fn=burn, now_fn=clock, enter_burn=2.0, enter_depth=8.0, dwell_s=5.0,
                revert_s=60.0, tick_interval_s=0.25)
    args.update(kw)
    return jbo.BrownoutController(**args), pbo.BrownoutController(**args)


def _transitions(ladder):
    return [{k: v for k, v in t.to_json_dict().items() if k != "ts"}
            for t in ladder.transitions]


def _snap(ladder):
    s = ladder.snapshot()
    s["transitions"] = [{k: v for k, v in t.items() if k != "ts"} for t in s["transitions"]]
    return s


@pytest.mark.parametrize("seed", range(4))
def test_same_signals_same_ladder(seed):
    """Seeded burn and depth walks, with dead feeds and raising providers,
    ticked under one clock: every tick's stage, the transitions, the
    snapshot and every effect equal the reference's."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    state = {"burn": None, "depth": 0, "burn_dead": False, "depth_dead": False}

    def burn():
        if state["burn_dead"]:
            raise RuntimeError("burn feed down")
        return state["burn"]

    def depth():
        if state["depth_dead"]:
            raise RuntimeError("queue gone")
        return state["depth"]

    j, p = _ladders(burn, clock)
    for ladder in (j, p):
        ladder.register_depth("q", depth)
    for step in range(300):
        clock.t += float(rng.choice([0.1, 0.3, 1.0, 6.0, 30.0]))
        phase = (step // 60) % 3
        state["burn"] = (None if rng.random() < 0.2
                         else float(rng.gamma(2.0, 3.0 if phase == 1 else 0.5)))
        state["depth"] = int(rng.integers(0, 80 if phase != 2 else 4))
        state["burn_dead"] = rng.random() < 0.15
        state["depth_dead"] = rng.random() < 0.15
        if rng.random() < 0.5:
            assert p.maybe_tick() == j.maybe_tick()
        else:
            assert p.tick() == j.tick()
        assert p.stage() == j.stage()
        for tier in ("interactive", "batch", "offline"):
            assert p.sheds_tier(tier) == j.sheds_tier(tier)
        assert (p.gen_max_new_scale(), p.gen_chunk_floor(), p.shed_margin_scale()) == \
            (j.gen_max_new_scale(), j.gen_chunk_floor(), j.shed_margin_scale())
    assert _transitions(p) == _transitions(j)
    assert len(p.transitions) > 4
    assert _snap(p) == _snap(j)
    assert p.signals_unavailable == j.signals_unavailable > 0


def test_ladder_walks_one_step_a_tick_with_dwell_and_revert():
    clock = _Clock()
    depth = {"n": 0}
    _, p = _ladders(lambda: None, clock, dwell_s=1.0, revert_s=10.0)
    p.register_depth("q", lambda: depth["n"])
    depth["n"] = 64  # pressure 8: severity 3
    stages = []
    for _ in range(4):
        clock.t += 1.0
        stages.append(p.tick())
    assert stages == [1, 2, 3, 3]
    depth["n"] = 0
    downs = []
    for _ in range(40):
        clock.t += 1.0
        downs.append(p.tick())
    # each step down holds for revert_s after the previous one
    assert downs[:10] == [3] * 10 and downs[10:20] == [2] * 10 and downs[20:30] == [1] * 10
    assert downs[30:] == [0] * 10
    assert [(t["from"], t["to"]) for t in _transitions(p)] == [
        (0, 1), (1, 2), (2, 3), (3, 2), (2, 1), (1, 0)]
    p.unregister_depth("q")
    assert "queue_depth" not in p._read_signals(clock.t)[1]


def test_kill_switch_neutralizes_effects(monkeypatch):
    clock = _Clock()
    j, p = _ladders(lambda: 100.0, clock)
    for _ in range(4):
        clock.t += 10.0
        j.tick()
        p.tick()
    assert p.stage() == j.stage() == 3
    monkeypatch.setenv("SELDON_TPU_BROWNOUT", "0")
    for ladder in (j, p):
        assert ladder.stage() == 0
        assert not ladder.sheds_tier("offline") and not ladder.sheds_tier("batch")
        assert (ladder.gen_max_new_scale(), ladder.gen_chunk_floor(),
                ladder.shed_margin_scale()) == (1.0, False, 1.0)
    assert _snap(p) == _snap(j)


# ---------------------------------------------------------------------------
# the generation scheduler
# ---------------------------------------------------------------------------

CFG = T.LMConfig(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return T.lm_init(torch.Generator().manual_seed(3), CFG, "cpu")


def _server(params, **kw):
    kw.setdefault("max_new_tokens", 10)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("slots", 8)
    kw.setdefault("span", 3)
    kw.setdefault("prefill_chunk", 4)
    return GenServer(params, CFG, **kw)


def _parked(params, **kw):
    """A scheduler whose worker never starts: submits stay queued."""
    srv = _server(params, **kw)
    srv._ensure_thread = lambda: None
    return srv


def test_tier_ordered_admission(params):
    srv = _parked(params, slots=2)
    try:
        srv.submit(np.zeros((1, 4)), tier="offline")
        srv.submit(np.zeros((1, 4)), tier="batch")
        with qos_scope("t", "interactive"):
            srv.submit(np.zeros((1, 4)))  # the tier bound to the context
        srv.submit(np.zeros((1, 4)), tier="batch")
        assert srv.snapshot()["sequences_by_tier"] == {"offline": 1, "batch": 2,
                                                       "interactive": 1}
        srv._waiting.extend(srv._arrivals)
        srv._arrivals.clear()
        assert srv._admit() == 2
        assert [s.request.tier for s in srv._prefilling] == ["interactive", "batch"]
        # FIFO within a tier: the first batch request went first
        assert srv._prefilling[1].sid == 2
        assert [s.request.tier for s in srv._waiting] == ["offline", "batch"]
    finally:
        srv.stop()


def test_tier_aware_victim(params):
    srv = _parked(params)
    try:
        def seq(sid, tier, order):
            s = _Sequence(sid, GenRequest(None, 4, tier=tier), np.zeros(4, np.int32), 4)
            s.admit_order = order
            return s

        inter_old, inter_young = seq(1, "interactive", 1), seq(2, "interactive", 9)
        batch_old, offline_oldest = seq(3, "batch", 2), seq(4, "offline", 0)
        srv._active = [inter_old, inter_young, batch_old, offline_oldest]
        assert srv._pick_victim(exclude=inter_old) is offline_oldest
        srv._active.remove(offline_oldest)
        assert srv._pick_victim(exclude=inter_old) is batch_old
        srv._active.remove(batch_old)
        assert srv._pick_victim(exclude=inter_old) is inter_young
    finally:
        srv.stop()


def test_preemption_spares_interactive_end_to_end(params):
    """A pool too small for every row: the batch-tier request's sequences
    carry the preemptions, the interactive one's none, and all tokens
    equal an unhurried run's."""
    prompts = np.random.default_rng(0).integers(0, 48, size=(4, 12))
    calm = _server(params, num_blocks=64)
    try:
        want_b = calm.submit(prompts[:3], tier="batch").future.result(WAIT_S)
        want_i = calm.submit(prompts[3:], tier="interactive").future.result(WAIT_S)
    finally:
        calm.stop()
    srv = _server(params, num_blocks=16, max_new_tokens=10)
    preempted = []
    orig = srv._preempt

    def spy(seq):
        preempted.append(seq.request.tier)
        return orig(seq)

    srv._preempt = spy
    try:
        rb = srv.submit(prompts[:3], tier="batch")
        ri = srv.submit(prompts[3:], tier="interactive")
        got_b, got_i = rb.future.result(WAIT_S), ri.future.result(WAIT_S)
    finally:
        srv.stop()
    assert preempted and set(preempted) == {"batch"}
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_i, want_i)


def test_stage_two_scales_max_new_and_floors_the_chunk(params, monkeypatch):
    widths = []
    orig = gs.paged_forward

    def spy(params, toks, *a, **kw):
        widths.append(int(toks.shape[1]))
        return orig(params, toks, *a, **kw)

    monkeypatch.setattr(gs, "paged_forward", spy)
    srv = _server(params, prefill_chunk=4)
    try:
        prompt = np.random.default_rng(1).integers(0, 48, size=(1, 16))
        srv._chunk_eff = srv._chunk_latched = 8  # the adaptive chunk grew past the floor
        pbo.BROWNOUT._stage = 2
        req = srv.submit(prompt, max_new=10)
        assert req.max_new == 5
        out = req.future.result(WAIT_S)
        assert out.shape == (1, 5)
        assert widths and set(widths) == {4}  # every prefill tick at the floor
        pbo.BROWNOUT._stage = 1
        with pytest.raises(LoadShedError, match=pbo.BROWNOUT_INFO_PREFIX):
            srv.submit(prompt, tier="offline")
        pbo.BROWNOUT._stage = 0
        widths.clear()
        out = srv.submit(prompt, max_new=10).future.result(WAIT_S)
        assert out.shape == (1, 10) and set(widths) == {8}
    finally:
        pbo.BROWNOUT.reset()
        srv.stop()


def test_depth_provider_registered_until_stop(params):
    srv = _parked(params)
    key = srv._brownout_key
    assert key in pbo.BROWNOUT._depth_fns
    srv.submit(np.zeros((2, 4)))
    assert pbo.BROWNOUT._depth_fns[key]() == 2
    sheds0 = RECORDER.autopilot_counters()[0].get("gen_queue", 0)
    srv.max_waiting = 2
    with pytest.raises(LoadShedError, match=gs.SHED_INFO_PREFIX):
        srv.submit(np.zeros((1, 4)))
    assert RECORDER.autopilot_counters()[0].get("gen_queue", 0) == sheds0 + 1
    srv.stop()
    assert key not in pbo.BROWNOUT._depth_fns


def test_continuous_lane_answers_follow_the_scaled_length():
    """Stage 2 on the engine's continuous lane: a unary answer and an SSE
    stream both carry max_new x 0.5 tokens a row; stage 3 sheds a batch-tier
    request with the brownout prefix."""
    doc = json.loads((ROOT / "examples" / "generator_deployment.json").read_text())
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        assert engine.genserver is not None
        full = engine.genserver.max_new_tokens
        pbo.BROWNOUT._stage = 2
        body = json.dumps({"data": {"ndarray": [[1, 2, 3, 4]]}})
        text, status = asyncio.run(engine.predict_json(body))
        assert status == 200
        assert len(json.loads(text)["data"]["ndarray"][0]) == max(1, int(full * 0.5))

        async def stream():
            req = engine.prepare_stream_request(json.dumps(
                {"data": {"ndarray": [[1, 2, 3, 4]]}, "chunk": 4}))
            return [json.loads(f) async for f in engine.generate_stream(req)]

        frames = asyncio.run(stream())
        assert sum(len(f["tokens"][0]) for f in frames[:-1]) == max(1, int(full * 0.5))
        pbo.BROWNOUT._stage = 3

        async def batch_tier():
            with qos_scope(None, "batch"):
                return await engine.predict_json(body)

        text, status = asyncio.run(batch_tier())
        assert status == 503
        assert json.loads(text)["status"]["info"].startswith(pbo.BROWNOUT_INFO_PREFIX)
    finally:
        pbo.BROWNOUT.reset()
        engine.close()
