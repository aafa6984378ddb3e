"""The port's speculative decoding (seldon_core_tpu_torch/models/
speculative.py, and runtime/genserver.py in speculative mode) against the
JAX package's ``speculative_generate``, ``generate`` and ``GenServer`` on
the same weights (carried across by ``params_from_jax``) and prompts
(numpy, from a seed).  In f32 the tokens and the rounds must be identical
to the reference's, and the tokens to greedy decoding of the target; the
cases mirror the reference's tests/test_speculative.py.  The deployment
examples that name the speculative and the prefix generator build an
engine and answer on both lanes."""

import asyncio
import importlib
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models import speculative as tspec
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.runtime.batching import MicroBatcher
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.genserver import GenServer
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

jgen = importlib.import_module("seldon_core_tpu.models.generate")
jspec = importlib.import_module("seldon_core_tpu.models.speculative")
jgs = importlib.import_module("seldon_core_tpu.runtime.genserver")
ROOT = Path(__file__).resolve().parents[1]

# the reference's TARGET and DRAFT (tests/test_speculative.py:14-17)
T_DIMS = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64)
D_DIMS = dict(vocab=48, d_model=16, n_heads=2, n_layers=1, d_ff=32)
JT, TT = JConfig(**T_DIMS, dtype=jnp.float32), TConfig(**T_DIMS, dtype=torch.float32)
JD, TD = JConfig(**D_DIMS, dtype=jnp.float32), TConfig(**D_DIMS, dtype=torch.float32)
WAIT_S = 60


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


def _weights(cfg, seed):
    jp = jax_lm_init(jax.random.key(seed), cfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return _weights(JT, 0), _weights(JD, 1)


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(0, 48, size=shape).astype(np.int32)


@pytest.mark.parametrize("max_rounds", [0, 4], ids=["worst-case", "capped"])
@pytest.mark.parametrize("B,k,new", [(1, 4, 24), (3, 4, 16), (2, 2, 12)])
def test_speculative_generate_matches_the_reference(models, B, k, new, max_rounds):
    """Tokens and rounds identical to the reference's, rows batched
    together (round-aligned slots, per-row bitmaps and logical positions),
    a capped round budget's zero-padded tails included."""
    (jtp, ttp), (jdp, tdp) = models
    prompt = _prompts(B + k + new, (B, 6))
    want, want_rounds = jspec.speculative_generate(jtp, jdp, jnp.asarray(prompt), JT, JD,
                                                   max_new_tokens=new, k=k,
                                                   max_rounds=max_rounds)
    got, rounds = tspec.speculative_generate(ttp, tdp, torch.from_numpy(prompt), TT, TD,
                                             max_new_tokens=new, k=k, max_rounds=max_rounds)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rounds.numpy(), np.asarray(want_rounds))


def test_speculative_equals_greedy_generation_of_the_target(models):
    (jtp, ttp), (_, tdp) = models
    prompt = _prompts(0, (1, 6))
    want = np.asarray(jgen.generate(jtp, jnp.asarray(prompt), JT, max_new_tokens=24))
    got, rounds = tspec.speculative_generate(ttp, tdp, torch.from_numpy(prompt), TT, TD,
                                             max_new_tokens=24, k=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= int(rounds[0]) <= 24


def test_self_draft_accepts_nearly_every_proposal(models):
    """Draft == target: every proposal matches, so rounds ~ max_new/(k+1)
    (the reference's tests/test_speculative.py:34 allows one round of
    slack for a near-tie flipping between the S=1 and S=k+1 forwards)."""
    (jtp, ttp), _ = models
    prompt = np.zeros((1, 4), np.int32)
    got, rounds = tspec.speculative_generate(ttp, ttp, torch.from_numpy(prompt), TT, TT,
                                             max_new_tokens=20, k=4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgen.generate(jtp, jnp.asarray(prompt), JT, max_new_tokens=20)))
    assert int(rounds[0]) <= 5


def test_batched_rows_equal_single_rows(models):
    """The batched invariant (the reference's tests/test_speculative.py:50):
    every row of a batch equals its own B=1 run, with its own rounds."""
    (_, ttp), (_, tdp) = models
    prompts = torch.from_numpy(_prompts(3, (3, 6)))
    batched, rounds = tspec.speculative_generate(ttp, tdp, prompts, TT, TD, max_new_tokens=16)
    for b in range(3):
        single, r1 = tspec.speculative_generate(ttp, tdp, prompts[b:b + 1], TT, TD,
                                                max_new_tokens=16)
        assert torch.equal(batched[b], single[0]) and int(rounds[b]) == int(r1[0])


def test_single_token_and_int8_guard(models):
    (_, ttp), (_, tdp) = models
    prompt = torch.from_numpy(_prompts(5, (2, 3)))
    got, rounds = tspec.speculative_generate(ttp, tdp, prompt, TT, TD, max_new_tokens=1)
    assert got.shape == (2, 1) and not rounds.any()
    with pytest.raises(NotImplementedError, match="float KV caches"):
        tspec.speculative_generate(ttp, tdp, prompt, TConfig(**T_DIMS, kv_quant="int8"), TD)


@pytest.mark.parametrize("dims", [
    dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64),
    dict(vocab=48, d_model=48, n_heads=12, n_layers=2, d_ff=64),
    dict(vocab=32768, d_model=1024, n_heads=16, n_layers=12, d_ff=4096),
    dict(vocab=48, d_model=64, n_heads=4, n_layers=3, d_ff=64, draft_d_model=24,
         draft_n_heads=3, draft_n_layers=2, draft_d_ff=40),
], ids=["small", "awkward", "flagship", "explicit"])
def test_unit_derives_the_reference_draft_dims(dims):
    """The draft's derived dims (a quarter of the width, half the heads
    adjusted to an even head dim, half the depth) and the float32 default;
    the flagship's draft is 256 wide, 8 heads of 32, 6 layers, d_ff 1024."""
    unit = tspec.SpeculativeGenerator(**dims, device="cpu")
    junit = jspec.SpeculativeGenerator(**dims)
    for got, want in ((unit.target_cfg, junit.target_cfg), (unit.draft_cfg, junit.draft_cfg)):
        assert (got.vocab, got.d_model, got.n_heads, got.n_layers, got.d_ff) == (
            want.vocab, want.d_model, want.n_heads, want.n_layers, want.d_ff)
        assert got.dtype == torch.float32 and got.kv_heads == got.n_heads
    if dims["d_model"] == 1024:
        d = unit.draft_cfg
        assert (d.d_model, d.n_heads, d.head_dim, d.n_layers, d.d_ff) == (256, 8, 32, 6, 1024)


def test_unit_predict_matches_the_reference_unit(models):
    junit = jspec.SpeculativeGenerator(**T_DIMS, max_new_tokens=9, k=3)
    jstate = junit.init_state(jax.random.key(5))
    unit = tspec.SpeculativeGenerator(**T_DIMS, max_new_tokens=9, k=3, device="cpu")
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert set(unit.init_state(None)) == set(state) == {"target", "draft"}
    X = _prompts(6, (2, 5)).astype(np.float32)
    want = np.asarray(junit.predict(jstate, jnp.asarray(X)))
    got = unit.predict(state, torch.from_numpy(X))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# -- the continuous lane in speculative mode ------------------------------------


def _spec_server(unit, state, **kw):
    return GenServer(**unit.continuous_spec(state), block_size=4, num_blocks=64, slots=4,
                     span=3, prefill_chunk=4, **kw)


@pytest.mark.parametrize("k", [3, 1])
def test_scheduler_speculative_rounds(k):
    """The reference's tests/test_genserver.py:186: draft k+1 paged steps
    and one verify a round; the output is the target's greedy decoding (the
    JAX generate's) for co-scheduled requests, prompts longer than a
    prefill chunk, and the draft pool's blocks go back at the end."""
    junit = jspec.SpeculativeGenerator(**T_DIMS, max_new_tokens=10, k=k)
    jstate = junit.init_state(jax.random.key(0))
    unit = tspec.SpeculativeGenerator(**T_DIMS, max_new_tokens=10, k=k, device="cpu")
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    prompts = _prompts(4, (3, 6))
    ref = np.asarray(jgen.generate(jstate["target"], jnp.asarray(prompts), junit.target_cfg,
                                   max_new_tokens=10))
    srv = _spec_server(unit, state)
    try:
        r1 = srv.submit(prompts[:2].astype(float))
        r2 = srv.submit(prompts[2:].astype(float))
        got = np.concatenate([r1.future.result(WAIT_S), r2.future.result(WAIT_S)])
        deadline = time.monotonic() + 10  # retirement runs a beat after delivery
        while srv.snapshot()["inflight_sequences"] and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = srv.snapshot()
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)
    assert snap["mode"] == "speculative" and snap["steps_total"].get("spec", 0) > 0
    assert snap["spec_rounds_total"] > 0 and snap["decode_steps_total"] == 0
    assert snap["kv_blocks"]["used"] == 0 and snap["draft_kv_blocks"]["used"] == 0


def test_scheduler_self_draft_accepts_and_stays_greedy(models):
    """The target as its own draft: the lane's answer is still the greedy
    one, and most proposals are accepted."""
    (jtp, ttp), _ = models
    prompts = _prompts(9, (2, 7))
    ref = np.asarray(jgen.generate(jtp, jnp.asarray(prompts), JT, max_new_tokens=16))
    srv = GenServer(ttp, TT, draft_params=ttp, draft_cfg=TT, spec_k=4, max_new_tokens=16,
                    block_size=4, num_blocks=64, slots=4, span=3, prefill_chunk=4)
    try:
        got = srv.submit(prompts.astype(float)).future.result(WAIT_S)
        snap = srv.snapshot()
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)
    assert snap["spec_accepted_total"] >= 2 * snap["spec_row_rounds_total"]


def test_scheduler_speculative_preemption_stays_greedy(models):
    """Pools too small for every sequence at once: sequences are preempted
    (their target and draft blocks freed) and recomputed, and the answer is
    still the target's greedy decoding."""
    (jtp, ttp), (_, tdp) = models
    prompts = _prompts(10, (4, 6))
    ref = np.asarray(jgen.generate(jtp, jnp.asarray(prompts), JT, max_new_tokens=10))
    srv = GenServer(ttp, TT, draft_params=tdp, draft_cfg=TD, spec_k=3, max_new_tokens=10,
                    block_size=4, num_blocks=14, slots=4, span=3, prefill_chunk=4)
    try:
        got = srv.submit(prompts.astype(float)).future.result(WAIT_S)
        deadline = time.monotonic() + 10
        while srv.snapshot()["inflight_sequences"] and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = srv.snapshot()
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, ref)
    assert snap["preempted_total"] >= 1
    assert snap["kv_blocks"]["used"] == 0 and snap["draft_kv_blocks"]["used"] == 0


@pytest.mark.parametrize("kw", [
    {"temperature": 0.7},
    {"prefix_cache": "any"},
    {"cfg": TConfig(**T_DIMS, dtype=torch.float32, kv_quant="int8")},
], ids=["sampling", "prefix", "int8-kv"])
def test_speculative_guards_raise_as_the_reference_does(models, kw):
    (jtp, ttp), (jdp, tdp) = models
    jkw = dict(kw)
    if "cfg" in kw:
        jkw["cfg"] = JConfig(**T_DIMS, dtype=jnp.float32, kv_quant="int8")
    with pytest.raises(ValueError) as want:
        jgs.GenServer(jtp, jkw.pop("cfg", JT), draft_params=jdp, draft_cfg=JD, **jkw)
    with pytest.raises(ValueError) as got:
        GenServer(ttp, kw.pop("cfg", TT), draft_params=tdp, draft_cfg=TD, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_the_disaggregated_roles_name_their_item(role, monkeypatch):
    """A speculative replica told to take a disaggregated role (the
    reference's ENGINE_GEN_ROLE, ported in [6d]) is refused in the
    reference's words, rather than served as a unified one: a hand-off
    would need the draft's pool too."""
    monkeypatch.setenv("ENGINE_GEN_ROLE", role)
    doc = json.loads((ROOT / "examples" / "speculative_deployment.json").read_text())
    with pytest.raises(ValueError, match="speculative decoding does not compose with "
                                         "disaggregated prefill/decode roles"):
        EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                      device="cpu")
    monkeypatch.setenv("ENGINE_GEN_ROLE", "unified")
    EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                  device="cpu").close()


def _kernel_dtypes(asked):
    """A stand-in for the paged kernel's shape check (nvcc answers it on the
    card): it takes bfloat16 and float32, as flash_decode_paged.cu does."""

    def shape_error(head_dim, dtype, group=1, block_size=16):
        asked.append((head_dim, dtype, group))
        return (None if dtype in (torch.bfloat16, torch.float32)
                else "the paged flash-decode kernel takes bfloat16 or float32 q/k/v only")

    return shape_error


def test_a_draft_the_paged_kernel_refuses_is_refused_on_cuda(monkeypatch):
    """On CUDA every draft step is a flash_decode_paged launch: a draft the
    kernel cannot take (float16, its shape check stubbed here) is refused
    at construction with the kernel's reason, never served by the plain
    path; a draft it takes is accepted, and its continuous spec asks for
    the kernels."""
    asked = []
    monkeypatch.setattr(tspec, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(tspec, "paged_kernel_shape_error", _kernel_dtypes(asked))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tspec.SpeculativeGenerator(d_model=256, n_heads=4, dtype="float16")
    assert asked == [(32, torch.float16, 1)]  # the derived draft: d_model 64, 2 heads
    unit = tspec.SpeculativeGenerator(d_model=256, n_heads=4, dtype="bfloat16")
    assert unit.device.type == "cuda"
    assert unit.continuous_spec({"target": {}, "draft": {}})["use_flash"]


def test_a_float32_draft_asks_the_paged_kernel_and_is_accepted_on_cuda(monkeypatch):
    """The unit's float32 default (the speculative example as written) asks
    the paged kernel for its f32 draft (hd 32, group 1) and is served
    through it: the kernel's float32 path, not a plain fallback."""
    asked = []
    monkeypatch.setattr(tspec, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(tspec, "paged_kernel_shape_error", _kernel_dtypes(asked))
    unit = tspec.SpeculativeGenerator(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
                                      draft_d_model=64, draft_n_layers=1, max_new_tokens=16, k=4)
    assert asked == [(32, torch.float32, 1)]
    assert unit.draft_cfg.dtype == torch.float32 and unit.device.type == "cuda"
    assert unit.continuous_spec({"target": {}, "draft": {}})["use_flash"]


# -- the deployment examples ---------------------------------------------------


@pytest.mark.parametrize("lane", ["continuous", "static"])
@pytest.mark.parametrize("example", ["speculative_deployment.json",
                                     "generator_prefix_deployment.json"])
def test_example_deployment_builds_an_engine_and_serves(example, lane, monkeypatch):
    """Each example as it stands builds an EngineService on the CPU and
    answers a request: with the reference unit's tokens (its state carried
    across) where the example serves f32, held to its teacher-forced
    logits where it serves bf16 (the prefix example)."""
    if lane == "static":
        monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    doc = json.loads((ROOT / "examples" / example).read_text())
    engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                           device="cpu")
    try:
        comp = doc["spec"]["predictors"][0]["components"][0]
        params = {p["name"]: (float(p["value"]) if p["type"] == "FLOAT" else
                              p["value"] if p["type"] == "STRING" else int(p["value"]))
                  for p in comp["parameters"]}
        jcls = (jspec.SpeculativeGenerator if comp["class_path"] == "SpeculativeGenerator"
                else jgen.TransformerGenerator)
        junit = jcls(**params)
        jstate = junit.init_state(jax.random.key(3))
        engine.load_states({"gen": params_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                                   device="cpu")})
        if lane == "continuous":
            assert engine.genserver is not None
            assert engine.genserver.snapshot()["mode"] == (
                "speculative" if jcls is jspec.SpeculativeGenerator else "decode")
        else:
            assert engine.genserver is None and isinstance(engine.batcher, MicroBatcher)
        X = _prompts(8, (2, 5)).astype(np.float32)
        want = np.asarray(junit.predict(jstate, jnp.asarray(X)))
        text, status = asyncio.run(engine.predict_json(json.dumps(
            {"data": {"ndarray": X.tolist()}})))
        assert status == 200
        got = np.asarray(json.loads(text)["data"]["ndarray"])
        assert got.shape == want.shape == (2, params["max_new_tokens"])
        unit = engine.compiled.units["gen"]
        cfg = getattr(unit, "cfg", None) or unit.target_cfg
        if cfg.dtype == torch.float32:
            np.testing.assert_array_equal(got, want)
        else:  # bf16: near-ties may break apart, so every token is held to its
            # teacher-forced logits instead (TOKEN_DELTA of chip_smoke.py)
            _assert_teacher_forced(engine.states()["gen"], unit, X, got.astype(np.int64))
    finally:
        engine.close()


def _assert_teacher_forced(state, unit, X, toks):
    """Each token up to a row's first eos within 0.125 of the maximum logit
    of the plain forward over prefix + prompt + the tokens before it."""
    from seldon_core_tpu_torch.models.transformer import lm_apply

    prefix = np.asarray(unit.prefix_ids, np.int64)[None].repeat(len(X), 0)
    seq = np.concatenate([prefix, X.astype(np.int64), toks[:, :-1]], axis=1)
    with torch.inference_mode():
        logits = lm_apply(state["params"], torch.from_numpy(seq), unit.cfg).float()
    start = prefix.shape[1] + X.shape[1] - 1
    rows = logits[:, start:start + toks.shape[1]]
    gap = (rows.amax(-1) - rows.gather(-1, torch.from_numpy(toks)[..., None])[..., 0]).numpy()
    for b in range(len(toks)):
        hits = np.flatnonzero(toks[b] == unit.eos_token)
        n = hits[0] + 1 if unit.eos_token >= 0 and hits.size else toks.shape[1]
        assert gap[b, :n].max() <= 0.125, (b, gap[b, :n])
