"""Tensor and expert parallelism in the port (``models/transformer.py``
``param_shardings`` / ``shard_params``, ``parallel/moe.py`` ``ep``,
``models/generate.py`` and ``runtime/genserver.py`` over a mesh) against
the JAX package on 8 CPU devices: every port shard of the tp and ep
layout is the reference array's block on that device; ``TransformerLM``
over ``{"tp": 4}``, ``{"dp": 2, "tp": 2}``, a ``tp`` that is a multiple
of the kv heads (``{"tp": 8}`` over 4) and one that neither divides nor is
a multiple of them (40 heads over 10 at ``{"tp": 4}``, 12 over 4 at
``{"tp": 6}``) gives the reference's logits within 3e-4
(``test_parallel.py:139``); the MoE layer over ``ep``
equals the unsharded layer within 1e-5 (``test_moe.py:72``); and the two
multi-device examples served by both engines give identical f32 greedy
tokens, with the reference's ``genserver.mesh`` in ``/stats``."""

import asyncio
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu.ops.quant import quantize_lm_params as jquantize
from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu.parallel import moe as jmoe
from seldon_core_tpu.runtime.engine import EngineService as JEngine
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models import transformer as ptr
from seldon_core_tpu_torch.models.generate import TransformerGenerator
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.parallel import moe as pmoe
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", 8)
    reset_learned_singletons()
    yield
    reset_learned_singletons()
    torch.set_num_threads(prev)


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("axes", [{"tp": 4}, {"dp": 2, "tp": 2}, {"tp": 2, "ep": 2},
                                  {"ep": 4}, {"dp": 2, "tp": 2, "ep": 2}])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_layout_is_the_references_block_on_every_device(axes, quant, devices8):
    """wqkv/w1 by columns, wo/w2 by rows, the int8 _q/_s leaves, and the MoE
    expert stacks over ep: the port's spec is the reference's
    PartitionSpec, and each port shard equals ``addressable_shards[i].data``
    of the reference array on device i."""
    cfg = jtr.LMConfig(vocab=64, d_model=32, n_heads=4, n_kv_heads=4, n_layers=2, d_ff=64,
                       moe_every=2, n_experts=4, dtype=jnp.float32)
    params = jtr.lm_init(jax.random.key(0), cfg)
    if quant == "int8":
        params = jquantize(params)
    jm = jmesh.build_mesh(axes)
    jsh = jtr.param_shardings(jm, params)
    placed = jax.device_put(params, jsh)
    pm = pmesh.build_mesh(axes, platform="cpu")
    port = params_from_jax(placed, "cpu")
    specs = ptr.param_shardings(pm, port)
    sharded = ptr.shard_params(port, pm)
    n_split = 0
    for path, jarr in _flat(placed):
        assert _get(specs, path) == tuple(_get(jsh, path).spec), path
        n_split += _get(specs, path) != ()
        for shard in jarr.addressable_shards:
            got = _get(sharded.shards[shard.device.id], path)
            assert tuple(got.shape) == tuple(shard.data.shape), path
            assert np.array_equal(_np(got), _np(shard.data)), (path, shard.device.id)
    assert n_split >= 2  # something is split on every mesh


@pytest.mark.parametrize("axes", [{"tp": 4}, {"dp": 2, "tp": 2}, {"tp": 2, "ep": 2}])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_a_split_leaf_holds_only_its_block(axes, quant):
    """On the whole tree's own device a split leaf (a row block of ``wo``
    or ``w2`` is a contiguous view) is still a copy: its storage is its
    block's size, so the shard on that device does not keep the whole
    leaf alive.  A replicated leaf is shared, not copied."""
    cfg = ptr.LMConfig(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, moe_every=2,
                       n_experts=4, dtype=torch.float32, quant=quant)
    params = ptr.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    if quant == "int8":
        params = ptr.quantize_lm_params(params)
    pm = pmesh.build_mesh(axes, platform="cpu")
    specs = ptr.param_shardings(pm, params)
    sharded = ptr.shard_params(params, pm)
    n_split = 0
    for path, leaf in _flat(params):
        split = any(a is not None and pm.shape[a] > 1 for a in _get(specs, path))
        n_split += split
        for tree in sharded.shards:
            got = _get(tree, path)
            if split:
                assert got.untyped_storage().nbytes() == got.numel() * got.element_size(), path
                assert got.data_ptr() != leaf.data_ptr(), path
            else:
                assert got.data_ptr() == leaf.data_ptr(), path
    assert n_split >= 4


def _lm_pair(axes, quant="none", n_heads=4, n_kv_heads=0, d_model=32, d_ff=64):
    kw = dict(vocab=64, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads, n_layers=2,
              d_ff=d_ff, dtype="float32", quant=quant)
    junit = jtr.TransformerLM(**kw, mesh=jmesh.build_mesh(axes))
    jstate = junit.init_state(jax.random.key(7))
    punit = ptr.TransformerLM(**kw, mesh=pmesh.build_mesh(axes, platform="cpu"), device="cpu")
    return junit, jstate, punit, params_from_jax(jstate, "cpu", layout=punit.shard_state)


@pytest.mark.parametrize("axes,quant,heads,ref_atol", [
    ({"tp": 4}, "none", (4, 0, 32), 3e-4), ({"dp": 2, "tp": 2}, "none", (4, 0, 32), 3e-4),
    ({"tp": 4}, "none", (8, 4, 64), 3e-4), ({"tp": 4}, "int8", (4, 0, 32), 3e-4),
    ({"dp": 2, "tp": 2}, "int8", (8, 4, 64), 1e-2), ({"tp": 8}, "none", (16, 4, 128), 3e-4),
    ({"tp": 4}, "none", (8, 2, 64), 3e-4), ({"tp": 4}, "int8", (8, 2, 64), 1e-2),
    ({"tp": 4}, "none", (40, 10, 320), 3e-4), ({"tp": 6}, "none", (12, 4, 576, 96), 3e-4)])
def test_transformer_lm_over_a_mesh_matches_reference(axes, quant, heads, ref_atol, devices8):
    """The reference unit's sharded state gathered and re-split by the
    port's layout: logits within 3e-4 of the port's unsharded unit with the
    same weights, and of the reference unit's on its mesh.  The int8
    weights' W8A16 products round their f32 activations to bf16 in both
    packages, so a last-bit difference of the f32 sums before them moves
    a bf16 rounding: at d_model 64 the unsharded port already stands
    6.3e-3 from the reference, and those cases hold the reference at 1e-2
    (``test_torch_quant.py``'s bound on the int8 path's outputs).  A ``tp``
    that is a multiple of the kv heads (8 over 4, 4 over 2) gives each
    shard the one kv head its query heads read (``kv_head_range``).  A
    ``tp`` that neither divides nor is a multiple of them (40 heads over
    10 at tp=4, head dim 8: shards read kv heads in runs of groups 4 and
    2; 12 over 4 at tp=6, head dim 48: shards hold 1 or 2 kv heads) gives
    each shard the kv heads its query heads read, one attention call a
    run (``per_run``)."""
    junit, jstate, punit, pstate = _lm_pair(axes, quant, *heads)
    assert isinstance(pstate, pmesh.ShardedTree) and pstate.mesh is punit.mesh
    tokens = np.random.default_rng(7).integers(0, 64, size=(4, 16)).astype(np.int32)
    want = np.asarray(jax.jit(junit.predict)(jstate, tokens))
    got = punit.predict(pstate, torch.from_numpy(tokens)).numpy()
    single = ptr.TransformerLM(vocab=64, d_model=heads[2], n_heads=heads[0],
                               n_kv_heads=heads[1], n_layers=2, d_ff=(*heads, 64)[3],
                               dtype="float32", quant=quant, device="cpu")
    ref = single.predict(params_from_jax(jstate, "cpu"), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4)
    np.testing.assert_allclose(got, want, atol=ref_atol)


def test_lm_apply_checks_its_mesh_and_splits_dp_rows(devices8):
    _, jstate, punit, pstate = _lm_pair({"dp": 2, "tp": 2})
    x = torch.randint(0, 64, (4, 8))
    whole = ptr.lm_apply(pstate, x, punit.cfg, mesh=punit.mesh)
    assert whole.shape == (4, 8, 64)
    # an odd row count cannot split over dp: every dp group takes all rows
    odd = ptr.lm_apply(pstate, x[:3], punit.cfg)
    torch.testing.assert_close(odd, whole[:3], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="mesh differs"):
        ptr.lm_apply(pstate, x, punit.cfg, mesh=pmesh.build_mesh({"tp": 2}, platform="cpu"))
    # a tp that neither divides nor is a multiple of the kv heads (4 over 6)
    # is served: each shard holds the kv heads its query heads read
    uneven = ptr.TransformerLM(vocab=64, d_model=48, n_heads=12, n_kv_heads=4, d_ff=96,
                               device="cpu", mesh=pmesh.build_mesh({"tp": 6}, platform="cpu"))
    assert [c.kv_heads for c in ptr.shard_configs(uneven.cfg, uneven.mesh)] == [1, 2]
    # a tp that does not divide the query heads is refused (12 over 8)
    with pytest.raises(ValueError, match="n_heads=12 not divisible over the tp axis of size 8"):
        ptr.TransformerLM(vocab=64, d_model=48, n_heads=12, n_kv_heads=4, d_ff=96,
                          device="cpu", mesh=pmesh.build_mesh({"tp": 8}, platform="cpu"))


def test_moe_over_ep_matches_unsharded_and_reference(devices8):
    """``moe_apply`` over an 8-device ep mesh equals the unsharded layer
    within 1e-5 (and its load-balance loss), and the reference's sharded
    layer on the same params."""
    jcfg = jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=8, k=2, capacity_factor=2.0,
                          dtype=jnp.float32)
    pcfg = pmoe.MoEConfig(d_model=16, d_ff=32, n_experts=8, k=2, capacity_factor=2.0,
                          dtype=torch.float32)
    jparams = jmoe.moe_init(jax.random.key(3), jcfg)
    x = np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32)
    jm = jmesh.build_mesh({"ep": 8})
    jsharded = jax.device_put(jparams, jmoe.moe_param_shardings(jm, jparams))
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg, mesh=jm))(jsharded, x)
    pm = pmesh.build_mesh({"ep": 8}, platform="cpu")
    params = params_from_jax(jparams, "cpu")
    assert pmoe.moe_param_shardings(pm, params) == \
        {k: tuple(v.spec) for k, v in jmoe.moe_param_shardings(jm, jparams).items()}
    sharded = ptr.shard_params(params, pm, pmoe.moe_param_shardings(pm, params))
    y_ref, aux_ref = pmoe.moe_apply(params, torch.from_numpy(x), pcfg)
    y_sh, aux_sh = pmoe.moe_apply(sharded, torch.from_numpy(x), pcfg, mesh=pm)
    torch.testing.assert_close(y_sh, y_ref, atol=1e-5, rtol=1e-5)
    assert float(aux_sh["lb_loss"]) == pytest.approx(float(aux_ref["lb_loss"]), abs=1e-5)
    np.testing.assert_allclose(y_sh.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert float(aux_sh["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]), abs=1e-5)


def _engines(example, monkeypatch, continuous):
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "1" if continuous else "0")
    text = (ROOT / "examples" / example).read_text()
    jeng = JEngine(JSpec.from_json(text), max_batch=8, max_wait_ms=1.0)
    peng = EngineService(SeldonDeploymentSpec.from_json(text), max_batch=8, max_wait_ms=1.0,
                         device="cpu")
    unit = peng.compiled.units["gen"]
    peng.load_states({"gen": params_from_jax(jeng.compiled.states["gen"], "cpu",
                                             layout=unit.shard_state)})
    return jeng, peng


@pytest.mark.parametrize("example,continuous", [("generator_tp_deployment.json", True),
                                                ("generator_tp_deployment.json", False),
                                                ("generator_ep_deployment.json", False)])
def test_mesh_examples_serve_the_reference_tokens(example, continuous, monkeypatch, devices8):
    """Both engines build the example over their 4-device mesh; with the
    reference engine's weights the port's engine answers the same f32
    greedy tokens for ragged prompts, and its ``/stats`` genserver block
    (the continuous lane) names the reference's mesh."""
    jeng, peng = _engines(example, monkeypatch, continuous)
    try:
        unit = peng.compiled.units["gen"]
        axes = {"generator_tp_deployment.json": {"tp": 4},
                "generator_ep_deployment.json": {"ep": 4}}[example]
        assert unit.mesh.shape == axes and peng.compiled.units["gen"].mesh.size == 4
        assert len(peng.states()["gen"]["params"].shards) == 4
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, size=(1, n)).tolist() for n in (5, 9, 17)]

        async def ask(engine):
            outs = []
            for p in prompts:
                text, status = await engine.predict_json(json.dumps({"data": {"ndarray": p}}))
                assert status == 200, text
                outs.append(json.loads(text)["data"]["ndarray"])
            return outs

        want = asyncio.run(ask(jeng))
        got = asyncio.run(ask(peng))
        assert got == want
        if continuous:
            jstats = jeng.stats() if not asyncio.iscoroutinefunction(jeng.stats) \
                else asyncio.run(jeng.stats())
            assert peng.genserver is not None
            assert peng.stats()["genserver"]["mesh"] == jstats["genserver"]["mesh"] == axes
        else:
            assert peng.genserver is None
    finally:
        peng.close()
        asyncio.run(jeng.close())


@pytest.fixture(scope="module")
def _gqa_tp4_reference():
    """The reference generator at 8 heads and 2 kv heads over its
    ``{"tp": 4}`` mesh: its state and its jitted greedy f32 tokens for two
    prompt rows."""
    from seldon_core_tpu.models.generate import TransformerGenerator as JaxGenerator

    junit = JaxGenerator(**_GQA, mesh=jmesh.build_mesh({"tp": 4}))
    jstate = junit.init_state(jax.random.key(3))
    prompt = np.random.default_rng(6).integers(0, 64, size=(2, 9)).astype(np.float32)
    return jstate, prompt, np.asarray(jax.jit(junit.predict)(jstate, prompt))


_GQA = dict(vocab=64, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2, d_ff=64,
            max_new_tokens=8, dtype="float32")


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "static"])
def test_a_gqa_generator_over_a_multiple_of_its_kv_heads_serves_the_reference_tokens(
        continuous, _gqa_tp4_reference, devices8):
    """A generator at 8 heads and 2 kv heads over ``{"tp": 4}`` (each kv
    head on the two shards of its group), with the reference unit's
    weights, answers the reference's f32 greedy tokens on both lanes; the
    continuous lane's pool holds one kv head a shard."""
    jstate, prompt, want = _gqa_tp4_reference
    unit = TransformerGenerator(**_GQA, device="cpu",
                                mesh=pmesh.build_mesh({"tp": 4}, platform="cpu"))
    state = params_from_jax(jstate, "cpu", layout=unit.shard_state)
    if not continuous:
        np.testing.assert_array_equal(unit.predict(state, torch.from_numpy(prompt)).numpy(),
                                      want)
        return
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    server = GenServer(**unit.continuous_spec(state), num_blocks=64, block_size=8)
    try:
        got = server.submit(prompt).future.result(timeout=120)
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
        assert [s["l0"]["k"].shape[1] for s in server._pool.shards] == [1] * 4
    finally:
        server.stop()


_UNEVEN = dict(vocab=64, d_model=320, n_heads=40, n_kv_heads=10, n_layers=2, d_ff=64,
               max_new_tokens=8, dtype="float32")


@pytest.fixture(scope="module")
def _uneven_tp4_reference():
    """The reference generator at 40 heads over 10 kv heads on its
    ``{"tp": 4}`` mesh: its state and its jitted greedy f32 tokens for
    three prompt rows."""
    from seldon_core_tpu.models.generate import TransformerGenerator as JaxGenerator

    junit = JaxGenerator(**_UNEVEN, mesh=jmesh.build_mesh({"tp": 4}))
    jstate = junit.init_state(jax.random.key(4))
    prompt = np.random.default_rng(8).integers(0, 64, size=(3, 11)).astype(np.float32)
    return jstate, prompt, np.asarray(jax.jit(junit.predict)(jstate, prompt))


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "static"])
def test_a_generator_over_an_uneven_tp_serves_the_reference_tokens(
        continuous, _uneven_tp4_reference, devices8):
    """40 heads over 10 kv heads at ``{"tp": 4}``, a tp that neither divides
    nor is a multiple of the kv heads: each shard holds the three kv heads
    its ten query heads read (kv heads 2 and 7 on two shards each) and
    attends them in two runs, of groups 4 and 2.  With the reference unit's
    weights both lanes answer the reference's f32 greedy tokens; the
    continuous lane's pool holds three kv heads a shard."""
    jstate, prompt, want = _uneven_tp4_reference
    unit = TransformerGenerator(**_UNEVEN, device="cpu",
                                mesh=pmesh.build_mesh({"tp": 4}, platform="cpu"))
    assert [c.kv_runs for c in ptr.shard_configs(unit.cfg, unit.mesh)] == \
        [((2, 4), (1, 2)), ((1, 2), (2, 4))]
    state = params_from_jax(jstate, "cpu", layout=unit.shard_state)
    if not continuous:
        np.testing.assert_array_equal(unit.predict(state, torch.from_numpy(prompt)).numpy(),
                                      want)
        return
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    server = GenServer(**unit.continuous_spec(state), num_blocks=64, block_size=8)
    try:
        got = server.submit(prompt).future.result(timeout=120)
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
        assert [s["l0"]["k"].shape[1] for s in server._pool.shards] == [3] * 4
    finally:
        server.stop()


def test_generator_stream_and_prefix_over_tp_match_one_device(devices8):
    """The port's own generator over {"tp": 2} with a shared prefix: its
    stream's chunks concatenate to the unsharded unit's tokens with the
    same state, the prefix cache is split over tp, and the continuous
    lane's pool holds each shard's KV heads."""
    kw = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
              dtype="float32", max_new_tokens=12, prefix_tokens="3,1,4,1,5,9", device="cpu")
    one = TransformerGenerator(**kw)
    state = one.init_state(torch.Generator().manual_seed(0))
    tp = TransformerGenerator(**kw, mesh=pmesh.build_mesh({"tp": 2}, platform="cpu"))
    sstate = tp.shard_state(state)
    assert sstate["prefix_cache"].shards[0]["l0"]["k"].shape[1] == 1
    built = tp.init_state(torch.Generator().manual_seed(0))
    for a, b in zip(built["prefix_cache"].shards, sstate["prefix_cache"].shards):
        torch.testing.assert_close(a["l1"]["v"], b["l1"]["v"], atol=1e-5, rtol=0)
    X = torch.randint(0, 64, (3, 7)).float()
    want = one.predict(state, X)
    assert torch.equal(tp.predict(sstate, X), want)
    chunks = list(tp.stream_tokens(sstate, X.numpy(), chunk=5))
    assert torch.equal(torch.cat(chunks, dim=1).float(), want)
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    spec = tp.continuous_spec(sstate)
    server = GenServer(**spec, num_blocks=64, block_size=8)
    try:
        out = server.submit(X.numpy()).future.result(timeout=120)
        assert np.array_equal(np.asarray(out, np.float32), want.numpy())
        pool = server._pool
        assert isinstance(pool, pmesh.ShardedTree)
        assert [s["l0"]["k"].shape[1] for s in pool.shards] == [1, 1]
        assert server.snapshot()["mesh"] == {"tp": 2}
    finally:
        server.stop()


def test_the_continuous_lane_decides_its_kernels_apart(monkeypatch):
    """``resolve_paged_flash`` on a card: an f32 config, which the prefill
    and two-tier decode kernels refuse (``use_flash`` False), still takes
    the continuous lane's kernels when the paged kernel accepts its shape,
    asked at one tp shard's heads over a mesh; ``attention="xla"``, an
    int8 cache and a shape the paged kernel refuses keep the plain path,
    and a unit already on the kernels keeps them.  The kernel's shape rule
    is stubbed (it asks nvcc)."""
    asked = []

    def shape_error(head_dim, dtype, group, block_size, kv_dtype=None):
        asked.append((head_dim, dtype, group, block_size))
        return None if dtype in (torch.float32, torch.bfloat16) else "float16 refused"

    monkeypatch.setattr(ptr, "paged_kernel_shape_error", shape_error)
    card = torch.device("cuda", 0)
    f32 = ptr.LMConfig(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
                       dtype=torch.float32)
    mesh = pmesh.build_mesh({"tp": 4}, devices=["cpu"] * 4)
    assert ptr.resolve_paged_flash("auto", f32, card, False, mesh=mesh) is True
    assert asked == [(32, torch.float32, 1, 16)]
    assert ptr.resolve_paged_flash("flash", f32, card, False) is True
    assert ptr.resolve_paged_flash("xla", f32, card, False) is False
    f16 = ptr.LMConfig(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
                       dtype=torch.float16)
    assert ptr.resolve_paged_flash("auto", f16, card, False) is False
    int8 = ptr.LMConfig(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
                        dtype=torch.float32, kv_quant="int8")
    assert ptr.resolve_paged_flash("auto", int8, card, False) is False
    assert ptr.resolve_paged_flash("auto", f32, card, True) is True
    assert ptr.resolve_paged_flash("auto", f32, torch.device("cpu"), True) is True
    assert len(asked) == 3
