"""The port's device meshes (``seldon_core_tpu_torch/parallel/mesh.py``)
and sharded ensemble (``parallel/ensemble.py``) against the JAX package's,
both on 8 CPU devices: ``MeshSpec.resolve`` and ``build_mesh`` give the
same dicts and the same errors; the collectives equal their plain
arithmetic; ``SharedEnsembleUnit`` with the reference unit's stacked state
carried across (``convert.params_from_jax`` with the unit's layout) gives
the reference's mean within 2e-6, alone and through the engine; a
binding's ``mesh_axes`` is refused on a meshless unit and when it asks
for more devices than exist, in the reference's words, and a
TransformerLM bound over ``sp`` or ``pp`` answers the reference's logits."""

import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.spec import GraphSpecError as JGraphSpecError
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
from seldon_core_tpu.parallel import ensemble as jens
from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu.runtime.engine import EngineService as JEngine
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec
from seldon_core_tpu_torch.parallel import ensemble as pens
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    """8 CPU devices on both sides: the reference's come from
    tests/conftest.py, the port's from its setter."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", pmesh._CPU_DEVICES)
    pmesh.set_cpu_device_count(8)
    reset_learned_singletons()
    yield
    reset_learned_singletons()
    torch.set_num_threads(prev)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


RESOLVE_CASES = [({"dp": -1}, 8), ({"dp": 2, "ens": -1}, 8), ({"dp": 3, "ens": -1}, 8),
                 ({"dp": 16}, 8), ({}, 8), ({"dp": -1, "tp": -1}, 8), ({"tp": 4}, 4),
                 ({"tp": 4, "dp": 2}, 8), ({"ep": 4}, 6)]


@pytest.mark.parametrize("axes,n", RESOLVE_CASES)
def test_mesh_spec_resolve_matches_reference(axes, n, devices8):
    """The same dict, or the same error text, for each request."""
    assert _outcome(lambda: pmesh.MeshSpec(axes).resolve(n)) == \
        _outcome(lambda: jmesh.MeshSpec(axes).resolve(n))


@pytest.mark.parametrize("axes", [{"dp": 2, "ens": 4}, {"tp": 4}, {"dp": 2, "tp": 2},
                                  {"ens": -1}, {"ep": 8}, {"dp": 16}, {"dp": 3, "ens": -1}])
def test_build_mesh_matches_reference(axes, devices8):
    """``mesh.shape`` as the reference's dict, and the devices in its
    order: the port's flat index i is the reference's device i."""
    got = _outcome(lambda: pmesh.build_mesh(axes, platform="cpu"))
    want = _outcome(lambda: jmesh.build_mesh(axes))
    assert got[0] == want[0]
    if got[0] == "error":
        assert got[1] == want[1]
        return
    pm, jm = got[1], want[1]
    assert pm.shape == dict(jm.shape) and pm.axis_names == tuple(jm.axis_names)
    assert pm.devices.shape == jm.devices.shape
    assert [d.id for d in jm.devices.flat] == list(range(pm.size))
    assert all(d == torch.device("cpu") for d in pm.device_list)


def test_explicit_devices_may_repeat_and_cuda_never_shrinks():
    m = pmesh.build_mesh({"tp": 4}, devices=["cpu"] * 4)
    assert m.shape == {"tp": 4} and m.distinct_devices == [torch.device("cpu")]
    have = pmesh.local_device_count("cuda")
    with pytest.raises(ValueError, match=f"needs {have + 1} devices, have {have}"
                       if have else "needs .* devices, have 0"):
        pmesh.build_mesh({"tp": have + 1})


def test_collectives_are_their_plain_arithmetic():
    """all_reduce, all_gather and gather_slices inside a run equal the sum,
    the concatenation and the column slices of every shard's tensor, on
    every shard of the group, and are identities outside a shard."""
    mesh = pmesh.build_mesh({"dp": 2, "tp": 4}, platform="cpu")
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32)) for _ in range(8)]

    def body(shard):
        t = parts[shard.index]
        return (pmesh.all_reduce(t, "tp"), pmesh.all_gather(t, "tp", 1),
                pmesh.gather_slices(t, "tp", 1, [(2, 9), (20, 24)]),
                pmesh.axis_index("tp"), pmesh.axis_size("dp"))

    outs = mesh.run(body)
    for i, (red, gat, sl, ti, dp) in enumerate(outs):
        d = mesh.coords(i)["dp"]
        group = parts[4 * d:4 * d + 4]
        total = group[0] + group[1] + group[2] + group[3]
        whole = torch.cat(group, dim=1)
        assert torch.equal(red, total) and torch.equal(gat, whole)
        assert torch.equal(sl, torch.cat([whole[:, 2:9], whole[:, 20:24]], dim=1))
        assert ti == mesh.coords(i)["tp"] and dp == 2
    t = parts[0]
    assert pmesh.all_reduce(t, "tp") is t and pmesh.all_gather(t, "tp") is t
    assert pmesh.axis_size("tp") == 1 and pmesh.axis_index("tp") == 0


def test_ring_shift_and_only_axes_are_their_plain_arithmetic():
    """``ring_shift`` gives each shard its predecessor's tensor along the
    axis (cyclically; a tuple moves together, None stays None); inside
    ``only_axes`` another axis reads as size 1 and its collectives are
    identities."""
    mesh = pmesh.build_mesh({"dp": 2, "sp": 4}, platform="cpu")
    parts = [torch.full((2,), float(i)) for i in range(8)]

    def body(shard):
        t = parts[shard.index]
        shifted = pmesh.ring_shift((t, t + 100), "sp")
        none = pmesh.ring_shift(None if shard.coords["sp"] == 1 else t, "sp")
        with pmesh.only_axes("dp"):
            hidden = (pmesh.axis_size("sp"), pmesh.axis_index("sp"),
                      pmesh.all_reduce(t, "sp") is t)
        return shifted, none, hidden

    for i, (shifted, none, hidden) in enumerate(mesh.run(body)):
        d, c = mesh.coords(i)["dp"], mesh.coords(i)["sp"]
        src = parts[4 * d + (c - 1) % 4]
        assert torch.equal(shifted[0], src) and torch.equal(shifted[1], src + 100)
        assert (none is None) == (c == 2)
        assert hidden == (1, 0, True)


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2, "tp": 2}, {"tp": 2, "sp": 2, "dp": 2}],
                         ids=["dp_first", "tp_first"])
def test_lead_shards_ordered_by_split_coordinates(axes):
    """The lead shards are those at 0 on every axis outside ``split``,
    ordered by their ``split`` coordinates with the first axis slowest,
    whatever order the mesh's axes were given in."""
    mesh = pmesh.build_mesh(axes, platform="cpu")
    leads = pmesh.lead_shards(mesh, ("dp", "sp"))
    assert [(mesh.coords(i)["dp"], mesh.coords(i)["sp"]) for i in leads] == [
        (d, c) for d in range(2) for c in range(2)]
    assert all(mesh.coords(i)["tp"] == 0 for i in leads)
    assert [mesh.coords(i)["sp"] for i in pmesh.lead_shards(mesh, ("sp",))] == [0, 1]


def test_sum_replicas_sums_each_leafs_copies():
    """A leaf split over ``tp`` is summed over its ``dp`` copies only, a
    replicated leaf over every shard, in shard order, the same bits on
    each copy."""
    mesh = pmesh.build_mesh({"dp": 2, "tp": 2}, platform="cpu")
    tree = pmesh.ShardedTree(mesh, [{"w": torch.full((1,), 10.0 ** i),
                                     "r": torch.full((1,), i + 1.0)} for i in range(4)],
                             {"w": ("tp",), "r": ()})
    out = pmesh.sum_replicas(tree)
    assert [float(s["w"]) for s in out.shards] == [101.0, 1010.0, 101.0, 1010.0]
    assert [float(s["r"]) for s in out.shards] == [10.0] * 4


def test_a_failing_shard_fails_the_run_and_frees_the_others():
    mesh = pmesh.build_mesh({"tp": 4}, platform="cpu")

    def body(shard):
        if shard.index == 2:
            raise RuntimeError("shard 2 failed")
        return pmesh.all_reduce(torch.ones(2), "tp")

    done = []
    t = threading.Thread(target=lambda: done.append(pytest.raises(RuntimeError, mesh.run, body)))
    t.start()
    t.join(timeout=30)
    assert done and "shard 2 failed" in str(done[0].value)
    # the mesh serves the next run
    assert torch.equal(mesh.run(lambda s: pmesh.all_reduce(torch.ones(2), "tp"))[0],
                       torch.full((2,), 4.0))


def test_shard_batch_splits_rows_over_dp():
    mesh = pmesh.build_mesh({"dp": 4, "ens": 2}, platform="cpu")
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    sharded = pmesh.shard_batch(mesh, x, "dp")
    for i, block in enumerate(sharded.shards):
        d = mesh.coords(i)["dp"]
        assert np.array_equal(block.numpy(), x[2 * d:2 * d + 2])


@pytest.mark.parametrize("axes,n", [({"ens": 8}, 8), ({"ens": 4}, 8), ({"ens": 2}, 6),
                                    ({"dp": 2, "ens": 4}, 4)])
def test_shared_ensemble_unit_matches_reference(axes, n, devices8):
    """The reference unit's stacked state (sharded over its ens axis,
    gathered by np.array) carried across and split by the port's layout:
    each port shard is the reference device's block.  The mean is the
    reference members' mean within 2e-6 (``test_parallel.py:60``), each
    member run by the reference on the same path: XLA's
    (``use_pallas="never"``) or the fused-MLP kernel (the port's plain
    version against the reference's interpret mode).  Where a device holds
    one member it is also the reference unit's answer within 2e-6; the
    reference unit's vmap over two or more local bf16 members, or over the
    interpreted kernel, moves its own answer by ~5e-4 on the CPU."""
    x = np.random.default_rng(1).normal(size=(5, 784)).astype(np.float32)
    junit = jens.SharedEnsembleUnit(member="MnistClassifier", n_members=n, member_hidden=32,
                                    member_use_pallas="never", mesh=jmesh.build_mesh(axes))
    jstate = junit.init_state(jax.random.key(0))
    want = np.asarray(jax.jit(junit.predict)(jstate, x))
    members = [jax.tree_util.tree_map(lambda a: a[i], jstate) for i in range(n)]
    from seldon_core_tpu.models.mnist import MnistClassifier as JMnist

    means = {mode: np.mean([np.asarray(JMnist(hidden=32, use_pallas=jmode).predict(m, x))
                            for m in members], axis=0)
             for mode, jmode in (("never", "never"), ("auto", "interpret"))}
    if n == axes["ens"]:
        np.testing.assert_allclose(means["never"], want, atol=2e-6)
    for mode, expected in means.items():
        punit = pens.SharedEnsembleUnit(member="MnistClassifier", n_members=n, member_hidden=32,
                                        member_use_pallas=mode,
                                        mesh=pmesh.build_mesh(axes, platform="cpu"),
                                        device="cpu")
        assert punit.members[0].path == ("mlp_apply" if mode == "never" else "kernel")
        pstate = params_from_jax(jstate, "cpu", layout=punit.shard_state)
        for name, jarr in jstate.items():
            for shard in jarr.addressable_shards:
                assert np.array_equal(pstate.shards[shard.device.id][name].float().numpy(),
                                      np.asarray(shard.data, np.float32)), name
        got = punit.predict(pstate, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, expected, atol=2e-6, err_msg=mode)
    # members differ (per-member seeds), as the reference's test checks
    assert not np.allclose(got, np.asarray(junit.members[0].predict(members[0], x)), atol=1e-5)


def test_ensemble_mean_fn_is_the_members_mean():
    mesh = pmesh.build_mesh({"ens": 4}, platform="cpu")
    from seldon_core_tpu_torch.models.mnist import MnistClassifier

    members = [MnistClassifier(hidden=32, seed=i, device="cpu") for i in range(8)]
    states = [m.init_state(torch.Generator().manual_seed(100 + i))
              for i, m in enumerate(members)]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 784)).astype(np.float32))
    expected = torch.stack([m.predict(s, x) for m, s in zip(members, states)]).mean(0)
    fn = pens.ensemble_mean_fn(lambda s, xx: members[0].predict(s, xx), mesh, 8, "ens")
    got = fn(pens._split(pens.stack_member_states(states), mesh, "ens"), x)
    torch.testing.assert_close(got, expected, atol=2e-6, rtol=0)


def _spec(cls, components, graph):
    return cls.from_json_dict({"spec": {"name": "d", "predictors": [
        {"name": "p", "graph": graph, "components": components}]}})


ENSEMBLE = [{"name": "ens", "runtime": "inprocess", "class_path": "SharedEnsembleUnit",
             "mesh_axes": {"ens": 8},
             "parameters": [{"name": "member", "value": "MnistClassifier", "type": "STRING"},
                            {"name": "n_members", "value": "8", "type": "INT"},
                            {"name": "member_hidden", "value": "32", "type": "INT"},
                            {"name": "member_use_pallas", "value": "never",
                             "type": "STRING"}]}]


def test_sharded_ensemble_through_engine_matches_reference(devices8):
    """The counterpart of ``test_serving_mesh.py:26``: an 8-member ensemble
    over an 8-device ``ens`` mesh served by predict_json (six concurrent
    3-row requests through the batcher), with the reference engine's
    state, answers the reference engine's probabilities within 2e-6; the
    engine's /stats lists the mesh."""
    graph = {"name": "ens", "type": "MODEL"}
    jeng = JEngine(_spec(JSpec, ENSEMBLE, graph), max_batch=16, max_wait_ms=1.0)
    peng = EngineService(_spec(SeldonDeploymentSpec, ENSEMBLE, graph), max_batch=16,
                         max_wait_ms=1.0, device="cpu")
    try:
        assert peng.mode == "compiled" == jeng.mode
        unit = peng.compiled.units["ens"]
        assert unit.mesh.shape == {"ens": 8}
        peng.load_states({"ens": params_from_jax(jeng.compiled.states["ens"], "cpu",
                                                 layout=unit.shard_state)})
        x = np.random.default_rng(2).normal(size=(3, 784))
        payload = json.dumps({"data": {"ndarray": x.tolist()}})

        async def run(engine):
            return await asyncio.gather(*[engine.predict_json(payload) for _ in range(6)])

        want = [np.asarray(json.loads(t)["data"]["ndarray"]) for t, _ in asyncio.run(run(jeng))]
        got = asyncio.run(run(peng))
        for (text, status), w in zip(got, want):
            assert status == 200
            arr = np.asarray(json.loads(text)["data"]["ndarray"])
            assert arr.shape == (3, 10)
            np.testing.assert_allclose(arr, w, atol=2e-6)
        stats = peng.stats()
        assert stats["meshes"] == {"ens": {"axes": {"ens": 8}, "devices": ["cpu"] * 8}}
    finally:
        peng.close()
        asyncio.run(jeng.close())


def test_mesh_axes_on_meshless_unit_rejected_in_reference_words():
    comps = [{"name": "m", "runtime": "inprocess", "class_path": "MnistClassifier",
              "mesh_axes": {"tp": 4},
              "parameters": [{"name": "hidden", "value": "32", "type": "INT"}]}]
    graph = {"name": "m", "type": "MODEL"}
    with pytest.raises(JGraphSpecError, match="mesh") as jerr:
        JEngine(_spec(JSpec, comps, graph))
    with pytest.raises(GraphSpecError, match="mesh") as perr:
        EngineService(_spec(SeldonDeploymentSpec, comps, graph), device="cpu")
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("axes", [{"sp": 2}, {"dp": 2, "sp": 4}, {"pp": 2}])
def test_sp_and_pipeline_axes_refused_naming_6b(axes, devices8):
    """Formerly the refusal of these bindings (ROADMAP item [6b]); the
    axes are served now, as the reference serves them: a TransformerLM
    bound over ``sp`` attends through the ring, over ``pp`` it is
    replicated (the reference's unit shards nothing over ``pp``).  Both
    engines built from the same spec, the reference engine's state carried
    across, answer the same logits within 2e-4."""
    comps = [{"name": "lm", "runtime": "inprocess", "class_path": "TransformerLM",
              "mesh_axes": axes,
              "parameters": [{"name": "vocab", "value": "64", "type": "INT"},
                             {"name": "d_model", "value": "32", "type": "INT"},
                             {"name": "dtype", "value": "float32", "type": "STRING"}]}]
    graph = {"name": "lm", "type": "MODEL"}
    jeng = JEngine(_spec(JSpec, comps, graph))
    peng = EngineService(_spec(SeldonDeploymentSpec, comps, graph), device="cpu")
    try:
        unit = peng.compiled.units["lm"]
        assert unit.mesh.shape == axes
        peng.load_states({"lm": params_from_jax(jeng.compiled.states["lm"], "cpu",
                                                layout=unit.shard_state)})
        tokens = np.random.default_rng(3).integers(0, 64, size=(2, 16))
        payload = json.dumps({"data": {"ndarray": tokens.tolist()}})
        (jtext, jstatus), (ptext, pstatus) = (asyncio.run(e.predict_json(payload))
                                              for e in (jeng, peng))
        assert pstatus == jstatus == 200
        got, want = (np.asarray(json.loads(t)["data"]["ndarray"]) for t in (ptext, jtext))
        assert got.shape == (2, 16, 64)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    finally:
        peng.close()
        asyncio.run(jeng.close())


@pytest.mark.parametrize("axes", [{"sp": 2}, {"pp": 2}])
def test_generator_over_sp_or_pp_is_replicated(axes, devices8):
    """The reference's generator shards nothing over ``sp`` or ``pp``
    (``param_shardings``; GSPMD replicates): the port's, bound so, answers
    its one-device self's greedy tokens, on the static lane and the
    continuous one."""
    from seldon_core_tpu_torch.models.generate import TransformerGenerator
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, dtype="float32",
              max_new_tokens=6, device="cpu")
    one = TransformerGenerator(**kw)
    state = one.init_state(torch.Generator().manual_seed(0))
    gen = TransformerGenerator(**kw, mesh=pmesh.build_mesh(axes, platform="cpu"))
    sstate = gen.shard_state(state)
    X = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(1)).float()
    want = one.predict(state, X)
    assert torch.equal(gen.predict(sstate, X), want)
    server = GenServer(**gen.continuous_spec(sstate), num_blocks=32, block_size=8)
    try:
        out = server.submit(X.numpy()).future.result(timeout=120)
        assert np.array_equal(np.asarray(out, np.float32), want.numpy())
    finally:
        server.stop()


def test_more_devices_than_exist_raise_the_reference_error(devices8):
    """An engine whose binding asks for 16 devices of 8 raises the
    reference's "needs 16 devices, have 8"; no smaller mesh is built."""
    comps = [dict(ENSEMBLE[0], mesh_axes={"ens": 16})]
    comps[0]["parameters"] = [dict(p) for p in ENSEMBLE[0]["parameters"]]
    comps[0]["parameters"][1]["value"] = "16"
    graph = {"name": "ens", "type": "MODEL"}
    with pytest.raises(ValueError, match="needs 16 devices, have 8") as perr:
        EngineService(_spec(SeldonDeploymentSpec, comps, graph), device="cpu")
    with pytest.raises(ValueError, match="needs 16 devices, have 8") as jerr:
        JEngine(_spec(JSpec, comps, graph))
    assert str(perr.value) == str(jerr.value)


def test_gen_pool_layout_matches_reference(devices8):
    """The port's one K/V layout rule (``kv_heads_held``, by which
    ``shard_kv_heads`` places a whole K/V tree) gives each device of the
    mesh the reference's block of the pool: its KV heads over ``tp`` (the
    port's pool is ``[blocks, KV, block_size, hd]``, the reference's
    ``[blocks, block_size, KV, hd]``).  Where ``tp`` is a multiple of the
    kv heads (1 head over ``tp=2``, 2 over ``{"tp": 4}``) the reference
    replicates the pool and each port shard holds the one head its query
    heads read: the reference's pool narrowed to ``kv_head_range``.  The
    genserver's pool (``shard_gen_pool``, allocated by shard) has each
    shard's blocks at the same shape, dtype and device.  Where ``tp``
    neither divides nor is a multiple of the heads (3 over ``tp=2`` at 6
    query heads) the reference replicates the pool and each port shard
    holds the kv heads its query heads read, kv head 1 on both: the
    reference's pool narrowed to ``kv_head_range`` at the query heads
    (shard 0 heads 0-1, shard 1 heads 1-2); the genserver's pool refuses
    the int8 cache there (its runs' scale planes would not be contiguous)
    and is laid out so for a float one."""
    from seldon_core_tpu.runtime import servingmesh as jsm
    from seldon_core_tpu_torch.models.generate import init_block_pool
    from seldon_core_tpu_torch.models.transformer import (LMConfig, kv_head_range,
                                                           shard_kv_heads)
    from seldon_core_tpu_torch.runtime import servingmesh as psm

    rng = np.random.default_rng(4)
    for axes, kv in (({"dp": 2, "tp": 2}, 4), ({"dp": 2, "tp": 2}, 3),
                     ({"dp": 2, "tp": 2}, 1), ({"tp": 4}, 2)):
        pm = pmesh.build_mesh(axes, platform="cpu")
        jm = jmesh.build_mesh(axes)
        assert pm.shape == dict(jm.shape) == axes
        tp = axes["tp"]
        heads = max(kv, tp) * (2 if kv % tp and tp % kv else 1)
        cfg = LMConfig(vocab=16, d_model=16 * heads, n_heads=heads, n_kv_heads=kv, n_layers=1,
                       d_ff=32, dtype=torch.float32, kv_quant="int8")
        jpool = {"l0": {"k": rng.normal(size=(6, 8, kv, 16)).astype(np.float32),
                        "k_s": rng.normal(size=(6, 8, kv)).astype(np.float32)}}
        jplaced = jsm.shard_gen_pool(jm, jpool)
        port = {"l0": {"k": torch.from_numpy(jpool["l0"]["k"]).permute(0, 2, 1, 3).contiguous(),
                       "k_s": torch.from_numpy(jpool["l0"]["k_s"]).permute(0, 2, 1).contiguous()}}
        uneven = bool(kv % tp and tp % kv)
        if uneven:
            with pytest.raises(ValueError, match="kv_quant='int8' .* unequal groups"):
                psm.shard_gen_pool(pm, cfg, 6, 8)
            cfg = LMConfig(vocab=16, d_model=16 * heads, n_heads=heads, n_kv_heads=kv,
                           n_layers=1, d_ff=32, dtype=torch.float32)
        placed = shard_kv_heads(port, pm, heads)
        for name in ("k", "k_s"):
            for shard in jplaced["l0"][name].addressable_shards:
                want = np.asarray(shard.data)
                if kv % tp:
                    lo, hi = kv_head_range(kv, tp, pm.coords(shard.device.id)["tp"], heads)
                    assert want.shape[2] == kv  # the reference's copy is whole
                    want = want[:, :, lo:hi]
                want = want.transpose(0, 2, 1, 3) if name == "k" else want.transpose(0, 2, 1)
                got = placed.shards[shard.device.id]["l0"][name].numpy()
                assert np.array_equal(got, want), (kv, name, shard.device.id)
        served = psm.shard_gen_pool(pm, cfg, 6, 8)
        laid = shard_kv_heads(init_block_pool(cfg, 6, 8, "cpu"), pm, heads)
        if uneven:
            assert [s["l0"]["k"].shape[1] for s in served.shards] == [2] * 4
        for got, want in zip(served.shards, laid.shards):
            assert got.keys() == want.keys() == {"l0"}
            for name, t in want["l0"].items():
                g = got["l0"][name]
                assert (g.shape, g.dtype, g.device) == (t.shape, t.dtype, t.device), (kv, name)
                assert not g.any()


def test_the_ring_loses_no_round_under_a_short_switch_interval():
    """Eight shards over dp x tp run 300 rounds of all_reduce, all_gather
    and gather_slices with the interpreter switching threads every
    microsecond: every shard reads every round's own values (a slot
    overwritten before its group read it would break the sums)."""
    import sys

    mesh = pmesh.build_mesh({"dp": 2, "tp": 4}, devices=["cpu"] * 8)
    rounds = 300

    def body(shard):
        bad = 0
        for r in range(rounds):
            mine = torch.tensor([float(r * 100 + shard.index)])
            d = shard.coords["dp"]
            group = [r * 100 + 4 * d + j for j in range(4)]
            if pmesh.all_reduce(mine, "tp").item() != float(sum(group)):
                bad += 1
            if pmesh.all_gather(mine, "tp").tolist() != [float(v) for v in group]:
                bad += 1
            if pmesh.gather_slices(mine, "tp", 0, [(3, 4), (0, 1)]).tolist() != \
                    [float(group[3]), float(group[0])]:
                bad += 1
        return bad

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = []
        t = threading.Thread(target=lambda: out.append(mesh.run(body)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert out == [[0] * 8]


def test_a_kernel_launch_makes_its_context_current_once_a_thread(monkeypatch):
    """``launch_on`` queries the device's stream once a thread and device
    before the first launch there (a mesh shard's fresh thread has no
    context current, and a kernel's TMA encode fails without one), and
    never again on that thread.  The CUDA calls are stubbed."""
    import contextlib

    from seldon_core_tpu_torch import device as pdev

    queries, launched = [], []

    class Stream:
        def __init__(self, index):
            self.index = index

        def query(self):
            queries.append((threading.get_ident(), self.index))
            return True

    monkeypatch.setattr(pdev, "_THREAD", threading.local())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None: Stream(index))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)

    def launch(*args):
        launched.append(args)
        return 0

    for _ in range(3):
        assert pdev.launch_on(torch.device("cuda", 0), launch, "main") == 0
    t = threading.Thread(target=lambda: [pdev.launch_on(torch.device("cuda", 0), launch, "shard")
                                         for _ in range(2)])
    t.start()
    t.join()
    pdev.launch_on(torch.device("cuda", 1), launch, "main")
    assert len(launched) == 6 and all(a[-1] == 7 for a in launched)
    assert [q[1] for q in queries] == [0, 0, 1]
    assert len({q[0] for q in queries}) == 2


def test_a_mesh_runs_on_shard_threads_that_live_across_runs(monkeypatch):
    """Two runs in a row take each shard to the same thread (a run starts
    no thread); a shard thread idle past ``WORKER_IDLE_S`` exits and the
    next run starts another, with the same answers."""
    import time

    mesh = pmesh.build_mesh({"tp": 4}, devices=["cpu"] * 4)

    def body(shard):
        return threading.get_ident(), float(pmesh.all_reduce(torch.tensor(shard.index + 1.0),
                                                             "tp"))

    first, second = mesh.run(body), mesh.run(body)
    assert [r[1] for r in first] == [r[1] for r in second] == [10.0] * 4
    assert [r[0] for r in first] == [r[0] for r in second]
    assert len({r[0] for r in first}) == 4 and first[0][0] == threading.get_ident()
    monkeypatch.setattr(pmesh, "WORKER_IDLE_S", 0.05)
    mesh2 = pmesh.build_mesh({"tp": 4}, devices=["cpu"] * 4)
    a = mesh2.run(body)
    time.sleep(0.5)
    alive = {t.ident for t in threading.enumerate()}
    assert not any(r[0] in alive for r in a[1:])
    b = mesh2.run(body)
    assert [r[1] for r in b] == [10.0] * 4
    assert all(r[0] in {t.ident for t in threading.enumerate()} for r in b[1:])
