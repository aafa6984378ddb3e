"""The GPipe pipeline over ``pp`` (``seldon_core_tpu_torch/parallel/pipeline.py``
and ``lm_pipeline_*`` in ``models/transformer.py``) against the JAX
package, the six cases of ``tests/test_pipeline.py`` on 8 CPU devices,
with the same weights (``convert.params_from_jax``) and inputs (numpy,
from a seed), in f32.  The reference's train-step case is ``slow`` in the
JAX suite (its jitted schedule compiles for long); the port's is small
and runs here against the reference's one-device ``lm_train_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu.parallel import pipeline as jpipe
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.optim import adam
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.parallel import pipeline as ppipe
from seldon_core_tpu_torch.tree import leaves_with_paths


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", pmesh._CPU_DEVICES)
    pmesh.set_cpu_device_count(8)
    yield
    torch.set_num_threads(prev)


DIMS = dict(vocab=32, d_model=16, n_heads=2, n_layers=4, d_ff=32)


def _setup(seed, **over):
    dims = dict(DIMS, **over)
    jcfg = jtr.LMConfig(**dims, dtype=jnp.float32)
    tcfg = ttr.LMConfig(**dims, dtype=torch.float32)
    jp = jtr.lm_init(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(rng, b, s):
    return rng.integers(0, DIMS["vocab"], size=(b, s)).astype(np.int32)


def test_generic_pipeline_matches_sequential_and_reference(devices8):
    """A 4-stage elementwise-affine pipeline equals composing the stages,
    and the reference's ``pipeline_apply`` on the same stages, within
    1e-6; each pp shard holds only its stage."""
    rng = np.random.default_rng(0)
    per_stage = [{"w": rng.normal(size=(8,)).astype(np.float32),
                  "b": rng.normal(size=(8,)).astype(np.float32)} for _ in range(4)]
    x = rng.normal(size=(6, 3, 8)).astype(np.float32)  # [n_micro, mb, F]
    jm = jmesh.build_mesh({"pp": 4}, devices=devices8[:4])
    jst = jpipe.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p) for p in per_stage])
    jst = jax.device_put(jst, jpipe.stage_param_shardings(jm, jst))
    want = np.asarray(jax.jit(lambda s, xm: jpipe.pipeline_apply(
        lambda p, h: jnp.tanh(h * p["w"] + p["b"]), s, xm, mesh=jm, batch_axis=None))(
            jst, jnp.asarray(x)))

    def stage_fn(p, h):
        return torch.tanh(h * p["w"] + p["b"])

    pm = pmesh.build_mesh({"pp": 4}, platform="cpu")
    stacked = ppipe.stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                                        for p in per_stage])
    placed = pmesh.place_tree(stacked, pm, ppipe.stage_param_shardings(pm, stacked))
    assert [s["w"].shape for s in placed.shards] == [(1, 8)] * 4
    got = ppipe.pipeline_apply(stage_fn, placed, torch.from_numpy(x), mesh=pm, batch_axis=None)
    expect = torch.from_numpy(x)
    for p in per_stage:
        expect = stage_fn({k: torch.from_numpy(v) for k, v in p.items()}, expect)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_micro_split_merge_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    m = ppipe.split_microbatches(x, 4)
    assert m.shape == (4, 3, 2)
    assert torch.equal(ppipe.merge_microbatches(m), x)
    with pytest.raises(ValueError) as perr:
        ppipe.split_microbatches(x, 5)
    with pytest.raises(ValueError) as jerr:
        jpipe.split_microbatches(jnp.arange(24.0).reshape(12, 2), 5)
    assert str(perr.value) == str(jerr.value)


def test_pipelined_lm_forward_matches_dense(devices8):
    """``lm_pipeline_apply`` over {"dp": 2, "pp": 4} equals the reference's
    one-device ``lm_apply`` within 2e-4, from ``lm_pipeline_params`` of the
    carried weights and from the reference's own ``lm_pipeline_params``
    tree carried across (``shard_pipeline_params``)."""
    jcfg, tcfg, jp, tp = _setup(0)
    tokens = _tokens(np.random.default_rng(1), 8, 12)
    want = np.asarray(jtr.lm_apply(jp, jnp.asarray(tokens), jcfg))
    pm = pmesh.build_mesh({"dp": 2, "pp": 4}, platform="cpu")
    pp = ttr.lm_pipeline_params(tp, tcfg, 4, pm)
    assert {tuple(s["stages"]["wqkv"].shape) for s in pp.shards} == {(1, 1, 16, 48)}
    got = ttr.lm_pipeline_apply(pp, torch.from_numpy(tokens), tcfg, pm, n_micro=4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    jm = jmesh.build_mesh({"dp": 2, "pp": 4}, devices=devices8)
    jpp = jtr.lm_pipeline_params(jp, jcfg, 4, jm)
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jpp), "cpu",
                              layout=lambda t: ttr.shard_pipeline_params(t, pm))
    again = ttr.lm_pipeline_apply(carried, torch.from_numpy(tokens), tcfg, n_micro=4)
    assert torch.equal(again, got)


class _GradCapture:
    """An optimizer whose update is zero and keeps the gradients it gets."""

    def update(self, grads, state, params=None):
        self.grads = grads
        return grads, state


def test_pipelined_train_step_matches_dense(devices8):
    """Over {"dp": 2, "pp": 2}: the pipelined loss equals the reference's
    dense loss within 1e-4 (``tests/test_pipeline.py:96``); the train
    step's gradients (the embedding's and final norm's copies summed)
    equal ``jax.grad`` of the dense loss within 1e-5 on every stage's
    layers; one pipelined train step equals the reference's one-device
    ``lm_train_step`` (loss at rtol 1e-5, the stages' layers and the
    replicated embedding within 2 lr, their copies bit-identical), and a
    second step lowers the loss."""
    from seldon_core_tpu_torch.optim import grad_update

    lr = 1e-3
    jcfg, tcfg, jp, tp = _setup(3)
    batch = _tokens(np.random.default_rng(2), 4, 13)
    dense, jgrads = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, {"tokens": jnp.asarray(batch)}, jcfg))(jp)
    pm = pmesh.build_mesh({"dp": 2, "pp": 2}, platform="cpu")
    pp = ttr.lm_pipeline_params(tp, tcfg, 2, pm)
    tb = {"tokens": torch.from_numpy(batch)}
    assert float(ttr.lm_pipeline_loss(pp, tb, tcfg, pm, n_micro=2)) == pytest.approx(
        float(dense), abs=1e-4)
    cap = _GradCapture()
    grad_update(lambda p, b: ttr.lm_pipeline_loss(p, b, tcfg, pm, n_micro=2), pp,
                pmesh.ShardedTree(pm, [None] * pm.size), tb, cap)
    gwant = {jax.tree_util.keystr(p): np.asarray(x)
             for p, x in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for i, shard in enumerate(cap.grads.shards):
        stage = pm.coords(i)["pp"]
        for key, leaf in leaves_with_paths(shard["stages"]):
            for j in range(leaf.shape[1]):
                want = gwant[f"['l{stage * 2 + j}']{key}"]
                np.testing.assert_allclose(leaf[0, j].numpy(), want, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{i} {key} {j}")
        for key in ("embed", "ln_f"):
            np.testing.assert_allclose(shard[key].numpy(), gwant[f"['{key}']"], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    opt = adam(lr)
    p1, _, loss1 = ttr.lm_pipeline_train_step(pp, opt.init(pp), tb, opt, tcfg, pm, n_micro=2)
    jopt = optax.adam(lr)
    jp1, _, jloss = jax.jit(lambda p, o, b: jtr.lm_train_step(p, o, b, jopt, jcfg, use_flash=False))(
        jp, jopt.init(jp), {"tokens": jnp.asarray(batch)})
    np.testing.assert_allclose(float(loss1), float(jloss), rtol=1e-5)
    want = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jp1)[0]}
    for i, shard in enumerate(p1.shards):
        stage = pm.coords(i)["pp"]
        for key, leaf in leaves_with_paths(shard["stages"]):
            for j in range(leaf.shape[1]):
                ref = want[f"['l{stage * 2 + j}']{key}"]
                assert np.abs(leaf[0, j].numpy() - ref).max() <= 2 * lr, (i, key, j)
        for key in ("embed", "ln_f"):
            assert torch.equal(shard[key], p1.shards[0][key]), (i, key)
            assert np.abs(shard[key].numpy() - want[f"['{key}']"]).max() <= 2 * lr, key
    _, _, loss2 = ttr.lm_pipeline_train_step(p1, opt.init(p1), tb, opt, tcfg, pm, n_micro=2)
    assert float(loss2) < float(loss1)


def test_stage_count_mesh_mismatch_rejected(devices8):
    """4 stacked stages on a pp=2 mesh fail in the reference's words."""
    jcfg, tcfg, jp, tp = _setup(5)
    tokens = _tokens(np.random.default_rng(4), 4, 8)
    jm = jmesh.build_mesh({"pp": 2}, devices=devices8[:2])
    with pytest.raises(ValueError, match="stacked stage dim") as jerr:
        jtr.lm_pipeline_apply(jtr.lm_pipeline_params(jp, jcfg, 4, jm), jnp.asarray(tokens),
                              jcfg, jm, n_micro=2)
    pm = pmesh.build_mesh({"pp": 2}, platform="cpu")
    with pytest.raises(ValueError, match="stacked stage dim") as perr:
        ttr.lm_pipeline_apply(ttr.lm_pipeline_params(tp, tcfg, 4, pm), torch.from_numpy(tokens),
                              tcfg, pm, n_micro=2)
    assert str(perr.value) == str(jerr.value)
    for dims, n in ((dict(n_layers=3), 2), (dict(moe_every=2, n_experts=4), 2)):
        jc, tc, jpar, tpar = _setup(6, **dims)
        with pytest.raises(ValueError) as jerr:
            jtr.lm_pipeline_params(jpar, jc, n, jm)
        with pytest.raises(ValueError) as perr:
            ttr.lm_pipeline_params(tpar, tc, n, pm)
        assert str(perr.value) == str(jerr.value)


def test_single_stage_degenerate(devices8):
    jcfg, tcfg, jp, tp = _setup(4)
    tokens = _tokens(np.random.default_rng(3), 4, 8)
    pm = pmesh.build_mesh({"pp": 1}, platform="cpu")
    got = ttr.lm_pipeline_apply(ttr.lm_pipeline_params(tp, tcfg, 1, pm),
                                torch.from_numpy(tokens), tcfg, pm, n_micro=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtr.lm_apply(jp, jnp.asarray(tokens), jcfg)),
                               atol=2e-4, rtol=2e-4)
