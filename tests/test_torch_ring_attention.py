"""Ring attention over ``sp`` (``seldon_core_tpu_torch/parallel/ring_attention.py``)
and the LM served over an ``sp`` mesh, against the JAX package's
``ring_attention_sharded`` / ``lm_apply(mesh=)`` / ``TransformerLM(mesh=)``
on 8 CPU devices, with the same inputs (numpy, from a seed) and the same
weights (carried across with ``convert.params_from_jax``).

The plain path is the reference's arithmetic and is held at the reference
test's own tolerance (2e-5, ``tests/test_parallel.py:114``).  The kernel
path (``RingFlash``) runs the flash wrappers' plain versions on the CPU,
so its block decomposition (causal on the diagonal, full below it, no
launch above it), its f32 merge and its per-block backward with the
merged o and lse are held here too; the card holds the kernels themselves
(``chip_smoke.py`` phase 10v)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu.parallel.ring_attention import ring_attention_sharded as jring
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.parallel import ring_attention as pring


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", pmesh._CPU_DEVICES)
    pmesh.set_cpu_device_count(8)
    yield
    torch.set_num_threads(prev)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_ring_and_grads(axes, causal, q, k, v, w):
    mesh = jmesh.build_mesh(axes)
    ring = jax.jit(jring(mesh, "sp", causal=causal))
    out = ring(*(jnp.asarray(t) for t in (q, k, v)))
    grads = jax.grad(lambda a, b, c: jnp.sum(ring(a, b, c) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring_and_grads(axes, causal, use_flash, q, k, v, w):
    mesh = pmesh.build_mesh(axes, platform="cpu")
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = pring.ring_attention_sharded(mesh, "sp", causal, use_flash=use_flash)(*ts)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_reference_ring(causal, devices8):
    """The plain path over {"sp": 8} at the reference test's shape
    (2, 2, 64, 16) against ``ring_attention_sharded``: the output within
    2e-5, and the gradients of sum(o * w) against ``jax.grad`` through the
    reference's ring."""
    q, k, v = _qkv((2, 2, 64, 16), 0)
    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    want, wgrads = _jax_ring_and_grads({"sp": 8}, causal, q, k, v, w)
    got, grads = _port_ring_and_grads({"sp": 8}, causal, None, q, k, v, w)
    np.testing.assert_allclose(got, want, atol=2e-5)
    for name, g, wg in zip("qkv", grads, wgrads):
        np.testing.assert_allclose(g, wg, atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_kernel_path_matches_reference_ring(causal, devices8, monkeypatch):
    """The kernel path (``RingFlash``, the flash wrappers' plain versions on
    the CPU) over {"sp": 4} with 128-position blocks against the
    reference's ring: output and gradients within 2e-5.  It launches the
    forward on the diagonal causally and below it in full, never above it
    (1 + 2 + 3 + 4 blocks causal, 16 full), and the backward once per
    launched block."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = pring.flash_attention_fwd, pring.flash_attention_bwd

    def count_fwd(q, k, v, c):
        calls["fwd"].append(c)
        return fwd(q, k, v, c)

    def count_bwd(q, k, v, o, lse, do, c):
        calls["bwd"].append(c)
        return bwd(q, k, v, o, lse, do, c)

    monkeypatch.setattr(pring, "flash_attention_fwd", count_fwd)
    monkeypatch.setattr(pring, "flash_attention_bwd", count_bwd)
    q, k, v = _qkv((1, 2, 512, 16), 2)
    w = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    want, wgrads = _jax_ring_and_grads({"sp": 4}, causal, q, k, v, w)
    got, grads = _port_ring_and_grads({"sp": 4}, causal, True, q, k, v, w)
    np.testing.assert_allclose(got, want, atol=2e-5)
    for name, g, wg in zip("qkv", grads, wgrads):
        np.testing.assert_allclose(g, wg, atol=2e-5, err_msg=f"d{name}")
    if causal:
        assert sorted(calls["fwd"]) == [False] * 6 + [True] * 4
    else:
        assert calls["fwd"] == [False] * 16
    assert sorted(calls["bwd"]) == sorted(calls["fwd"])


def test_ring_kernel_path_is_static_and_bf16_by_default(devices8):
    """The kernel path is decided from one block's shape: S_local 64 (not
    a multiple of 128) takes the plain path even when asked; the standalone
    ring asks for it by default for bf16 only."""
    q = torch.zeros(1, 2, 64, 16)
    assert not pring.ring_uses_kernels(q, q, q, True)
    q = torch.zeros(1, 2, 128, 16)
    assert pring.ring_uses_kernels(q, q, q, True)
    assert not pring.ring_uses_kernels(q, q, q, False)
    mesh = pmesh.build_mesh({"sp": 2}, platform="cpu")
    before = []
    orig = pring.RingFlash.apply

    class Spy(pring.RingFlash):
        @staticmethod
        def forward(ctx, *a):
            before.append(a[0].dtype)
            return pring.RingFlash.forward(ctx, *a)

    pring.RingFlash.apply = Spy.apply
    try:
        x = torch.randn(1, 2, 256, 16)
        pring.ring_attention_sharded(mesh)(x, x, x)
        pring.ring_attention_sharded(mesh)(*(x.bfloat16() for _ in range(3)))
    finally:
        pring.RingFlash.apply = orig
    assert before == [torch.bfloat16, torch.bfloat16]


DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def _lm(dims, seed):
    jcfg = jtr.LMConfig(**dims, dtype=jnp.float32)
    tcfg = ttr.LMConfig(**dims, dtype=torch.float32)
    jp = jtr.lm_init(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 4}, {"sp": 4, "dp": 2}, {"sp": 2, "tp": 2}],
                         ids=["dp2_sp4", "sp4_dp2", "sp2_tp2"])
def test_lm_apply_over_sp_matches_reference(axes, devices8):
    """``lm_apply`` with rope on over an sp mesh (and dp or tp beside it)
    against the reference's ``lm_apply(mesh=)`` within 2e-4: each shard
    rotates at its global positions (``axis_index("sp") * S_local`` on), as
    the reference rotates the whole sequence before its ring.  A mesh given
    sp before dp gathers its blocks by coordinate, not by flat order."""
    jcfg, tcfg, jp, tp = _lm(DIMS, 5)
    tokens = np.random.default_rng(5).integers(0, 64, size=(2, 32)).astype(np.int32)
    jm = jmesh.build_mesh(axes)
    want = np.asarray(jax.jit(lambda p, t: jtr.lm_apply(p, t, jcfg, jm))(
        jax.device_put(jp, jtr.param_shardings(jm, jp)), jnp.asarray(tokens)))
    pm = pmesh.build_mesh(axes, platform="cpu")
    got = ttr.lm_apply(ttr.shard_params(tp, pm), torch.from_numpy(tokens), tcfg)
    assert got.shape == (2, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_lm_kernel_path_over_sp_matches_one_device(devices8):
    """With ``use_flash`` the LM's ring takes ``RingFlash`` at 128-position
    blocks (the plain flash versions on the CPU): logits over {"sp": 4}
    equal the reference's one-device ``lm_apply`` within 2e-4."""
    jcfg, tcfg, jp, tp = _lm(DIMS, 6)
    tokens = np.random.default_rng(6).integers(0, 64, size=(1, 512)).astype(np.int32)
    want = np.asarray(jtr.lm_apply(jp, jnp.asarray(tokens), jcfg))
    pm = pmesh.build_mesh({"sp": 4}, platform="cpu")
    got = ttr.lm_apply(ttr.shard_params(tp, pm), torch.from_numpy(tokens), tcfg, use_flash=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_moe_lm_over_sp_matches_reference(devices8):
    """An MoE config over {"sp": 2}: each shard's FFN routes the whole
    sequence (capacity is set over every token), so the logits equal the
    reference's over the same mesh."""
    dims = dict(DIMS, moe_every=2, n_experts=4, moe_k=2)
    jcfg, tcfg, jp, tp = _lm(dims, 7)
    tokens = np.random.default_rng(7).integers(0, 64, size=(2, 16)).astype(np.int32)
    jm = jmesh.build_mesh({"sp": 2})
    want = np.asarray(jax.jit(lambda p, t: jtr.lm_apply(p, t, jcfg, jm))(
        jax.device_put(jp, jtr.param_shardings(jm, jp)), jnp.asarray(tokens)))
    pm = pmesh.build_mesh({"sp": 2}, platform="cpu")
    got = ttr.lm_apply(ttr.shard_params(tp, pm), torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_gqa_over_sp_refused_in_reference_words(devices8):
    dims = dict(DIMS, n_heads=4, n_kv_heads=2)
    jcfg, tcfg, jp, tp = _lm(dims, 8)
    tokens = np.zeros((2, 16), np.int32)
    jm = jmesh.build_mesh({"sp": 2})
    with pytest.raises(ValueError) as jerr:
        jtr.lm_apply(jax.device_put(jp, jtr.param_shardings(jm, jp)), jnp.asarray(tokens),
                     jcfg, jm)
    pm = pmesh.build_mesh({"sp": 2}, platform="cpu")
    with pytest.raises(ValueError) as perr:
        ttr.lm_apply(ttr.shard_params(tp, pm), torch.from_numpy(tokens), tcfg)
    assert str(perr.value) == str(jerr.value) == (
        "sequence-parallel ring attention requires n_kv_heads == n_heads")


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 4}, {"sp": 4, "dp": 2}],
                         ids=["dp2_sp4", "sp4_dp2"])
def test_transformer_unit_serves_on_sp_mesh_as_reference(axes, devices8):
    """The counterpart of ``test_parallel.py:177``: the same unit over
    {"dp": 2, "sp": 4} (either axis first) with the reference unit's state
    carried across answers the reference unit's logits within 2e-4, and
    its one-device self within 2e-4."""
    from seldon_core_tpu.models.transformer import TransformerLM as JUnit

    kw = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, dtype="float32")
    tokens = np.random.default_rng(7).integers(0, 64, size=(2, 32)).astype(np.int32)
    jm = jmesh.build_mesh(axes)
    junit = JUnit(**kw, mesh=jm)
    jstate = junit.init_state(jax.random.key(7))
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(tokens)))
    pm = pmesh.build_mesh(axes, platform="cpu")
    unit = ttr.TransformerLM(**kw, mesh=pm, device="cpu")
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu",
                            layout=unit.shard_state)
    got = unit.predict(state, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    one = ttr.TransformerLM(**kw, device="cpu")
    alone = one.predict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu"),
                        torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=2e-4, rtol=2e-4)


def test_sequence_not_divisible_over_sp_refused(devices8):
    _, tcfg, _, tp = _lm(DIMS, 9)
    pm = pmesh.build_mesh({"sp": 4}, platform="cpu")
    with pytest.raises(ValueError, match="not divisible over 'sp' of size 4"):
        ttr.lm_apply(ttr.shard_params(tp, pm), torch.zeros(1, 10, dtype=torch.int64), tcfg)
