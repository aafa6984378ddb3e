"""The port's flash-attention backward (seldon_core_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas backward kernels in
interpret mode, as tests/test_flash_attention.py runs them on the CPU.

On the CPU the port's wrapper runs the kernels' plain version
(``flash_attention_bwd_reference``), so these tests hold that plain
version to the TPU kernels' arithmetic, and check that autograd through
the port's ``flash_attention`` takes that backward.  The CUDA kernels
themselves are held to the plain version on the card (the ``cuda`` tests
below, and chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.ops import flash_attention as fa

# the module itself: the package re-exports a function of the same name
jfa = importlib.import_module("seldon_core_tpu.ops.flash_attention")

# (B, H, KV, S, D): MHA, the 3-tile (384) carry, GQA
SHAPES = [(1, 2, 2, 256, 64), (1, 1, 1, 384, 32), (1, 8, 2, 256, 64)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, seed):
    B, H, KV, S, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32))


def _jax_bwd(q, k, v, do, causal, dtype):
    """The JAX package's (o, lse) and its custom-VJP backward (the MHA
    kernels, and for GQA the repeat and group sum), in interpret mode."""
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=dtype) for a in (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, causal, True)
    return (o, lse), jfa._flash_bwd(causal, True, (jq, jk, jv, o, lse), jdo)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_interpret_f32(shape, causal):
    q, k, v, do = _inputs(shape, 0)
    (o, lse), want = _jax_bwd(q, k, v, do, causal, jnp.float32)
    got = fa.flash_attention_bwd(_torch(q), _torch(k), _torch(v), _torch(o), _torch(lse),
                                 _torch(do), causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        # f32 throughout on both sides, only the order of the f32 sums
        # differs; tighter than the JAX test's 3e-4 against XLA's VJP
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} at {shape} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_interpret_bf16(shape, causal):
    q, k, v, do = _inputs(shape, 1)
    (o, lse), want = _jax_bwd(q, k, v, do, causal, jnp.bfloat16)
    bf = torch.bfloat16
    got = fa.flash_attention_bwd(_torch(q, bf), _torch(k, bf), _torch(v, bf), _torch(o, bf),
                                 _torch(lse), _torch(do, bf), causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, dtype=np.float32)
        # both round p and ds to bf16 at the same places and the result at
        # the end; the TPU kernel's 128-wide blocks sum in another f32
        # order, which can move one of those roundings by an ulp: 2 bf16
        # ulps of the gradient's largest element
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2.0 ** -6 * np.abs(w).max(), f"{name} at {shape} causal={causal}: {err}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_matches_jax_grad_f32(shape, causal):
    """torch.autograd.grad through the port's flash_attention against
    jax.grad of the JAX package's flash_attention (interpret mode)."""
    q, k, v, do = _inputs(shape, 2)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jfa.flash_attention(a, b, c, causal, True) * jnp.asarray(do)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), _torch(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        # the JAX test's tolerance against the XLA VJP (test_flash_attention.py:79-82)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-4, rtol=3e-4,
                                   err_msg=f"{name} at {shape} causal={causal}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_takes_the_plain_backward_exactly(dtype):
    """On the CPU the gradient of flash_attention is the plain backward's
    result, bit for bit (the custom-VJP rule), not autograd of the plain
    forward."""
    q, k, v, do = (_torch(a, dtype) for a in _inputs((1, 8, 2, 256, 64), 3))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention(tq, tk, tv, causal=True), (tq, tk, tv), do)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


def test_backward_keeps_the_shape_contract_messages():
    z = torch.zeros
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention_bwd(*(z(1, 1, 100, 64),) * 3, z(1, 1, 100, 64), z(1, 100, 1),
                               z(1, 1, 100, 64))
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention_bwd(z(1, 3, 128, 64), z(1, 2, 128, 64), z(1, 2, 128, 64),
                               z(1, 3, 128, 64), z(3, 128, 1), z(1, 3, 128, 64))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


# S=192 is a ragged last 128-row tile, which only the kernels' own entries
# take (the JAX contract wants S % 128); (1, 8, 1, 256, 64) a group of 8
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(2, 8, 2, 1024, 128), (1, 4, 4, 256, 256),
                                            (2, 8, 2, 192, 64), (1, 8, 1, 256, 64)])
def test_kernels_match_plain_on_card(shape, causal):
    _need_card()
    dev = torch.device("cuda")
    q, k, v, do = (_torch(a, torch.bfloat16).to(dev) for a in _inputs(shape, 4))
    ragged = shape[3] % 128 != 0
    fwd = fa._launch if ragged else fa.flash_attention_fwd
    bwd = fa._launch_bwd if ragged else fa.flash_attention_bwd
    o, lse = fwd(q, k, v, causal)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    got = bwd(q, k, v, o, lse, do, causal)
    again = bwd(q, k, v, o, lse, do, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 2, before[1] + 2)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)  # no atomics: the same bits every call
        # chip_smoke.py's BWD_REL_TOL: 4 bf16 ulps of the largest element
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2.0 ** -5 * float(w.float().abs().max())


@pytest.mark.cuda
def test_backward_kernels_refuse_what_the_forward_refuses():
    _need_card()
    assert "bfloat16" in fa.bwd_kernel_shape_error(64, torch.float32)
    assert "multiple of 16" in fa.bwd_kernel_shape_error(40, torch.bfloat16)
    for d in (16, 32, 64, 128, 256):
        assert fa.bwd_kernel_shape_error(d, torch.bfloat16) is None
