"""The port's fused-MLP op (seldon_core_tpu_torch/ops/fused_mlp.py) against
the JAX package's Pallas kernel in interpret mode.

On the CPU the port's wrapper runs the kernel's plain version, so these
tests hold that plain version to the TPU kernel's arithmetic.  The CUDA
kernel itself is held to the plain version on the card (the ``cuda``
test below, and chip_smoke.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops.fused_mlp import fused_mlp_softmax as jax_fused_mlp_softmax
from seldon_core_tpu_torch.ops import fused_mlp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_mlp(seed, dims):
    """He-scaled weights and small non-zero biases, f32 numpy."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (rng.standard_normal((k, n)) * math.sqrt(2.0 / k)).astype(np.float32)
        params[f"b{i}"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return params


def _pair(params, torch_dtype, jax_dtype):
    tp = {k: torch.from_numpy(v).to(torch_dtype) for k, v in params.items()}
    jp = {k: jnp.asarray(v, dtype=jax_dtype) for k, v in params.items()}
    return tp, jp


@pytest.mark.parametrize("batch,hidden,depth", [(8, 64, 2), (5, 32, 1), (17, 48, 3)])
def test_plain_matches_pallas_interpret_f32(batch, hidden, depth):
    dims = [24] + [hidden] * depth + [10]
    tp, jp = _pair(_np_mlp(0, dims), torch.float32, jnp.float32)
    x = np.random.default_rng(1).standard_normal((batch, 24)).astype(np.float32)
    got = fused_mlp.fused_mlp_softmax(tp, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fused_mlp_softmax(jp, jnp.asarray(x), block_b=8, interpret=True))
    # f32 throughout: only the order of the f32 sums differs
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("batch,hidden", [(4, 64), (9, 32)])
def test_plain_matches_pallas_interpret_bf16(batch, hidden):
    dims = [16, hidden, hidden, 10]
    tp, jp = _pair(_np_mlp(2, dims), torch.bfloat16, jnp.bfloat16)
    # both frameworks round f32 -> bf16 to nearest even: identical weights
    for k in tp:
        np.testing.assert_array_equal(
            tp[k].view(torch.int16).numpy(), np.asarray(jp[k]).view(np.int16))
    x = np.random.default_rng(3).standard_normal((batch, 16)).astype(np.float32)
    got = fused_mlp.fused_mlp_softmax(tp, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fused_mlp_softmax(jp, jnp.asarray(x), block_b=4, interpret=True))
    # the same bf16 casts at the same places; an f32 sum order difference
    # can still flip one bf16 rounding of an activation (2^-8 relative)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_wrapper_rejects_bad_shapes():
    tp = {k: torch.from_numpy(v) for k, v in _np_mlp(0, [4, 8, 2]).items()}
    with pytest.raises(ValueError, match=r"x must be \[B, D\]"):
        fused_mlp.fused_mlp_softmax(tp, torch.ones(4))
    with pytest.raises(ValueError, match="in_dim"):
        fused_mlp.fused_mlp_softmax(tp, torch.ones(2, 5))
    with pytest.raises(ValueError, match="empty params"):
        fused_mlp.fused_mlp_softmax({}, torch.ones(2, 4))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


@pytest.mark.parametrize("dims,dtype,match", [
    # the dtype rule is the wrapper's own: no build needed
    ([784, 256, 10], torch.float32, "bfloat16"),
    # widths and shared memory are the kernel source's to judge
    pytest.param([4096, 4096, 4096, 10], torch.bfloat16, "shared memory", marks=pytest.mark.cuda),
    pytest.param([24, 64, 10], torch.bfloat16, "multiple of 16", marks=pytest.mark.cuda),
    pytest.param([16] * 10 + [10], torch.bfloat16, "at most 8", marks=pytest.mark.cuda),
])
def test_kernel_shape_error_refuses_what_the_kernel_cannot_take(dims, dtype, match):
    if dtype == torch.bfloat16:
        _need_card()
    why = fused_mlp.kernel_shape_error(dims, [dtype] * (2 * len(dims) - 2))
    assert why is not None and match in why


@pytest.mark.cuda
def test_kernel_takes_the_served_widths():
    _need_card()
    for hidden in (256, 512):
        dims = [784, hidden, hidden, 10]
        assert fused_mlp.kernel_shape_error(dims, [torch.bfloat16] * 6) is None


@pytest.mark.cuda
def test_smem_layout_matches_hand_count():
    _need_card()
    # 784-256-256-10 (the csrc layout, 128-byte aligned pieces):
    # buffer 0: 32 rows x (784 + 8) bf16 = 50688; buffer 1: 32 x (256 + 8)
    # bf16 = 16896; weight stage 64 x (256 + 8) bf16 = 33792; 8 warps x
    # 16x16 f32 scratch = 8192; logits 32 x 16 f32 = 2048
    want = 50688 + 16896 + 33792 + 8192 + 2048
    assert fused_mlp._smem_bytes([784, 256, 256, 10]) == (want, None)


@pytest.mark.cuda
def test_probe_kernel_builds_and_launches_once():
    _need_card()
    before = fused_mlp.LAUNCHES
    fused_mlp.probe_kernel([784, 256, 256, 10], torch.device("cuda"))
    assert fused_mlp.LAUNCHES == before + 1


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    _need_card()
    dev = torch.device("cuda")
    for hidden in (256, 512):
        dims = [784, hidden, hidden, 10]
        tp = {k: torch.from_numpy(v).to(torch.bfloat16).to(dev)
              for k, v in _np_mlp(4, dims).items()}
        for batch in (1, 7, 32, 64, 128, 1024):
            x = torch.from_numpy(
                np.random.default_rng(batch).random((batch, 784)).astype(np.float32)).to(dev)
            before = fused_mlp.LAUNCHES
            got = fused_mlp.fused_mlp_softmax(tp, x)
            want = fused_mlp.fused_mlp_softmax_reference(tp, x)
            torch.cuda.synchronize()
            assert fused_mlp.LAUNCHES == before + 1
            # both sides round at the same bf16 casts; f32 sum order differs
            assert float((got - want).abs().max()) <= 2e-3
