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
    # 784-256-256-10 at the B=1 plan, a cluster of 16 and 8 rows a block
    # (the csrc layout, 128-byte aligned pieces): buffer 0: 8 rows x (784 +
    # 8) bf16 = 12672; buffer 1: 8 x (256 + 8) bf16 = 4224; the rank's
    # weight slices 784 x 16 and 256 x 16 bf16 = 25088 + 8192; the last
    # layer whole, 256 x 10 bf16 = 5120; three layers' biases, 16 f32 each
    # (128 apiece); 8 warps' partial sums, 32 lanes x 4 f32 = 4096; logits
    # 8 x 10 f32 = 384; three mbarriers = 128
    want = 12672 + 4224 + 25088 + 8192 + 5120 + 3 * 128 + 4096 + 384 + 128
    assert fused_mlp._smem_bytes([784, 256, 256, 10], 16, 8) == (want, None)
    # and the Python statement of the layout, which mlp_plan reads, is the
    # source's at every plan of both served stacks
    for hidden in (256, 512):
        dims = [784, hidden, hidden, 10]
        for C in (1, 2, 4, 8, 16):
            for BM in (8, 16, 32, 64):
                n, why = fused_mlp._smem_bytes(dims, C, BM)
                assert fused_mlp._layout_bytes(dims, C, BM) == (n if why is None else None)


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


@pytest.mark.parametrize("batch", [1, 7, 32, 64, 128, 1024])
@pytest.mark.parametrize("hidden", [256, 512])
def test_plan_covers_every_row_and_column_once(batch, hidden):
    """``mlp_plan``'s (BM, C) at the served widths: a plan the source takes
    (a cluster of 1-16 blocks, 8-64 rows a block, a layout within the
    shared-memory budget), tiles of BM rows that cover each batch row once,
    and ranks whose column ranges cover each layer's columns once: the
    hidden layers split over the cluster, the last layer's 10 columns on
    rank 0 alone, even over 16 ranks."""
    dims = (784, hidden, hidden, 10)
    BM, C = fused_mlp.mlp_plan(batch, dims, 132)
    assert C in (1, 2, 4, 8, 16) and BM in (8, 16, 32, 64)
    assert fused_mlp._layout_bytes(dims, C, BM) is not None
    tiles = [range(t * BM, min(batch, (t + 1) * BM)) for t in range(-(-batch // BM))]
    assert [r for tile in tiles for r in tile] == list(range(batch))
    cw = fused_mlp.layer_columns(dims, C)
    for l, n in enumerate(dims[1:-1]):
        owned = [c for r in range(C) for c in range(r * cw[l], min(n, (r + 1) * cw[l]))]
        assert owned == list(range(n)) and cw[l] % 16 == 0
    assert cw[-1] == 16  # rank 0's one m16 tile of the 10 logits
    if batch <= 32:
        assert C == 16  # the one-tile batches take the widest cluster


@pytest.mark.parametrize("dims,C,columns", [
    ((784, 256, 256, 10), 16, [16, 16, 16]), ((784, 512, 512, 10), 16, [32, 32, 16]),
    ((784, 256, 256, 10), 1, [256, 256, 16]), ((32, 48, 10), 16, [16, 16]),
    ((32, 48, 10), 2, [32, 16]),
])
def test_layer_columns_and_the_layout_rule(dims, C, columns):
    """Each rank's columns are a multiple of 16 (one m16 tile each), and
    the Python statement of the layout refuses what the source refuses: a
    rank's columns past 256 (one TMA box), a cluster or row tile it has no
    kernel for, more than the 227 KiB budget (the 4096-wide MLP)."""
    assert fused_mlp.layer_columns(dims, C) == columns
    assert fused_mlp._layout_bytes((784, 512, 512, 10), 1, 8) is None  # 512 columns a rank
    assert fused_mlp._layout_bytes((784, 256, 256, 10), 3, 8) is None
    assert fused_mlp._layout_bytes((784, 256, 256, 10), 16, 12) is None
    assert fused_mlp._layout_bytes((4096, 4096, 4096, 10), 16, 8) is None
    assert fused_mlp._layout_bytes((784, 256, 256, 10), 16, 8) == 60288


def _column_split(params, x, C):
    """The kernel's split, emulated plainly: each rank computes its columns
    of a hidden layer from its own slice of the weights (bias and relu on
    them), the columns are gathered, and rank 0 computes the last layer
    whole and the softmax."""
    layers = fused_mlp._layer_params(params)
    dims = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
    cw = fused_mlp.layer_columns(dims, C)
    h = x.float()
    for i, (w, b) in enumerate(layers):
        hin = h.to(w.dtype).float()
        if i == len(layers) - 1:
            h = hin @ w.float() + b.float()
        else:
            n = w.shape[1]
            h = torch.relu(torch.cat([hin @ w[:, r * cw[i]:(r + 1) * cw[i]].float()
                                      + b[r * cw[i]:(r + 1) * cw[i]].float()
                                      for r in range(C) if r * cw[i] < n], dim=1))
    return torch.softmax(h, dim=-1)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_column_split_is_the_plain_version_bit_for_bit(C):
    """Splitting each hidden layer's columns over C ranks and gathering
    them changes no bit of the plain version's probabilities: a column's
    dot product does not depend on the other columns (bf16 weights, the
    served 784-256-256-10 stack, 7 rows)."""
    dims = [784, 256, 256, 10]
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _np_mlp(5, dims).items()}
    x = torch.from_numpy(np.random.default_rng(6).random((7, 784)).astype(np.float32))
    want = fused_mlp.fused_mlp_softmax_reference(tp, x)
    assert torch.equal(_column_split(tp, x, C), want)


@pytest.mark.cuda
def test_kernel_row_bits_do_not_depend_on_the_plan_on_card():
    """Every plan the kernel takes gives a row the same bits (a column's
    dot product is one rank's, in a fixed order of its k-steps), a repeat
    gives the same bits, and the launch runs the cluster the plan asked
    for, as the kernel itself reads it."""
    _need_card()
    dev = torch.device("cuda")
    dims = (784, 256, 256, 10)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16).to(dev) for k, v in _np_mlp(7, dims).items()}
    layers = fused_mlp._layer_params(tp)
    x = torch.from_numpy(np.random.default_rng(8).random((64, 784)).astype(np.float32)).to(dev)
    want = fused_mlp.fused_mlp_softmax_reference(tp, x)
    first = None
    for C in (1, 2, 4, 8, 16):
        for BM in (8, 16, 32, 64):
            if fused_mlp._layout_bytes(dims, C, BM) is None:
                continue
            shape = torch.zeros(3, dtype=torch.int32, device=dev)
            got = fused_mlp._launch(layers, dims, x, (BM, C), shape)
            again = fused_mlp._launch(layers, dims, x, (BM, C))
            torch.cuda.synchronize()
            assert shape.tolist() == [C, C * -(-64 // BM), BM]
            assert torch.equal(got, again)
            assert float((got - want).abs().max()) <= 2e-3
            first = got if first is None else first
            assert torch.equal(got, first)
