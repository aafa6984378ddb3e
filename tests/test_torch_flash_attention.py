"""The port's flash-attention forward (seldon_core_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernel in interpret
mode, as tests/test_flash_attention.py runs it on the CPU.

On the CPU the port's wrapper runs the kernel's plain version, so these
tests hold that plain version to the TPU kernel's arithmetic.  The CUDA
kernel itself is held to the plain version on the card (the ``cuda``
tests below, and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops.flash_attention import _fwd_impl
from seldon_core_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from seldon_core_tpu_torch.ops import flash_attention as fa

# (B, H, KV, S, D): MHA, the 3-block online-softmax carry, GQA
SHAPES = [(2, 2, 2, 256, 64), (1, 1, 1, 384, 32), (1, 8, 2, 256, 64)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(shape, seed):
    B, H, KV, S, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_f32(shape, causal):
    q, k, v = _qkv(shape, 0)
    o, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    want_o, want_lse = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal, interpret=True)
    assert o.shape == want_o.shape and lse.shape == want_lse.shape
    # the JAX test's tolerance (tests/test_flash_attention.py:35): f32
    # throughout, only the order of the f32 sums differs
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-5, rtol=2e-5)
    # lse is an f32 reduction (max + log of a sum)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_bf16(shape, causal):
    q, k, v = _qkv(shape, 1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    want = jax_flash_attention(jq, jk, jv, causal, True)
    assert got.dtype == torch.bfloat16
    # both cast p to bf16 before the PV product and round o to bf16; the
    # TPU kernel's running max (3 K blocks at S=384) and the f32 sum order
    # can move one bf16 rounding of p or o: 2 ulp at |o| ~ 1 (2^-7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=1.6e-2, rtol=1e-2)


def test_constraint_errors_carry_the_jax_messages():
    z = torch.zeros
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention(z(1, 1, 100, 64), z(1, 1, 100, 64), z(1, 1, 100, 64))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(z(1, 1, 128, 512), z(1, 1, 128, 512), z(1, 1, 128, 512))
    with pytest.raises(ValueError, match="shapes differ"):
        fa.flash_attention(z(1, 1, 128, 64), z(1, 1, 128, 32), z(1, 1, 128, 64))
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention(z(1, 3, 128, 64), z(1, 2, 128, 64), z(1, 2, 128, 64))
    assert fa.shape_contract_error(z(1, 4, 128, 16), z(1, 2, 128, 16), z(1, 2, 128, 16)) is None


def test_plain_lse_is_the_row_logsumexp():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 1, 128, 16), 2))
    _, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    s = torch.einsum("bhqd,bkd->bhqk", q, k[:, 0]) / 4.0
    s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(lse.reshape(2, 128), torch.logsumexp(s, -1)[0], atol=1e-5, rtol=1e-5)


def test_lm_head_views_reach_the_kernel_without_a_copy():
    """The kernel reads q/k/v by strides: the head views the LM blocks make
    (a transpose of a slice of the fused qkv product, RoPE's output) pass
    as they are; a row stride that breaks 16-byte alignment is copied."""
    from seldon_core_tpu_torch.models.transformer import apply_rope, heads

    B, S, H, KV, D = 2, 128, 4, 2, 16
    qkv = torch.zeros(B, S, (H + 2 * KV) * D, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [H * D, KV * D, KV * D], dim=-1)
    views = [heads(q, B, S, H, D), heads(k, B, S, KV, D), heads(v, B, S, KV, D)]
    for t in views + [apply_rope(views[0], torch.arange(S))]:
        assert fa._kernel_view(t) is t
    odd = torch.zeros(B, H, S, 20, dtype=torch.bfloat16)[..., :16]
    fixed = fa._kernel_view(odd)
    assert fixed is not odd and fixed.is_contiguous()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(1, 4, 4, 256, 256)])
def test_kernel_matches_plain_on_card(shape, causal):
    _need_card()
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).to(dev) for a in _qkv(shape, 3))
    before = fa.LAUNCHES
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    want_o, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    # p rounds to bf16 at running (kernel) vs row (plain) maxima, and o to bf16
    assert float((o.float() - want_o.float()).abs().max()) <= 1.6e-2
    assert float((lse - want_lse).abs().max()) <= 1e-4


# (B, H, KV, S, D): a ragged last 128-row query tile (S = 192, which only
# the kernel's own entry takes: the JAX contract wants S % 128 == 0), the
# narrowest and the widest tile width
KERNEL_EDGES = [(2, 8, 2, 192, 64), (1, 4, 2, 192, 32), (1, 2, 1, 192, 256), (2, 4, 4, 256, 32),
                (1, 4, 2, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", KERNEL_EDGES, ids=[str(c) for c in KERNEL_EDGES])
def test_kernel_edges_match_plain_on_card(shape, causal, strided):
    """The ragged query tile, D = 32 and D = 256, by contiguous tensors and
    by the strided head views of a fused qkv product (TMA reads both)."""
    _need_card()
    B, H, KV, S, D = shape
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(S + D)
    if strided:
        qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=gen).to(torch.bfloat16).to(dev)
        q, k, v = torch.split(qkv, [H * D, KV * D, KV * D], dim=-1)
        q = q.reshape(B, S, H, D).transpose(1, 2)
        k = k.reshape(B, S, KV, D).transpose(1, 2)
        v = v.reshape(B, S, KV, D).transpose(1, 2)
        assert all(fa._kernel_view(t) is t for t in (q, k, v))
    else:
        q, k, v = (torch.randn(B, n, S, D, generator=gen).to(torch.bfloat16).to(dev)
                   for n in (H, KV, KV))
    before = fa.LAUNCHES
    o, lse = fa._launch(q, k, v, causal)
    again, _ = fa._launch(q, k, v, causal)
    want_o, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    assert float((o.float() - want_o.float()).abs().max()) <= 1.6e-2
    assert float((lse - want_lse).abs().max()) <= 1e-4
    assert torch.equal(o, again)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _need_card()
    assert "bfloat16" in fa.kernel_shape_error(64, torch.float32)
    assert "multiple of 16" in fa.kernel_shape_error(40, torch.bfloat16)
    assert fa.kernel_shape_error(64, torch.bfloat16) is None
