"""Flash attention on Hopper — the prefill attention of the LM units and,
with its backward, the attention of training.

    o = softmax(q k^T / sqrt(D)) v,   lse = logsumexp(q k^T / sqrt(D))

q ``[B, H, S, D]``, k/v ``[B, KV, S, D]`` with H a multiple of KV (grouped-
query attention is native: K/V are never repeated), o ``[B, H, S, D]`` in
q's dtype and the per-row log-sum-exp ``lse`` ``[B*H, S, 1]`` float32, the
layout of the JAX package.

Replaces the three Pallas TPU kernels of
``seldon_core_tpu/ops/flash_attention.py`` with hand-written CUDA kernels
for sm_90a that compute the same arithmetic and round at the same places:

  forward   ``_fwd_impl`` :136 (``_flash_kernel`` :56, ``pallas_call``
            :177) -> ``ops/csrc/flash_attention.cu``: f32 scores, causal
            masking by global position with -1e30, an online softmax whose
            ``p`` is cast to V's dtype before the PV product,
            ``acc / max(l, 1e-30)``;
  backward  ``_bwd_impl`` :303 (``_bwd_dq_kernel`` :208, ``pallas_call``
            :331; ``_bwd_dkv_kernel`` :252, ``pallas_call`` :349) ->
            ``ops/csrc/flash_attention_bwd.cu``: p recomputed as
            exp(s - lse), ``p`` cast to dO's dtype before P^T dO, ds =
            p (dp - dsum) in f32 cast to K's/Q's dtype before dS K and
            dS^T Q, the scale after the f32 products; two kernels, no
            atomics.  The dQ kernel also computes dsum = rowsum(dO o)
            (XLA's term outside the TPU kernels) and hands it to the
            dK/dV kernel, so the backward is two launches.  The GQA
            adjoint (``_flash_bwd`` :397-413) is native too: the dK/dV
            kernel sums a kv head's query heads in f32.

Bound on an H100 SXM: at the served prefill (B=32, H=16, KV=4, S=512,
D=64, bf16) the forward moves ~85 MB, ~25 us at 3.35 TB/s, against 17.2
GFLOP, ~17 us at 989 TFLOP/s, so it is bound by the bytes; the backward's
bounds are in its source.  The kernels keep the [S, S] scores out of
device memory and stream each kv head's K/V at its stored size.

``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is ``flash_attention_fwd`` and
whose backward is ``flash_attention_bwd``, as ``jax.custom_vjp`` wraps the
TPU kernels: on the CPU the plain forward runs without a graph and the
gradient comes from the plain *backward*, not from autograd of the plain
forward.  Every entry point first holds the inputs to the JAX package's
shape contract (``_validate``, the same messages).  A CUDA tensor then
launches the kernel or raises: what the kernels cannot take (a dtype other
than bf16, a head dim that is not a multiple of 16) is a ``ValueError``
from a static check before any launch, and those kernel-only limits are
the sources' to state (``flash_attention_smem_bytes`` and
``flash_attention_bwd_smem_bytes``, asked through ``kernel_shape_error``
and ``bwd_kernel_shape_error``).  The kernels take q/k/v/dO by strides
(unit stride along D), so the strided head views of the LM blocks need no
copy; a tensor whose rows are not 16-byte aligned is made contiguous
first.  A CPU tensor runs the plain PyTorch versions
(``flash_attention_reference``, ``flash_attention_bwd_reference``) that
the tests and ``chip_smoke.py`` hold the kernels against; nothing on the
CUDA path calls them.  ``LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES``
count kernel launches and nothing else.  ``probe_kernel`` and
``probe_bwd_kernel`` build a library and launch once, so a unit or a
training run finds a missing compiler or a failing build before it
starts.
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library

__all__ = [
    "LAUNCHES",
    "DQ_LAUNCHES",
    "DKV_LAUNCHES",
    "FlashAttention",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_reference",
    "flash_attention_bwd_reference",
    "shape_contract_error",
    "kernel_shape_error",
    "bwd_kernel_shape_error",
    "probe_kernel",
    "probe_bwd_kernel",
]

#: forward kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
#: dQ and dK/dV kernel launches, likewise
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

_BLOCK = 128       # the JAX contract: S divisible by 128
_NEG_INF = -1e30


def shape_contract_error(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why q/k/v break the JAX package's flash contract (``_validate``,
    ``seldon_core_tpu/ops/flash_attention.py:118``), with its messages, or
    None.  Static: ``_attention`` asks it to pick the plain path."""
    if k.shape != v.shape:
        return f"k/v shapes differ: {tuple(k.shape)} {tuple(v.shape)}"
    if q.ndim != 4 or k.ndim != 4:
        return f"expected [B, H, S, D], got {tuple(q.shape)} {tuple(k.shape)}"
    B, H, S, D = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        return f"q/k shapes differ: {tuple(q.shape)} {tuple(k.shape)}"
    if KV == 0 or H % KV != 0:
        return f"query heads {H} not a multiple of kv heads {KV}"
    if S % _BLOCK != 0:
        return f"seq len {S} not divisible by {_BLOCK}"
    if D > 256:
        return f"head dim {D} > 256"
    return None


def _validate(q, k, v) -> None:
    why = shape_contract_error(q, k, v)
    if why is not None:
        raise ValueError(why)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, on any device: (o, lse).  f32 scores from
    the inputs upcast (JAX's ``preferred_element_type=f32``), the softmax
    over the whole row at once with the row max, ``p`` cast to V's dtype
    before an f32 PV product, then ``/ max(l, 1e-30)``."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    g = H // KV
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, KV, g * S, D).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale  # [B, KV, g*S, S]
    s = s.reshape(B, KV, g, S, S)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float().reshape(B, KV, g * S, S), v.float())
    o = (acc.reshape(B, KV, g, S, D) / l).to(q.dtype).reshape(B, H, S, D)
    lse = (m + torch.log(l)).reshape(B * H, S, 1)
    return o, lse


def _dsum(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * o) in f32, [B, H, S] contiguous: the term ``_bwd_impl``
    computes in XLA outside the TPU kernels (:316-319).  The plain
    version's; on CUDA the dQ kernel computes it."""
    return torch.sum(do.float() * o.float(), dim=-1)


def _probs(q, k, lse, causal: bool) -> torch.Tensor:
    """p = exp(s - lse), [B, H, S, S] f32, with K/V at the query heads."""
    B, H, S, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / (D ** 0.5))
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], _NEG_INF)
    return torch.exp(s - lse.reshape(B, H, S, 1))


def _dq_reference(q, k, v, do, lse, dsum, causal: bool) -> torch.Tensor:
    """``_bwd_dq_kernel`` over whole rows, K/V at the query heads: dQ =
    (bf16(ds) k) * scale, ds = p (dO v^T - dsum) in f32."""
    p = _probs(q, k, lse, causal)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - dsum[..., None])
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * (1.0 / (q.shape[-1] ** 0.5))
    return dq.to(q.dtype)


def _dkv_reference(q, k, v, do, lse, dsum, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_bwd_dkv_kernel`` over whole rows, K/V at the query heads: dV =
    bf16(p)^T dO, dK = (bf16(ds)^T q) * scale, each in K's/V's dtype."""
    p = _probs(q, k, lse, causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - dsum[..., None])
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * (
        1.0 / (q.shape[-1] ** 0.5))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch backward, on any device: (dq, dk, dv).  Mirrors
    ``_bwd_impl`` and the GQA adjoint of ``_flash_bwd``: K/V repeated over
    the group, the MHA backward, each query head's dK/dV rounded to K's/V's
    dtype, the group summed in f32 and cast."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    g = H // KV
    dsum = _dsum(o, do)
    krep = k.repeat_interleave(g, dim=1) if g > 1 else k
    vrep = v.repeat_interleave(g, dim=1) if g > 1 else v
    dq = _dq_reference(q, krep, vrep, do, lse, dsum, causal)
    dk, dv = _dkv_reference(q, krep, vrep, do, lse, dsum, causal)
    if g > 1:
        dk = dk.float().reshape(B, KV, g, S, D).sum(dim=2).to(k.dtype)
        dv = dv.float().reshape(B, KV, g, S, D).sum(dim=2).to(v.dtype)
    return dq, dk, dv


_bind_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None


def _library() -> SimpleNamespace:
    """The kernel library's entry points, built and bound at first use."""
    global _lib
    with _bind_lock:
        if _lib is None:
            lib = load_library("flash_attention")
            launch = lib.flash_attention_fwd_launch
            launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p, ctypes.c_void_p]
            launch.restype = ctypes.c_int
            smem = lib.flash_attention_smem_bytes
            smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int]
            smem.restype = ctypes.c_int
            err = lib.flash_attention_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, smem_bytes=smem, error_string=err)
        return _lib


_bwd_lib: Optional[SimpleNamespace] = None


def _bwd_library() -> SimpleNamespace:
    """The backward library's entry points, built and bound at first use."""
    global _bwd_lib
    with _bind_lock:
        if _bwd_lib is None:
            lib = load_library("flash_attention_bwd")
            dq = lib.flash_attention_bwd_dq_launch
            dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p, ctypes.c_void_p]
            dq.restype = ctypes.c_int
            dkv = lib.flash_attention_bwd_dkv_launch
            dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p, ctypes.c_void_p]
            dkv.restype = ctypes.c_int
            smem = lib.flash_attention_bwd_smem_bytes
            smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int]
            smem.restype = ctypes.c_int
            err = lib.flash_attention_bwd_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bwd_lib = SimpleNamespace(dq=dq, dkv=dkv, smem_bytes=smem, error_string=err)
        return _bwd_lib


def _smem_bytes(head_dim: int, seq_len: int, dtype: torch.dtype,
                bwd: bool = False) -> Tuple[int, Optional[str]]:
    """(dynamic shared memory the forward, or with ``bwd`` the backward,
    asks for, None), or (-1, why not), from ``flash_attention_smem_bytes``
    / ``flash_attention_bwd_smem_bytes`` in the sources."""
    why = ctypes.create_string_buffer(256)
    dtype_code = 0 if dtype == torch.bfloat16 else -1  # the .cu's codes: 0 = bfloat16
    lib = _bwd_library() if bwd else _library()
    n = lib.smem_bytes(int(head_dim), int(seq_len), dtype_code, ctypes.addressof(why), len(why))
    return n, (why.value.decode() if n < 0 else None)


def kernel_shape_error(head_dim: int, dtype: torch.dtype, seq_len: int = _BLOCK) -> Optional[str]:
    """Why the forward kernel cannot take this head dim, dtype and sequence
    length (any length the JAX contract admits, by default), or None.  Asks
    the kernel source (nvcc needed); units call it at construction."""
    return _smem_bytes(head_dim, seq_len, dtype)[1]


def bwd_kernel_shape_error(head_dim: int, dtype: torch.dtype,
                           seq_len: int = _BLOCK) -> Optional[str]:
    """The same question for the two backward kernels (their source takes
    what the forward takes)."""
    return _smem_bytes(head_dim, seq_len, dtype, bwd=True)[1]


def _tma_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels can read the 4-d ``t`` by strides: unit stride
    along D and 16-byte aligned rows, counted in bytes (8 bf16 or 4 f32
    elements).  Those are also the rules of the kernels' TMA tensor maps (a
    16-byte aligned base, every stride a multiple of 16 bytes; a dimension
    of size 1 is never stepped, so the source gives it a stride of its
    own)."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * size % 16 == 0 or t.shape[i] == 1 for i in range(3)))


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when ``_tma_aligned``, else a contiguous copy: every
    view this admits is loaded by TMA as it is."""
    return t if _tma_aligned(t) else t.contiguous()


def _same_device_and_dtype(q, **others) -> None:
    for name, t in others.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q dtype {q.dtype}")


def _count(counter: str) -> None:
    with _LAUNCH_LOCK:
        globals()[counter] += 1


def _raise_launch_error(what: str, rc: int, lib: SimpleNamespace) -> None:
    raise RuntimeError(
        f"{what} kernel launch failed: CUDA error {rc} ({lib.error_string(rc).decode()})")


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, S, D = q.shape
    KV = k.shape[1]
    _same_device_and_dtype(q, k=k, v=v)
    why = kernel_shape_error(D, q.dtype, S)
    if why is not None:
        raise ValueError(why)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, lse
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    lib = _library()
    rc = launch_on(q.device, lib.launch, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), B, H, KV, S, D, int(bool(causal)), ctypes.addressof(strides))
    if rc != 0:
        _raise_launch_error("flash_attention", rc, lib)
    _count("LAUNCHES")
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, causal: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, H, S, D = q.shape
    KV = k.shape[1]
    _same_device_and_dtype(q, k=k, v=v, o=o, do=do)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"o/dO shapes {tuple(o.shape)} {tuple(do.shape)} != q {tuple(q.shape)}")
    if lse.device != q.device or lse.dtype != torch.float32 or lse.numel() != B * H * S:
        raise ValueError(f"lse must be [B*H, S, 1] float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    why = bwd_kernel_shape_error(D, q.dtype, S)
    if why is not None:
        raise ValueError(why)
    lse = lse.contiguous()
    if lse.data_ptr() % 16:  # the dK/dV kernel bulk-copies its rows
        lse = lse.clone()
    q, k, v, do, o = (_kernel_view(t) for t in (q, k, v, do, o))
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, S, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, KV, S, D), dtype=v.dtype, device=q.device)
    # rowsum(dO o): written by the dQ kernel, read by the dK/dV kernel
    dsum = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if B == 0:
        return dq, dk, dv
    strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *do.stride()[:3], *o.stride()[:3])
    lib = _bwd_library()
    shape = (B, H, KV, S, D, int(bool(causal)), ctypes.addressof(strides))
    qkvdo = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr())
    rc = launch_on(q.device, lib.dq, *qkvdo, o.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                   dq.data_ptr(), *shape)
    if rc != 0:
        _raise_launch_error("flash_attention dQ", rc, lib)
    _count("DQ_LAUNCHES")
    rc = launch_on(q.device, lib.dkv, *qkvdo, lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), *shape)
    if rc != 0:
        _raise_launch_error("flash_attention dK/dV", rc, lib)
    _count("DKV_LAUNCHES")
    return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o ``[B, H, S, D]``, lse ``[B*H, S, 1]`` f32), the pair ``_fwd_impl``
    returns.  A CUDA q launches the kernel or raises; a CPU q runs the
    plain version."""
    _validate(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes cpu or cuda tensors, got {q.device}")
    return _launch(q, k, v, causal)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``o = flash_attention(q, k, v)`` for the cotangent
    ``do``, from the forward's ``o`` and ``lse``: ``_flash_bwd``'s result.
    A CUDA q launches the dQ kernel (which also makes dsum) and then the
    dK/dV kernel, or raises; a CPU q runs the plain version."""
    _validate(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes cpu or cuda tensors, got {q.device}")
    return _launch_bwd(q, k, v, o, lse, do, causal)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward, as ``jax.custom_vjp`` wraps
    the TPU kernels: the forward saves (q, k, v, o, lse) and the backward
    is ``flash_attention_bwd`` (the kernels on CUDA, the plain backward on
    the CPU).  Not twice differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, KV, S, D] (KV divides H) -> [B, H, S, D],
    differentiable through ``FlashAttention``.  Constraints (ValueError
    otherwise): S divisible by 128, D <= 256, H a multiple of KV; on CUDA
    also what the kernels take."""
    return FlashAttention.apply(q, k, v, causal)


def probe_kernel(n_heads: int, n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device) -> None:
    """Build the library and launch the kernel once, on zeros, at the head
    shape (``n_heads``, ``n_kv_heads``, ``head_dim``) with S=128 on a CUDA
    ``device``; raise if either fails or the answer is not what zeros give
    (o = 0, causal lse of row i = log(i + 1)).  The counterpart of the JAX
    package's backend probe (``pallas_supported``), except that it raises
    where that one answers False."""
    q = torch.zeros(1, n_heads, _BLOCK, head_dim, dtype=dtype, device=device)
    kv = torch.zeros(1, n_kv_heads, _BLOCK, head_dim, dtype=dtype, device=device)
    o, lse = flash_attention_fwd(q, kv, kv, causal=True)
    want = torch.log(torch.arange(1, _BLOCK + 1, dtype=torch.float32))
    lse = lse.cpu().reshape(n_heads, _BLOCK)
    if bool(o.abs().max().cpu() != 0) or not torch.allclose(lse, want.expand_as(lse), atol=1e-5):
        raise RuntimeError(
            f"flash_attention probe at heads {n_heads}/{n_kv_heads}, head dim {head_dim} "
            f"answered o max {float(o.abs().max())}, lse {lse[0, :4].tolist()}...")


def probe_bwd_kernel(n_heads: int, n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                     device: torch.device) -> None:
    """Build the backward library and launch both kernels once at the head
    shape with S=128 on a CUDA ``device``, for the cotangent dO = 1 of
    attention over zeros (uniform causal p, o = 0): dQ and dK must be 0
    and dV must equal the plain backward's; raise otherwise."""
    q = torch.zeros(1, n_heads, _BLOCK, head_dim, dtype=dtype, device=device)
    kv = torch.zeros(1, n_kv_heads, _BLOCK, head_dim, dtype=dtype, device=device)
    lse = torch.log(torch.arange(1, _BLOCK + 1, dtype=torch.float32, device=device))
    lse = lse.repeat(n_heads).reshape(n_heads, _BLOCK, 1)
    do = torch.ones_like(q)
    dq, dk, dv = flash_attention_bwd(q, kv, kv, q, lse, do, causal=True)
    want = flash_attention_bwd_reference(q, kv, kv, q, lse, do, causal=True)[2].float()
    dv_err = float((dv.float() - want).abs().max())
    # both round the same f32 sums to bf16, summed in another order: an ulp
    ulp = 2.0 ** -7 * float(want.abs().max())
    if bool(dq.abs().max().cpu() != 0) or bool(dk.abs().max().cpu() != 0) or dv_err > ulp:
        raise RuntimeError(
            f"flash_attention backward probe at heads {n_heads}/{n_kv_heads}, head dim "
            f"{head_dim} answered dq max {float(dq.abs().max())}, dk max "
            f"{float(dk.abs().max())}, dv error {dv_err}")
