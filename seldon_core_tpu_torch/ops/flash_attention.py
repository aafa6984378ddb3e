"""Flash-attention forward — the prefill attention of the LM units on Hopper.

    o = softmax(q k^T / sqrt(D)) v,   lse = logsumexp(q k^T / sqrt(D))

q ``[B, H, S, D]``, k/v ``[B, KV, S, D]`` with H a multiple of KV (grouped-
query attention is native: K/V are never repeated), o ``[B, H, S, D]`` in
q's dtype and the per-row log-sum-exp ``lse`` ``[B*H, S, 1]`` float32, the
layout of the JAX package.

Replaces the Pallas TPU kernel ``seldon_core_tpu/ops/flash_attention.py``
(``_fwd_impl`` :136, kernel body ``_flash_kernel`` :56, ``pallas_call``
:177) with the hand-written CUDA kernel ``ops/csrc/flash_attention.cu`` for
sm_90a, which computes the same arithmetic in the same order: f32 scores,
causal masking by global position with -1e30, an online softmax whose
``p`` is cast to V's dtype before the PV product, ``acc / max(l, 1e-30)``.
Only the forward is ported; the backward kernels come with training.

Bound on an H100 SXM: at the served prefill (B=32, H=16, KV=4, S=512,
D=64, bf16) the call moves ~85 MB, ~25 us at 3.35 TB/s, against 17.2
GFLOP, ~17 us at 989 TFLOP/s, so it is bound by the bytes.  The kernel
keeps the [S, S] scores out of device memory and streams each kv head's
K/V once per query tile; see the source for the layout.

``flash_attention`` / ``flash_attention_fwd`` first hold the inputs to the
JAX package's shape contract (``_validate``, the same messages).  A CUDA
tensor then launches the kernel or raises: what the kernel cannot take
(a dtype other than bf16, a head dim that is not a multiple of 16) is a
``ValueError`` from a static check before any launch, and those kernel-
only limits are the source's to state (``flash_attention_smem_bytes``,
asked through ``kernel_shape_error``).  The kernel takes q/k/v by strides
(unit stride along D), so the strided head views of the LM blocks need no
copy; a tensor whose rows are not 16-byte aligned is made contiguous
first.  A CPU tensor runs ``flash_attention_reference``, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against;
nothing on the CUDA path calls it.  ``LAUNCHES`` counts kernel launches
and nothing else.  ``probe_kernel`` builds the library and launches once,
so a unit finds a missing compiler or a failing build when it is built.
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from seldon_core_tpu_torch.ops._build import load_library

__all__ = [
    "LAUNCHES",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_reference",
    "shape_contract_error",
    "kernel_shape_error",
    "probe_kernel",
]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
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


def _smem_bytes(head_dim: int, seq_len: int, dtype: torch.dtype) -> Tuple[int, Optional[str]]:
    """(dynamic shared memory the kernel asks for, None), or (-1, why not),
    from ``flash_attention_smem_bytes`` in the .cu."""
    why = ctypes.create_string_buffer(256)
    dtype_code = 0 if dtype == torch.bfloat16 else -1  # the .cu's codes: 0 = bfloat16
    n = _library().smem_bytes(int(head_dim), int(seq_len), dtype_code,
                              ctypes.addressof(why), len(why))
    return n, (why.value.decode() if n < 0 else None)


def kernel_shape_error(head_dim: int, dtype: torch.dtype, seq_len: int = _BLOCK) -> Optional[str]:
    """Why the kernel cannot take this head dim, dtype and sequence length
    (any length the JAX contract admits, by default), or None.  Asks the
    kernel source (nvcc needed); units call it at construction."""
    return _smem_bytes(head_dim, seq_len, dtype)[1]


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it by strides (unit stride
    along D, 16-byte aligned rows), else a contiguous copy."""
    aligned = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(t.stride(i) % 8 == 0 or t.shape[i] == 1 for i in range(3)))
    return t if aligned else t.contiguous()


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, H, S, D = q.shape
    KV = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q dtype {q.dtype}")
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), B, H, KV, S, D, int(bool(causal)),
                        ctypes.addressof(strides), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {rc} "
            f"({lib.error_string(rc).decode()})"
        )
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return o, lse


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, KV, S, D] (KV divides H) -> [B, H, S, D].
    Constraints (ValueError otherwise): S divisible by 128, D <= 256, H a
    multiple of KV; on CUDA also what the kernel takes."""
    return flash_attention_fwd(q, k, v, causal)[0]


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
