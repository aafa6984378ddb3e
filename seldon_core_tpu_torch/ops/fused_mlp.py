"""Fused MLP-forward + softmax — the serving flagship's hot op on Hopper.

    probs = softmax(relu(x @ w0 + b0) ... @ wL + bL)

Replaces the Pallas TPU kernel ``seldon_core_tpu/ops/fused_mlp.py``
(``fused_mlp_softmax`` :64, kernel body ``_mlp_kernel`` :44) with the
hand-written CUDA kernel ``ops/csrc/fused_mlp.cu`` for sm_90a.  Same
arithmetic, same order: each layer's input is cast to the weight dtype
(bf16), the product accumulates in f32, the bias is added and relu applied
in f32, and the final logits get an f32 max-shifted softmax.

Bound on an H100 SXM: at the served widths (784 -> 256 -> 256 -> 10) the
call is bound by the bytes it must move (x, ~0.5 MB of bf16 weights, the
probabilities) at 3.35 TB/s; its FLOPs at 989 TFLOP/s stay below that at
every batch size.  The design keeps every activation in shared memory (one
block owns 32 batch rows through the whole chain) and streams the weights,
which all blocks share through L2 — see the source for the layout.

``fused_mlp_softmax`` launches the kernel for a CUDA tensor and raises
``ValueError`` for shapes or dtypes the kernel does not take; it never
falls back to another path for a CUDA tensor.  A CPU tensor goes through
``fused_mlp_softmax_reference``, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against.  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show that its main path went
through the kernel.  Which widths the kernel takes is decided by its source
alone (``fused_mlp_smem_bytes``); ``kernel_shape_error`` asks it, and
``probe_kernel`` builds and launches the kernel once, so a unit finds a
missing compiler or a failing build when it is constructed.
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library

__all__ = [
    "LAUNCHES",
    "fused_mlp_softmax",
    "fused_mlp_softmax_reference",
    "kernel_shape_error",
    "probe_kernel",
]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _layer_params(params: Dict[str, torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    n_layers = len(params) // 2
    return [(params[f"w{i}"], params[f"b{i}"]) for i in range(n_layers)]


def kernel_shape_error(dims: Sequence[int], dtypes: Sequence[torch.dtype]) -> Optional[str]:
    """Why the kernel cannot take an MLP of layer widths ``dims`` (input
    first) whose weights and biases have ``dtypes``, or None when it can.
    Static: units call it at construction to pick their path.  The widths
    and the shared-memory layout are the kernel source's to judge, so past
    the dtype rule this builds and asks the library (nvcc needed)."""
    if any(dt != torch.bfloat16 for dt in dtypes):
        return f"weights and biases must be bfloat16, got {sorted({str(d) for d in dtypes})}"
    return _smem_bytes(dims)[1]


def _smem_bytes(dims: Sequence[int]) -> Tuple[int, Optional[str]]:
    """(dynamic shared memory the kernel asks for, None), or (-1, why not),
    from ``fused_mlp_smem_bytes`` in the .cu."""
    lib = _library()
    why = ctypes.create_string_buffer(256)
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    n = lib.smem_bytes(len(dims) - 1, ctypes.addressof(dims_arr), ctypes.addressof(why),
                       len(why))
    return n, (why.value.decode() if n < 0 else None)


def fused_mlp_softmax_reference(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the kernel's arithmetic on any device.
    ``h.to(w.dtype).float() @ w.float()`` and not a bf16 matmul, whose
    output PyTorch rounds to bf16 where the kernel keeps f32."""
    layers = _layer_params(params)
    h = x.float()
    for i, (w, b) in enumerate(layers):
        h = h.to(w.dtype).float() @ w.float() + b.float()
        if i < len(layers) - 1:
            h = torch.relu(h)
    return torch.softmax(h, dim=-1)


_bind_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None


def _library() -> SimpleNamespace:
    """The kernel library's entry points, built and bound at first use."""
    global _lib
    with _bind_lock:
        if _lib is None:
            lib = load_library("fused_mlp")
            launch = lib.fused_mlp_softmax_launch
            launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
            launch.restype = ctypes.c_int
            smem = lib.fused_mlp_smem_bytes
            smem.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            smem.restype = ctypes.c_int
            err = lib.fused_mlp_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, smem_bytes=smem, error_string=err)
        return _lib


def probe_kernel(dims: Sequence[int], device: torch.device) -> None:
    """Build the library and launch the kernel once, on zeros, at widths
    ``dims`` on a CUDA ``device``; raise if either fails or the answer is
    not the uniform distribution that zero weights give.  The counterpart
    of the JAX package's backend probe (``pallas_supported``), except that
    it raises where that one answers False."""
    params = {}
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.zeros(k, n, dtype=torch.bfloat16, device=device)
        params[f"b{i}"] = torch.zeros(n, dtype=torch.bfloat16, device=device)
    y = fused_mlp_softmax(params, torch.zeros(1, dims[0], device=device)).cpu()
    if not torch.allclose(y, torch.full_like(y, 1.0 / dims[-1])):
        raise RuntimeError(f"fused_mlp_softmax probe at widths {list(dims)} answered {y}")


def fused_mlp_softmax(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """softmax(mlp(x)).  params: flat dict {w0, b0, ..., wL, bL}
    (models/mnist.py mlp_init layout, W as [in, out]); x: [B, in_dim].
    Returns [B, out_dim] float32 probabilities.  A CUDA ``x`` launches the
    kernel or raises; a CPU ``x`` runs the plain version."""
    global LAUNCHES
    layers = _layer_params(params)
    if not layers:
        raise ValueError("empty params")
    if x.ndim != 2:
        raise ValueError(f"x must be [B, D], got {tuple(x.shape)}")
    in_dim = layers[0][0].shape[0]
    if x.shape[1] != in_dim:
        raise ValueError(f"x dim {x.shape[1]} != w0 in_dim {in_dim}")
    if x.device.type == "cpu":
        return fused_mlp_softmax_reference(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_softmax takes cpu or cuda tensors, got {x.device}")
    dims = [in_dim] + [w.shape[1] for w, _ in layers]
    why = kernel_shape_error(dims, [t.dtype for wb in layers for t in wb])
    if why is not None:
        raise ValueError(why)
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32 for the kernel, got {x.dtype}")
    for i, (w, b) in enumerate(layers):
        if w.device != x.device or b.device != x.device:
            raise ValueError(f"layer {i} weights are on {w.device}/{b.device}, x on {x.device}")
        if w.ndim != 2 or w.shape[0] != dims[i] or tuple(b.shape) != (dims[i + 1],):
            raise ValueError(
                f"layer {i}: w {tuple(w.shape)} / b {tuple(b.shape)} do not chain "
                f"from width {dims[i]}"
            )
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"layer {i} weights must be contiguous")
    x = x.contiguous()
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    lib = _library()
    n = len(layers)
    dims_arr = (ctypes.c_int * (n + 1))(*dims)
    w_arr = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in layers])
    b_arr = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
    rc = launch_on(x.device, lib.launch, x.data_ptr(), out.data_ptr(), x.shape[0], n,
                   ctypes.addressof(dims_arr), ctypes.addressof(w_arr),
                   ctypes.addressof(b_arr))
    if rc != 0:
        raise RuntimeError(
            f"fused_mlp_softmax kernel launch failed: CUDA error {rc} "
            f"({lib.error_string(rc).decode()})"
        )
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out
