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
every batch size.  That bound (~0.16 us at B=1) is far below one launch, so
the design works on latency: the weights are split over the blocks of a
thread-block cluster (each block's whole slice in flight at entry), every
activation stays in shared memory and moves between the blocks through
distributed shared memory -- see the source.  ``mlp_plan`` picks the rows a
block takes (BM) and the cluster's size (C) from the batch, the widths and
the SM count, without a device sync; ``_layout_bytes`` is its statement of
the source's shared-memory layout, which the card tests hold to the source's
own (``fused_mlp_smem_bytes``).

``fused_mlp_softmax`` launches the kernel for a CUDA tensor and raises
``ValueError`` for shapes or dtypes the kernel does not take; it never
falls back to another path for a CUDA tensor.  A CPU tensor goes through
``fused_mlp_softmax_reference``, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against.  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show that its main path went
through the kernel.  Which widths the kernel takes is decided by its source
alone; ``kernel_shape_error`` asks it once per widths and dtypes, and
``probe_kernel`` builds and launches the kernel once, so a unit finds a
missing compiler or a failing build when it is constructed.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from seldon_core_tpu_torch.device import launch_on
from seldon_core_tpu_torch.ops._build import load_library

__all__ = [
    "LAUNCHES",
    "dispatch_cost",
    "fused_mlp_softmax",
    "fused_mlp_softmax_reference",
    "kernel_shape_error",
    "mlp_plan",
    "probe_kernel",
]

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

# the plans the kernel takes (fused_mlp.cu plan_layout)
_CLUSTERS = (1, 2, 4, 8, 16)     # blocks a cluster; 16 is a non-portable size
_ROW_TILES = (8, 16, 32, 64)     # batch rows a block: n8 tiles of the products
_PAD = 8                         # bf16 row padding of the activation buffers
_MAX_BOX = 256                   # TMA box dimensions: a rank's columns at most
_NWARPS = 8
_SMEM_LIMIT = 232448             # 227 KB opt-in per block on sm_90


def _layer_params(params: Dict[str, torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    n_layers = len(params) // 2
    return [(params[f"w{i}"], params[f"b{i}"]) for i in range(n_layers)]


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def _align128(v: int) -> int:
    return (v + 127) // 128 * 128


def layer_columns(dims: Sequence[int], C: int) -> List[int]:
    """cw_l, the output columns each rank of a C-block cluster owns in layer
    l, from column r * cw_l: round16(ceil(N_l / C)) for a hidden layer, and
    the whole last layer (round16(N_L)) on rank 0 alone."""
    cols = [_round16(-(-n // C)) for n in dims[1:-1]]
    return cols + [_round16(dims[-1])]


def _layout_bytes(dims: Sequence[int], C: int, BM: int) -> Optional[int]:
    """The dynamic shared memory the kernel takes at (C, BM), or None where
    it refuses the plan: ``plan_layout`` in fused_mlp.cu, step by step (the
    card tests hold the two to each other).  Assumes the widths rule holds
    (every layer's input a multiple of 16, 1 to 8 layers)."""
    L = len(dims) - 1
    cw = layer_columns(dims, C)
    if C not in _CLUSTERS or BM not in _ROW_TILES or max(cw) > _MAX_BOX:
        return None
    ld0 = max(dims[l] for l in range(0, L, 2)) + _PAD
    ld1 = max((dims[l] for l in range(1, L, 2)), default=-_PAD) + _PAD
    off = _align128(BM * ld0 * 2)
    off = _align128(off + BM * ld1 * 2)
    for l in range(L - 1):
        off = _align128(off + dims[l] * cw[l] * 2)
    off = _align128(off + dims[L - 1] * dims[L] * 2)
    for l in range(L):
        off = _align128(off + cw[l] * 4)          # a rank's biases, f32
    off = _align128(off + _NWARPS * 32 * 4 * 4)   # the classes' partial sums
    off = _align128(off + BM * dims[L] * 4)       # the logits
    off = _align128(off + L * 8)                  # one mbarrier a layer
    return off if off <= _SMEM_LIMIT else None


@functools.lru_cache(maxsize=4096)
def mlp_plan(B: int, dims: Tuple[int, ...], sm_count: int) -> Tuple[int, int]:
    """(BM, C): the batch rows a block takes and the blocks of the cluster
    that serves each tile of BM rows, for B rows at widths ``dims``.  A
    block's time grows with its rows and with its slice of the weights, and
    the exchange between a cluster's blocks costs little, so (from sweeps
    of every plan on an H100 SXM, PERF.md §6):
      * at most 4 tiles of 8 rows: 8 rows a block and the widest useful
        cluster (C_top: 16 columns a rank of the widest hidden layer, at
        most 16 blocks);
      * more: a cluster of min(8, C_top) (eight or more 16-block clusters
        ran slower than the same rows over 8-block ones), and the fewest
        rows a block that keep the grid within about 4 blocks an SM.
    A plan whose layout does not fit (``_layout_bytes``) gives way to the
    fitting one with the fewest blocks.  A one-layer MLP takes C = 1: rank
    0 computes the last layer alone.  Decided from the shapes alone, with
    no device sync; cached."""
    fits = [(BM, C) for BM in _ROW_TILES for C in _CLUSTERS
            if (C == 1 or len(dims) > 2) and _layout_bytes(dims, C, BM) is not None]
    if not fits:
        raise ValueError(f"no plan of the fused-MLP kernel fits widths {list(dims)}")
    widest = max((-(-n // 16) for n in dims[1:-1]), default=1)
    c_top = next(C for C in _CLUSTERS if C >= min(widest, _CLUSTERS[-1]))
    if -(-B // _ROW_TILES[0]) <= 4:
        want = (_ROW_TILES[0], c_top)
    else:
        C = min(8, c_top)
        BM = next((bm for bm in _ROW_TILES if -(-B // bm) * C <= 4 * sm_count), _ROW_TILES[-1])
        want = (BM, C)
    if want in fits:
        return want
    return min(fits, key=lambda p: (-(-B // p[0]) * p[1], -p[0]))


def kernel_shape_error(dims: Sequence[int], dtypes: Sequence[torch.dtype]) -> Optional[str]:
    """Why the kernel cannot take an MLP of layer widths ``dims`` (input
    first) whose weights and biases have ``dtypes``, or None when it can.
    Static: units call it at construction to pick their path.  The widths
    and the shared-memory layout are the kernel source's to judge, so past
    the dtype rule this builds and asks the library (nvcc needed), at the
    plan with the smallest layout (a cluster of 16, 8 rows a block), once
    per widths and dtypes."""
    return _shape_error(tuple(int(d) for d in dims), tuple(dtypes))


@functools.lru_cache(maxsize=None)
def _shape_error(dims: Tuple[int, ...], dtypes: Tuple[torch.dtype, ...]) -> Optional[str]:
    if any(dt != torch.bfloat16 for dt in dtypes):
        return f"weights and biases must be bfloat16, got {sorted({str(d) for d in dtypes})}"
    return _smem_bytes(dims, _CLUSTERS[-1], _ROW_TILES[0])[1]


def _smem_bytes(dims: Sequence[int], C: int, BM: int) -> Tuple[int, Optional[str]]:
    """(dynamic shared memory the kernel asks for at a cluster of C blocks
    and BM rows a block, None), or (-1, why not), from
    ``fused_mlp_smem_bytes`` in the .cu."""
    lib = _library()
    why = ctypes.create_string_buffer(256)
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    n = lib.smem_bytes(len(dims) - 1, ctypes.addressof(dims_arr), C, BM,
                       ctypes.addressof(why), len(why))
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


def dispatch_cost(params: Dict[str, torch.Tensor], rows: int,
                  x_itemsize: int = 4) -> Dict[str, float]:
    """The analytic cost of one ``fused_mlp_softmax`` call on ``rows`` rows,
    in the perf observatory's cost-feature keys (``utils/perf.py``):
    ``flops`` = 2·B·Σ d_in·d_out (the products; the bias, relu and softmax
    are lower order), ``bytes_accessed`` = every weight and bias once, x
    (``x_itemsize`` bytes an element) and the float32 probabilities, and
    ``output_bytes`` = the probabilities."""
    layers = _layer_params(params)
    B = int(rows)
    flops = sum(2.0 * B * w.shape[0] * w.shape[1] for w, _ in layers)
    weights = sum(w.numel() * w.element_size() + b.numel() * b.element_size()
                  for w, b in layers)
    out_bytes = 4.0 * B * layers[-1][0].shape[1]
    x_bytes = float(B * layers[0][0].shape[0] * int(x_itemsize))
    return {"flops": flops, "bytes_accessed": float(weights) + x_bytes + out_bytes,
            "output_bytes": out_bytes}


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
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
            launch.restype = ctypes.c_int
            empty = lib.fused_mlp_empty_launch
            empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
            empty.restype = ctypes.c_int
            smem = lib.fused_mlp_smem_bytes
            smem.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int]
            smem.restype = ctypes.c_int
            err = lib.fused_mlp_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = SimpleNamespace(launch=launch, empty=empty, smem_bytes=smem,
                                   error_string=err)
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({_library().error_string(code).decode()})")


def fused_mlp_softmax(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """softmax(mlp(x)).  params: flat dict {w0, b0, ..., wL, bL}
    (models/mnist.py mlp_init layout, W as [in, out]); x: [B, in_dim].
    Returns [B, out_dim] float32 probabilities.  A CUDA ``x`` launches the
    kernel at ``mlp_plan``'s (BM, C) or raises; a CPU ``x`` runs the plain
    version."""
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
    dims = (in_dim,) + tuple(w.shape[1] for w, _ in layers)
    why = _shape_error(dims, tuple(t.dtype for wb in layers for t in wb))
    if why is not None:
        raise ValueError(why)
    index = torch.cuda.current_device() if x.device.index is None else x.device.index
    return _launch(layers, dims, x, mlp_plan(x.shape[0], dims, _sm_count(index)))


def _launch(layers, dims, x: torch.Tensor, plan: Tuple[int, int],
            shape_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel at ``plan`` = (BM, C) on a CUDA ``x``; ``shape_out`` (int32
    [3] on the device, or None) receives {blocks a cluster, blocks, BM} as
    the launched kernel sees them."""
    global LAUNCHES
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
        if not (w.is_contiguous() and b.is_contiguous()) or w.data_ptr() % 16:
            raise ValueError(f"layer {i} weights must be contiguous and 16-byte aligned "
                             f"(the kernel copies them by TMA)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)  # 16-byte loads of x
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    lib = _library()
    n = len(layers)
    BM, C = plan
    dims_arr = (ctypes.c_int * (n + 1))(*dims)
    w_arr = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in layers])
    b_arr = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
    rc = launch_on(x.device, lib.launch, x.data_ptr(), out.data_ptr(), x.shape[0], n,
                   ctypes.addressof(dims_arr), ctypes.addressof(w_arr),
                   ctypes.addressof(b_arr), C, BM,
                   None if shape_out is None else shape_out.data_ptr())
    _check(rc, f"fused_mlp_softmax kernel launch at (BM, C) = {plan}")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out


def _empty_launch(dims: Sequence[int], B: int, plan: Tuple[int, int],
                  device: torch.device) -> None:
    """An empty kernel at the grid, cluster and shared memory of the
    kernel's launch for B rows at ``plan``: the launch's own cost, which
    ``chip_smoke.py`` times beside the kernel.  Not counted in LAUNCHES."""
    BM, C = plan
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    rc = launch_on(device, _library().empty, B, len(dims) - 1, ctypes.addressof(dims_arr),
                   C, BM)
    _check(rc, f"the empty launch at (BM, C) = {plan}")
