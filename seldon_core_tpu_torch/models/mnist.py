"""MNIST classifier — the flagship serving workload, ported from
``seldon_core_tpu/models/mnist.py:41-149``.

``MnistClassifier`` is an MLP (784 -> hidden^depth -> 10) with bf16
weights and f32 class probabilities out, registered under the same name
and with the same parameters (``hidden``, ``depth``, ``seed``, ``dtype``,
``use_pallas``) as the JAX unit, so ``examples/mnist_deployment.json``
resolves unchanged.  Its path is chosen once, at construction, from the
static shapes and the device, as the JAX unit chooses:

  ``use_pallas``  on CUDA                          on CPU
  "auto"          the Hopper kernel (ops/fused_mlp)  the kernel's plain version
  "interpret"     the kernel's plain version         the kernel's plain version
  "never"         ``mlp_apply`` (torch.matmul)       ``mlp_apply``

"auto" on CUDA with shapes or dtypes the kernel cannot take serves through
``mlp_apply`` and says so once in the log, as the JAX unit falls back to
its XLA path.  When the kernel is taken, the constructor builds and
launches it once (``probe_kernel``) and raises if that fails.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import torch

from seldon_core_tpu_torch.device import DeviceLike, parse_dtype, resolve_device
from seldon_core_tpu_torch.graph.units import Unit, register_unit
from seldon_core_tpu_torch.ops.fused_mlp import (
    fused_mlp_softmax,
    fused_mlp_softmax_reference,
    kernel_shape_error,
    probe_kernel,
)

__all__ = ["MnistClassifier", "mlp_init", "mlp_apply"]

logger = logging.getLogger(__name__)

NUM_CLASSES = 10
INPUT_DIM = 784


def mlp_init(
    rng: torch.Generator,
    hidden: int = 512,
    depth: int = 2,
    in_dim: int = INPUT_DIM,
    out_dim: int = NUM_CLASSES,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """He-initialised MLP parameters as a flat dict {w0, b0, ...}; W is
    [in, out] as in the JAX package.  Drawn on the CPU from ``rng`` (a CPU
    ``torch.Generator``), then moved to ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    dims = [in_dim] + [hidden] * depth + [out_dim]
    params: Dict[str, torch.Tensor] = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(d_in, d_out, generator=rng, dtype=torch.float32)
        params[f"w{i}"] = (w * math.sqrt(2.0 / d_in)).to(dtype).to(device)
        params[f"b{i}"] = torch.zeros(d_out, dtype=dtype, device=device)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Logits, computed in the params' dtype (bf16 matmuls) with the final
    logits in f32 — the JAX package's XLA path, op for op."""
    n_layers = len(params) // 2
    h = x.to(params["w0"].dtype)
    for i in range(n_layers - 1):
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
    last = n_layers - 1
    return (h @ params[f"w{last}"]).float() + params[f"b{last}"].float()


@register_unit("MnistClassifier")
class MnistClassifier(Unit):
    """MLP MNIST unit; predict returns class probabilities."""

    class_names = [f"class:{i}" for i in range(NUM_CLASSES)]

    def __init__(
        self,
        hidden: int = 512,
        depth: int = 2,
        seed: int = 0,
        dtype: str = "bfloat16",
        use_pallas: str = "auto",
        device: DeviceLike = None,
    ):
        self.hidden = int(hidden)
        self.depth = int(depth)
        self.seed = int(seed)
        self.dtype = parse_dtype(dtype)
        self.use_pallas = str(use_pallas)
        if self.use_pallas not in ("auto", "interpret", "never"):
            raise ValueError(f"use_pallas {use_pallas!r} not auto/interpret/never")
        self.device = resolve_device(device)
        self.dims = [INPUT_DIM] + [self.hidden] * self.depth + [NUM_CLASSES]
        # the path is decided HERE, from static shapes, never per request
        if self.use_pallas == "never":
            self.path = "mlp_apply"
        elif self.use_pallas == "interpret":
            self.path = "reference"
        elif self.device.type == "cuda":
            why = kernel_shape_error(self.dims, [self.dtype] * (2 * len(self.dims) - 2))
            if why is None:
                # build and launch the kernel once now, as the JAX unit
                # probes its backend at construction: a missing nvcc or a
                # failing build raises here, before an engine reports ready
                probe_kernel(self.dims, self.device)
                self.path = "kernel"
            else:
                logger.info("MnistClassifier: fused-MLP kernel not used (%s); "
                            "serving through mlp_apply", why)
                self.path = "mlp_apply"
        else:
            # the wrapper runs the kernel's plain version for CPU tensors
            self.path = "kernel"

    def init_state(self, rng: Optional[torch.Generator]):
        # fold the construction seed into the graph's generator so two
        # ensemble members with different seeds differ under one graph seed
        base = 0 if rng is None else rng.initial_seed()
        g = torch.Generator(device="cpu")
        g.manual_seed((base * 1_000_003 + self.seed) % (1 << 63))
        return mlp_init(g, hidden=self.hidden, depth=self.depth,
                        dtype=self.dtype, device=self.device)

    def predict(self, state, X):
        X = X.reshape(X.shape[0], -1)
        if X.shape[1] != INPUT_DIM:
            raise ValueError(f"x dim {X.shape[1]} != w0 in_dim {INPUT_DIM}")
        if self.path == "kernel":
            return fused_mlp_softmax(state, X)
        if self.path == "reference":
            return fused_mlp_softmax_reference(state, X)
        return torch.softmax(mlp_apply(state, X), dim=-1)
