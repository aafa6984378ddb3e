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

Training (``mnist.py:75-92``): ``loss_fn`` is the mean cross-entropy of
``mlp_apply``'s logits, and ``train_step`` one optimizer step on it
(``optim.grad_update``); on params placed over a ``dp`` mesh
(``parallel/mesh.py`` ``place_tree``) the rows split over ``dp`` and the
gradients are summed over the copies.

"auto" on CUDA with shapes or dtypes the kernel cannot take serves through
``mlp_apply`` and says so once in the log, as the JAX unit falls back to
its XLA path.  When the kernel is taken, the constructor builds and
launches it once (``probe_kernel``) and raises if that fails.

``MnistCNN`` (``mnist.py:172`` there) is the small convnet: two 3x3 conv
+ ReLU + 2x2 max-pool layers and a dense softmax, bf16 by default.  Its
public functions keep the JAX package's layouts, NHWC input and HWIO conv
weights (``cnn_init``, ``cnn_apply``; the state carries across from the
JAX unit as it is); inside, ``F.conv2d`` runs in NCHW/OIHW.  The JAX
package computes the convolutions in XLA, outside any Pallas kernel, so
they stay library calls here (cuDNN on the card).  A float32 CNN on the
card convolves in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.device import DeviceLike, parse_dtype, resolve_device
from seldon_core_tpu_torch.graph.units import Unit, register_unit
from seldon_core_tpu_torch.ops.quant import QuantizedMLP, quantize_mlp_params
from seldon_core_tpu_torch.models.transformer import seeded_generator
from seldon_core_tpu_torch.optim import grad_update
from seldon_core_tpu_torch.parallel.mesh import ShardedTree, lead_shards, sum_onto
from seldon_core_tpu_torch.ops.fused_mlp import (
    dispatch_cost,
    fused_mlp_softmax,
    fused_mlp_softmax_reference,
    kernel_shape_error,
    probe_kernel,
)

__all__ = ["MnistClassifier", "MnistCNN", "mlp_init", "mlp_apply", "loss_fn", "train_step",
           "cnn_init", "cnn_apply"]

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


def loss_fn(params, batch) -> torch.Tensor:
    """Mean cross-entropy of ``mlp_apply``'s logits at ``batch["label"]``
    for ``batch["image"]`` (``mnist.py:75-80``), f32.  ``params`` a
    ``ShardedTree`` (``parallel/mesh.py`` ``place_tree``: every leaf
    replicated) runs over its mesh: the rows split over ``dp``, each
    ``dp`` group's nll summed on its shard, the sum of those over the
    batch's rows on the mesh's first device."""
    x, y = batch["image"], batch["label"]
    if not isinstance(params, ShardedTree):
        logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
        return -torch.mean(torch.gather(logp, 1, y[:, None].long()))
    mesh = params.mesh
    dp = mesh.shape.get("dp", 1)
    if x.shape[0] % dp:
        raise ValueError(f"batch of {x.shape[0]} rows not divisible over 'dp' of size {dp}")
    rows = x.shape[0] // dp
    leads = lead_shards(mesh, ("dp",))

    def body(shard):
        if shard.index not in leads:
            return None
        d = shard.coords.get("dp", 0)
        xs, ys = (t[d * rows:(d + 1) * rows].to(shard.device) for t in (x, y))
        logp = torch.log_softmax(mlp_apply(params.shards[shard.index], xs), dim=-1)
        return -torch.gather(logp, 1, ys[:, None].long()).sum()

    outs = mesh.run(body)
    return sum_onto([outs[i] for i in leads], mesh.device_list[0]) / x.shape[0]


def train_step(params, opt_state, batch, optimizer):
    """One optimizer step on ``loss_fn`` (``mnist.py:83-92``): returns
    (params, opt_state, loss).  Over a ``dp`` mesh (``params`` and
    ``opt_state`` ``ShardedTree``s) each shard's rows take the forward and
    the gradients are summed over ``dp`` (``optim.grad_update``), so every
    copy of the weights takes the same update."""
    return grad_update(loss_fn, params, opt_state, batch, optimizer)


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
        # the construction seed folded into the graph's generator: two
        # ensemble members with different seeds differ under one graph seed
        return mlp_init(seeded_generator(rng, self.seed), hidden=self.hidden, depth=self.depth,
                        dtype=self.dtype, device=self.device)

    def dispatch_cost(self, state, rows: int):
        """The fused MLP's count (``ops/fused_mlp.py:dispatch_cost``): the
        same arithmetic on every path, float32 rows in."""
        return dispatch_cost(state, rows) if state is not None else None

    def predict(self, state, X):
        X = X.reshape(X.shape[0], -1)
        if X.shape[1] != INPUT_DIM:
            raise ValueError(f"x dim {X.shape[1]} != w0 in_dim {INPUT_DIM}")
        if self.path == "kernel":
            return fused_mlp_softmax(state, X)
        if self.path == "reference":
            return fused_mlp_softmax_reference(state, X)
        return torch.softmax(mlp_apply(state, X), dim=-1)


@register_unit("QuantizedMnistClassifier")
class QuantizedMnistClassifier(MnistClassifier):
    """Int8 serving variant (``mnist.py:152-168`` there): the MLP's weights
    quantize once at init (``quantize_mlp_params``, symmetric per output
    channel) and serve weight-only through ``QuantizedMLP``, every layer a
    ``dequant_matmul``.  No kernel, as in the reference, whose int8 path is
    XLA's: ``use_pallas`` is checked and has no other effect."""

    def __init__(self, hidden: int = 512, depth: int = 2, seed: int = 0,
                 dtype: str = "bfloat16", use_pallas: str = "auto", device: DeviceLike = None):
        if str(use_pallas) not in ("auto", "interpret", "never"):
            raise ValueError(f"use_pallas {use_pallas!r} not auto/interpret/never")
        super().__init__(hidden, depth, seed, dtype, "never", device)
        self.path = "int8"

    def init_state(self, rng: Optional[torch.Generator]):
        return quantize_mlp_params(super().init_state(rng))

    def dispatch_cost(self, state, rows: int):
        """No count: the int8 path is not the fused MLP's arithmetic."""
        return None

    def predict(self, state, X):
        return QuantizedMLP.apply(state, X.reshape(X.shape[0], -1))


def cnn_init(rng: torch.Generator, channels: int = 32, dtype: torch.dtype = torch.bfloat16,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """He-initialised convnet parameters {c1, c2 (HWIO), w [7*7*2c, 10], b},
    drawn on the CPU from ``rng`` and moved to ``device`` (default cuda)."""
    device = resolve_device(device)
    c = int(channels)

    def normal(shape, fan_in):
        w = torch.randn(*shape, generator=rng, dtype=torch.float32) * math.sqrt(2.0 / fan_in)
        return w.to(dtype).to(device)

    return {"c1": normal((3, 3, 1, c), 9), "c2": normal((3, 3, c, 2 * c), 9 * c),
            "w": normal((7 * 7 * 2 * c, NUM_CLASSES), 7 * 7 * 2 * c),
            "b": torch.zeros(NUM_CLASSES, dtype=dtype, device=device)}


def cnn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Class probabilities [B, 10] f32 for x [B, 784] or NHWC [B, 28, 28, 1]:
    each conv 3x3 'SAME' then ReLU then a 2x2 max-pool, in the params'
    dtype; the flattened NHWC features times w, plus b, in f32."""
    h = x.reshape(-1, 28, 28, 1).to(params["c1"].dtype).permute(0, 3, 1, 2)  # NCHW
    for name in ("c1", "c2"):
        h = F.conv2d(h, params[name].permute(3, 2, 0, 1), padding=1)  # HWIO -> OIHW
        h = F.max_pool2d(torch.relu(h), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC order, as the reference flattens
    logits = (h @ params["w"]).float() + params["b"].float()
    return torch.softmax(logits, dim=-1)


@register_unit("MnistCNN")
class MnistCNN(Unit):
    """Small convnet (2x conv+pool, 1 dense); accepts [B, 784] or [B, 28,
    28, 1] input."""

    class_names = [f"class:{i}" for i in range(NUM_CLASSES)]

    def __init__(self, channels: int = 32, seed: int = 0, dtype: str = "bfloat16",
                 device: DeviceLike = None):
        self.channels = int(channels)
        self.seed = int(seed)
        self.dtype = parse_dtype(dtype)
        self.device = resolve_device(device)

    def init_state(self, rng: Optional[torch.Generator]):
        return cnn_init(seeded_generator(rng, self.seed), self.channels, self.dtype, self.device)

    def predict(self, state, X):
        return cnn_apply(state, X)
