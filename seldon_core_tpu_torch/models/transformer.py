"""Decoder-only transformer LM — the port's counterpart of
``seldon_core_tpu/models/transformer.py``, single device, dense or MoE FFN.

Public functions keep the JAX layout: heads ``[B, H, S, hd]``, weights
``W`` as ``[in, out]``, params as nested dicts ``{"embed", "l0": {"ln1",
"wqkv", "wo", "ln2", "w1", "w2"}, ..., "ln_f"}``, so
``convert.params_from_jax`` carries a JAX unit's state across unchanged.
The arithmetic mirrors the JAX code op for op: where JAX asks for an f32
product of bf16 inputs (``preferred_element_type``, in ``gqa_attention``),
the port upcasts both inputs and multiplies in f32, since a bf16
``torch.matmul`` would round its output to bf16 (it costs an f32 copy of
q/k/v and f32 tensor-core-free products on the plain path); where JAX
rounds (``h @ w`` in bf16, the unembed before ``.astype(f32)``), the port
rounds too.

Attention (``_attention``): ``use_flash`` sends prefill and ``lm_apply``
attention to the flash-attention forward (``ops/flash_attention.py``: the
Hopper kernel for CUDA tensors, its plain version for CPU tensors) when
the JAX shape contract holds (S % 128 == 0, head dim <= 256, H a multiple
of KV), and otherwise to the plain attention (``gqa_attention`` for
grouped K/V, the einsum path for full heads), as the JAX package falls
back.  ``resolve_flash`` decides ``use_flash`` once, at construction:

  ``attention``  on CUDA                                      on CPU
  "auto"         the kernel, probed now; plain attention       the plain
                 (logged) when the kernel refuses the dtype    flash version
                 or head dim
  "flash"        the kernel, probed now; ValueError when the   the plain
                 kernel refuses the dtype or head dim          flash version
  "xla"          plain attention                               plain attention

A generator asks with ``decode=True``: then the decode lane's kernel
(``ops/flash_decode.py``, whose launch also writes the step's K/V) is
asked and probed as well, and a refusal sends prefill and decode to the
plain path ("auto", logged) or raises ("flash").  The decode kernel takes every
config the forward takes (bf16, head dim a multiple of 16 up to 256), so
in practice the forward decides.  With ``kv_quant="int8"`` the question is
the cache's: the int8-K/V variants of both decode kernels (two-tier and
paged, dtype code 2) are asked, and the two-tier one probed, so an int8
cache never reaches a bf16 kernel.

The JAX package's length gates (``FLASH_AUTO_MIN_S`` = 4096 and
``FLASH_AUTO_MIN_S_GQA`` = 512, ``transformer.py:544-545``) were set from
TPU measurements and are not inherited: "auto" takes the kernel at every
length the contract admits.  ``chip_smoke.py`` times the kernel against
PyTorch's fused attention on the H100; a later change may set a gate from
those numbers.

Training: ``lm_loss`` (next-token cross-entropy) and ``lm_train_step``
(one functional step: loss, ``torch.autograd.grad`` over the leaves, an
optimizer update such as ``optim.adam``), as ``transformer.py:412-462``.
On CUDA the attention's gradient comes from the two backward kernels
through ``ops.flash_attention.FlashAttention``; ``resolve_train_flash``
decides ``use_flash=None`` (the kernels where both the forward and the
backward take the dtype and head dim, probed once; the plain attention on
the CPU, as JAX's ``pallas_supported()`` answers there).  The kernels are
bf16 only, so f32 training on CUDA takes the plain attention (logged).
``save_lm_weights`` / ``load_lm_weights`` and the units' ``weights_path``
carry trained weights to serving in the JAX package's ``.npz`` format.

Int8 weights (``quant="int8"``): the units quantize after loading their
weights (``ops/quant.py`` ``quantize_lm_params``) and every layer matmul
takes ``lm_matmul``'s W8A16 path; ``lm_train_step`` refuses them, as the
reference does.

MoE layers (``moe_every > 0``): every ``moe_every``-th block (1-indexed)
swaps its dense FFN for ``parallel/moe.py``'s mixture of ``n_experts``
experts, top-``moe_k`` routed, whose subtree ``l{i}/moe/{wg, w1, w2}``
keeps the router ``wg`` in f32 in a bf16 model (int8 weights leave it
unquantized, as the reference).  ``_block`` returns the layer's
load-balance loss beside its output, ``lm_apply(return_lb=True)`` their
sum, and ``lm_loss`` adds ``LB_LOSS_COEF`` times it.  Capacity is set over
the whole flattened batch, so an MoE unit is ``batch_coupled``: co-batched
rows change each other's overflow.

Meshes ([6a]): ``param_shardings`` is the reference's tp layout and
``shard_params`` places a tree by it over a ``parallel/mesh.py`` mesh (a
``ShardedTree``).  ``lm_apply`` on such params runs every shard on its
own device with its ``LMConfig.tp_local`` config: the fused projection's
columns regrouped to the shard's heads (``split_qkv``; each shard holds
the kv heads its query heads read, ``kv_head_range``, a kv head whose
readers lie on two shards held by both), attention over those heads
through the same kernels as one device (one launch a run of one group
size where a shard's heads read their kv heads in unequal groups,
``per_run``), one ``all_reduce``
over ``tp`` after ``wo`` and one after ``w2`` (``attn_out``, ``_ffn``), and
MoE experts over ``ep`` (``moe_apply``), and the sequence over ``sp``: each
shard holds a block of positions, rotates them at their global positions
and attends through the ring (``parallel/ring_attention.py``, the flash
kernels on every block when ``use_flash``).  The collectives read the
calling shard from its thread, so ``_block``, ``_ffn`` and the generator's
blocks take no mesh argument: outside a shard they are the single-device
code.  ``lm_loss`` and ``lm_train_step`` train over such params (``dp x tp
x sp``): the forward over the mesh, the backward once over the run's one
autograd graph, replicated leaves' gradients summed over their copies
(``optim.grad_update``).  ``lm_pipeline_params`` / ``_apply`` / ``_loss``
/ ``_train_step`` run the layer stack as a GPipe pipeline over ``pp``
(``parallel/pipeline.py``), composable with ``dp``, each stage through
the same kernels as one device.  Over a mesh that spans processes
(``parallel/multihost.py``, one process a card) ``lm_apply``, ``lm_loss``,
``lm_train_step``, MoE experts over ``ep`` and the ``lm_pipeline_*``
functions over ``pp`` run each process's shards and gather the answer or
the loss onto every process (``DeviceMesh.collect``).
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.device import DeviceLike, parse_dtype, resolve_device
from seldon_core_tpu_torch.graph.units import Unit, register_unit
from seldon_core_tpu_torch.ops.flash_attention import (
    bwd_kernel_shape_error,
    flash_attention,
    kernel_shape_error,
    probe_bwd_kernel,
    probe_kernel,
    shape_contract_error,
)
from seldon_core_tpu_torch.ops.flash_decode import (decode_kernel_shape_error,
                                                    paged_kernel_shape_error, probe_decode_kernel)
from seldon_core_tpu_torch.ops.quant import lm_matmul, quantize_lm_params
from seldon_core_tpu_torch.optim import grad_update
from seldon_core_tpu_torch.parallel.mesh import (DeviceMesh, ShardedTree, all_gather, all_reduce,
                                                 axis_index, axis_size, gather_slices,
                                                 lead_shards, place_tree, sum_onto)
from seldon_core_tpu_torch.parallel.pipeline import (merge_microbatches, pipeline_map,
                                                     split_microbatches, stack_stage_params,
                                                     stage_param_shardings)
from seldon_core_tpu_torch.parallel.ring_attention import ring_attention
from seldon_core_tpu_torch.parallel.moe import MoEConfig, moe_apply, moe_init, moe_leaf_spec
from seldon_core_tpu_torch.runtime.persistence import save_state_to_path, state_from_host
from seldon_core_tpu_torch.tree import leaves_with_paths, tree_map

__all__ = ["LMConfig", "lm_init", "lm_apply", "token_rows", "apply_rope", "gqa_attention",
           "resolve_flash", "resolve_paged_flash", "resolve_train_flash", "lm_loss",
           "lm_train_step", "save_lm_weights", "load_lm_weights", "LB_LOSS_COEF", "TransformerLM",
           "param_shardings", "shard_params", "kv_head_range", "kv_heads_held",
           "shard_kv_heads", "shard_configs", "per_run",
           "lm_pipeline_params", "shard_pipeline_params",
           "lm_pipeline_apply", "lm_pipeline_loss", "lm_pipeline_train_step"]

logger = logging.getLogger(__name__)

@dataclass(frozen=True)
class LMConfig:
    """``seldon_core_tpu/models/transformer.py:53-125`` with a torch dtype;
    the same fields, defaults and validation messages."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    n_kv_heads: int = 0   # 0 = multi-head attention
    dtype: torch.dtype = torch.bfloat16
    moe_every: int = 0
    n_experts: int = 8
    moe_k: int = 2
    quant: str = "none"
    kv_quant: str = "none"
    rope: bool = True
    rope_base: float = 10000.0
    #: a tp shard's runs of query heads, one (kv heads, group) each, where
    #: its heads read kv heads with unequal groups (``tp_local``); () for
    #: one uniform group, ``n_heads / kv_heads``
    kv_runs: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if self.d_model % self.n_heads != 0:
            raise ValueError(
                f"d_model={self.d_model} not divisible by "
                f"n_heads={self.n_heads}"
            )
        if self.quant not in ("none", "int8"):
            raise ValueError(
                f"quant={self.quant!r} not supported (none | int8)"
            )
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant={self.kv_quant!r} not supported (none | int8)"
            )
        kv = self.kv_heads
        if self.kv_runs:
            if (sum(n * g for n, g in self.kv_runs) != self.n_heads
                    or sum(n for n, _ in self.kv_runs) != kv):
                raise ValueError(f"kv_runs={self.kv_runs} do not cover n_heads={self.n_heads} "
                                 f"over n_kv_heads={kv}")
        elif self.n_heads % kv != 0:
            raise ValueError(
                f"n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={kv}"
            )
        if self.rope and (self.d_model // self.n_heads) % 2 != 0:
            raise ValueError(
                f"RoPE needs an even head dim, got "
                f"{self.d_model // self.n_heads}"
            )

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_every > 0 and (i + 1) % self.moe_every == 0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def runs(self) -> Tuple[Tuple[int, int], ...]:
        """The runs of query heads that share one group size, in head
        order, one (kv heads, group) each: ``kv_runs``, or the one uniform
        run.  Attention takes one call a run (``per_run``)."""
        return self.kv_runs or ((self.kv_heads, self.n_heads // self.kv_heads),)

    def tp_local(self, tp: int, t: int = 0) -> "LMConfig":
        """The config shard ``t`` of ``tp`` tensor-parallel shards computes
        with: its ``n_heads / tp`` query heads over the kv heads they read
        (``kv_head_range``), the head dim kept, and its ``d_ff / tp`` FFN
        columns; ``d_model`` is the width of its heads' attention output,
        ``n_heads * head_dim`` (the residual stream keeps the full width).
        Where ``tp`` divides the kv heads or is a multiple of them every
        shard's config is the same, one uniform group; otherwise a shard's
        heads may read kv heads with unequal groups, and its config lists
        their runs (``kv_runs``: 40 heads over 10 kv heads at tp=4 give
        shard 0 runs (2, 4) and (1, 2), shard 1 (1, 2) and (2, 4)).
        Refuses a head or FFN count that ``tp`` does not divide, and an
        int8 K/V cache at such unequal runs (its paged kernel reads whole
        scale planes)."""
        if tp == 1:
            return self
        if self.n_heads % tp:
            raise ValueError(f"n_heads={self.n_heads} not divisible over the tp axis of size {tp}")
        if self.d_ff % tp:
            raise ValueError(f"d_ff={self.d_ff} not divisible over the tp axis of size {tp}")
        lo, hi = kv_head_range(self.kv_heads, tp, t, self.n_heads)
        runs = _shard_runs(self.n_heads, self.kv_heads, tp, t)
        if len(runs) > 1 and self.kv_quant != "none":
            raise ValueError(f"kv_quant={self.kv_quant!r} at n_heads={self.n_heads} over "
                             f"n_kv_heads={self.kv_heads} and tp={tp} is not supported: the "
                             f"shards' query heads read their kv heads in unequal groups")
        return replace(self, n_heads=self.n_heads // tp, n_kv_heads=hi - lo,
                       d_model=self.d_model // tp, d_ff=self.d_ff // tp,
                       kv_runs=runs if len(runs) > 1 else ())

    def for_shard(self, shard) -> "LMConfig":
        """``tp_local`` at the shard's mesh and ``tp`` coordinate
        (``parallel/mesh.py`` ``spmd``)."""
        return self.tp_local(shard.mesh.shape.get("tp", 1), shard.coords.get("tp", 0))

    @property
    def moe(self) -> MoEConfig:
        """The MoE layers' config (``transformer.py:198-204``, ``:351``)."""
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
                         k=self.moe_k, dtype=self.dtype)


def kv_head_range(kv_heads: int, tp: int, t: int, n_heads: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) that shard ``t`` of a ``tp`` axis holds, the
    one layout rule of the K/V heads over ``tp`` (the projection's columns
    a shard reads, ``split_qkv``; its caches and pool blocks,
    ``shard_kv_heads``; the hand-off's reads and writes,
    ``runtime/kvstream.py``): the kv heads that its ``n_heads / tp`` query
    heads read, query head h reading kv head ``h // (n_heads /
    kv_heads)``.  When ``tp`` divides the kv heads that is the ``kv_heads
    / tp`` heads of its block; when ``tp`` is a multiple ``r`` of them,
    the one kv head ``t // r``, which the ``r`` shards of its group each
    hold; otherwise its query heads read their kv heads in unequal groups,
    and a kv head whose readers lie on two shards is held by both (40
    heads over 10 kv heads at tp=4: shard 0 holds kv heads 0-2, shard 1
    2-4).  Refuses a head count that ``tp`` does not divide."""
    if n_heads % tp:
        raise ValueError(f"n_heads={n_heads} not divisible over the tp axis of size {tp}")
    hq, g = n_heads // tp, n_heads // kv_heads
    return t * hq // g, ((t + 1) * hq - 1) // g + 1


def _shard_runs(n_heads: int, kv_heads: int, tp: int, t: int) -> Tuple[Tuple[int, int], ...]:
    """Shard ``t``'s query heads as runs of one group size, in head order:
    ((kv heads, group), ...), neighbouring kv heads with as many readers
    on the shard merged into one run."""
    hq, g = n_heads // tp, n_heads // kv_heads
    lo, hi = kv_head_range(kv_heads, tp, t, n_heads)
    runs: list = []
    for j in range(lo, hi):
        c = min((t + 1) * hq, (j + 1) * g) - max(t * hq, j * g)
        if runs and runs[-1][1] == c:
            runs[-1] = (runs[-1][0] + 1, c)
        else:
            runs.append((1, c))
    return tuple(runs)


def shard_configs(cfg: LMConfig, mesh: Optional[DeviceMesh]):
    """The distinct configs the shards of ``mesh`` compute with
    (``tp_local`` at every ``tp`` coordinate): one where the layout is even,
    more where the shards' runs differ; ``[cfg]`` without a mesh.  Raises
    ``tp_local``'s refusals."""
    if mesh is None:
        return [cfg]
    tp = mesh.shape.get("tp", 1)
    return list(dict.fromkeys(cfg.tp_local(tp, t) for t in range(tp)))


def _narrow_heads(x, lo: int, n: int):
    """Heads [lo, lo + n) along dim 1 of a tensor, or of every tensor of a
    tuple or dict (a cache or pool layer); None stays None."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _narrow_heads(v, lo, n) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_narrow_heads(v, lo, n) for v in x)
    return x.narrow(1, lo, n)


def per_run(cfg: LMConfig, attend: Callable, q, *kv):
    """``attend(q, *kv)`` [B, H, ...] -> [B, H, ...] over the shard's query
    heads ``q`` (dim 1) and its kv heads' tensors ``kv`` (dim 1 of each,
    or of each tensor of a layer dict or tuple): one call a run of
    ``cfg.runs`` (its query heads and the kv heads they read, one group
    size, so one launch of a kernel at a uniform group), the outputs
    concatenated in head order; a single call where the config has one
    run.  A kernel that writes a kv head in place writes it through the
    run's view."""
    if not cfg.kv_runs:
        return attend(q, *kv)
    outs, qh, kh = [], 0, 0
    for n, g in cfg.kv_runs:
        outs.append(attend(q.narrow(1, qh, n * g), *(_narrow_heads(t, kh, n) for t in kv)))
        qh, kh = qh + n * g, kh + n
    return torch.cat(outs, dim=1)


def kv_heads_held(kv_heads: int, mesh: DeviceMesh, i: int, n_heads: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) of a K/V tree (a pool, a cache) that shard
    ``i`` of ``mesh`` holds: every head without a ``tp`` axis, else
    ``kv_head_range`` at its ``tp`` coordinate (``n_heads``, the model's
    query heads)."""
    tp = mesh.shape.get("tp", 1)
    if tp == 1:
        return 0, kv_heads
    return kv_head_range(kv_heads, tp, mesh.coords(i)["tp"], n_heads)


def shard_kv_heads(tree, mesh: DeviceMesh, n_heads: int) -> ShardedTree:
    """A whole tree of K/V tensors whose dim 1 is the kv heads (a paged
    pool's ``[blocks, KV, block_size, hd]`` and scale planes, a cache's
    ``[B, KV, S, hd]``) placed over ``mesh``: each shard holds its
    ``kv_heads_held`` (``n_heads``, the model's query heads), a copy of
    its own where that is not every head (a prefix cache; a paged pool is
    allocated by shard, ``runtime/servingmesh.py`` ``shard_gen_pool``)."""

    def block(leaf, i):
        kv = leaf.shape[1]
        lo, hi = kv_heads_held(kv, mesh, i, n_heads)
        if (lo, hi) == (0, kv):
            return leaf.to(mesh.device_list[i])
        return leaf.narrow(1, lo, hi - lo).to(mesh.device_list[i], copy=True,
                                              memory_format=torch.contiguous_format)

    def walk(t, i):
        return {k: walk(v, i) for k, v in t.items()} if isinstance(t, dict) else block(t, i)

    return ShardedTree(mesh, [walk(tree, i) if mesh.owns(i) else None
                              for i in range(mesh.size)])


def _rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w


def apply_rope(x, positions, base: float = 10000.0):
    """Rotate [B, H, S, hd] by per-position angles; positions [S] shared
    across the batch or [B, S] per row.  Half-split convention, f32 trig,
    output in the input dtype.  The JAX code computes the rotate-half as
    ``x @ R`` with a signed permutation R, which is exact arithmetic; the
    concatenation ``[-x2, x1]`` in f32 gives the same numbers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    if angles.ndim == 2:  # shared positions [S, half]
        c = torch.cat([cos, cos], dim=-1)[None, None]
        s = torch.cat([sin, sin], dim=-1)[None, None]
    else:  # per-row positions [B, S, half] -> broadcast over heads
        c = torch.cat([cos, cos], dim=-1)[:, None]
        s = torch.cat([sin, sin], dim=-1)[:, None]
    x32 = x.float()
    rx = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * c + rx * s).to(x.dtype)


def _dense(rng: torch.Generator, shape, fan_in: int, dtype: torch.dtype) -> torch.Tensor:
    # scaled in place: the same bits as a product, one f32 buffer fewer
    return torch.randn(shape, generator=rng, dtype=torch.float32).mul_(fan_in ** -0.5).to(dtype)


def lm_init(rng: torch.Generator, cfg: LMConfig, device: DeviceLike = None) -> Dict[str, Any]:
    """Parameters as ``lm_init`` lays them out, drawn on the CPU from
    ``rng`` (a CPU ``torch.Generator``) in the order embed, then per layer
    wqkv, wo and w1, w2 (an MoE layer: its ``moe`` subtree, ``moe_init``),
    and moved to ``device`` (default ``cuda``).  The draws differ from
    ``jax.random``'s; parity tests carry JAX weights across instead."""
    dev = resolve_device(device)
    dt = cfg.dtype
    hd = cfg.head_dim
    qkv_out = cfg.d_model + 2 * cfg.kv_heads * hd  # q | k | v segments
    params: Dict[str, Any] = {"embed": _dense(rng, (cfg.vocab, cfg.d_model), cfg.d_model, dt).to(dev)}
    for i in range(cfg.n_layers):
        lp = {
            "ln1": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "wqkv": _dense(rng, (cfg.d_model, qkv_out), cfg.d_model, dt).to(dev),
            "wo": _dense(rng, (cfg.d_model, cfg.d_model), cfg.d_model, dt).to(dev),
            "ln2": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }
        if cfg.is_moe_layer(i):
            lp["moe"] = moe_init(rng, cfg.moe, dev)
        else:
            lp["w1"] = _dense(rng, (cfg.d_model, cfg.d_ff), cfg.d_model, dt).to(dev)
            lp["w2"] = _dense(rng, (cfg.d_ff, cfg.d_model), cfg.d_ff, dt).to(dev)
        params[f"l{i}"] = lp
    params["ln_f"] = torch.ones(cfg.d_model, dtype=dt, device=dev)
    return params


def param_shardings(mesh: DeviceMesh, params) -> Any:
    """The tp layout of ``transformer.py:214-245``, as a tree of partition
    specs (a tuple of mesh axis names or None per dimension, ``()``
    replicated): ``wqkv`` and ``w1`` split by columns over ``tp``, ``wo``
    and ``w2`` by rows; the int8 ``_q`` leaves as their weights, the
    scales ``_s`` along the output axis of ``wqkv``/``w1`` and replicated
    for ``wo``/``w2``; ``moe`` leaves by ``moe_leaf_spec``; everything
    else replicated."""
    has_tp = "tp" in mesh.shape

    def spec_for(names, leaf):
        name = names[-1]
        if "moe" in names:
            return moe_leaf_spec(name, leaf, mesh)
        if name.endswith("_q") or name.endswith("_s"):
            base, kind = name[:-2], name[-1]
            if base in ("wqkv", "w1"):
                if kind == "q":
                    return (None, "tp") if has_tp else ()
                return ("tp",) if has_tp else ()
            if base in ("wo", "w2"):
                return ("tp", None) if (has_tp and kind == "q") else ()
            return ()
        if name in ("wqkv", "w1"):
            return (None, "tp") if has_tp else ()
        if name in ("wo", "w2"):
            return ("tp", None) if has_tp else ()
        return ()

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (k,)) for k, v in tree.items()}
        return spec_for(names, tree)

    return walk(params, ())


def check_mesh(cfg: LMConfig, mesh: DeviceMesh, what: str) -> None:
    """A unit's mesh refused at construction, in ``what``'s name: a tp
    that does not divide the query heads or the FFN (``tp_local``)."""
    try:
        shard_configs(cfg, mesh)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None


def shard_params(params, mesh: DeviceMesh, specs=None) -> ShardedTree:
    """``params`` (one device's whole tree) placed over ``mesh`` by
    ``specs`` (default ``param_shardings``; ``parallel/mesh.py``
    ``place_tree``): each device's tree holds its blocks, and the result
    keeps the specs (which shards hold copies of a leaf)."""
    return place_tree(params, mesh, param_shardings(mesh, params) if specs is None else specs)


def gqa_attention(q, k, v, causal: bool):
    """Grouped-query attention without repeating K/V: q [B, H, S, hd],
    k/v [B, KV, S_k, hd], H = KV * g, group heads folded into the row
    axis.  Scores and the PV product in f32 from the inputs upcast, p cast
    to V's dtype first, the output in q's dtype."""
    B, H, S, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / (hd ** 0.5)
    s = torch.matmul(q.reshape(B, KV, g * S, hd).float(),
                     k.float().transpose(-1, -2)) * scale  # [B, KV, g*S, Sk]
    s = s.reshape(B, KV, g, S, Sk)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p.reshape(B, KV, g * S, Sk).float(), v.float()).to(q.dtype)
    return out.reshape(B, H, S, hd)


def _attention(q, k, v, causal: bool, use_flash: bool = False):
    """q [B, H, S, hd], k/v [B, KV, S, hd] -> [B, H, S, hd].  The flash
    forward when ``use_flash`` and the JAX shape contract holds (a static
    check: a launch failure is never caught), else the plain attention."""
    if use_flash and shape_contract_error(q, k, v) is None:
        return flash_attention(q, k, v, causal=causal)
    if k.shape[1] != q.shape[1]:
        return gqa_attention(q, k, v, causal)
    # plain attention in q's dtype, as the JAX package's XLA fallback
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), device=q.device)).to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def heads(t, B, S, n, hd):
    """[B, S, n*hd] -> [B, n, S, hd] (a strided view, no copy)."""
    return t.reshape(B, S, n, hd).transpose(1, 2)


def split_qkv(qkv, cfg: LMConfig):
    """The fused projection's output -> (q, k, v) columns of this shard's
    heads.  On one device (or a tp axis of 1) a split at [D, kv*hd].  On a
    tp shard, ``qkv`` holds the shard's contiguous block of the reference
    layout's columns (``param_shardings``: ``wqkv`` split by columns over
    ``tp``), which does not follow the q | k | v boundaries, so the shard
    reads the columns of its own query heads and of the kv heads it holds
    (``kv_head_range``) from the group's blocks (``gather_slices``): the
    reshard GSPMD inserts there.  The whole layout's widths come from the
    block's: ``tp`` blocks of ``D + 2 KV`` columns.  Where two shards hold
    one kv head (``tp`` a multiple of the kv heads, or a kv head whose
    readers lie on both), they read the same K/V columns, so the backward
    sums their gradients onto that block."""
    hd = cfg.head_dim
    dq, dkv = cfg.n_heads * hd, cfg.kv_heads * hd
    tp = axis_size("tp")
    if tp == 1:
        return torch.split(qkv, [dq, dkv, dkv], dim=-1)
    t = axis_index("tp")
    D = dq * tp
    KV = (qkv.shape[-1] * tp - D) // 2
    lo, hi = kv_head_range(KV // hd, tp, t, D // hd)
    qkv = gather_slices(qkv, "tp", qkv.ndim - 1,
                        [(t * dq, (t + 1) * dq), (D + lo * hd, D + hi * hd),
                         (D + KV + lo * hd, D + KV + hi * hd)])
    return torch.split(qkv, [dq, dkv, dkv], dim=-1)


def attn_out(lp, x, a):
    """x + the attention output projection of a [B, S, n_heads*hd]; on a
    tp shard ``wo`` holds its heads' rows, so the partial products are
    summed over ``tp`` (``all_reduce``) before the residual."""
    return x + all_reduce(lm_matmul(lp, "wo", a, out_dtype=x.dtype), "tp")


def _ffn(lp, h, cfg: LMConfig):
    """Dense or MoE feed-forward on h [B, S, D] -> (y, lb_loss): the dense
    FFN is gelu (tanh form, as ``jax.nn.gelu``) between the two layer
    matmuls, with a load-balance loss of 0.0 (a float: no device work); an MoE layer routes the whole
    [B*S] token stream (``moe_apply``; its experts split over ``ep`` on
    a mesh).  On a tp shard ``w1`` holds its columns and ``w2`` its rows,
    so the dense output is summed over ``tp``; MoE leaves replicate over
    ``tp``."""
    if "moe" in lp:
        y, aux = moe_apply(lp["moe"], h, cfg.moe)
        return y, aux["lb_loss"]
    u = F.gelu(lm_matmul(lp, "w1", h, out_dtype=h.dtype), approximate="tanh")
    return all_reduce(lm_matmul(lp, "w2", u, out_dtype=h.dtype), "tp"), 0.0


def _block(lp, x, cfg: LMConfig, causal: bool, use_flash: bool = False):
    """One decoder block: attention + FFN (dense or MoE) with residuals ->
    (x', lb_loss).  On a tp shard (``cfg`` the shard's, ``LMConfig.tp_local``)
    the block attends its heads (one call a run of one group size,
    ``per_run``) and reduces twice over ``tp``: after ``wo`` and after
    ``w2``.  On an sp shard ``x`` holds positions
    ``axis_index("sp") * S`` on: rope rotates at those global positions (the
    reference rotates the whole sequence before its ring), attention is
    the ring (``parallel/ring_attention.py``; grouped K/V refused in the
    reference's words), and an MoE FFN routes the whole sequence (its
    capacity is set over every token), gathered over ``sp`` and sliced
    back."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    kv = cfg.kv_heads
    sp = axis_size("sp")
    h = _rmsnorm(x, lp["ln1"])
    qkv = lm_matmul(lp, "wqkv", h, out_dtype=x.dtype)
    q, k, v = split_qkv(qkv, cfg)
    q, k, v = heads(q, B, S, cfg.n_heads, hd), heads(k, B, S, kv, hd), heads(v, B, S, kv, hd)
    if cfg.rope:
        positions = torch.arange(S, device=x.device) + axis_index("sp") * S
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    if sp > 1:
        if kv != cfg.n_heads:
            raise ValueError(
                "sequence-parallel ring attention requires "
                "n_kv_heads == n_heads"
            )
        a = ring_attention(q, k, v, "sp", causal, use_flash)
    else:
        a = per_run(cfg, lambda q, k, v: _attention(q, k, v, causal, use_flash), q, k, v)
    x = attn_out(lp, x, a.transpose(1, 2).reshape(B, S, -1))
    h = _rmsnorm(x, lp["ln2"])
    if sp > 1 and "moe" in lp:
        y, lb = _ffn(lp, all_gather(h, "sp", dim=1), cfg)
        return x + y.narrow(1, axis_index("sp") * S, S), lb
    y, lb = _ffn(lp, h, cfg)
    return x + y, lb


def token_rows(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """Token ids, or the float values a wire row carries, -> rows of the
    embedding table (int64), by the reference's rule: ``X.astype(int32)``
    (NaN is 0, a float truncates toward zero and saturates at the int32
    range, a wider int wraps), then JAX's gather, which adds ``vocab`` to
    a negative index once and clamps what is still out of range to
    [0, vocab - 1].  So no index leaves the table on any device."""
    if tokens.is_floating_point():
        t = torch.nan_to_num(tokens.double(), nan=0.0).trunc()
        t = t.clamp(-2.0 ** 31, 2.0 ** 31 - 1).long()
    else:
        t = tokens.to(torch.int32).long()
    return torch.where(t < 0, t + vocab, t).clamp(0, vocab - 1)


def lm_apply(params, tokens, cfg: LMConfig, causal: bool = True, use_flash: bool = False,
             return_lb: bool = False, mesh: Optional[DeviceMesh] = None):
    """tokens [B, S] (ids, or wire values: ``token_rows``) -> logits
    [B, S, V] f32; with ``return_lb`` also the summed MoE load-balance
    loss (f32 scalar, 0 for a dense config).  ``params`` a ``ShardedTree``
    (``shard_params``) runs over its mesh (``mesh``, if given, must be
    it): each shard on its device, its heads and FFN columns over ``tp``,
    its experts over ``ep``, its columns of ``tokens`` over ``sp`` (the
    ring), and the rows split over ``dp`` when ``dp`` divides them and no
    MoE layer couples them (else every ``dp`` group takes all rows); the
    logits come back on the mesh's first device."""
    if isinstance(params, ShardedTree):
        if mesh is not None and mesh is not params.mesh:
            raise ValueError("lm_apply: mesh differs from the params' mesh")
        outs, lay = _lm_sharded(params, tokens, cfg, causal, use_flash,
                                lambda p, x, sl: _lm_head(p, x))
        logits = lay.gather([None if o is None else o[0] for o in outs])
        return (logits, outs[params.mesh.owned[0]][1]) if return_lb else logits
    x, lb_total = _lm_trunk(params, tokens, cfg, causal, use_flash)
    logits = _lm_head(params, x)
    return (logits, lb_total) if return_lb else logits


def _lm_trunk(params, tokens, cfg: LMConfig, causal: bool, use_flash: bool):
    """The embedding and every block: (x [B, S, D], summed lb loss)."""
    x = params["embed"][token_rows(tokens, cfg.vocab)]
    lb_total = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        x, lb = _block(params[f"l{i}"], x, cfg, causal, use_flash)
        lb_total = lb_total + lb
    return x, lb_total


def _lm_head(params, x):
    """The final norm and the unembedding: logits f32."""
    return (_rmsnorm(x, params["ln_f"]) @ params["embed"].T).float()


@dataclass(frozen=True)
class _Layout:
    """How a sharded LM call splits [B, S] over its mesh: rows over ``dp``
    (when ``split_rows``) and columns over ``sp``; ``leads`` are the shards
    that hold one block each of the answer, in (dp, sp) order."""

    mesh: DeviceMesh
    split_rows: bool
    rows: int
    cols: int

    @property
    def leads(self):
        return lead_shards(self.mesh, ("dp", "sp") if self.split_rows else ("sp",))

    def slice(self, t: torch.Tensor, coords: Dict[str, int]) -> torch.Tensor:
        """A shard's block of a [B, S, ...] tensor."""
        if self.split_rows:
            d = coords["dp"]
            t = t[d * self.rows:(d + 1) * self.rows]
        if "sp" in coords:
            c = coords["sp"]
            t = t[:, c * self.cols:(c + 1) * self.cols]
        return t

    def gather(self, blocks):
        """The leads' blocks of a run's per-shard ``blocks`` (in ``leads``'
        order: dp slowest, whatever the mesh's axis order) reassembled on
        this process's first device (``DeviceMesh.collect``: over a mesh
        that spans processes every process gets the whole answer)."""
        blocks = self.mesh.collect(blocks, self.leads)
        sp = self.mesh.shape.get("sp", 1)
        rows = [torch.cat(blocks[r:r + sp], dim=1) for r in range(0, len(blocks), sp)]
        return torch.cat(rows)


def _layout(mesh: DeviceMesh, B: int, S: int, cfg: LMConfig) -> _Layout:
    dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
    if S % sp:
        raise ValueError(f"sequence of {S} tokens not divisible over 'sp' of size {sp}")
    split = dp > 1 and B % dp == 0 and cfg.moe_every == 0
    return _Layout(mesh, split, B // dp if split else B, S // sp)


def _lm_sharded(params: ShardedTree, tokens, cfg: LMConfig, causal: bool, use_flash: bool,
                head: Callable):
    """Every shard runs the trunk on its block of ``tokens`` (``_Layout``);
    each lead then runs ``head(params, x, block_slice)``, the others
    nothing.  Returns ([(head's answer or None, lb)] in shard order, the
    layout)."""
    mesh = params.mesh
    lay = _layout(mesh, tokens.shape[0], tokens.shape[1], cfg)
    leads = set(lay.leads)

    def body(shard):
        p = params.shards[shard.index]
        sl = functools.partial(lay.slice, coords=shard.coords)
        x, lb = _lm_trunk(p, sl(tokens).to(shard.device), cfg.for_shard(shard), causal,
                          use_flash)
        return (head(p, x, sl) if shard.index in leads else None), lb

    return mesh.run(body), lay


def resolve_flash(attention: str, cfg: LMConfig, device: torch.device,
                  decode: bool = False, mesh: Optional[DeviceMesh] = None) -> bool:
    """Deployment-parameter attention mode -> ``use_flash``, decided once
    at construction (table in the module docstring).  On CUDA the kernel
    is built and launched once here (``probe_kernel``), so a missing nvcc
    or a failing build raises before an engine reports ready.  With
    ``decode`` (a generator) the decode lane's kernels are asked and
    probed too (``decode_kernel_shape_error``, ``probe_decode_kernel``, with
    the step's K/V write fused in, as every cached step calls it), and
    ``use_flash`` also sends every cached step through it.  An int8 cache
    (``kv_quant="int8"``) asks and probes the int8-K/V variants (the paged
    kernel asked at the continuous lane's default block size, 16; the
    scheduler probes it at its own).

    With a ``mesh`` the question is asked at every shard's shapes
    (``shard_configs``: its heads, the same head dim, and each run's group
    and kv heads, ``LMConfig.runs``) and the kernels probed on every device
    of the mesh: each shard launches the kernels on its own heads, one
    launch a run.  One refused shape sends every shard to the plain path
    ("auto") or raises ("flash").  The reference keeps a multi-device mesh
    off its Pallas kernels (GSPMD cannot partition a ``pallas_call``); the
    port's shards are single-device programs and do not inherit that."""
    if mesh is not None:
        return all(resolve_flash(attention, local, d, decode)
                   for local in shard_configs(cfg, mesh) for d in mesh.distinct_devices)
    if attention == "xla":
        return False
    if attention not in ("auto", "flash"):
        raise ValueError(
            f"attention={attention!r} not supported (auto | flash | xla)"
        )
    if device.type != "cuda":
        return True  # the wrappers run the plain versions for CPU tensors
    kv_dtype = torch.int8 if cfg.kv_quant == "int8" else None
    why = kernel_shape_error(cfg.head_dim, cfg.dtype)
    for _, group in cfg.runs:
        if why is None and decode:
            why = decode_kernel_shape_error(cfg.head_dim, cfg.dtype, group, kv_dtype)
        if why is None and decode and kv_dtype is not None:
            why = paged_kernel_shape_error(cfg.head_dim, cfg.dtype, group, 16, kv_dtype)
    if why is not None:
        if attention == "flash":
            raise ValueError(f"attention='flash': {why}")
        logger.info("flash kernels not used (%s); attention and decode run the "
                    "plain path", why)
        return False
    for n, group in cfg.runs:
        probe_kernel(n * group, n, cfg.head_dim, cfg.dtype, device)
        if decode:
            probe_decode_kernel(n, group, cfg.head_dim, cfg.dtype, device, kv_dtype)
    return True


def resolve_paged_flash(attention: str, cfg: LMConfig, device: torch.device,
                        use_flash: bool, mesh: Optional[DeviceMesh] = None) -> bool:
    """Whether the continuous lane takes its kernels (``kv_write_paged``
    for a prefill tick, ``flash_decode_paged`` for a decode step): the
    unit's ``use_flash``, and also where ``resolve_flash`` refused only for
    kernels that lane never runs.  The lane launches no ``flash_attention``
    and no two-tier decode, and the paged kernel takes float32, so an f32
    config (a bf16-only refusal) still serves the lane through its
    kernels, as the speculative draft's f32 steps do.  Asked at every
    shard's runs over a ``mesh``; the scheduler probes both kernels at its
    construction.  The plain path stays for ``attention="xla"``, an int8
    cache whose variants ``resolve_flash`` already asked, and a shape the
    paged kernel refuses."""
    if use_flash or attention == "xla" or cfg.kv_quant != "none" or device.type != "cuda":
        return use_flash
    whys = [paged_kernel_shape_error(local.head_dim, local.dtype, g, 16)
            for local in shard_configs(cfg, mesh)
            for _, g in local.runs]
    why = next((w for w in whys if w is not None), None)
    if why is not None:
        logger.info("paged kernels not used (%s); the continuous lane runs the plain path", why)
        return False
    return True


@functools.lru_cache(maxsize=None)
def _train_kernels(n_heads: int, n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   device: torch.device) -> bool:
    why = kernel_shape_error(head_dim, dtype) or bwd_kernel_shape_error(head_dim, dtype)
    if why is not None:
        logger.info("flash-attention kernels not used for training (%s); attention "
                    "runs the plain path", why)
        return False
    probe_kernel(n_heads, n_kv_heads, head_dim, dtype, device)
    probe_bwd_kernel(n_heads, n_kv_heads, head_dim, dtype, device)
    return True


def resolve_train_flash(cfg: LMConfig, device: torch.device) -> bool:
    """``lm_loss``'s ``use_flash=None``: on CUDA the kernels when both the
    forward and the backward take the config's dtype and head dim (asked,
    and both probed, once per config and device; a missing nvcc or a
    failing build raises), else the plain attention; on the CPU the plain
    attention, as the JAX package's ``pallas_supported()`` answers off
    the TPU."""
    if device.type != "cuda":
        return False
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return all(_train_kernels(n * g, n, cfg.head_dim, cfg.dtype, device) for n, g in cfg.runs)


#: weight of the MoE load-balance loss in ``lm_loss`` (``transformer.py:409``)
LB_LOSS_COEF = 0.01


def _nll_sum(logits, targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].sum()


def lm_loss(params, batch, cfg: LMConfig, use_flash: Optional[bool] = None):
    """Next-token cross-entropy plus ``LB_LOSS_COEF`` times the MoE
    load-balance loss, f32 scalar; ``batch = {"tokens": [B, S+1]}``: the
    mean over positions of ``-log_softmax(logits)`` at the next token, as
    ``transformer.py:409-442``.  ``use_flash=None`` asks
    ``resolve_train_flash`` (over a mesh at one shard's shape on each of its
    devices).  ``params`` a ``ShardedTree`` over ``dp x tp x sp`` (and
    ``ep``): inputs ``tokens[:, :-1]`` and targets ``tokens[:, 1:]`` split
    alike (``_Layout``), each lead's nll summed on its shard, the sum of
    those over every token's count on the mesh's first device; the one
    autograd graph of the run reaches every shard's leaves."""
    tokens = batch["tokens"]
    if isinstance(params, ShardedTree):
        return _lm_loss_sharded(params, tokens, cfg, use_flash)
    if use_flash is None:
        use_flash = resolve_train_flash(cfg, params["embed"].device)
    logits, lb_total = lm_apply(params, tokens[:, :-1], cfg, use_flash=use_flash,
                                return_lb=True)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean() + LB_LOSS_COEF * lb_total


def _lm_loss_sharded(params: ShardedTree, tokens, cfg: LMConfig, use_flash: Optional[bool]):
    mesh = params.mesh
    if use_flash is None:
        use_flash = all(resolve_train_flash(local, d) for local in shard_configs(cfg, mesh)
                        for d in mesh.distinct_devices)
    targets = tokens[:, 1:]
    outs, lay = _lm_sharded(params, tokens[:, :-1], cfg, True, use_flash,
                            lambda p, x, sl: _nll_sum(_lm_head(p, x),
                                                      sl(targets).to(x.device)))
    dev = mesh.first_device
    total = sum_onto(mesh.collect([None if o is None else o[0] for o in outs], lay.leads), dev)
    return total / targets.numel() + LB_LOSS_COEF * outs[mesh.owned[0]][1].to(dev)


def lm_train_step(params, opt_state, batch, optimizer, cfg: LMConfig,
                  use_flash: Optional[bool] = None):
    """One training step, ``transformer.py:452-462``: returns (params,
    opt_state, loss).  ``params`` and ``opt_state`` a ``ShardedTree``
    (``shard_params``, ``optimizer.init`` of it) train over their mesh:
    the forward over every shard, the backward once over the run's graph,
    each replicated leaf's gradient summed over its copies
    (``optim.grad_update``)."""
    if cfg.quant != "none":
        # int8 weights are not differentiable: quantization is a serving
        # transform, applied after training
        raise ValueError("lm_train_step requires quant='none'")
    return grad_update(lambda p, b: lm_loss(p, b, cfg, use_flash=use_flash),
                       params, opt_state, batch, optimizer)


# -- the pipeline over pp (transformer.py:465-537) ------------------------------
# The layer stack splits into pp stages, one stage a shard
# (parallel/pipeline.py); the embedding and the head stay outside the
# pipeline, replicated: stage 0 embeds, the last stage runs the head.


def lm_pipeline_params(params, cfg: LMConfig, n_stages: int, mesh: DeviceMesh) -> ShardedTree:
    """``lm_init`` params re-laid out for an ``n_stages``-stage pipeline
    over ``mesh``: ``{embed, ln_f, stages}``, ``stages``' leaves stacked
    ``[n_stages, layers_per_stage, ...]`` and split over ``pp`` (each shard
    holds its stage's layers), ``embed`` and ``ln_f`` replicated."""
    if cfg.n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={n_stages}"
        )
    if cfg.moe_every:
        # MoE layers have another param tree than dense ones, so they
        # cannot stack into one per-stage tree; their lb loss would be
        # dropped by the schedule too
        raise ValueError("pipeline parallelism does not support MoE layers")
    lps = cfg.n_layers // n_stages
    stages = stack_stage_params([
        tree_map(lambda *ls: torch.stack(ls, 0),
                 *[params[f"l{s * lps + j}"] for j in range(lps)])
        for s in range(n_stages)])
    return shard_pipeline_params({"embed": params["embed"], "ln_f": params["ln_f"],
                                  "stages": stages}, mesh)


def shard_pipeline_params(pp_params, mesh: DeviceMesh) -> ShardedTree:
    """A whole ``{embed, ln_f, stages}`` tree (``convert.params_from_jax`` of
    the reference's ``lm_pipeline_params``) placed over ``mesh`` (this
    process's shards, over a mesh that spans processes)."""
    specs = {"embed": (), "ln_f": (),
             "stages": stage_param_shardings(mesh, pp_params["stages"])}
    return place_tree(pp_params, mesh, specs)


def _pipeline_sharded(pp_params: ShardedTree, tokens, cfg: LMConfig, n_micro: int,
                      causal: bool, use_flash: bool, head: Callable):
    """The GPipe forward over the params' mesh (``pipeline_map``): stage 0
    embeds each ``dp`` group's rows of each microbatch, each stage runs its
    layers, each group's last stage answers ``head(params, y, rows)``.
    Returns the answers in dp order."""

    def stage_fn(stage, x):
        for j in range(stage["wqkv"].shape[0]):
            x, _ = _block({k: v[j] for k, v in stage.items()}, x, cfg, causal, use_flash)
        return x

    return pipeline_map(
        stage_fn, pp_params, split_microbatches(tokens, n_micro), stages=lambda p: p["stages"],
        enter=lambda p, t: p["embed"][token_rows(t, cfg.vocab)], leave=head,
        handoff=lambda p, shape, dtype: (shape + p["embed"].shape[1:], p["embed"].dtype))


def lm_pipeline_apply(pp_params: ShardedTree, tokens, cfg: LMConfig,
                      mesh: Optional[DeviceMesh] = None, n_micro: int = 4,
                      causal: bool = True, use_flash: bool = False):
    """Pipelined forward: tokens [B, S] -> logits [B, S, V] f32 on this
    process's first device (every process the same bits).  Each stage runs
    its layers through ``_block``, with the flash kernels when
    ``use_flash`` (on the card, decided at the stage's shape as one device
    decides; the reference's stages take the plain attention, since GSPMD
    cannot partition its Pallas kernel)."""
    if mesh is not None and mesh is not pp_params.mesh:
        raise ValueError("lm_pipeline_apply: mesh differs from the params' mesh")
    outs = _pipeline_sharded(pp_params, tokens, cfg, n_micro, causal, use_flash,
                             lambda p, y, rows: _lm_head(p, y))
    dev = pp_params.mesh.first_device
    return merge_microbatches(torch.cat([o.to(dev) for o in outs], dim=1))


def lm_pipeline_loss(pp_params: ShardedTree, batch, cfg: LMConfig,
                     mesh: Optional[DeviceMesh] = None, n_micro: int = 4,
                     use_flash: Optional[bool] = None):
    """``lm_loss`` through the pipelined forward (``transformer.py:514``):
    each ``dp`` group's last stage sums its rows' nll, the sum of those
    over every token's count.  ``use_flash=None`` asks
    ``resolve_train_flash`` on each of the mesh's devices."""
    if cfg.moe_every:
        # a custom forward cannot report the lb loss; training without it
        # collapses the router
        raise ValueError("lm_loss(apply_fn=...) does not support MoE configs")
    pmesh = pp_params.mesh
    if mesh is not None and mesh is not pmesh:
        raise ValueError("lm_pipeline_loss: mesh differs from the params' mesh")
    if use_flash is None:
        use_flash = all(resolve_train_flash(cfg, d) for d in pmesh.distinct_devices)
    tokens = batch["tokens"]
    targets = split_microbatches(tokens[:, 1:], n_micro)
    outs = _pipeline_sharded(
        pp_params, tokens[:, :-1], cfg, n_micro, True, use_flash,
        lambda p, y, rows: _nll_sum(_lm_head(p, y), rows(targets).to(y.device)))
    return sum_onto(outs, pmesh.first_device) / targets.numel()


def lm_pipeline_train_step(pp_params: ShardedTree, opt_state, batch, optimizer,
                           cfg: LMConfig, mesh: Optional[DeviceMesh] = None,
                           n_micro: int = 4, use_flash: Optional[bool] = None):
    """One pipeline-parallel train step (``transformer.py:527-537``): the
    backward once over the schedule's graph, the replicated embedding's
    and final norm's gradients summed over their copies (stage 0's lookup
    and the last stage's head), ``optim.grad_update``."""
    return grad_update(lambda p, b: lm_pipeline_loss(p, b, cfg, mesh, n_micro, use_flash),
                       pp_params, opt_state, batch, optimizer)


def save_lm_weights(params, path: str) -> str:
    """Checkpoint an ``lm_init``-shaped params tree to one ``.npz`` in the
    JAX package's flat-pytree format: the train -> serve hand-off."""
    return save_state_to_path(path, params)


def load_lm_weights(params, path: str):
    """Trained weights onto a freshly initialised params tree (the
    ``weights_path`` unit parameter), cast to the serving config's dtypes
    on its device.  Strict, with the JAX package's messages: a missing
    file, a checkpoint whose keys do not cover the serving config's tree,
    or a shape mismatch raises at load time."""
    if not path:
        return params
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights_path {path!r} does not exist")
    with np.load(path) as data:
        flat = dict(data)
    want = {key: tuple(leaf.shape) for key, leaf in leaves_with_paths(params)}
    missing = sorted(set(want) - set(flat))
    if missing:
        raise ValueError(
            f"weights_path {path!r} does not cover the serving config: "
            f"{len(missing)} missing leaves (first: {missing[0]}); is the "
            f"checkpoint from a different architecture, or a unit-STATE "
            f"snapshot rather than save_lm_weights params?"
        )
    bad = [(k, flat[k].shape, want[k]) for k in want if tuple(flat[k].shape) != want[k]]
    if bad:
        k, got, exp = bad[0]
        raise ValueError(
            f"weights_path {path!r} shape mismatch at {k}: checkpoint "
            f"{got} vs serving config {exp} (+{len(bad) - 1} more)"
        )
    return state_from_host(flat, params)


def seeded_generator(rng: Optional[torch.Generator], seed: int) -> torch.Generator:
    """The unit's CPU generator: the graph's seed folded with the unit's,
    so two units with different seeds differ under one graph seed."""
    base = 0 if rng is None else rng.initial_seed()
    g = torch.Generator(device="cpu")
    g.manual_seed((base * 1_000_003 + int(seed)) % (1 << 63))
    return g


@register_unit("TransformerLM")
class TransformerLM(Unit):
    """Serving unit: next-token logits [B, S, V] f32 for token rows,
    registered under the JAX unit's name with its parameters.  A
    ``weights_path`` is loaded over the seeded weights in ``init_state``
    (``load_lm_weights``), as the JAX unit does."""

    def __init__(
        self,
        vocab: int = 256,
        d_model: int = 128,
        n_heads: int = 4,
        n_layers: int = 2,
        d_ff: int = 512,
        seed: int = 0,
        dtype: str = "bfloat16",
        moe_every: int = 0,
        n_experts: int = 8,
        moe_k: int = 2,
        quant: str = "none",
        attention: str = "auto",
        n_kv_heads: int = 0,
        weights_path: str = "",
        rope: bool = True,
        rope_base: float = 10000.0,
        device: DeviceLike = None,
        mesh: Optional[DeviceMesh] = None,
    ):
        self.cfg = LMConfig(
            vocab=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
            n_layers=int(n_layers), d_ff=int(d_ff), dtype=parse_dtype(dtype),
            moe_every=int(moe_every), n_experts=int(n_experts),
            moe_k=int(moe_k), quant=str(quant), n_kv_heads=int(n_kv_heads),
            rope=bool(rope), rope_base=float(rope_base),
        )
        self.weights_path = str(weights_path)
        self.seed = int(seed)
        # mesh (a binding's mesh_axes): params laid out by param_shardings,
        # every shard on its own device (the first holds the answers)
        self.mesh = mesh
        if mesh is not None:
            check_mesh(self.cfg, mesh, "TransformerLM")
            device = mesh.first_device
        self.device = resolve_device(device)
        self.use_flash = resolve_flash(str(attention), self.cfg, self.device, mesh=mesh)
        # capacity routing flattens the stacked batch into one token stream,
        # so co-batched rows change each other's overflow: no coalescing
        self.batch_coupled = self.cfg.moe_every > 0

    def init_state(self, rng):
        params = lm_init(seeded_generator(rng, self.seed), self.cfg, self.device)
        params = load_lm_weights(params, self.weights_path)
        params = quantize_lm_params(params) if self.cfg.quant == "int8" else params
        return self.shard_state(params)

    def shard_state(self, params):
        """A whole params tree (one device's, or ``convert.params_from_jax``
        of the reference unit's gathered state) laid out over the unit's
        mesh; unchanged without one."""
        return params if self.mesh is None else shard_params(params, self.mesh)

    def predict(self, state, X):
        return lm_apply(state, X, self.cfg, use_flash=self.use_flash)

