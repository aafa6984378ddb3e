"""Ring attention over the ``sp`` mesh axis — the port's counterpart of
``seldon_core_tpu/parallel/ring_attention.py:35-119``.

A sequence is split over ``sp``: shard i holds positions [i*S_local,
(i+1)*S_local) of q, k and v ([B, H, S_local, D] blocks).  Each shard keeps
its Q block and the K/V blocks rotate around the ring, one shard on per
round (``parallel/mesh.py`` ``ring_shift``, the counterpart of
``lax.ppermute``, k and v moved together in one baton round), so after
``sp - 1`` rounds every shard has attended every block.  Causality across
blocks is by global position: the block a shard holds after r rounds came
from shard (i - r) mod sp.

Two paths, decided once from one block's shape (a static check; a launch
failure is never caught):

* the plain path: the reference's arithmetic, ``_block_attend`` and
  ``_merge``, in q's dtype: a block's scores masked with -1e30 by global
  position, its running max ``m``, sum ``l`` and unnormalised ``o``, rows
  wholly masked zeroed, the partials merged online and ``o / max(l,
  1e-30)`` at the end.  Autograd differentiates it op by op.
* the kernel path (``use_flash`` and the flash contract at the block's
  shape, ``shape_contract_error``: S_local % 128, D <= 256; on the card
  also the kernels' bf16): ``RingFlash``, a ``torch.autograd.Function`` over
  the shard's Q block and the K/V blocks that reached it.  Its forward
  launches ``flash_attention_fwd`` once per block that holds a position
  not in the future: causal on the diagonal block (its own), full for
  blocks from earlier positions; blocks wholly in the future contribute
  nothing and are not launched.  The partials are merged through their
  f32 log-sum-exps (``lse = logsumexp_j lse_j``, ``o = sum_j exp(lse_j -
  lse) o_j`` in f32, rounded to q's dtype once).  Its backward launches
  ``flash_attention_bwd`` once per launched block with the MERGED ``o``
  and ``lse``: the dQ kernel recomputes p = exp(s - lse) with the global
  ``lse`` and takes rowsum(dO o) from the merged ``o``, so each launch
  yields that block's exact share of dQ and its whole dK and dV.  The dQ
  shares are summed in f32.  Each block's dK/dV flows back to the shard
  that owns it through the copy edges of the run's one autograd graph
  (``mesh.py``, Autograd).  On the CPU the wrappers run their plain
  versions, so this path's arithmetic is testable there.

Memory: a shard keeps every K/V block it launched for the backward (on
the causal kernel path shard i keeps i + 1 blocks; the plain path's
autograd saves every block it saw), so O(S) a shard, not the reference's
O(S_local): the ring's O(S_local) backward, which rotates K/V and dK/dV
again, is a later change.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from seldon_core_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                       flash_attention_fwd,
                                                       shape_contract_error)
from seldon_core_tpu_torch.parallel.mesh import (DeviceMesh, axis_index, axis_size,
                                                 lead_shards, ring_shift)

__all__ = ["ring_attention", "ring_attention_sharded", "ring_uses_kernels", "RingFlash"]

_NEG_INF = -1e30


def _block_attend(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """One (Q block, K/V block) pair's online-softmax partials (m, l, o),
    ``ring_attention.py:35-51`` in q's dtype."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), device=q.device)).to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    # fully masked rows (a block wholly in the future): zero them
    p = torch.where(m[..., None] <= _NEG_INF / 2,
                    torch.zeros((), dtype=p.dtype, device=p.device), p)
    l = torch.sum(p, dim=-1)  # noqa: E741
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    """Two online-softmax partials merged (``ring_attention.py:54-61``)."""
    m = torch.maximum(m1, m2)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    a1 = torch.where(m1 <= _NEG_INF / 2, zero, torch.exp(m1 - m))
    a2 = torch.where(m2 <= _NEG_INF / 2, zero, torch.exp(m2 - m))
    l = a1 * l1 + a2 * l2  # noqa: E741
    o = a1[..., None] * o1 + a2[..., None] * o2
    return m, l, o


def _blocks(k, v, axis: str) -> List[Tuple[int, torch.Tensor, torch.Tensor]]:
    """[(owner's coordinate, k block, v block)] in ring order: the shard's
    own block, then the one each round brings (``ring_shift``)."""
    n, me = axis_size(axis), axis_index(axis)
    out = [(me, k, v)]
    kv = (k, v)
    for r in range(1, n):
        kv = ring_shift(kv, axis)
        out.append(((me - r) % n, kv[0], kv[1]))
    return out


def ring_uses_kernels(q, k, v, use_flash: bool) -> bool:
    """The static decision: the kernel path when ``use_flash`` and one
    block meets the flash contract (``shape_contract_error``)."""
    return bool(use_flash) and shape_contract_error(q, k, v) is None


class RingFlash(torch.autograd.Function):
    """The kernel path over a shard's Q block and the K/V blocks that
    reached it and are launched (module docstring); ``causals[j]`` is
    block j's ``causal``.  Blocks wholly in the future are not passed, so
    neither the forward's saved tensors nor the backward hold them."""

    @staticmethod
    def forward(ctx, q, causals: Sequence[bool], *kvs):
        os, lses = [], []
        for j, causal in enumerate(causals):
            o_j, lse_j = flash_attention_fwd(q, kvs[2 * j], kvs[2 * j + 1], causal)
            os.append(o_j)
            lses.append(lse_j)
        lse = torch.logsumexp(torch.stack(lses), dim=0) if len(lses) > 1 else lses[0]
        if len(os) == 1:
            o = os[0]
        else:
            B, H, S, D = q.shape
            acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
            for o_j, lse_j in zip(os, lses):
                acc += torch.exp(lse_j - lse).reshape(B, H, S, 1) * o_j.float()
            o = acc.to(q.dtype)
        ctx.causals = tuple(causals)
        ctx.save_for_backward(q, o, lse, *kvs)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, o, lse, *kvs = ctx.saved_tensors
        dq = None
        grads: List[torch.Tensor] = []
        for j, causal in enumerate(ctx.causals):
            dq_j, dk_j, dv_j = flash_attention_bwd(q, kvs[2 * j], kvs[2 * j + 1], o, lse, do,
                                                   causal)
            dq = dq_j.float() if dq is None else dq + dq_j.float()
            grads += [dk_j, dv_j]
        return (dq.to(q.dtype), None, *grads)


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = True,
                   use_flash: bool = False):
    """Attention over a sequence split on ``axis_name``, called inside a
    shard (``DeviceMesh.run``) with the local blocks q/k/v [B, H, S_local,
    D]; returns the local output block [B, H, S_local, D].  Outside a shard
    (or on an axis of size 1) it is one block's attention.  ``use_flash``
    asks for the kernel path (module docstring)."""
    me = axis_index(axis_name)
    blocks = _blocks(k, v, axis_name)
    if ring_uses_kernels(q, k, v, use_flash):
        # causal on the diagonal, full below it, not launched above it
        launched = [(j, kb, vb) for j, kb, vb in blocks if not causal or j <= me]
        return RingFlash.apply(q, [causal and j == me for j, _, _ in launched],
                               *[t for _, kb, vb in launched for t in (kb, vb)])
    s_local = q.shape[2]
    m = l = o = None  # noqa: E741
    for j, kb, vb in blocks:
        part = _block_attend(q, kb, vb, me * s_local, j * s_local, causal)
        m, l, o = part if m is None else _merge(m, l, o, *part)  # noqa: E741
    return o / torch.clamp(l, min=1e-30)[..., None]


def ring_attention_sharded(mesh: DeviceMesh, axis: str = "sp", causal: bool = True,
                           use_flash: Optional[bool] = None):
    """Standalone ring attention on global [B, H, S, D] q/k/v with S split
    over ``axis`` (every other mesh axis replicated); returns the global
    output on the mesh's first device, differentiable.  ``use_flash=None``
    takes the kernel path for bf16 inputs whose block meets the contract."""
    n = mesh.shape[axis]

    def fn(q, k, v):
        S = q.shape[2]
        if S % n:
            raise ValueError(f"sequence of {S} positions not divisible over {axis!r} of size {n}")
        w = S // n
        flash = q.dtype == torch.bfloat16 if use_flash is None else use_flash

        def body(shard):
            c = shard.coords[axis]
            qs, ks, vs = (t[:, :, c * w:(c + 1) * w].to(shard.device) for t in (q, k, v))
            return ring_attention(qs, ks, vs, axis, causal, flash)

        outs = mesh.run(body)
        dev = mesh.device_list[0]
        return torch.cat([outs[i].to(dev) for i in lead_shards(mesh, (axis,))], dim=2)

    return fn
