"""Speculative decoding — draft/verify generation, exact under greedy: the
port's counterpart of ``seldon_core_tpu/models/speculative.py``.

A small draft LM proposes ``k`` tokens with its own KV cache; the target
LM scores all ``k+1`` positions in one forward; the longest prefix where
the draft matched the target's argmax is accepted, plus one corrected
token.  Greedy acceptance is exact in exact arithmetic: the output equals
greedy decoding of the target token for token (the f32 tests pin it).  In
bf16 an argmax near-tie can flip between the one-token draft forward and
the (k+1)-token verify (their sums run in other orders): same-quality
tokens, not errors.

``speculative_generate`` keeps the reference's layout for a shared batch:
every round writes its k+1 candidate K/V at the same cache slots
``S + r*(k+1)..`` for every row (a slice assignment, never a per-row
scatter); rejected candidates leave holes that a per-row validity bitmap
masks out of every later attention (an additive -1e30), and RoPE rotates
by per-row logical positions (``apply_rope`` takes [B, S] positions), so
the math over the valid slots is greedy decoding of the target.  Caches
are sized ``S + R*(k+1)``, R = max_new_tokens - 1 rounds at worst, or
``max_rounds`` (rows still decoding when the rounds run out get
zero-padded tails).  The round loop is a host loop (``lax.while_loop``
in the reference) that reads back one flag a round: whether any row still
decodes.  Its attention is the plain one, as in the reference (no kernel
takes a bitmap mask).

``SpeculativeGenerator`` is the serving unit (the reference's name and
parameters; the draft's dims default to a quarter of the width and half
the depth, dtype float32).  On CUDA it asks the paged decode kernel for
its draft's shape and refuses one the kernel cannot take (the kernel takes
bfloat16 on the tensor cores and float32 by f32 FMAs, not float16), so no
draft step runs the plain path on the card.
The engine serves it by the continuous lane (``continuous_spec``:
``runtime/genserver.py`` in speculative mode, whose rounds are
``models/generate.py:paged_spec_round``, the draft's steps through the
``flash_decode_paged`` kernel) unless ``SELDON_TPU_GEN_CONTINUOUS=0``,
and then ``predict`` runs ``speculative_generate``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from seldon_core_tpu_torch.device import DeviceLike, parse_dtype, resolve_device
from seldon_core_tpu_torch.graph.units import Unit, register_unit
from seldon_core_tpu_torch.models.generate import (
    _finish_block,
    _qkv,
    init_cache,
    sanitize_prompt,
    segment_forward,
)
from seldon_core_tpu_torch.models.transformer import (
    LMConfig,
    _rmsnorm,
    lm_init,
    seeded_generator,
)
from seldon_core_tpu_torch.ops.flash_decode import paged_kernel_shape_error

__all__ = ["speculative_generate", "SpeculativeGenerator"]

def _attend_masked(q, k, v, mask_add):
    """q [B, H, W, hd] over a cache k/v [B, KV, L, hd] with an additive mask
    [B, W, L] (``_grouped_qk`` / ``_grouped_pv``'s arithmetic): f32 scores
    of the inputs times 1/sqrt(hd), the mask added, a softmax, p cast to
    q's dtype before an f32 PV product, o in q's dtype."""
    B, H, W, hd = q.shape
    KV, L = k.shape[1], k.shape[2]
    g = H // KV
    s = torch.matmul(q.reshape(B, KV, g * W, hd).float(), k.float().transpose(-1, -2))
    s = (s * (1.0 / (hd ** 0.5))).reshape(B, KV, g, W, L) + mask_add[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(q.dtype).reshape(B, KV, g * W, L).float(), v.float())
    return out.to(q.dtype).reshape(B, H, W, hd)


def _forward_seg(params, tokens, cache, off: int, pos0, valid, cfg: LMConfig):
    """The bitmap-masked segment forward of the shared round loop
    (``speculative.py:66``).  tokens [B, W] at per-row logical positions
    pos0[:, None] + arange(W); their K/V go to cache slots off..off+W-1 (the
    same for every row), in place.  Query i of a row sees the slots its
    ``valid`` [B, L] bitmap allows and the segment's slots off+j, j <= i.
    Returns (logits [B, W, V] f32, cache)."""
    B, W = tokens.shape
    L = cache["l0"]["k"].shape[2]
    dev = tokens.device
    lidx = torch.arange(L, device=dev)
    seg = (lidx >= off) & (lidx < off + W)                                   # [L]
    incause = (lidx - off)[None, :] <= torch.arange(W, device=dev)[:, None]  # [W, L]
    allowed = torch.where(seg[None, None, :], incause[None], valid[:, None, :])  # [B, W, L]
    mask_add = torch.where(allowed, 0.0, -1e30).float()
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        lp, cl = params[f"l{i}"], cache[f"l{i}"]
        q, k, v = _qkv(lp, x, cfg, pos0[:, None])
        cl["k"][:, :, off:off + W] = k
        cl["v"][:, :, off:off + W] = v
        x = _finish_block(lp, x, _attend_masked(q, cl["k"], cl["v"], mask_add), cfg)
    x = _rmsnorm(x, params["ln_f"])
    return (x @ params["embed"].T).float(), cache


def speculative_generate(target_params, draft_params, prompt, target_cfg: LMConfig,
                         draft_cfg: LMConfig, max_new_tokens: int = 32, k: int = 4,
                         max_rounds: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompt [B, S] int32 -> (tokens [B, max_new_tokens] int32, rounds [B]
    int32: the verify passes each row used).  Greedy; each row equals
    greedy decoding of the target.  Caches hold ``S + R*(k+1)`` slots, R =
    max_new_tokens - 1, capped by ``max_rounds`` > 0 (rows still decoding
    when the rounds run out get zero-padded tails)."""
    if target_cfg.kv_quant == "int8" or draft_cfg.kv_quant == "int8":
        raise NotImplementedError(
            "speculative decoding runs float KV caches; quantize weights "
            "(quant='int8'), not the cache")
    B, S = prompt.shape
    dev = prompt.device
    W = k + 1
    R = max(max_new_tokens - 1, 1)  # worst case: one token gained a round
    if max_rounds > 0:
        R = min(R, int(max_rounds))
    Lmax = S + R * W
    t_cache = init_cache(target_cfg, B, Lmax, dev)
    d_cache = init_cache(draft_cfg, B, Lmax, dev)
    # both models prefill the prompt; the target's last position gives the first token
    t_logits, t_cache = segment_forward(target_params, prompt, t_cache, 0, target_cfg,
                                        segment=False, last_only=True)
    _, d_cache = segment_forward(draft_params, prompt, d_cache, 0, draft_cfg, segment=False,
                                 last_only=True)
    first = torch.argmax(t_logits[:, -1, :], dim=-1).to(torch.int32)
    if max_new_tokens == 1:
        return first[:, None], torch.zeros(B, dtype=torch.int32, device=dev)

    t_valid = (torch.arange(Lmax, device=dev) < S)[None, :].repeat(B, 1)
    d_valid = t_valid.clone()
    toks_rounds = torch.zeros(B, R, W, dtype=torch.int32, device=dev)
    gained_rounds = torch.zeros(B, R, dtype=torch.int32, device=dev)
    n = torch.ones(B, dtype=torch.int32, device=dev)
    rounds_used = torch.zeros(B, dtype=torch.int32, device=dev)
    last = first
    arange_w = torch.arange(W, device=dev)
    r = 0
    while r < R and bool((n < max_new_tokens).any()):
        off = S + r * W
        pos = S + n - 1  # the logical position of `last`, per row
        # every row drafts k tokens in k+1 one-token forwards; the extra
        # step writes the last proposal's K/V, so a fully accepted round
        # leaves no hole.  Earlier in-round slots are visible through the
        # provisional bitmap dv
        dv, tok, seg = d_valid.clone(), last, []
        for i in range(W):
            logits, d_cache = _forward_seg(draft_params, tok[:, None], d_cache, off + i,
                                           pos + i, dv, draft_cfg)
            dv[:, off + i] = True
            seg.append(tok)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        seg_toks = torch.stack(seg, dim=1)  # [B, W]: the tokens fed, [last, d1..dk]
        draft_toks = seg_toks[:, 1:]
        # one (k+1)-wide target pass verifies every row
        t_logits, t_cache = _forward_seg(target_params, seg_toks, t_cache, off, pos, t_valid,
                                         target_cfg)
        t_argmax = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [B, W]
        # greedy acceptance: the longest prefix where draft == target argmax
        mismatch = torch.cat([draft_toks != t_argmax[:, :k],
                              torch.ones(B, 1, dtype=torch.bool, device=dev)], dim=1)
        a = torch.argmax(mismatch.to(torch.int32), dim=1)  # the first mismatch; k if none
        corrected = torch.gather(t_argmax, 1, a[:, None])[:, 0]
        padded = torch.cat([draft_toks, torch.zeros(B, 1, dtype=torch.int32, device=dev)], dim=1)
        new_toks = torch.where(arange_w[None, :] < a[:, None], padded, corrected[:, None])
        active = n < max_new_tokens
        gained = torch.where(active, a + 1, 0).to(torch.int32)
        toks_rounds[:, r] = new_toks
        gained_rounds[:, r] = gained
        # confirmed slots: off (last, forwarded here for the first time) ..
        # off + a; the rejected tail stays a hole
        vmask = (arange_w[None, :] <= a[:, None]) & active[:, None]
        t_valid[:, off:off + W] = vmask
        d_valid[:, off:off + W] = vmask
        last = torch.where(active, corrected, last)
        n = n + gained
        rounds_used = rounds_used + active.to(torch.int32)
        r += 1

    # the round-aligned tokens compacted into dense rows: the one scatter
    flat = toks_rounds.reshape(B, R * W)
    keep = (arange_w[None, None, :] < gained_rounds[:, :, None]).reshape(B, R * W)
    dest = torch.cumsum(keep.to(torch.int64), dim=1)  # kept token j -> output index 1..
    pad = max_new_tokens + W  # clipped rows' overflow lands past the end
    dest = torch.where(keep, torch.clamp(dest, max=pad), pad)
    out = torch.zeros(B, pad + 1, dtype=torch.int32, device=dev)
    out[:, 0] = first
    out.scatter_(1, dest, torch.where(keep, flat, 0).to(torch.int32))
    return out[:, :max_new_tokens], rounds_used


@register_unit("SpeculativeGenerator")
class SpeculativeGenerator(Unit):
    """Serving unit: speculative draft/verify generation over the standard
    data plane, registered under the JAX unit's name with its parameters.
    Per-row outputs are independent of the rows batched with them, so
    concurrent callers coalesce like any other unit's.

    Memory: round-aligned cache slots size both caches of
    ``speculative_generate`` at ``S + (max_new_tokens - 1) * (k + 1)``
    slots; ``max_rounds`` caps it by an expected-acceptance bound."""

    pure = True

    def __init__(self, vocab: int = 256, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 512,
                 draft_d_model: int = 0, draft_n_heads: int = 0,
                 draft_n_layers: int = 0, draft_d_ff: int = 0,
                 seed: int = 0, max_new_tokens: int = 32, k: int = 4,
                 max_rounds: int = 0, dtype: str = "float32", rope: bool = True,
                 rope_base: float = 10000.0, device: DeviceLike = None):
        dt = parse_dtype(dtype)
        rope = bool(rope)
        self.target_cfg = LMConfig(
            vocab=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
            n_layers=int(n_layers), d_ff=int(d_ff), dtype=dt,
            rope=rope, rope_base=float(rope_base),
        )
        dd = int(draft_d_model) or max(16, int(d_model) // 4)
        dh = int(draft_n_heads) or max(2, int(n_heads) // 2)
        # derived defaults must keep hd integral, and even under RoPE
        while dd % dh != 0 or (rope and (dd // dh) % 2 != 0):
            if dh <= 1:
                raise ValueError(
                    f"cannot derive a draft head count for d_model={dd} "
                    f"with rope={rope}; set draft_n_heads explicitly"
                )
            dh -= 1
        self.draft_cfg = LMConfig(
            vocab=int(vocab), d_model=dd, n_heads=dh,
            n_layers=int(draft_n_layers) or max(1, int(n_layers) // 2),
            d_ff=int(draft_d_ff) or max(32, int(d_ff) // 4),
            dtype=dt, rope=rope, rope_base=float(rope_base),
        )
        self.seed = int(seed)
        self.max_new_tokens = int(max_new_tokens)
        self.k = int(k)
        self.max_rounds = int(max_rounds)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every draft step of the continuous lane is a flash_decode_paged
            # launch: a draft it cannot take is refused here, never served
            # by the plain path on the card (the kernel takes bfloat16 and
            # float32)
            why = paged_kernel_shape_error(self.draft_cfg.head_dim, dt, 1)
            if why is not None:
                raise ValueError(f"SpeculativeGenerator on {self.device}: {why}")

    def init_state(self, rng):
        g = seeded_generator(rng, self.seed)
        return {"target": lm_init(g, self.target_cfg, self.device),
                "draft": lm_init(g, self.draft_cfg, self.device)}

    def continuous_spec(self, state):
        """The continuous lane's contract (``runtime/genserver.py``): the
        draft's params and config put the scheduler in speculative mode;
        greedy and float pools, as ``speculative_generate``.  The kernels
        always: on CUDA the constructor has checked the draft's shape, on
        the CPU the wrappers run their plain versions."""
        return {"params": state["target"], "cfg": self.target_cfg, "temperature": 0.0,
                "top_k": 0, "top_p": 0.0, "eos_token": -1,
                "max_new_tokens": self.max_new_tokens, "draft_params": state["draft"],
                "draft_cfg": self.draft_cfg, "spec_k": self.k, "seed": self.seed,
                "use_flash": True}

    def predict(self, state, X):
        prompt = sanitize_prompt(X, self.target_cfg.vocab)
        toks, _rounds = speculative_generate(
            state["target"], state["draft"], prompt, self.target_cfg, self.draft_cfg,
            max_new_tokens=self.max_new_tokens, k=self.k, max_rounds=self.max_rounds)
        return toks.to(torch.float32)
