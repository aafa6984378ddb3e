"""Autoregressive greedy decoding with a KV cache — the port's counterpart
of the static per-request path of ``seldon_core_tpu/models/generate.py``.

``TransformerGenerator`` is a MODEL unit: prompt token rows in, generated
token rows out, over the same REST data plane as every other model.  Its
``predict`` runs ``generate``:

  * prefill: one forward over the prompt fills a MAIN cache
    ``[B, KV, S, hd]`` per layer (grouped heads); its causal attention is
    the flash-attention forward (``models/transformer.py:_attention``);
  * decode: the main cache is read-only, each new token's K/V go to a
    chunk buffer, and attention softmaxes over the concatenated scores of
    both tiers (``_attend_two_tier``), as the JAX package does;
  * generations longer than ``GEN_CHUNK_CAP`` fold each full chunk into
    main (``merge_chunk``) between chunks.

Where the JAX package rebuilds a buffer (``dynamic_update_slice`` inside a
jitted scan), the port writes it in place: the prefill writes K/V into the
cache by slice assignment, a decode step writes its slot of the chunk
buffer, and ``merge_chunk`` copies the chunk into main in place.  The
decode loop (``lax.scan`` in JAX) is a Python loop.  The JAX package's
telemetry records (TTFT, decode rate) are not ported.

Served here: greedy decoding (``temperature`` 0), float caches, no shared
prefix, seeded or trained weights (``weights_path``, loaded in
``init_state`` as the JAX unit does).  The constructor refuses, with the
ROADMAP item that will port each: ``temperature > 0`` (sampling),
``prefix_tokens`` (prefix cache), ``quant`` / ``kv_quant`` other than
"none" and ``moe_every > 0``.  The continuous-batching lane, speculative
decoding and the paged KV pool are later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from seldon_core_tpu_torch.device import DeviceLike, parse_dtype, resolve_device
from seldon_core_tpu_torch.graph.units import Unit, register_unit
from seldon_core_tpu_torch.models.transformer import (
    LMConfig,
    _attention,
    _ffn,
    _rmsnorm,
    apply_rope,
    heads,
    lm_init,
    load_lm_weights,
    refuse_unported,
    resolve_flash,
    seeded_generator,
)
from seldon_core_tpu_torch.ops.quant import lm_matmul

__all__ = ["init_cache", "init_chunk", "prefill", "decode_step",
           "decode_step_two_tier", "merge_chunk", "generate", "sample_token",
           "mask_after_eos", "sanitize_prompt", "GEN_CHUNK_CAP",
           "TransformerGenerator"]

#: generation chunk-buffer capacity: generations up to this length run
#: with a prompt-sized main cache and no merges; longer ones merge the
#: chunk into main once per CAP tokens
GEN_CHUNK_CAP = 256


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed K/V ``[batch, kv_heads, max_len, hd]`` per layer in the
    model dtype, at the grouped head count, on ``device`` (default
    ``cuda``)."""
    if cfg.kv_quant != "none":
        refuse_unported(cfg)
    dev = resolve_device(device)
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {f"l{i}": {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for i in range(cfg.n_layers)}


def init_chunk(cfg: LMConfig, batch: int, cap: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Decode chunk buffer: the cache layout, named for the role."""
    return init_cache(cfg, batch, cap, device)


def sanitize_prompt(X, vocab: int):
    """Float wire rows -> int32 token ids in [0, vocab): NaN to 0, then
    clamp in float space before the cast, as the JAX package does."""
    return torch.clamp(torch.nan_to_num(X), 0, vocab - 1).to(torch.int32)


def _grouped_qk(q, cache_k):
    """q [B,H,S,hd] x cache_k [B,KV,L,hd] -> scores [B,KV,g,S,L] f32, the
    group axis folded into the row axis; f32 products of the upcast
    inputs (JAX's ``preferred_element_type=f32``)."""
    B, H, S, hd = q.shape
    KV, L = cache_k.shape[1], cache_k.shape[2]
    g = H // KV
    scale = 1.0 / (hd ** 0.5)
    s = torch.matmul(q.reshape(B, KV, g * S, hd).float(),
                     cache_k.float().transpose(-1, -2)) * scale
    return s.reshape(B, KV, g, S, L)


def _grouped_pv(p, cache_v, out_shape, out_dtype):
    """p [B,KV,g,S,L] x cache_v [B,KV,L,hd] -> [B,H,S,hd] ``out_dtype``:
    p cast to ``out_dtype`` first, the product in f32."""
    B, KV, g, S, L = p.shape
    out = torch.matmul(p.to(out_dtype).reshape(B, KV, g * S, L).float(),
                       cache_v.float()).to(out_dtype)
    return out.reshape(out_shape)


def _pv_f32(p, cache_v):
    """p [B,KV,g,S,L] x cache_v [B,KV,L,hd] -> f32 [B,KV,g*S,hd] partial
    output (un-cast, so the two tiers' partials add exactly); p is cast to
    the cache dtype first."""
    B, KV, g, S, L = p.shape
    return torch.matmul(p.to(cache_v.dtype).reshape(B, KV, g * S, L).float(),
                        cache_v.float())


def _attend_two_tier(q, main_layer, chunk_layer, n_main: int, n_chunk: int,
                     main_full: bool = False):
    """q [B,H,1,hd] over main[:n_main] + chunk[:n_chunk]: one softmax over
    the concatenated scores, partial PV products summed in f32 and
    normalised after them.  Validity masks are added (0 / -1e30); with
    ``main_full`` every main slot is valid and main is not masked."""
    sm = _grouped_qk(q, main_layer["k"])
    sc = _grouped_qk(q, chunk_layer["k"])
    C = chunk_layer["k"].shape[2]
    dev = q.device
    if not main_full:
        Lm = main_layer["k"].shape[2]
        sm = sm + torch.where(torch.arange(Lm, device=dev) < n_main, 0.0, -1e30)
    sc = sc + torch.where(torch.arange(C, device=dev) < n_chunk, 0.0, -1e30)
    m = torch.maximum(sm.amax(dim=-1), sc.amax(dim=-1))
    em = torch.exp(sm - m[..., None])
    ec = torch.exp(sc - m[..., None])
    l = em.sum(dim=-1) + ec.sum(dim=-1)  # [B,KV,g,S]
    om = _pv_f32(em, main_layer["v"])
    oc = _pv_f32(ec, chunk_layer["v"])
    B, KV, g, S = m.shape
    out = (om + oc) / l.reshape(B, KV, g * S)[..., None]
    return out.to(q.dtype).reshape(q.shape)


def _qkv(lp, x, cfg: LMConfig, start: int):
    """ln1, the qkv matmul, the head split and RoPE at global positions
    start.. -> (q, k, v), each [B, n, S, hd]."""
    B, S, D = x.shape
    hd, kv = cfg.head_dim, cfg.kv_heads
    qkv = lm_matmul(lp, "wqkv", _rmsnorm(x, lp["ln1"]), out_dtype=x.dtype)
    q, k, v = torch.split(qkv, [D, kv * hd, kv * hd], dim=-1)
    q, k, v = heads(q, B, S, cfg.n_heads, hd), heads(k, B, S, kv, hd), heads(v, B, S, kv, hd)
    if cfg.rope:
        positions = start + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    return q, k, v


def _finish_block(lp, x, a):
    """Attention output projection and the dense FFN, with residuals."""
    B, S, D = x.shape
    x = x + lm_matmul(lp, "wo", a.transpose(1, 2).reshape(B, S, D), out_dtype=x.dtype)
    return x + _ffn(lp, _rmsnorm(x, lp["ln2"]))


def _block_two_tier(lp, x, main_layer, chunk_layer, n_main: int, n_chunk: int,
                    cfg: LMConfig, main_full: bool = False):
    """One decoder block for one cached step: this token's K/V are written
    in place into chunk slot ``n_chunk`` (main is never touched), then it
    attends over main[:n_main] + chunk[:n_chunk+1].  Its global position
    is n_main + n_chunk."""
    q, k, v = _qkv(lp, x, cfg, n_main + n_chunk)
    chunk_layer["k"][:, :, n_chunk:n_chunk + 1] = k
    chunk_layer["v"][:, :, n_chunk:n_chunk + 1] = v
    a = _attend_two_tier(q, main_layer, chunk_layer, n_main, n_chunk + 1, main_full)
    return _finish_block(lp, x, a), chunk_layer


def decode_step_two_tier(params, token, main, chunk, n_main: int, n_chunk: int,
                         cfg: LMConfig, main_full: bool = False):
    """One cached step against (read-only main, growing chunk).  token [B]
    -> (logits [B, V] f32, chunk, written in place)."""
    x = params["embed"][token.long()][:, None, :]
    for i in range(cfg.n_layers):
        x, chunk[f"l{i}"] = _block_two_tier(
            params[f"l{i}"], x, main[f"l{i}"], chunk[f"l{i}"], n_main, n_chunk, cfg, main_full)
    x = _rmsnorm(x, params["ln_f"])
    return (x[:, 0, :] @ params["embed"].T).float(), chunk


def merge_chunk(main, chunk, n_main: int, cfg: LMConfig):
    """Copy a chunk buffer into the main cache at position ``n_main``, in
    place (JAX rebuilds main with a donated ``dynamic_update_slice``).
    Returns main."""
    for i in range(cfg.n_layers):
        ml, cl = main[f"l{i}"], chunk[f"l{i}"]
        C = cl["k"].shape[2]
        ml["k"][:, :, n_main:n_main + C] = cl["k"]
        ml["v"][:, :, n_main:n_main + C] = cl["v"]
    return main


def _attend_cached(q, cache_layer, n_valid: int):
    """q [B,H,1,hd] against the cache layer; positions >= n_valid masked."""
    s = _grouped_qk(q, cache_layer["k"])
    valid = torch.arange(cache_layer["k"].shape[2], device=q.device) < n_valid
    s = s.masked_fill(~valid, -1e30)
    return _grouped_pv(torch.softmax(s, dim=-1), cache_layer["v"], q.shape, q.dtype)


def _block_cached(lp, x, cache_layer, start: int, n_valid: int, cfg: LMConfig,
                  use_flash: bool = False):
    """One decoder block writing K/V into the cache at ``start`` (in place)
    and attending: S > 1 is a prefill from position 0, causal over the
    fresh K/V (the flash forward when ``use_flash`` and the shape contract
    holds); S == 1 is a cached step over cache[:n_valid]."""
    S = x.shape[1]
    q, k, v = _qkv(lp, x, cfg, start)
    cache_layer["k"][:, :, start:start + S] = k
    cache_layer["v"][:, :, start:start + S] = v
    if S > 1:
        a = _attention(q, k, v, causal=True, use_flash=use_flash)
    else:
        a = _attend_cached(q, cache_layer, n_valid)
    return _finish_block(lp, x, a), cache_layer


def segment_forward(params, tokens, cache, start: int, cfg: LMConfig,
                    use_flash: bool = False, last_only: bool = False):
    """Forward S tokens from position ``start`` (0: the prefill) through the
    cache, filling it; returns (logits [B, S, V] f32, or [B, 1, V] with
    ``last_only``, cache)."""
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        x, cache[f"l{i}"] = _block_cached(
            params[f"l{i}"], x, cache[f"l{i}"], start, tokens.shape[1], cfg, use_flash)
    if last_only:
        x = x[:, -1:, :]  # before the (positionwise) norm: same numerics
    x = _rmsnorm(x, params["ln_f"])
    return (x @ params["embed"].T).float(), cache


def prefill(params, tokens, cache, cfg: LMConfig, use_flash: bool = False):
    """Consume the prompt in one pass, filling the cache.
    tokens [B, S] -> (last-position logits [B, V] f32, cache)."""
    logits, cache = segment_forward(params, tokens, cache, 0, cfg, use_flash, last_only=True)
    return logits[:, -1, :], cache


def decode_step(params, token, cache, pos: int, cfg: LMConfig):
    """One cached step over a single-tier cache.  token [B], pos an int ->
    (logits [B, V] f32, cache)."""
    x = params["embed"][token.long()][:, None, :]
    for i in range(cfg.n_layers):
        x, cache[f"l{i}"] = _block_cached(params[f"l{i}"], x, cache[f"l{i}"], pos, pos + 1, cfg)
    x = _rmsnorm(x, params["ln_f"])
    return (x[:, 0, :] @ params["embed"].T).float(), cache


def _greedy_only(temperature: float) -> None:
    if temperature > 0.0:
        raise ValueError(
            f"temperature={temperature}: sampled decoding is not ported yet; "
            f"the port serves greedy decoding (ROADMAP Queue 1 item 5d)"
        )


def sample_token(logits, temperature: float = 0.0):
    """[B, V] f32 logits -> [B] int32 greedy ids.  ``torch.argmax`` returns
    the first maximal index, as ``jnp.argmax`` does, so ties break alike."""
    _greedy_only(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def mask_after_eos(toks, eos_token: int):
    """Force every position strictly after a row's first ``eos_token`` to
    eos; no-op when eos_token < 0."""
    if eos_token < 0:
        return toks
    is_eos = (toks == eos_token).to(torch.int32)
    after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
    return torch.where(after, torch.full_like(toks, eos_token), toks)


def _chunk_step(params, token, main, chunk_buf, n_main: int, used: int,
                cfg: LMConfig, n: int, temperature: float = 0.0,
                main_full: bool = False):
    """n cached greedy steps over the two-tier cache (a Python loop where
    JAX scans): main is read-only, new K/V go to chunk slots
    used..used+n-1.  Returns (tokens [B, n], (token, chunk_buf, used'))."""
    toks = []
    for _ in range(n):
        logits, chunk_buf = decode_step_two_tier(
            params, token, main, chunk_buf, n_main, used, cfg, main_full)
        token = sample_token(logits, temperature)
        toks.append(token)
        used += 1
    return torch.stack(toks, dim=1), (token, chunk_buf, used)


def generate(params, prompt, cfg: LMConfig, max_new_tokens: int = 32,
             temperature: float = 0.0, use_flash: bool = False,
             eos_token: int = -1):
    """prompt [B, S] int32 -> generated [B, max_new_tokens] int32, greedy;
    rows that emit ``eos_token`` are eos-padded afterwards.  The first
    token comes from the prefill; the chunk loop emits the rest over the
    two-tier cache, merging a full chunk into main before the next one
    when ``max_new_tokens - 1`` exceeds ``GEN_CHUNK_CAP``."""
    _greedy_only(temperature)
    B, S = prompt.shape
    dev = prompt.device
    chunked = max_new_tokens - 1 > GEN_CHUNK_CAP
    # single-chunk generations never merge, so main holds only the prompt
    main_len = S + max_new_tokens if chunked else S
    main = init_cache(cfg, B, main_len, dev)
    logits, main = prefill(params, prompt, main, cfg, use_flash)
    token = sample_token(logits, temperature)
    out = [token[:, None]]
    n_main, remaining = S, max_new_tokens - 1
    while remaining > 0:
        n = min(remaining, GEN_CHUNK_CAP) if chunked else remaining
        # only the valid prefix of main is read: no mask over unwritten slots
        valid = {li: {kk: vv[:, :, :n_main] for kk, vv in layer.items()}
                 for li, layer in main.items()}
        chunk = init_chunk(cfg, B, GEN_CHUNK_CAP if chunked else n, dev)
        toks, (token, chunk, _) = _chunk_step(
            params, token, valid, chunk, n_main, 0, cfg, n, temperature, main_full=True)
        out.append(toks)
        remaining -= n
        if remaining > 0:  # fold the finished chunk in before the next
            main = merge_chunk(main, chunk, n_main, cfg)
            n_main += n
    return mask_after_eos(torch.cat(out, dim=1), eos_token)


@register_unit("TransformerGenerator")
class TransformerGenerator(Unit):
    """Serving unit: prompt token rows in, generated token rows out
    (``[B, max_new_tokens]`` float32 token ids, no class names), registered
    under the JAX unit's name with its parameters.  Prompt values are
    truncated to int32 and clamped to [0, vocab).  Greedy decoding is a
    pure function of (weights, prompt) and each row is independent, so the
    engine's batcher may stack and pad requests."""

    pure = True
    class_names = None

    def __init__(self, vocab: int = 256, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 512, seed: int = 0,
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, eos_token: int = -1,
                 prefix_tokens: str = "",
                 dtype: str = "bfloat16", moe_every: int = 0,
                 n_experts: int = 8, moe_k: int = 2,
                 quant: str = "none", attention: str = "auto",
                 kv_quant: str = "none",
                 n_kv_heads: int = 0, weights_path: str = "",
                 rope: bool = True, rope_base: float = 10000.0,
                 device: DeviceLike = None):
        self.cfg = LMConfig(
            vocab=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
            n_layers=int(n_layers), d_ff=int(d_ff), dtype=parse_dtype(dtype),
            moe_every=int(moe_every), n_experts=int(n_experts),
            moe_k=int(moe_k), quant=str(quant), kv_quant=str(kv_quant),
            n_kv_heads=int(n_kv_heads), rope=bool(rope), rope_base=float(rope_base),
        )
        refuse_unported(self.cfg)
        _greedy_only(float(temperature))
        if str(prefix_tokens).replace(" ", "").replace(",", ""):
            raise ValueError(
                f"prefix_tokens={prefix_tokens!r}: the shared-prefix cache is not "
                f"ported yet (ROADMAP Queue 1 item 5d)"
            )
        # top_k / top_p shape sampled decoding only: greedy reads neither
        self.seed = int(seed)
        self.weights_path = str(weights_path)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = int(eos_token)
        self.device = resolve_device(device)
        self.use_flash = resolve_flash(str(attention), self.cfg, self.device)

    def init_state(self, rng: Optional[torch.Generator]):
        # the JAX unit's state also counts requests, for sampled decoding;
        # greedy decoding needs only the weights
        params = lm_init(seeded_generator(rng, self.seed), self.cfg, self.device)
        return {"params": load_lm_weights(params, self.weights_path)}

    def predict(self, state, X):
        prompt = sanitize_prompt(X, self.cfg.vocab)
        return generate(state["params"], prompt, self.cfg,
                        max_new_tokens=self.max_new_tokens,
                        use_flash=self.use_flash,
                        eos_token=self.eos_token).to(torch.float32)
