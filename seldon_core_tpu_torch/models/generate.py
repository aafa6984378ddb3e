"""Autoregressive decoding with a KV cache — the port's counterpart of the
static per-request path, the stream and the paged programs of
``seldon_core_tpu/models/generate.py``.

``TransformerGenerator`` is a MODEL unit: prompt token rows in, generated
token rows out, over the same REST data plane as every other model.  Its
``predict`` runs ``generate``:

  * prefill: one forward over the prompt fills a MAIN cache
    ``[B, KV, S, hd]`` per layer (grouped heads); its causal attention is
    the flash-attention forward (``models/transformer.py:_attention``);
  * decode: the main cache is read-only, each new token's K/V go to a
    chunk buffer, and attention softmaxes over both tiers at once
    (``_attend_two_tier``), as the JAX package does.  With ``use_flash``
    each layer of each step writes its slot and attends in one launch of
    the ``flash_decode_two_tier`` kernel (``ops/csrc/flash_decode.cu``,
    the step's K/V write fused in), which reads the bf16 caches at their
    stored size; without it, the slot's slice assignment and the plain
    attention.  The choice is static; a launch failure is never caught;
  * generations longer than ``GEN_CHUNK_CAP`` fold each full chunk into
    main (``merge_chunk``) between chunks.

Over a device mesh (``TransformerGenerator(mesh=)``, a binding's
``mesh_axes``) the params are a ``ShardedTree`` laid out by the
reference's tp layout (``models/transformer.py`` ``param_shardings``), and
``prefill``, ``generate``, ``stream_chunks`` and the paged programs below
run once per shard (``parallel/mesh.py`` ``spmd``): each shard holds its
heads' caches or pool blocks on its own device and launches the same
kernels at its shape; shard 0's answer is returned.  Where a shard's query
heads read their kv heads in unequal groups (a ``tp`` that neither divides
nor is a multiple of the kv heads, ``LMConfig.kv_runs``) every attention
call, two-tier, cached or paged, is one call a run of one group size
(``models/transformer.py`` ``per_run``), each kernel launched at that
run's uniform group on views of the run's kv heads.  Over a mesh that
spans processes (``parallel/multihost.py``) every process runs its own
shards of the static lane (dense or MoE, its experts over ``ep``) and
returns its first shard's answer, the same bits on each; the continuous
lane refuses such a mesh.

``stream_chunks`` (and the unit's ``stream_tokens``, which the engine's
SSE route drives) yields the same tokens chunk by chunk: the same decode
steps, a ``STREAM_CHUNK_CAP``-slot chunk buffer that ``grow_merge`` folds
into main when it fills, and the after-eos latch on the device
(``_chunk_eos_mask``).

Sampling (``sample_token``): greedy at ``temperature <= 0``; otherwise
the reference's truncation (``top_k`` as a threshold at the k-th largest
logit, ``top_p`` as the nucleus cut of the sorted softmax) and JAX's
categorical draw, ``argmax(logits + gumbel)``.  The Gumbel noise comes
from ``models/prng.py``, a counter-based generator keyed by integers
(its bits differ from ``jax.random``'s by design): one key per request,
``fold_in(key(seed), requests)``, split once a step, as the reference
threads its key; the continuous lane carries one key per sequence.

The shared prefix (``prefix_tokens``): ``init_state`` prefills the prefix
once at B=1; a request then prefills only its suffix, as a causal segment
at global offset P over the broadcast prefix (``build_prefix_main``,
``segment_forward(segment=True)``, the plain attention: the flash forward
has no mid-sequence causal mask, as in the reference), and decodes over
the P + S main cache through ``flash_decode_two_tier``.

Where the JAX package rebuilds a buffer (``dynamic_update_slice`` inside a
jitted scan), the port writes it in place: the prefill writes K/V into the
cache by slice assignment, a decode step writes its slot of the chunk
buffer, and ``merge_chunk`` copies the chunk into main in place.  The
decode loop (``lax.scan`` in JAX) is a Python loop.  The JAX package's
telemetry (TTFT, decode rate, the flight recorder) is not ported.

Served here: greedy and sampled decoding, the shared prefix, float and
int8 caches, seeded or trained weights (``weights_path``, loaded in
``init_state`` as the JAX unit does), dense or int8 weights (``quant``:
``quantize_lm_params`` after the load, served through ``dequant_matmul``),
dense or MoE layers (``moe_every``: ``_finish_block`` takes the MoE FFN
over each call's B*S tokens, so a prefill, a prefix's own prefill in
``init_state``, a suffix segment and each cached step of B rows each set
their own capacity, as the reference's).  An MoE generator is
``batch_coupled`` and has no ``continuous_spec``: it serves on the static
lane.  Speculative decoding is ``models/speculative.py``.

The int8 K/V cache (``kv_quant="int8"``, the reference's
``generate.py:133-447``): a layer holds int8 ``k``/``v`` and f32 scale
planes ``k_s``/``v_s`` [B, KV, L], one scale per position and kv head
(``_quantize_kv``: ``kv_write.quantize_kv``).  The prefill attends the
exact K/V and stores them quantized; a decode step's K/V are quantized
into the chunk slot and attended as codes times scales, its own row too;
the merges, the stream's ``grow_merge`` and the prefix's
``build_prefix_main`` carry the scales.  With ``use_flash`` each step is
one launch of ``flash_decode_two_tier``'s int8-K/V variant, which
quantizes in its launch.

The paged KV pool of the continuous lane (``runtime/genserver.py``; the
reference's ``generate.py:985-1351``): a per-layer pool of fixed-size
blocks, block 0 the scratch block, and a block table per row.

  * ``init_block_pool`` makes the pools (int8 pools with scale planes
    ``[num_blocks, KV, block_size]`` f32, where the reference has
    ``[num_blocks, block_size, KV]``; ``paged_scale_view`` gives its
    views).  The port lays
    a pool out as ``[num_blocks, KV, block_size, hd]``, where the
    reference has ``[num_blocks, block_size, KV, hd]``: one kv head's rows
    of a block are then one contiguous run (2 KB at bs 16, hd 64, bf16),
    which the paged flash-decode kernel's ring reads as one TMA box.
    ``_paged_view`` gives the reference's dense views, so the tests
    compare views (and transposed pools), not raw pool bytes;
  * ``_paged_write`` scatters fresh K/V at per-row positions ``start[b] +
    i`` (the reference takes the positions [B, W] themselves; every
    caller's are start + i), ``_paged_view`` gathers a row's blocks,
    ``_attend_paged`` attends with per-row starts, ``_paged_block`` is a
    decoder block over the pool;
  * ``paged_forward``: W tokens a row at per-row offsets (the chunked
    prefill and the speculative verify), ``last_only`` for the next-token
    logits;
  * ``paged_decode_round``: ``span`` steps for the whole in-flight batch
    with static shapes: ``token``, ``n_valid``, ``active``, ``seen_eos``
    and the per-row sampling ``keys`` stay device tensors across the
    steps (a Python loop where the reference scans) and the loop makes no
    host sync; the caller reads back the round's [B, span] tokens once;
  * ``paged_spec_round``: k + 1 draft steps, one (k + 1)-wide target
    verify and greedy acceptance;
  * ``paged_write_prefix_blocks`` / ``paged_write_prefix_tail``: the
    shared prefix's full blocks (once, pinned by the scheduler) and its
    tail (into each sequence's first private block), each one
    ``kv_write_paged`` launch a layer with ``use_flash``.

With ``use_flash`` a W = 1 block (every decode step and draft step)
writes and attends in one ``flash_decode_paged`` call, the write fused
into the attention's launch; there an inactive row writes nothing, where
the reference sends its write to the scratch block 0, so the pools differ
from the reference's only in block 0, which no active row reads.  A
W > 1 block (the prefill tick, the verify) writes through
``kv_write_paged`` and attends through the plain ``_attend_paged``, as the
reference does (neither package has a kernel there).  On CUDA the
wrappers launch their kernels, on the CPU they run their plain versions.
The pools are written in place, where the reference donates them through
each jitted program.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, parse_dtype, resolve_device
from seldon_core_tpu_torch.graph.units import Unit, UnitAux, register_unit
from seldon_core_tpu_torch.models import prng
from seldon_core_tpu_torch.models.transformer import (
    LMConfig,
    _attention,
    _ffn,
    _rmsnorm,
    apply_rope,
    attn_out,
    check_mesh,
    heads,
    lm_init,
    per_run,
    load_lm_weights,
    resolve_flash,
    resolve_paged_flash,
    seeded_generator,
    shard_kv_heads,
    shard_params,
    split_qkv,
)
from seldon_core_tpu_torch.parallel.mesh import DeviceMesh, ShardedTree, spmd, spmd_stream
from seldon_core_tpu_torch.ops.flash_decode import (
    attend_paged,
    flash_decode_paged,
    flash_decode_reference,
    flash_decode_two_tier,
    flash_decode_two_tier_reference,
    paged_scale_view,
    paged_view,
)
from seldon_core_tpu_torch.ops.kv_write import (
    kv_write_paged,
    kv_write_paged_reference,
    kv_write_reference,
    quantize_kv as _quantize_kv,
)
from seldon_core_tpu_torch.ops.quant import lm_matmul, quantize_lm_params

__all__ = ["init_cache", "init_chunk", "prefill", "decode_step",
           "decode_step_two_tier", "merge_chunk", "generate", "sample_token",
           "truncate_logits", "mask_after_eos", "sanitize_prompt", "grow_merge",
           "stream_chunks", "build_prefix_main", "segment_forward",
           "init_block_pool", "paged_forward", "paged_decode_round",
           "paged_spec_round", "paged_write_prefix_blocks", "paged_write_prefix_tail",
           "GEN_CHUNK_CAP", "STREAM_CHUNK_CAP", "TransformerGenerator"]

_stream_counter = itertools.count()  # the process's sampled-stream key source

#: generation chunk-buffer capacity: generations up to this length run
#: with a prompt-sized main cache and no merges; longer ones merge the
#: chunk into main once per CAP tokens
GEN_CHUNK_CAP = 256
#: stream chunk-buffer capacity: slots between ``grow_merge``s
STREAM_CHUNK_CAP = 128


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed K/V ``[batch, kv_heads, max_len, hd]`` per layer in the
    model dtype, at the grouped head count, on ``device`` (default
    ``cuda``); with ``kv_quant="int8"`` int8 K/V and f32 scale planes
    ``k_s``/``v_s`` ``[batch, kv_heads, max_len]``."""
    dev = resolve_device(device)
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    if cfg.kv_quant == "int8":
        return {f"l{i}": {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                          "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                          "k_s": torch.zeros(shape[:3], device=dev),
                          "v_s": torch.zeros(shape[:3], device=dev)}
                for i in range(cfg.n_layers)}
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


def _grouped(q, kv_heads: int):
    """q [B, H, 1, hd] -> [B, KV, G, hd]: the group's query heads folded
    onto rows (a view), the layout of the decode kernel."""
    B, H, _, hd = q.shape
    return q.reshape(B, kv_heads, H // kv_heads, hd)


def _scales(layer):
    """An int8 layer's (k_s, v_s), or None for a float one."""
    return (layer["k_s"], layer["v_s"]) if "k_s" in layer else None


def _attend_two_tier(q, main_layer, chunk_layer, n_main: int, n_chunk: int,
                     use_flash: bool = False, k_new=None, v_new=None):
    """q [B,H,1,hd] over main[:n_main] + chunk[:n_chunk]: one softmax over
    both tiers (``_attend_two_tier``'s arithmetic); main is masked only
    where n_main is short of its length.  With ``k_new``/``v_new`` [B, KV,
    1, hd] the step's K/V first go into the slot of position n_main +
    n_chunk - 1 (the chunk's last, or main's when the chunk is empty).
    ``use_flash`` takes ``flash_decode_two_tier`` (the kernel for CUDA
    tensors: one launch, the write fused in), else its plain version (the
    slot's slice assignment, then the plain attention).  Int8 layers pass
    their scale planes: the write quantizes, the attention scales."""
    attend = flash_decode_two_tier if use_flash else flash_decode_two_tier_reference
    ms = _scales(main_layer)
    out = attend(_grouped(q, main_layer["k"].shape[1]), main_layer["k"], main_layer["v"],
                 n_main, chunk_layer["k"], chunk_layer["v"], n_chunk, k_new, v_new,
                 None if ms is None else ms + _scales(chunk_layer))
    return out.reshape(q.shape)


def _attend_cached(q, cache_layer, n_valid: int, use_flash: bool = False, k_new=None,
                   v_new=None):
    """q [B,H,1,hd] against the cache layer; positions >= n_valid masked.
    With ``k_new``/``v_new`` the step's K/V first go into slot n_valid - 1.
    ``use_flash`` takes ``flash_decode_two_tier`` over cache[:n_valid] and
    an empty chunk, the write fused in (the kernel for CUDA tensors, at any
    cache length: the L % 128 rule is ``flash_decode``'s, for JAX parity
    only), else the slot's slice assignment and the plain version
    (``_attend_cached``'s arithmetic)."""
    qg = _grouped(q, cache_layer["k"].shape[1])
    k, v = cache_layer["k"], cache_layer["v"]
    sc = _scales(cache_layer)
    if use_flash:
        out = flash_decode_two_tier(qg, k, v, n_valid, k[:, :, :0], v[:, :, :0], 0, k_new, v_new,
                                    None if sc is None else sc + (sc[0][:, :, :0], sc[1][:, :, :0]))
    else:
        if k_new is not None:
            kv_write_reference(k, v, k_new, v_new, n_valid - 1, sc)
        out = flash_decode_reference(qg, k, v, n_valid, *(sc or ()))
    return out.reshape(q.shape)


def _qkv(lp, x, cfg: LMConfig, start):
    """ln1, the qkv matmul, the head split and RoPE at global positions
    start.. (an int, or a [B, 1] tensor of per-row starts) -> (q, k, v),
    each [B, n, S, hd]."""
    B, S, _ = x.shape
    hd, kv = cfg.head_dim, cfg.kv_heads
    qkv = lm_matmul(lp, "wqkv", _rmsnorm(x, lp["ln1"]), out_dtype=x.dtype)
    q, k, v = split_qkv(qkv, cfg)
    q, k, v = heads(q, B, S, cfg.n_heads, hd), heads(k, B, S, kv, hd), heads(v, B, S, kv, hd)
    if cfg.rope:
        positions = start + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    return q, k, v


def _finish_block(lp, x, a, cfg: LMConfig):
    """Attention output projection and the FFN (dense, or MoE over this
    call's B*S tokens: the capacity is set by them), with residuals; the
    load-balance loss is dropped, as the reference's serving paths drop it.
    On a tp shard both products are summed over ``tp`` (``attn_out``,
    ``_ffn``)."""
    B, S, _ = x.shape
    x = attn_out(lp, x, a.transpose(1, 2).reshape(B, S, -1))
    return x + _ffn(lp, _rmsnorm(x, lp["ln2"]), cfg)[0]


def _block_two_tier(lp, x, main_layer, chunk_layer, n_main: int, n_chunk: int,
                    cfg: LMConfig, use_flash: bool = False):
    """One decoder block for one cached step: this token's K/V are written
    in place into chunk slot ``n_chunk`` (main is never touched), and it
    attends over main[:n_main] + chunk[:n_chunk+1].  Its global position
    is n_main + n_chunk.  ``use_flash`` takes the decode kernel, write and
    attention in one launch."""
    q, k, v = _qkv(lp, x, cfg, n_main + n_chunk)
    a = per_run(cfg, lambda q, m, c, k, v: _attend_two_tier(q, m, c, n_main, n_chunk + 1,
                                                            use_flash, k, v),
                q, main_layer, chunk_layer, k, v)
    return _finish_block(lp, x, a, cfg), chunk_layer


def decode_step_two_tier(params, token, main, chunk, n_main: int, n_chunk: int,
                         cfg: LMConfig, use_flash: bool = False):
    """One cached step against (read-only main[:n_main], growing chunk).
    token [B] -> (logits [B, V] f32, chunk, written in place).  With
    ``use_flash`` each layer makes one ``flash_decode_two_tier`` launch
    (write and attention), else the slot's slice assignment and the plain
    attention."""
    x = params["embed"][token.long()][:, None, :]
    for i in range(cfg.n_layers):
        x, chunk[f"l{i}"] = _block_two_tier(
            params[f"l{i}"], x, main[f"l{i}"], chunk[f"l{i}"], n_main, n_chunk, cfg, use_flash)
    x = _rmsnorm(x, params["ln_f"])
    return (x[:, 0, :] @ params["embed"].T).float(), chunk


def merge_chunk(main, chunk, n_main: int, cfg: LMConfig):
    """Copy a chunk buffer into the main cache at position ``n_main``, in
    place (JAX rebuilds main with a donated ``dynamic_update_slice``), the
    scale planes of an int8 cache too.  Returns main."""
    for i in range(cfg.n_layers):
        ml, cl = main[f"l{i}"], chunk[f"l{i}"]
        C = cl["k"].shape[2]
        for kk in ml:
            ml[kk][:, :, n_main:n_main + C] = cl[kk]
    return main


def _attend_cached_causal(q, cache_layer, start: int):
    """q [B,H,S,hd] for global positions start..start+S-1 over the whole
    cache: query i sees positions <= start + i (``_attend_cached_causal``,
    ``generate.py:387``: the prefix's suffix segment).  The plain attention
    of the paged pool's views, with one start for every row (and an int8
    cache's scales)."""
    starts = torch.full((q.shape[0],), int(start), dtype=torch.int32, device=q.device)
    return attend_paged(q, cache_layer["k"], cache_layer["v"], starts,
                        *(_scales(cache_layer) or ()))


def _block_cached(lp, x, cache_layer, start: int, n_valid: int, cfg: LMConfig,
                  use_flash: bool = False, segment: bool = False):
    """One decoder block writing K/V into the cache at ``start`` (in place)
    and attending.  ``segment``: a mid-sequence causal segment at global
    offset ``start`` over the whole cache (the plain attention, with or
    without ``use_flash``: the flash forward has no mid-sequence mask);
    else S > 1 is a prefill from position 0, causal over the fresh K/V (the
    flash forward when ``use_flash`` and the shape contract holds), and
    S == 1 a cached step over cache[:n_valid], whose K/V go to slot
    ``start`` = n_valid - 1 (one ``flash_decode_two_tier`` launch, the
    write fused in, when ``use_flash``).  An int8 cache stores the K/V
    quantized with their scales; the prefill still attends the exact K/V,
    a segment and a step the stored codes."""
    S = x.shape[1]
    q, k, v = _qkv(lp, x, cfg, start)
    if segment or S > 1:
        if "k_s" in cache_layer:
            (kw, k_s), (vw, v_s) = _quantize_kv(k), _quantize_kv(v)
            cache_layer["k_s"][:, :, start:start + S] = k_s
            cache_layer["v_s"][:, :, start:start + S] = v_s
        else:
            kw, vw = k, v
        cache_layer["k"][:, :, start:start + S] = kw
        cache_layer["v"][:, :, start:start + S] = vw
    if segment:
        a = per_run(cfg, lambda q, c: _attend_cached_causal(q, c, start), q, cache_layer)
    elif S > 1:
        a = per_run(cfg, lambda q, k, v: _attention(q, k, v, causal=True, use_flash=use_flash),
                    q, k, v)
    else:
        a = per_run(cfg, lambda q, c, k, v: _attend_cached(q, c, n_valid, use_flash, k, v),
                    q, cache_layer, k, v)
    return _finish_block(lp, x, a, cfg), cache_layer


def segment_forward(params, tokens, cache, start: int, cfg: LMConfig,
                    use_flash: bool = False, segment: bool = True, last_only: bool = False):
    """Forward S tokens at global positions start.. through the cache,
    filling it; returns (logits [B, S, V] f32, or [B, 1, V] with
    ``last_only``, cache).  ``segment=False`` is the prefill (start 0)."""
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        x, cache[f"l{i}"] = _block_cached(
            params[f"l{i}"], x, cache[f"l{i}"], start, tokens.shape[1], cfg, use_flash, segment)
    if last_only:
        x = x[:, -1:, :]  # before the (positionwise) norm: same numerics
    x = _rmsnorm(x, params["ln_f"])
    return (x @ params["embed"].T).float(), cache


@spmd
def prefill(params, tokens, cache, cfg: LMConfig, use_flash: bool = False):
    """Consume the prompt in one pass, filling the cache.
    tokens [B, S] -> (last-position logits [B, V] f32, cache)."""
    logits, cache = segment_forward(params, tokens, cache, 0, cfg, use_flash, segment=False,
                                    last_only=True)
    return logits[:, -1, :], cache


def decode_step(params, token, cache, pos: int, cfg: LMConfig, use_flash: bool = False):
    """One cached step over a single-tier cache.  token [B], pos an int ->
    (logits [B, V] f32, cache)."""
    x = params["embed"][token.long()][:, None, :]
    for i in range(cfg.n_layers):
        x, cache[f"l{i}"] = _block_cached(params[f"l{i}"], x, cache[f"l{i}"], pos, pos + 1, cfg,
                                          use_flash)
    x = _rmsnorm(x, params["ln_f"])
    return (x[:, 0, :] @ params["embed"].T).float(), cache


def build_prefix_main(prefix_cache, batch: int, total_len: int, cfg: LMConfig):
    """A batched main cache [batch, KV, total_len, hd] per layer whose first
    P slots hold the shared B=1 prefix cache, the rest zeros
    (``build_prefix_main``, ``generate.py:522``; an int8 cache's scale
    planes likewise): each request then prefills only its suffix."""
    out = {}
    for li, layer in prefix_cache.items():
        out[li] = {}
        for kk, vv in layer.items():
            t = vv.new_zeros((batch, vv.shape[1], total_len) + tuple(vv.shape[3:]))
            t[:, :, :vv.shape[2]] = vv
            out[li][kk] = t
    return out


def truncate_logits(logits, temperature: float, top_k: int = 0, top_p: float = 0.0):
    """``sample_token``'s truncation at ``temperature > 0``: logits /
    temperature in f32, then ``top_k`` (clamped to V) keeps every logit >=
    the k-th largest, ties included; ``top_p`` (only for 0 < top_p < 1)
    sorts descending, takes the softmax of the sorted values, keeps the
    tokens whose mass before them is < top_p and cuts at the smallest kept
    value, ties at the cut kept (always at least one token).  Dropped
    logits become -inf."""
    logits = (logits / temperature).float()
    if top_k and top_k > 0:
        kk = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, kk, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p and 0.0 < top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        cutoff = torch.where(mass_before < top_p, srt, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_token(logits, key=None, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, gumbel=None):
    """[B, V] f32 logits -> [B] int32 next-token ids (``generate.py:546``).
    ``temperature <= 0`` is greedy: ``torch.argmax`` returns the first
    maximal index, as ``jnp.argmax`` does.  Otherwise ``truncate_logits``,
    then JAX's categorical draw, ``argmax(gumbel + logits)``, with standard
    Gumbel noise [B, V]: ``gumbel`` when given (the tests inject the
    reference's draws), else from ``key``: one key [2] for the batch (the
    noise of its B*V elements, as JAX draws one [B, V] array from one key)
    or per-row keys [B, 2] (each row's noise from its own key alone)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = truncate_logits(logits, temperature, top_k, top_p)
    if gumbel is None:
        if key is None:
            raise ValueError("sampled decoding (temperature > 0) needs a key or gumbel noise")
        B, V = logits.shape
        gumbel = (prng.gumbel(key, B * V).reshape(B, V) if key.ndim == 1
                  else prng.gumbel(key, V))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def mask_after_eos(toks, eos_token: int):
    """Force every position strictly after a row's first ``eos_token`` to
    eos; no-op when eos_token < 0."""
    if eos_token < 0:
        return toks
    is_eos = (toks == eos_token).to(torch.int32)
    after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
    return torch.where(after, torch.full_like(toks, eos_token), toks)


def _chunk_eos_mask(toks, seen_eos, eos_token: int):
    """Per-chunk after-eos masking with a carried latch, on the device:
    rows already stopped (``seen_eos`` [B] bool) are forced to eos, the
    positions after a fresh eos too, and the latch is updated.  Returns
    (masked [B, n], seen_eos', all_done), all_done a 0-dim bool tensor:
    the caller reads back only that flag."""
    t = torch.where(seen_eos[:, None], torch.full_like(toks, eos_token), toks)
    is_eos = (t == eos_token).to(torch.int32)
    after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
    t = torch.where(after, torch.full_like(t, eos_token), t)
    seen = seen_eos | (is_eos > 0).any(dim=1)
    return t, seen, seen.all()


def _chunk_step(params, token, main, chunk_buf, n_main: int, used: int,
                cfg: LMConfig, n: int, temperature: float = 0.0,
                use_flash: bool = False, key=None, top_k: int = 0, top_p: float = 0.0):
    """n cached steps over the two-tier cache (a Python loop where JAX
    scans): main[:n_main] is read-only, new K/V go to chunk slots
    used..used+n-1; a sampled step splits ``key`` and spends one half.
    Returns (tokens [B, n], (token, chunk_buf, used', key'))."""
    toks = []
    for _ in range(n):
        logits, chunk_buf = decode_step_two_tier(
            params, token, main, chunk_buf, n_main, used, cfg, use_flash)
        sub = None
        if temperature > 0.0:
            key, sub = prng.split(key)
        token = sample_token(logits, sub, temperature, top_k, top_p)
        toks.append(token)
        used += 1
    return torch.stack(toks, dim=1), (token, chunk_buf, used, key)


def _prefill_or_prefix(params, prompt, cfg: LMConfig, main_len: int, use_flash: bool, prefix):
    """The first token's logits [B, V] and a main cache of ``main_len``
    slots: the prompt's prefill, or with a shared ``prefix`` (B=1, P
    slots) the suffix as a causal segment at offset P over a cache of
    exactly P + S slots, zero-padded to ``main_len`` afterwards, as the
    reference sizes it.  The segment takes the plain attention."""
    B, S = prompt.shape
    if prefix is None:
        main = init_cache(cfg, B, main_len, prompt.device)
        return prefill(params, prompt, main, cfg, use_flash)
    P = prefix["l0"]["k"].shape[2]
    main = build_prefix_main(prefix, B, P + S, cfg)
    logits, main = segment_forward(params, prompt, main, P, cfg, segment=True, last_only=True)
    if main_len > P + S:
        main = {li: {kk: torch.cat([vv, vv.new_zeros(vv.shape[:2] + (main_len - P - S,)
                                                      + vv.shape[3:])], dim=2)
                     for kk, vv in layer.items()}
                for li, layer in main.items()}
    return logits[:, -1, :], main


@spmd
def generate(params, prompt, cfg: LMConfig, max_new_tokens: int = 32,
             temperature: float = 0.0, use_flash: bool = False,
             eos_token: int = -1, rng=None, top_k: int = 0, top_p: float = 0.0,
             prefix: Optional[Dict[str, Any]] = None):
    """prompt [B, S] int32 -> generated [B, max_new_tokens] int32: greedy
    at ``temperature`` 0, else sampled (``sample_token``; ``rng`` a key
    [2] from ``models/prng.py``, split as the reference splits its key);
    rows that emit ``eos_token`` are eos-padded afterwards.  With a shared
    ``prefix`` (a B=1 cache of P slots) ``prompt`` holds the suffix, which
    prefills as a causal segment at offset P; positions are global, so the
    answer equals generating over the concatenation.  The first token
    comes from the prefill; the chunk loop emits the rest over the
    two-tier cache, merging a full chunk into main before the next one
    when ``max_new_tokens - 1`` exceeds ``GEN_CHUNK_CAP``.  ``use_flash``
    takes the flash forward in a prefill (not in a prefix's suffix) and
    the decode kernels in every step."""
    B, S = prompt.shape
    dev = prompt.device
    P = 0 if prefix is None else prefix["l0"]["k"].shape[2]
    chunked = max_new_tokens - 1 > GEN_CHUNK_CAP
    # single-chunk generations never merge, so main holds only the prompt
    main_len = P + S + max_new_tokens if chunked else P + S
    logits, main = _prefill_or_prefix(params, prompt, cfg, main_len, use_flash, prefix)
    key0 = None
    if temperature > 0.0:
        key0, rng = prng.split(prng.key(0, dev) if rng is None else rng)
    token = sample_token(logits, key0, temperature, top_k, top_p)
    out = [token[:, None]]
    n_main, remaining = P + S, max_new_tokens - 1
    while remaining > 0:
        n = min(remaining, GEN_CHUNK_CAP) if chunked else remaining
        # only the valid prefix of main is read: no mask over unwritten slots
        valid = {li: {kk: vv[:, :, :n_main] for kk, vv in layer.items()}
                 for li, layer in main.items()}
        chunk = init_chunk(cfg, B, GEN_CHUNK_CAP if chunked else n, dev)
        toks, (token, chunk, _, rng) = _chunk_step(
            params, token, valid, chunk, n_main, 0, cfg, n, temperature, use_flash, rng,
            top_k, top_p)
        out.append(toks)
        remaining -= n
        if remaining > 0:  # fold the finished chunk in before the next
            main = merge_chunk(main, chunk, n_main, cfg)
            n_main += n
    return mask_after_eos(torch.cat(out, dim=1), eos_token)


def grow_merge(main, chunk, cfg: LMConfig, used: int):
    """main ++ chunk[:used] along the length axis (``torch.cat``): a new
    main cache that is exactly full, so every later step reads valid slots
    only.  The stream's counterpart of ``merge_chunk``; it copies main once
    per ``STREAM_CHUNK_CAP`` tokens and briefly holds old and new main
    (an int8 cache's scale planes grow with it)."""
    return {f"l{i}": {kk: torch.cat([main[f"l{i}"][kk], chunk[f"l{i}"][kk][:, :, :used]], dim=2)
                      for kk in main[f"l{i}"]}
            for i in range(cfg.n_layers)}


def stream_chunks(params, prompt, cfg: LMConfig, max_new_tokens: int, chunk: int = 8,
                  temperature: float = 0.0, use_flash: bool = False, eos_token: int = -1,
                  prefix=None, rng=None, top_k: int = 0, top_p: float = 0.0):
    """Incremental decoding: yields int32 token tensors [B, <=chunk] whose
    concatenation equals ``generate(...)`` token for token (the same
    sampling and key, eos padding and shared prefix).  The first chunk is
    the prefill's token and chunk-1 steps; each later one is
    ``_chunk_step`` over ``chunk`` steps, chunks capped at
    ``STREAM_CHUNK_CAP``.  When the chunk buffer would overflow, main grows
    by the buffered tokens (``grow_merge``) and a fresh buffer starts.
    With ``eos_token`` set, masking runs on the device
    (``_chunk_eos_mask``) and only the all-done flag is read back; once
    every row has stopped, the host pads the remaining chunks with eos and
    the device does no more work.  Over a mesh (``params`` a
    ``ShardedTree``) every shard's stream advances in lockstep and shard
    0's chunks are yielded."""
    if isinstance(params, ShardedTree):
        yield from spmd_stream(stream_chunks, params, prompt, cfg, max_new_tokens, chunk,
                               temperature, use_flash, eos_token, prefix, rng, top_k, top_p)
        return
    B, S = prompt.shape
    dev = prompt.device
    cap = STREAM_CHUNK_CAP
    chunk = min(int(chunk), cap)  # a chunk may not outgrow the buffer
    P = 0 if prefix is None else prefix["l0"]["k"].shape[2]
    logits, main = _prefill_or_prefix(params, prompt, cfg, P + S, use_flash, prefix)
    key0 = None
    if temperature > 0.0:
        key0, rng = prng.split(prng.key(0, dev) if rng is None else rng)
    first = sample_token(logits, key0, temperature, top_k, top_p)
    token, chunk_buf = first, init_chunk(cfg, B, cap, dev)
    n_main, used = P + S, 0
    seen_eos = torch.zeros(B, dtype=torch.bool, device=dev)
    all_done = False

    def finalize(toks):
        nonlocal seen_eos, all_done
        if eos_token < 0:
            return toks
        toks, seen_eos, flag = _chunk_eos_mask(toks, seen_eos, eos_token)
        all_done = bool(flag)  # the one readback: drives the early stop
        return toks

    def emit(n):
        nonlocal token, chunk_buf, main, n_main, used, rng
        if used + n > cap:  # grow main by the buffered tokens, continue
            main = grow_merge(main, chunk_buf, cfg, used)
            n_main += used
            chunk_buf = init_chunk(cfg, B, cap, dev)
            used = 0
        toks, (token, chunk_buf, used, rng) = _chunk_step(
            params, token, main, chunk_buf, n_main, used, cfg, n, temperature, use_flash, rng,
            top_k, top_p)
        return toks

    n_first = min(chunk - 1, max_new_tokens - 1)
    if n_first > 0:
        yield finalize(torch.cat([first[:, None], emit(n_first)], dim=1))
    else:
        yield finalize(first[:, None])
    done = 1 + n_first
    while done < max_new_tokens:
        n = min(chunk, max_new_tokens - done)
        if eos_token >= 0 and all_done:  # every row stopped: pad on the host
            yield torch.full((B, n), eos_token, dtype=torch.int32, device=dev)
        else:
            yield finalize(emit(n))
        done += n


# ---------------------------------------------------------------------------
# Paged KV-block pool: the continuous lane (runtime/genserver.py)
# ---------------------------------------------------------------------------


def init_block_pool(cfg: LMConfig, num_blocks: int, block_size: int,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Per-layer {k, v} pools ``[num_blocks, KV, block_size, hd]`` in the
    model dtype on ``device`` (default ``cuda``); with ``kv_quant="int8"``
    int8 pools and their f32 scale planes ``k_s``/``v_s`` ``[num_blocks,
    KV, block_size]`` (the reference's are ``[num_blocks, block_size,
    KV]``).  Block 0 is the scratch block: the allocator hands out ids >=
    1."""
    dev = resolve_device(device)
    shape = (num_blocks, cfg.kv_heads, block_size, cfg.head_dim)
    if cfg.kv_quant == "int8":
        return {f"l{i}": {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                          "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                          "k_s": torch.zeros(shape[:3], device=dev),
                          "v_s": torch.zeros(shape[:3], device=dev)}
                for i in range(cfg.n_layers)}
    return {f"l{i}": {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for i in range(cfg.n_layers)}


def _paged_view(layer, tables):
    """One layer's blocks gathered into dense position-ordered views:
    {"k", "v"} each [B, KV, nblk*bs, hd], the reference's view, and an
    int8 pool's {"k_s", "v_s"} [B, KV, nblk*bs]."""
    k, v = paged_view(layer["k"], layer["v"], tables)
    out = {"k": k, "v": v}
    for kk in ("k_s", "v_s"):
        if kk in layer:
            out[kk] = paged_scale_view(layer[kk], tables)
    return out


def _paged_write(layer, tables, start, valid, k_new, v_new, use_flash: bool = False,
                 k_s=None, v_s=None):
    """Fresh K/V [B, KV, W, hd] into the pool at positions start[b] + i of
    each row, through its table; ``valid`` [B, W] False routes a write to
    the scratch block 0.  An int8 pool quantizes float rows, or takes int8
    rows with their scales ``k_s``/``v_s`` [B, KV, W] as they are, and
    writes the scales to its planes.  In place: ``kv_write_paged`` (the
    kernel for CUDA tensors) when ``use_flash``, else its plain version.
    Returns the layer."""
    write = kv_write_paged if use_flash else kv_write_paged_reference
    write(layer["k"], layer["v"], k_new, v_new, tables, start, valid, _scales(layer), k_s, v_s)
    return layer


def _attend_paged(q, view, start):
    """q [B, H, W, hd] over a dense paged view; query i of row b sees
    positions <= start[b] + i (its own fresh K/V is already in the pool).
    W == 1 with start == n_valid is the cached decode mask."""
    return attend_paged(q, view["k"], view["v"], start, view.get("k_s"), view.get("v_s"))


def _paged_block(lp, x, pool_layer, tables, start, valid, cfg: LMConfig,
                 use_flash: bool = False, lens=None):
    """One decoder block over the paged pool: K/V written at per-row
    positions start[b] + i, then attention over each row's own blocks.
    x [B, W, D].  A W == 1 block with ``use_flash`` writes and attends in
    one ``flash_decode_paged`` call over ``lens`` (start + 1, shared by the
    layers of a step), where a row whose ``valid`` is False writes
    nothing; any other block writes through ``_paged_write`` (invalid
    positions to the scratch block) and attends through ``_attend_paged``
    over ``_paged_view``."""
    W = x.shape[1]
    q, k, v = _qkv(lp, x, cfg, start[:, None])
    if W == 1 and use_flash:
        lens = start + 1 if lens is None else lens
        a = per_run(cfg, lambda q, p, k, v: flash_decode_paged(
            _grouped(q, p["k"].shape[1]), p["k"], p["v"], tables, lens, k, v, valid[:, 0],
            _scales(p)).reshape(q.shape), q, pool_layer, k, v)
    else:
        _paged_write(pool_layer, tables, start, valid, k, v, use_flash)
        a = per_run(cfg, lambda q, view: _attend_paged(q, view, start), q,
                    _paged_view(pool_layer, tables))
    return _finish_block(lp, x, a, cfg), pool_layer


@spmd
def paged_forward(params, tokens, pool, tables, start, width, cfg: LMConfig,
                  last_only: bool = True, use_flash: bool = False):
    """W tokens a row at per-row offsets over the paged pool: the chunked
    prefill.  tokens [B, W] int32; start [B] the global offset of each
    row's token 0; width [B] its valid tokens (pad positions write to the
    scratch block; their logits are garbage nobody reads).  Returns
    (logits, pool): [B, V] f32 at each row's last valid position with
    ``last_only``, else [B, W, V]."""
    B, W = tokens.shape
    valid = torch.arange(W, device=tokens.device)[None, :] < width[:, None]
    lens = start + 1 if W == 1 else None
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        x, pool[f"l{i}"] = _paged_block(params[f"l{i}"], x, pool[f"l{i}"], tables, start,
                                        valid, cfg, use_flash, lens)
    if last_only:
        idx = torch.clamp(width.long() - 1, 0, W - 1)
        # before the (positionwise) norm: same numerics
        x = x[torch.arange(B, device=x.device), idx][:, None, :]
    x = _rmsnorm(x, params["ln_f"])
    logits = (x @ params["embed"].T).float()
    return (logits[:, 0, :] if last_only else logits), pool


@spmd
def paged_decode_round(params, pool, tables, token, n_valid, active, seen_eos, cfg: LMConfig,
                       *, span: int, keys=None, temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0, eos_token: int = -1, use_flash: bool = False):
    """``span`` cached steps for the whole in-flight batch: the
    scheduler's unit of work between admission points.

    token [B] pending tokens, n_valid [B] per-row cache lengths, active
    [B] bool (empty slots emit 0 and write nothing with ``use_flash``,
    to the scratch block without), seen_eos [B] bool the after-eos latch
    (rows past their stop emit eos until the host retires them), keys [B,
    2] the rows' own sampling keys (``models/prng.py``; needed when
    ``temperature > 0``, split once a step, so co-batched rows never share
    a draw), all device tensors that stay on the device across the steps;
    tables [B, nblk] covers n_valid + span for every active row.  Static
    shapes, no host sync: the caller's readback of the tokens is the
    round's one.  Returns (toks [B, span] int32, pool, token, n_valid,
    seen_eos, keys)."""
    if temperature > 0.0 and keys is None:
        raise ValueError("a sampled round (temperature > 0) needs per-row keys [B, 2]")
    valid = active[:, None]
    step = active.to(torch.int32)
    toks = []
    for _ in range(span):
        logits = _paged_step_logits(params, pool, tables, token, n_valid, valid, cfg, use_flash)
        sub = None
        if temperature > 0.0:
            keys, sub = prng.split(keys)
        nxt = sample_token(logits, sub, temperature, top_k, top_p)
        if eos_token >= 0:
            nxt = nxt.masked_fill(seen_eos, eos_token)
            seen_eos = seen_eos | (nxt == eos_token)
        nxt = nxt.masked_fill(~active, 0)
        n_valid = n_valid + step
        toks.append(nxt)
        token = nxt
    return torch.stack(toks, dim=1), pool, token, n_valid, seen_eos, keys


def _paged_step_logits(params, pool, tables, token, n_valid, valid, cfg: LMConfig,
                       use_flash: bool):
    """One W = 1 step over the pool at per-row positions n_valid: [B, V]
    f32 logits (the pool written in place)."""
    lens = n_valid + 1  # the step's own K/V is written before it attends
    x = params["embed"][token.long()][:, None, :]
    for i in range(cfg.n_layers):
        x, pool[f"l{i}"] = _paged_block(params[f"l{i}"], x, pool[f"l{i}"], tables, n_valid,
                                        valid, cfg, use_flash, lens)
    x = _rmsnorm(x, params["ln_f"])
    return (x[:, 0, :] @ params["embed"].T).float()


def paged_spec_round(t_params, d_params, t_pool, d_pool, t_tables, d_tables, token, n_valid,
                     active, t_cfg: LMConfig, d_cfg: LMConfig, *, k: int,
                     use_flash: bool = False):
    """One speculative draft/verify round over the paged pools
    (``generate.py:1211``; greedy, float pools).  The draft takes k + 1
    single-token steps (the last writes the last proposal's K/V, so a fully
    accepted round leaves no draft-cache hole), each layer of each a
    ``flash_decode_paged`` launch with the step's write fused in when
    ``use_flash``; the target verifies all k + 1 positions in one
    ``paged_forward`` (``kv_write_paged``, then the plain attention);
    greedy acceptance takes the longest matched prefix plus the corrected
    token.  Rejected candidates' K/V stay as stale slots past the row's
    length, which the next round overwrites before anything attends them.
    Returns (new_toks [B, k+1], gained [B], corrected [B], t_pool,
    d_pool): row b's output is new_toks[b, :gained[b]], its next pending
    token corrected[b]."""
    B, W = token.shape[0], k + 1
    valid = active[:, None]
    seg, tok, nv = [], token, n_valid
    for _ in range(W):
        logits = _paged_step_logits(d_params, d_pool, d_tables, tok, nv, valid, d_cfg, use_flash)
        seg.append(tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        nv = nv + 1
    seg = torch.stack(seg, dim=1)  # [B, W] = [pending, d1 .. dk]
    widths = torch.where(active, W, 0).to(torch.int32)
    t_logits, t_pool = paged_forward(t_params, seg, t_pool, t_tables, n_valid, widths, t_cfg,
                                     last_only=False, use_flash=use_flash)
    t_argmax = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [B, W]
    draft = seg[:, 1:]
    mismatch = torch.cat([draft != t_argmax[:, :k],
                          torch.ones(B, 1, dtype=torch.bool, device=seg.device)], dim=1)
    a = torch.argmax(mismatch.to(torch.int32), dim=1)  # the first mismatch; k if none
    corrected = torch.gather(t_argmax, 1, a[:, None])[:, 0]
    padded = torch.cat([draft, torch.zeros(B, 1, dtype=torch.int32, device=seg.device)], dim=1)
    new_toks = torch.where(torch.arange(W, device=seg.device)[None, :] < a[:, None], padded,
                           corrected[:, None])
    gained = torch.where(active, a + 1, 0).to(torch.int32)
    return new_toks, gained, corrected, t_pool, d_pool


def _prefix_write(pool, prefix, tables: List[int], lo: int, hi: int, use_flash: bool):
    """Positions lo..hi-1 of the B=1 prefix cache into the pool through a
    one-row table, starting at the table's position 0: one
    ``_paged_write`` a layer (``kv_write_paged`` with ``use_flash``).  An
    int8 prefix's codes and scales are copied as they are (the reference
    copies them)."""
    dev = pool["l0"]["k"].device
    table = torch.tensor([tables], dtype=torch.int32, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    valid = torch.ones(1, hi - lo, dtype=torch.bool, device=dev)
    for li, layer in pool.items():
        pl = prefix[li]
        sc = _scales(pl)
        _paged_write(layer, table, start, valid, pl["k"][:, :, lo:hi], pl["v"][:, :, lo:hi],
                     use_flash, *(() if sc is None else (t[:, :, lo:hi] for t in sc)))
    return pool


@spmd
def paged_write_prefix_blocks(pool, prefix, blocks: List[int], cfg: LMConfig,
                              use_flash: bool = False):
    """Write the full-block part of a shared prefix into pool ``blocks``
    (len = P // block_size), once per deployment
    (``paged_write_prefix_blocks``, ``generate.py:1297``): one B=1 write a
    layer, the blocks as the table row, start 0, W = the blocks' slots.
    Every admitted sequence then references these blocks through its
    table."""
    bs = pool["l0"]["k"].shape[2]
    return _prefix_write(pool, prefix, list(blocks), 0, len(blocks) * bs, use_flash)


@spmd
def paged_write_prefix_tail(pool, prefix, blk: int, cfg: LMConfig, *, p0: int,
                            use_flash: bool = False):
    """Copy the shared prefix's tail (positions p0..P-1, short of a whole
    block) into one private pool block ``blk`` at rows 0..r-1
    (``paged_write_prefix_tail``, ``generate.py:1270``): one B=1 write a
    layer.  The boundary block must be private: the sequence's own tokens
    continue into it."""
    return _prefix_write(pool, prefix, [int(blk)], p0, prefix["l0"]["k"].shape[2], use_flash)


@register_unit("TransformerGenerator")
class TransformerGenerator(Unit):
    """Serving unit: prompt token rows in, generated token rows out
    (``[B, max_new_tokens]`` float32 token ids, no class names), registered
    under the JAX unit's name with its parameters.  Prompt values are
    truncated to int32 and clamped to [0, vocab).

    Greedy dense decoding is a pure function of (weights, prompt) and each
    row is independent, so the engine's batcher may stack and pad requests;
    MoE layers share their capacity over the batch, so an MoE unit is
    ``batch_coupled`` and the engine neither coalesces nor pads its rows.
    Sampled decoding (``temperature > 0``) draws a request's noise from one
    key, ``fold_in(key(seed), requests)``, so a row's tokens depend on its
    place in the batch, and the request counter in state advances with
    every predict: the unit declares ``batch_coupled`` and
    ``updates_state_on_predict``, and the engine neither coalesces nor pads
    its requests.  ``prefix_tokens`` ("1,2,3") is a shared prefix whose
    cache ``init_state`` builds once."""

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
                 device: DeviceLike = None, mesh: Optional[DeviceMesh] = None):
        self.cfg = LMConfig(
            vocab=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
            n_layers=int(n_layers), d_ff=int(d_ff), dtype=parse_dtype(dtype),
            moe_every=int(moe_every), n_experts=int(n_experts),
            moe_k=int(moe_k), quant=str(quant), kv_quant=str(kv_quant),
            n_kv_heads=int(n_kv_heads), rope=bool(rope), rope_base=float(rope_base),
        )
        self.seed = int(seed)
        self.weights_path = str(weights_path)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token = int(eos_token)
        self.prefix_ids = [int(t) for t in str(prefix_tokens).replace(" ", "").split(",")
                           if t != ""]
        for t in self.prefix_ids:
            if not 0 <= t < self.cfg.vocab:
                raise ValueError(f"prefix token {t} outside vocab [0, {self.cfg.vocab})")
        # sampled rows depend on their place in the batch, and MoE capacity
        # is shared by the flattened token stream: either way co-batching
        # other callers' rows would change this caller's answer
        self.batch_coupled = self.temperature > 0.0 or self.cfg.moe_every > 0
        self.updates_state_on_predict = self.temperature > 0.0
        # mesh (a binding's mesh_axes, e.g. {"tp": 4}): the params laid out
        # by param_shardings, every shard's heads and K/V on its own device,
        # prefill and decode run by every shard through the same kernels
        # (decided once here at the shard's shape); the answers come back
        # on the mesh's first device, and the continuous lane's pool is
        # laid out over the same mesh (runtime/servingmesh.py)
        self.mesh = mesh
        if mesh is not None:
            check_mesh(self.cfg, mesh, "TransformerGenerator")
            device = mesh.first_device
        self.device = resolve_device(device)
        self.use_flash = resolve_flash(str(attention), self.cfg, self.device, decode=True,
                                       mesh=mesh)
        # the continuous lane's kernels, decided apart: they take float32
        self.paged_flash = resolve_paged_flash(str(attention), self.cfg, self.device,
                                               self.use_flash, mesh=mesh)
        self._root_key = prng.key(self.seed, self.device)

    def init_state(self, rng: Optional[torch.Generator]):
        params = lm_init(seeded_generator(rng, self.seed), self.cfg, self.device)
        params = load_lm_weights(params, self.weights_path)
        if self.cfg.quant == "int8":  # after the load, as the reference
            params = quantize_lm_params(params)
        if self.mesh is not None:
            params = shard_params(params, self.mesh)
        state = {"params": params,
                 "requests": torch.zeros((), dtype=torch.int32, device=self.device)}
        if self.prefix_ids:
            prompt = torch.tensor([self.prefix_ids], dtype=torch.int32, device=self.device)
            P = len(self.prefix_ids)
            cache = (init_cache(self.cfg, 1, P, self.device) if self.mesh is None else
                     self.mesh.map_shards(lambda sh: init_cache(self.cfg.for_shard(sh), 1, P,
                                                                sh.device)))
            _, state["prefix_cache"] = prefill(params, prompt, cache, self.cfg, self.use_flash)
        return state

    def shard_state(self, state):
        """A whole state (``convert.params_from_jax`` of the reference
        unit's gathered state) laid out over the unit's mesh: the params by
        ``param_shardings``, a prefix cache's K/V heads over ``tp`` by
        ``kv_head_range`` (``shard_kv_heads``); unchanged without a mesh."""
        if self.mesh is None:
            return state
        out = dict(state)
        out["params"] = shard_params(state["params"], self.mesh)
        if state.get("prefix_cache") is not None:
            out["prefix_cache"] = shard_kv_heads(state["prefix_cache"], self.mesh,
                                                 self.cfg.n_heads)
        return out

    def predict(self, state, X):
        prompt = sanitize_prompt(X, self.cfg.vocab)
        sampled = self.temperature > 0.0
        y = generate(state["params"], prompt, self.cfg,
                     max_new_tokens=self.max_new_tokens, temperature=self.temperature,
                     use_flash=self.use_flash, eos_token=self.eos_token,
                     rng=prng.fold_in(self._root_key, state["requests"]) if sampled else None,
                     top_k=self.top_k, top_p=self.top_p,
                     prefix=state.get("prefix_cache")).to(torch.float32)
        if sampled:
            # every state key is kept (the prefix cache): only the counter moves
            return y, UnitAux(state={**state, "requests": state["requests"] + 1})
        return y

    def continuous_spec(self, state):
        """What the continuous lane (``runtime/genserver.py``) needs to
        serve this unit: the params, the config, the sampling knobs and
        seed, ``eos_token``, ``max_new_tokens``, the shared-prefix cache and
        whether to take the lane's kernels (``paged_flash``).  None where the
        reference returns None: MoE capacity couples co-scheduled rows, so
        an MoE generator serves on the static lane."""
        if self.cfg.moe_every > 0:
            return None
        return {"params": state["params"], "cfg": self.cfg, "temperature": self.temperature,
                "top_k": self.top_k, "top_p": self.top_p, "eos_token": self.eos_token,
                "max_new_tokens": self.max_new_tokens,
                "prefix_cache": state.get("prefix_cache"), "seed": self.seed,
                "use_flash": self.paged_flash, "mesh": self.mesh}

    def stream_tokens(self, state, X, chunk: int = 8):
        """Incremental serving: yields int32 token tensors [B, <=chunk]
        whose concatenation equals ``predict``'s output for greedy decoding.
        ``X`` (prompt rows, any array) goes to the unit's device as float32,
        as the engine's dispatch does.  Streams bypass the batcher and the
        state write-back, so a sampled stream draws a key of its own per
        call, ``fold_in(key(seed), n)`` with n from a process-wide counter,
        as the reference does."""
        rows = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        n = next(_stream_counter) if self.temperature > 0.0 else 0
        yield from stream_chunks(state["params"], sanitize_prompt(rows, self.cfg.vocab), self.cfg,
                                 max_new_tokens=self.max_new_tokens, chunk=int(chunk),
                                 temperature=self.temperature, use_flash=self.use_flash,
                                 eos_token=self.eos_token, prefix=state.get("prefix_cache"),
                                 rng=prng.fold_in(self._root_key, n), top_k=self.top_k,
                                 top_p=self.top_p)
