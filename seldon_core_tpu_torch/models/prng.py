"""Counter-based random keys for sampled decoding — the port's stand-in
for ``jax.random`` in ``models/generate.py`` and ``runtime/genserver.py``.

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words.  Every
function is a pure integer hash of its inputs in plain torch ops, on
whatever device the key lives on:

  * ``key(seed)``            the root key of a seed (``jax.random.key``);
  * ``fold_in(key, data)``   a key derived from ``key`` and an integer or
                             an integer tensor, e.g. a request counter
                             that lives on the device (``fold_in``);
  * ``split(key)``           two keys from one (``split`` into two);
  * ``gumbel(key, n)``       ``n`` standard Gumbel draws a key, f32, from
                             the words of element j = 0..n-1 alone;
  * ``uniform(key, n)``      ``n`` uniform draws in [0, 1) a key, f32, from
                             the same words (the routers' coin).

So a draw depends only on its key and its index: a batch of per-row keys
``[B, 2]`` gives each row the noise it would get alone, whatever rows are
batched with it or where it sits, and the whole chain (fold, split, draw)
runs on the device with static shapes and no host sync, as a captured
decode round needs.  ``torch.Generator`` cannot do this: its offsets
follow the launches, not a row's key.

The hash is murmur3's 32-bit finalizer (``_fmix``), with keys mixed in
between rounds; 32 x 32-bit products are split into 16-bit halves so no
intermediate leaves int64, and integer results are the same bits on the
CPU and on the card.  A draw takes 24 bits to a uniform u in (0, 1) and
``-log(-log(u))`` in float64, rounded to f32.

The bits differ from ``jax.random``'s by design: the port cannot
reproduce the reference's threefry stream without its implementation,
and nothing depends on the particular bits.  What carries over is the
structure (a key per request or per sequence, split once a step) and the
distribution; the tests hold ``sample_token`` to the reference's with the
reference's own Gumbel draws injected.
"""

from __future__ import annotations

import torch

__all__ = ["key", "fold_in", "split", "gumbel", "uniform"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# domain constants (the fractional digits of pi): a seed, a fold and a
# split never hash the same words
_SEED_LO, _SEED_HI, _FOLD, _SPLIT = 0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344


def _mul(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) and a constant c < 2^32, with every
    product below 2^49: int64 never overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix(x):
    """murmur3's 32-bit finalizer: a bijection on [0, 2^32) that avalanches
    every input bit.  Works on Python ints and int64 tensors alike."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def key(seed: int, device=None) -> torch.Tensor:
    """The root key [2] of an integer seed (any sign, up to 64 bits)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0 = _fmix((s & _M32) ^ _SEED_LO)
    k1 = _fmix(((s >> 32) ^ _SEED_HI ^ k0) & _M32)
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """A new key from ``k`` [..., 2] and ``data`` (an int, or an integer
    tensor broadcasting against k[..., 0]); only data's low 32 bits count."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64)
    d = data & _M32
    k0, k1 = k[..., 0], k[..., 1]
    n0 = _fmix(k0 ^ _mul(d ^ k1, _GOLDEN) ^ _FOLD)
    n1 = _fmix((k1 + n0 + _FOLD) & _M32)
    return torch.stack(torch.broadcast_tensors(n0, n1), dim=-1)


def split(k: torch.Tensor):
    """Two keys from ``k`` [..., 2], as ``jax.random.split`` into two: the
    caller keeps one and spends the other.  Both are folded at once (one
    pass of ops over [..., 2, 2]: a decode step launches it once)."""
    both = fold_in(k.unsqueeze(-2), _SPLIT + torch.arange(2, device=k.device))
    return both[..., 0, :], both[..., 1, :]


def _words(k: torch.Tensor, n: int) -> torch.Tensor:
    """24 random bits [..., n] from keys [..., 2]: element j of a key's row
    hashes (key, j) alone."""
    j = torch.arange(int(n), device=k.device, dtype=torch.int64)
    k0, k1 = k[..., 0:1], k[..., 1:2]
    h = _fmix(_mul(j, _GOLDEN) ^ k0)
    return _fmix((h + k1) & _M32) >> 8


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel draws [..., n] f32 from keys [..., 2]."""
    u = (_words(k, n).double() + 0.5) * 2.0 ** -24  # (0, 1), never 0 or 1
    return (-torch.log(-torch.log(u))).float()


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform draws [..., n] f32 in [0, 1) from keys [..., 2], on a grid of
    2^-24 (exact in f32), from the words ``gumbel`` draws from."""
    return _words(k, n).float() * 2.0 ** -24
