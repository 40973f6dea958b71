"""Counter-based threefry2x32 bits, as ``jax.random`` draws them.

Frozen copy of ``src/repro_torch/core/rng.py`` at commit 0d012dd (the
hash, ``PRNGKey``, ``split``, ``fold_in`` and the float32 uniform), in plain
torch integer ops on any device, with the draws of one key taken in flat
chunks of the counter so that a codebook of 180 million bits fits beside
nothing else. The library's codebooks and decoys are drawn from these bits;
the reference draws them again from the seed instead of reading the
program's.

A key is an int64 tensor ``(..., 2)`` of two uint32 words; bits are int64
tensors with values in ``[0, 2**32)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 24


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Twenty rounds with a key injection after every four."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(1, 6):
        for r in _ROTATIONS[(i - 1) % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[i % 3]) & _M32
        x1 = (x1 + ks[(i + 1) % 3] + i) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` without 64-bit mode: ``[0, seed & 0xFFFFFFFF]``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _hash(key: torch.Tensor, counts: torch.Tensor):
    """threefry of ``counts`` (high words 0) under ``key`` (..., 2),
    broadcast: key dims lead, count dims trail."""
    trail = (1,) * counts.ndim
    k1 = key[..., 0].reshape(*key.shape[:-1], *trail)
    k2 = key[..., 1].reshape(*key.shape[:-1], *trail)
    return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    y1, y2 = _hash(key, torch.arange(num, dtype=torch.int64, device=key.device))
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """One key per element of ``data`` (an integer tensor)."""
    d = data.to(torch.int64) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def _to_uniform(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """23 mantissa bits -> [1, 2) -> [0, 1), scaled in float64 and rounded
    once to float32 (the fused multiply-add XLA emits)."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    out = (floats.to(torch.float64) * float(span) + float(lo)).to(torch.float32)
    return torch.clamp_min(out, float(lo))


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` of one key (1-d) in chunks of
    the flat counter, or of a batch of keys (..., 2) at once."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    if key.ndim != 1:
        counts = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
        y1, y2 = _hash(key, counts)
        return y1 ^ y2
    out = torch.empty(n, dtype=torch.int64, device=key.device)
    for s in range(0, n, _CHUNK):
        y1, y2 = _hash(key, torch.arange(s, min(n, s + _CHUNK), dtype=torch.int64,
                                         device=key.device))
        out[s:s + _CHUNK] = y1 ^ y2
    return out.reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    return _to_uniform(bits(key, shape), minval, maxval)


def bernoulli_packed(key: torch.Tensor, p: float, rows: int, dim: int) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (rows, dim))`` packed LSB-first into
    (rows, dim // 32) int32 words, drawn a chunk of rows at a time."""
    from portbench.reference.encode import pack_bits
    out = torch.empty((rows, dim // 32), dtype=torch.int32, device=key.device)
    step = max(1, _CHUNK // dim)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        y1, y2 = _hash(key, torch.arange(r0 * dim, r1 * dim, dtype=torch.int64,
                                         device=key.device))
        u = _to_uniform(y1 ^ y2, 0.0, 1.0) < np.float32(p)
        out[r0:r1] = pack_bits(u.reshape(r1 - r0, dim))
    return out


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: rounds of stable sorts on fresh
    32-bit draws."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.argsort(bits(sub, (n,)), stable=True)]
    return x
