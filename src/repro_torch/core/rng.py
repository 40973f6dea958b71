"""Counter-based threefry2x32 generator, bit-exact with ``jax.random``.

The reference draws its codebooks (``encoding.make_codebooks``) and decoy
peaks (``decoys.make_decoy_peaks``) from ``jax.random`` keys derived from
the config seed. A store written by the reference carries only that seed,
so the port must reproduce the same bits without JAX. This module is the
installed jax's default PRNG (threefry2x32 with
``jax_threefry_partitionable=True``) written with torch integer ops, so it
runs on whatever device the key lives on.

Representation: a key is an int64 tensor of shape ``(..., 2)`` holding two
uint32 words; random bits are int64 tensors with values in ``[0, 2**32)``.
int64 carries every uint32 intermediate without overflow, and each add or
shift is masked back to 32 bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counts (x1, x2) under key (k1, k2).

    All four are int64 tensors with uint32 values that broadcast together;
    returns the two output words. Twenty rounds with a key injection after
    every four, as ``jax._src.prng._threefry2x32_lowering``.
    """
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


def PRNGKey(seed: int, device: str | torch.device | None = None) -> torch.Tensor:
    """Raw key of an integer seed, ``[0, seed & 0xFFFFFFFF]``: jax without
    64-bit mode keeps the seed's low 32 bits."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _counts(shape: tuple[int, ...], device) -> torch.Tensor:
    """Low words of the flat row-major iota over ``shape`` (the high words
    are zero below 2**32 elements)."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash_counts(key: torch.Tensor, shape: tuple[int, ...]):
    """threefry of the iota over ``shape`` under (possibly batched) ``key``
    (..., 2) -> two (..., *shape) words."""
    trail = (1,) * len(shape)
    k1 = key[..., 0].reshape(*key.shape[:-1], *trail)
    k2 = key[..., 1].reshape(*key.shape[:-1], *trail)
    lo = _counts(shape, key.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like, partitionable): (num, 2) keys."""
    y1, y2 = _hash_counts(key, (num,))
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be an int or an integer tensor
    of any shape (one key per element, as ``vmap(fold_in)``)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element: ``jax.random.bits(key, shape, uint32)``.
    A batched key (..., 2) draws ``shape`` for each of its keys."""
    y1, y2 = _hash_counts(key, tuple(shape))
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32.

    The reference's ``floats * (maxval - minval) + minval`` is contracted
    into one fused multiply-add by XLA on the CPU. The product of two
    float32 values is exact in float64, so computing it there and rounding
    once reproduces the fused result bit for bit.
    """
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    b = bits(key, shape)
    mant = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = mant - 1.0
    out = (floats.to(torch.float64) * float(span) + float(lo)).to(torch.float32)
    return torch.clamp_min(out, float(lo))


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` (bool)."""
    return uniform(key, shape) < np.float32(p)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: the sort-based shuffle of
    ``arange(n)`` — ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a stable
    sort on 32 fresh random bits from a split-off subkey."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.argsort(bits(sub, (n,)), stable=True)
        x = x[order]
    return x
