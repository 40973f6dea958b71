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


_CPU_CHUNK = 1 << 16


def _threefry_np(k1: int, k2: int, start: int, stop: int) -> np.ndarray:
    """``threefry2x32`` of the counts [start, stop) (high words 0) under
    the key (k1, k2), XORed to 32 bits, in numpy uint32 arithmetic, which
    wraps at 2**32 as the hash does."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.full(stop - start, ks[0], np.uint32)
        x1 = np.arange(start, stop, dtype=np.uint32) + ks[1]
        for i in range(1, 6):
            for r in _ROTATIONS[(i - 1) % 2]:
                x0 += x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 += ks[i % 3]
            x1 += ks[(i + 1) % 3] + np.uint32(i)
    return x0 ^ x1


def _draw(key: torch.Tensor, shape: tuple[int, ...], fn) -> torch.Tensor:
    """``fn`` of the 32 random bits (int64) of each element of ``shape``.
    On the CPU one unbatched key's draws are hashed by :func:`_threefry_np`
    in flat runs of ``_CPU_CHUNK`` counts, the same counts and so the same
    bits: torch's int64 ops over a whole 36,000 x 4,096 codebook (1.2 GB
    an intermediate) took ~10x as long on one thread."""
    shape = tuple(shape)
    n = math.prod(shape)
    if key.device.type != "cpu" or key.ndim != 1 or n <= _CPU_CHUNK:
        y1, y2 = _hash_counts(key, shape)
        return fn(y1 ^ y2)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    k1, k2 = (int(k) for k in key)
    parts = [fn(torch.from_numpy(_threefry_np(k1, k2, start, min(n, start + _CPU_CHUNK))
                                 .astype(np.int64)))
             for start in range(0, n, _CPU_CHUNK)]
    return torch.cat(parts).reshape(shape)


def bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element: ``jax.random.bits(key, shape, uint32)``.
    A batched key (..., 2) draws ``shape`` for each of its keys."""
    return _draw(key, shape, lambda b: b)


def _to_uniform(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    mant = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = mant - 1.0
    out = (floats.to(torch.float64) * float(span) + float(lo)).to(torch.float32)
    return torch.clamp_min(out, float(lo))


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32.

    The reference's ``floats * (maxval - minval) + minval`` is contracted
    into one fused multiply-add by XLA on the CPU. The product of two
    float32 values is exact in float64, so computing it there and rounding
    once reproduces the fused result bit for bit.
    """
    return _draw(key, shape, lambda b: _to_uniform(b, minval, maxval))


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` (bool)."""
    return _draw(key, shape, lambda b: _to_uniform(b, 0.0, 1.0) < np.float32(p))


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
