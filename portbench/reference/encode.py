"""The ID-level hypervector encoder, plain torch: codebooks, preprocessing,
bind, bundle and majority.

The codebooks and the preprocessing are frozen copies of
``src/repro_torch/core/encoding.py`` at commit 0d012dd (the reference's
float32 op order, which sets every bin and level). The bundling is this
file's own: each spectrum's bound peaks are counted per bit in bit-sliced
counters (a ripple-carry add of one bound word per peak into
``ceil(log2(P + 1))`` planes of int32 words), then the counts are unpacked
and compared with half the number of peaks, exact ties taking the
tie-break bit. Packed hypervectors are int32 words, bit ``32 w + b`` of the
hypervector is bit ``b`` (LSB first) of word ``w``.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import threefry

WORD_BITS = 32


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., D) {0, 1} -> (..., D // 32) int32 words, LSB first."""
    w = bits.shape[-1] // WORD_BITS
    b = bits.to(torch.int32).reshape(*bits.shape[:-1], w, WORD_BITS)
    weights = torch.ones((), dtype=torch.int32, device=bits.device) << torch.arange(
        WORD_BITS, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., W, 32) int32 {0, 1}."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    return (words[..., None] >> shifts) & 1


def make_codebooks(seed: int, n_bins: int, n_levels: int, dim: int, device):
    """(id_hvs (n_bins, W), level_hvs (n_levels, W), tiebreak (W,)) drawn
    from the configuration's seed: the codebook key is the first half of
    ``split(PRNGKey(seed))``, split again four ways."""
    k_cb = threefry.split(threefry.prng_key(seed, device))[0]
    k_id, k_base, k_perm, k_tie = threefry.split(k_cb, 4)
    id_hvs = threefry.bernoulli_packed(k_id, 0.5, n_bins, dim)
    base = (threefry.uniform(k_base, (dim,)) < np.float32(0.5)).to(torch.int32)
    perm = threefry.permutation(k_perm, dim)
    flips_per_level = dim // (2 * max(n_levels - 1, 1))
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(dim, device=device)
    qs = torch.arange(n_levels, device=device)[:, None]
    level_bits = base[None, :] ^ (rank[None, :] < qs * flips_per_level).to(torch.int32)
    tie = (threefry.uniform(k_tie, (dim,)) < np.float32(0.5)).to(torch.int32)
    return id_hvs, pack_bits(level_bits), pack_bits(tie)


def decoy_key(seed: int, device) -> torch.Tensor:
    """The decoy key: the second half of ``split(PRNGKey(seed))``."""
    return threefry.split(threefry.prng_key(seed, device))[1]


def make_decoy_peaks(key, mz, intensity, mz_min: float, mz_max: float, *,
                     row_offset: int):
    """Decoy of library row ``row_offset + r``: the same intensities at m/z
    drawn from ``fold_in(key, row)`` (frozen copy of
    ``src/repro_torch/core/decoys.py`` at commit 0d012dd)."""
    B, P = mz.shape
    rows = torch.arange(B, dtype=torch.int64, device=key.device) + row_offset
    new_mz = threefry.uniform(threefry.fold_in(key, rows), (P,), mz_min, mz_max)
    return torch.where(intensity > 0, new_mz.to(mz.dtype), 0.0), intensity


def _f32(x: float) -> float:
    return float(np.float32(x))


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (CUDA's is; torch's vectorised
    one on the CPU is not, numpy's is)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def preprocess(mz, intensity, *, bin_size: float, mz_min: float, mz_max: float,
               n_levels: int, min_intensity_frac: float = 0.01):
    """(bins, levels, mask), each (B, P): the 1% base-peak filter, m/z bins
    by the float32 reciprocal, sqrt-scaled intensities max-normalised into
    levels; one eager float32 op at a time."""
    valid = (intensity > 0) & (mz >= _f32(mz_min)) & (mz < _f32(mz_max))
    inten = torch.where(valid, intensity, 0.0)
    base = inten.amax(dim=-1, keepdim=True)
    valid = valid & (inten >= _f32(min_intensity_frac) * base)
    inten = torch.where(valid, inten, 0.0)
    n_bins = int(round((mz_max - mz_min) / bin_size))
    inv_bin = float(np.float32(1.0 / bin_size))
    bins = torch.clamp(((mz - _f32(mz_min)) * inv_bin).to(torch.int32), 0, n_bins - 1)
    scaled = _sqrt_f32(inten)
    smax = torch.clamp_min(scaled.amax(dim=-1, keepdim=True), _f32(1e-9))
    levels = torch.clamp((scaled / smax * float(n_levels - 1) + 0.5).to(torch.int32),
                         0, n_levels - 1)
    zero = torch.zeros((), dtype=torch.int32, device=mz.device)
    return torch.where(valid, bins, zero), torch.where(valid, levels, zero), valid


def bundle(bins, levels, mask, id_hvs, level_hvs, tiebreak) -> torch.Tensor:
    """(B, W) int32 hypervectors: bit d is 1 where more than half of the
    valid peaks' bound words (ID of the bin XOR level) have it, the tie-break
    bit where exactly half do."""
    B, P = bins.shape
    W = id_hvs.shape[1]
    planes = [torch.zeros((B, W), dtype=torch.int32, device=bins.device)
              for _ in range(max(1, P.bit_length()))]
    zero = torch.zeros((), dtype=torch.int32, device=bins.device)
    for p in range(P):
        carry = torch.where(mask[:, p, None],
                            id_hvs[bins[:, p].long()] ^ level_hvs[levels[:, p].long()],
                            zero)
        for j, plane in enumerate(planes):
            planes[j] = plane ^ carry
            carry = plane & carry
    counts = unpack_bits(planes[0])
    for j, plane in enumerate(planes[1:], 1):
        counts += unpack_bits(plane) << j
    del planes
    n = mask.sum(dim=1, dtype=torch.int32)[:, None, None]
    twice = 2 * counts
    tie = unpack_bits(tiebreak)[None]
    bits = torch.where(twice == n, tie, (twice > n).to(torch.int32))
    return pack_bits(bits.reshape(B, W * WORD_BITS))


class Encoder:
    """One configuration's codebooks and preprocessing on one device."""

    def __init__(self, oms: dict, seed: int, device):
        self.oms = oms
        self.n_bins = int(round((oms["mz_max"] - oms["mz_min"]) / oms["bin_size"]))
        self.id_hvs, self.level_hvs, self.tiebreak = make_codebooks(
            seed, self.n_bins, oms["n_levels"], oms["dim"], device)

    def __call__(self, mz, intensity, *, chunk: int = 1 << 17) -> torch.Tensor:
        out = []
        for s in range(0, mz.shape[0], chunk):
            bins, levels, mask = preprocess(
                mz[s:s + chunk], intensity[s:s + chunk], bin_size=self.oms["bin_size"],
                mz_min=self.oms["mz_min"], mz_max=self.oms["mz_max"],
                n_levels=self.oms["n_levels"])
            out.append(bundle(bins, levels, mask, self.id_hvs, self.level_hvs,
                              self.tiebreak))
        return torch.cat(out)
