"""ID-Level hyperdimensional encoding of mass spectra (paper §II-A, Fig. 3).

Counterpart of ``repro.core.encoding``: the same preprocessing (1% base-peak
filter, m/z binning, sqrt scaling, intensity levels), the same codebooks
(drawn from :mod:`repro_torch.core.rng`, bit-exact with the reference's
``jax.random`` draws) and the same bind/bundle/majority encode. Packed HVs
are int32 tensors holding the reference's uint32 bit patterns.

``encode_spectra`` is the bit-exact oracle; dispatch goes through the
backend registry in :mod:`repro_torch.core.encode_backends`, whose backends
are all required (and tested) to be bit-identical to it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.packing import pack_bits, unpack_bits

# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Codebooks:
    """Packed codebooks + majority tie-break vector, all on one device."""

    id_hvs: torch.Tensor      # (n_bins, W) int32 — per-m/z-bin ID hypervectors
    level_hvs: torch.Tensor   # (n_levels, W) int32 — intensity Level hypervectors
    tiebreak: torch.Tensor    # (W,) int32 — decides even-count majority ties
    dim: int

    @property
    def device(self) -> torch.device:
        return self.id_hvs.device

    def to(self, device) -> "Codebooks":
        return Codebooks(self.id_hvs.to(device), self.level_hvs.to(device),
                         self.tiebreak.to(device), self.dim)


def make_codebooks(key: torch.Tensor, n_bins: int, n_levels: int,
                   dim: int) -> Codebooks:
    """Codebooks on ``key``'s device, bit-identical to the reference's."""
    k_id, k_base, k_perm, k_tie = rng.split(key, 4)
    id_bits = rng.bernoulli(k_id, 0.5, (n_bins, dim)).to(torch.uint8)

    base = rng.bernoulli(k_base, 0.5, (dim,)).to(torch.uint8)
    perm = rng.permutation(k_perm, dim)
    # Level q flips the first q * dim/(2*(n_levels-1)) positions of `perm`
    # (cumulative), so L[0] and L[n_levels-1] differ in dim/2 bits.
    flips_per_level = dim // (2 * max(n_levels - 1, 1))
    qs = torch.arange(n_levels, device=key.device)[:, None]
    rank = torch.empty_like(perm)                  # position -> rank in perm
    rank[perm] = torch.arange(dim, device=key.device)
    flip_mask = rank[None, :] < qs * flips_per_level
    level_bits = base[None, :] ^ flip_mask.to(torch.uint8)

    tie_bits = rng.bernoulli(k_tie, 0.5, (dim,)).to(torch.uint8)
    return Codebooks(id_hvs=pack_bits(id_bits), level_hvs=pack_bits(level_bits),
                     tiebreak=pack_bits(tie_bits), dim=dim)


# ---------------------------------------------------------------------------
# Preprocessing (peaks -> (bin, level, mask) triples)
# ---------------------------------------------------------------------------


class PreprocessParams(NamedTuple):
    """Static preprocessing knobs."""

    bin_size: float
    mz_min: float
    mz_max: float
    n_levels: int
    min_intensity_frac: float = 0.01


@dataclasses.dataclass(frozen=True)
class PreprocessedSpectra:
    bins: torch.Tensor           # (B, P) int32 — m/z bin per peak (0 where masked)
    levels: torch.Tensor         # (B, P) int32 — intensity level per peak
    mask: torch.Tensor           # (B, P) bool — valid-peak mask
    pmz: torch.Tensor | None     # (B,) float32 — precursor m/z
    charge: torch.Tensor | None  # (B,) int32 — precursor charge


def _f32(x: float) -> float:
    """A Python float holding exactly the float32 value the reference's weak
    typing would use for the literal ``x``."""
    return float(np.float32(x))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, which XLA computes. CUDA's
    float32 sqrt is correctly rounded; torch's vectorised float32 sqrt on the
    CPU is not (about 0.6% of results 1 ulp off, and a level sitting on a
    rounding boundary would flip), so the CPU takes numpy's, which is."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def preprocess_spectra(mz: torch.Tensor, intensity: torch.Tensor,
                       pmz: torch.Tensor, charge: torch.Tensor, *,
                       bin_size: float, mz_min: float, mz_max: float,
                       n_levels: int, min_intensity_frac: float = 0.01
                       ) -> PreprocessedSpectra:
    """Vectorised spectrum preprocessing. Padded peaks carry intensity 0.

    Every step is one eager float32 op, in the reference's order, so the
    results round exactly as the reference's do (no fused multiply-add).
    """
    valid = (intensity > 0) & (mz >= _f32(mz_min)) & (mz < _f32(mz_max))
    inten = torch.where(valid, intensity, 0.0)

    # 1% base-peak noise filter.
    base = inten.amax(dim=-1, keepdim=True)
    valid = valid & (inten >= _f32(min_intensity_frac) * base)
    inten = torch.where(valid, inten, 0.0)

    # m/z binning by the host-hoisted float32 reciprocal, as the reference.
    n_bins = int(round((mz_max - mz_min) / bin_size))
    inv_bin = float(np.float32(1.0 / bin_size))
    bins = torch.clamp(((mz - _f32(mz_min)) * inv_bin).to(torch.int32), 0, n_bins - 1)

    # sqrt scaling + per-spectrum max-normalisation, then quantise to levels.
    scaled = sqrt_f32(inten)
    smax = torch.clamp_min(scaled.amax(dim=-1, keepdim=True), _f32(1e-9))
    levels = torch.clamp(
        (scaled / smax * float(n_levels - 1) + 0.5).to(torch.int32), 0, n_levels - 1)

    zero = torch.zeros((), dtype=torch.int32, device=mz.device)
    return PreprocessedSpectra(
        bins=torch.where(valid, bins, zero),
        levels=torch.where(valid, levels, zero),
        mask=valid,
        pmz=pmz.to(torch.float32),
        charge=charge.to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Encoding (bind + bundle + binarise)
# ---------------------------------------------------------------------------


def _binarise_majority(counts, n, tie_bits) -> torch.Tensor:
    """Bit d is 1 iff 2*counts_d > n; exact ties take the tiebreak bit.
    counts (B, D'), n (B, 1), tie_bits (1, D') -> packed (B, D'/32) int32."""
    twice = 2 * counts
    bits = torch.where(twice == n, tie_bits, (twice > n).to(torch.int32))
    return pack_bits(bits)


def encode_spectra(spectra: PreprocessedSpectra, cb: Codebooks) -> torch.Tensor:
    """Encode preprocessed spectra into packed HVs (B, W) int32 — the oracle,
    which materialises the full (B, P, D) unpacked bits."""
    bound = cb.id_hvs[spectra.bins.long()] ^ cb.level_hvs[spectra.levels.long()]
    mask_i = spectra.mask.to(torch.int32)
    counts = (unpack_bits(bound).to(torch.int32) * mask_i[..., None]).sum(
        dim=1, dtype=torch.int32)
    n = mask_i.sum(dim=-1, dtype=torch.int32)[:, None]
    tie = unpack_bits(cb.tiebreak)[None, :].to(torch.int32)
    return _binarise_majority(counts, n, tie)


def encode_spectra_word_tiled(spectra: PreprocessedSpectra, cb: Codebooks,
                              *, word_tile: int = 8) -> torch.Tensor:
    """Oracle rewrite that loops the Dhv word dimension in fixed tiles, so
    the unpacked-bit intermediate is (B, P, word_tile*32) instead of
    (B, P, D). A ragged last tile is padded with zero words and sliced off."""
    W = cb.id_hvs.shape[1]
    wt = min(word_tile, W)
    padw = (-W) % wt

    def _padc(x):
        return torch.nn.functional.pad(x, (0, padw)) if padw else x

    ids, lvls, tie = _padc(cb.id_hvs), _padc(cb.level_hvs), _padc(cb.tiebreak)
    bins, levels = spectra.bins.long(), spectra.levels.long()
    mask_i = spectra.mask.to(torch.int32)
    n = mask_i.sum(dim=-1, dtype=torch.int32)[:, None]
    out = []
    for s in range(0, W + padw, wt):
        bound = ids[:, s:s + wt][bins] ^ lvls[:, s:s + wt][levels]
        counts = (unpack_bits(bound).to(torch.int32) * mask_i[..., None]).sum(
            dim=1, dtype=torch.int32)
        tie_bits = unpack_bits(tie[s:s + wt])[None, :].to(torch.int32)
        out.append(_binarise_majority(counts, n, tie_bits))
    return torch.cat(out, dim=1)[:, :W]


def chunked_batch_map(fn: Callable, args: Sequence[torch.Tensor | None],
                      batch: int):
    """Pad every argument's leading dim to a ``batch`` multiple, call ``fn``
    on each (batch, ...) chunk, and cut the concatenated outputs back to the
    true row count. The one chunking schedule every encode path shares;
    ``None`` arguments pass through untouched. ``fn`` returns a tensor or a
    tuple of tensors."""
    B = next(a for a in args if a is not None).shape[0]
    pad = (-B) % batch

    def _pad(x):
        if x is None or not pad:
            return x
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    padded = [_pad(a) for a in args]
    outs = [fn(*(None if a is None else a[s:s + batch] for a in padded))
            for s in range(0, B + pad, batch)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(col)[:B] for col in zip(*outs))
    return torch.cat(outs)[:B]


def encode_spectra_batched(spectra: PreprocessedSpectra, cb: Codebooks,
                           batch: int = 512,
                           backend: str = "oracle") -> torch.Tensor:
    """Memory-bounded encode: ``backend`` (any ``encode``-kind name) applied
    chunk by chunk. All backends are bit-identical."""
    from repro_torch.core import encode_backends

    be = encode_backends.get(backend)
    if be.kind != encode_backends.ENCODE:
        raise ValueError(
            f"encode_spectra_batched needs an {encode_backends.ENCODE!r}-kind "
            f"backend (got {backend!r}, kind {be.kind!r}); fused backends "
            "start from raw peaks — use encode_backends.preprocess_encode")

    def one(bins, levels, mask):
        return be.fn(PreprocessedSpectra(bins, levels, mask, None, None), cb)

    return chunked_batch_map(one, (spectra.bins, spectra.levels, spectra.mask),
                             batch)
