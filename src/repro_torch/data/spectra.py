"""Synthetic mass-spectral libraries calibrated to the paper's Table I.

Counterpart of ``repro.data.spectra`` with the same configuration and the
same generative model — random fragment ladders as references; noisy,
partly mass-shifted replicas of them as queries, with planted ground truth
— drawn from numpy's ``default_rng(seed)``. The draws are therefore not
bit-equal to the reference's ``jax.random`` ones; cross-checks against the
reference feed both packages arrays the reference generated.

Arrays are host numpy (float32 / int32); the pipeline uploads them chunk by
chunk.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LibraryConfig:
    n_refs: int = 4096
    n_queries: int = 512
    max_peaks: int = 64
    min_peaks: int = 24
    mz_min: float = 200.0
    mz_max: float = 2000.0
    pmz_min: float = 400.0
    pmz_max: float = 1800.0
    charges: tuple[int, ...] = (2, 3)
    modified_frac: float = 0.5      # fraction of queries with a PTM-style shift
    open_tol_da: float = 75.0
    dropout: float = 0.15           # per-peak dropout probability in queries
    mz_jitter: float = 0.01         # Da jitter on query peaks
    intensity_jitter: float = 0.2   # lognormal sigma on query peak intensities
    seed: int = 0


class SpectraSet(NamedTuple):
    mz: np.ndarray          # (B, P) float32, 0 padded — fragment m/z
    intensity: np.ndarray   # (B, P) float32, 0 padded
    pmz: np.ndarray         # (B,) float32 — precursor mass the windows apply to
    charge: np.ndarray      # (B,) int32


class SyntheticDataset(NamedTuple):
    refs: SpectraSet
    queries: SpectraSet
    query_source: np.ndarray    # (Q,) int32 — ground-truth reference index
    query_modified: np.ndarray  # (Q,) bool — True where a mass shift was planted
    query_shift: np.ndarray     # (Q,) float32 — planted precursor shift (Da)


def _make_refs(rng: np.random.Generator, cfg: LibraryConfig) -> SpectraSet:
    B, P = cfg.n_refs, cfg.max_peaks
    n_peaks = rng.integers(cfg.min_peaks, cfg.max_peaks + 1, B)
    mask = np.arange(P)[None, :] < n_peaks[:, None]
    mz = rng.uniform(cfg.mz_min, cfg.mz_max, (B, P)).astype(np.float32)
    inten = (rng.standard_exponential((B, P), dtype=np.float32)
             + np.float32(0.05))
    pmz = rng.uniform(cfg.pmz_min, cfg.pmz_max, B).astype(np.float32)
    charge = np.asarray(cfg.charges, np.int32)[rng.integers(0, len(cfg.charges), B)]
    return SpectraSet(mz=np.where(mask, mz, np.float32(0)),
                      intensity=np.where(mask, inten, np.float32(0)),
                      pmz=pmz, charge=charge)


def _make_queries(rng: np.random.Generator, refs: SpectraSet, cfg: LibraryConfig):
    Q, P = cfg.n_queries, cfg.max_peaks
    src = rng.integers(0, refs.mz.shape[0], Q).astype(np.int32)
    mz = refs.mz[src]
    inten = refs.intensity[src]
    valid = inten > 0

    # Peak dropout + intensity jitter + m/z jitter.
    keep = (rng.random((Q, P)) < 1.0 - cfg.dropout) & valid
    mz = mz + (rng.standard_normal((Q, P)) * cfg.mz_jitter).astype(np.float32)
    inten = inten * np.exp(rng.standard_normal((Q, P)) * cfg.intensity_jitter
                           ).astype(np.float32)

    # Plant modifications: shift the precursor by a delta and every fragment
    # above a random breakpoint by the same delta (PTM on a suffix residue).
    modified = rng.random(Q) < cfg.modified_frac
    shift = rng.uniform(-cfg.open_tol_da, cfg.open_tol_da, Q).astype(np.float32)
    # Keep shifts away from ~0 so "modified" really is out of the ppm window.
    shift = np.where(np.abs(shift) < 2.0, np.sign(shift) * 2.0 + shift, shift)
    shift = np.where(modified, shift, 0.0).astype(np.float32)
    breakpoint_mz = rng.uniform(cfg.mz_min, cfg.mz_max, Q).astype(np.float32)
    frag_shift = np.where((mz > breakpoint_mz[:, None]) & modified[:, None],
                          shift[:, None], np.float32(0))
    mz = mz + frag_shift

    queries = SpectraSet(
        mz=np.where(keep, np.clip(mz, cfg.mz_min, cfg.mz_max - 1e-3),
                    0.0).astype(np.float32),
        intensity=np.where(keep, inten, 0.0).astype(np.float32),
        pmz=(refs.pmz[src] + shift).astype(np.float32),
        charge=refs.charge[src],
    )
    return queries, src, modified, shift


def make_dataset(cfg: LibraryConfig) -> SyntheticDataset:
    rng = np.random.default_rng(cfg.seed)
    refs = _make_refs(rng, cfg)
    queries, src, modified, shift = _make_queries(rng, refs, cfg)
    return SyntheticDataset(refs=refs, queries=queries, query_source=src,
                            query_modified=modified, query_shift=shift)


# Paper Table I presets (scale=1.0 reproduces the paper's library sizes).
def iprg2012_config(scale: float = 1.0, seed: int = 0) -> LibraryConfig:
    return LibraryConfig(
        n_refs=max(int(1_160_000 * scale), 1024),
        n_queries=max(int(16_000 * scale), 128),
        open_tol_da=75.0,
        seed=seed,
    )


def hek293_config(scale: float = 1.0, seed: int = 0) -> LibraryConfig:
    return LibraryConfig(
        n_refs=max(int(3_000_000 * scale), 1024),
        n_queries=max(int(47_000 * scale), 128),
        open_tol_da=75.0,
        seed=seed,
    )
