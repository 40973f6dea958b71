"""Comparison baselines the paper evaluates against (§III-B/D).

Counterpart of ``repro.core.baselines``:

  * ``exhaustive`` HDC search — HyperOMS [Kang+ PACT'22]: identical HD
    encoding + Hamming scoring, but *every* query is compared against *every*
    reference (no PMZ block pruning): ``SearchParams(exhaustive=True)``,
    re-exported here for discoverability.
  * ``shifted_cosine`` — ANN-SoLo-style [Bittremieux+ JPR'18] scoring on
    dense binned intensity vectors: standard cosine within the ppm window and
    a *shifted* dot product for the open window, where fragment peaks may
    match either at their own m/z or displaced by the precursor mass delta.
  * ``spectrast_dot`` — SpectraST-style plain normalised dot product within
    the standard window only (closed search).

These are quality/runtime baselines for the Fig. 5 / Table I benchmarks on
modest library slices (they are O(Q·R·bins) dense). The reference computes
them outside any Pallas kernel, so they stay plain PyTorch: binning runs on
``device`` (``cuda`` unless the caller asks for the CPU), and the scoring
functions on the device of the vectors they are given. Binning is exact (the reference's float32 ops in its order, the
sqrt correctly rounded); the dot products and norms are float32 reductions
whose summation order differs from XLA's, so scores agree with the
reference to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.search import SearchParams


def exhaustive_params(base: SearchParams = SearchParams()) -> SearchParams:
    """HyperOMS baseline = same engine, no block pruning."""
    return base._replace(exhaustive=True)


# ---------------------------------------------------------------------------
# Dense binned-vector scoring (ANN-SoLo / SpectraST style)
# ---------------------------------------------------------------------------


def bin_spectra_dense(mz, intensity, *, bin_size, mz_min, mz_max,
                      device=None):
    """(B, P) peaks -> (B, n_bins) sqrt-scaled L2-normalised dense vectors.

    ``mz`` / ``intensity`` (numpy or tensors) are moved to ``device``
    (``None`` -> ``cuda``, which raises without a GPU)."""
    dev = resolve_device(device)
    mz = torch.as_tensor(mz, dtype=torch.float32, device=dev)
    intensity = torch.as_tensor(intensity, dtype=torch.float32, device=dev)
    n_bins = int(round((mz_max - mz_min) / bin_size))
    valid = intensity > 0
    bins = torch.clamp(((mz - mz_min) / bin_size).to(torch.int32), 0,
                       n_bins - 1)
    # float64 sqrt rounded once: the correctly rounded float32 sqrt (torch's
    # vectorised float32 sqrt on the CPU is not, XLA's is).
    inten = torch.sqrt(torch.where(valid, intensity, 0.0).to(torch.float64)
                       ).to(torch.float32)
    vec = torch.zeros((mz.shape[0], n_bins), dtype=torch.float32,
                      device=mz.device)
    vec.scatter_add_(1, bins.long(), inten)
    norm = torch.clamp_min(torch.linalg.vector_norm(vec, dim=-1, keepdim=True),
                           1e-9)
    return vec / norm


class DenseSearchResult(NamedTuple):
    std_idx: torch.Tensor     # (Q,) int32, -1 if nothing in the window
    std_score: torch.Tensor   # (Q,) float32, -2.0 if nothing in the window
    open_idx: torch.Tensor
    open_score: torch.Tensor


def _dual_window_argmax(scores, q_pmz, r_pmz, q_charge, r_charge,
                        ppm_tol, open_tol_da):
    dpmz = torch.abs(q_pmz[:, None] - r_pmz[None, :])
    chg = q_charge[:, None] == r_charge[None, :]
    std_m = chg & (dpmz <= q_pmz[:, None] * ppm_tol * 1e-6)
    open_m = chg & (dpmz <= open_tol_da)
    neg = torch.tensor(-2.0, dtype=torch.float32, device=scores.device)
    s_std = torch.where(std_m, scores, neg)
    s_open = torch.where(open_m, scores, neg)
    # argmax keeps the first maximum, as jnp.argmax
    std_idx = torch.argmax(s_std, dim=1)
    open_idx = torch.argmax(s_open, dim=1)
    std_sc = torch.gather(s_std, 1, std_idx[:, None])[:, 0]
    open_sc = torch.gather(s_open, 1, open_idx[:, None])[:, 0]
    none = torch.tensor(-1, dtype=torch.int32, device=scores.device)
    return (torch.where(std_sc > neg, std_idx.to(torch.int32), none), std_sc,
            torch.where(open_sc > neg, open_idx.to(torch.int32), none), open_sc)


def spectrast_dot(q_vec, r_vec, q_pmz, r_pmz, q_charge, r_charge,
                  *, ppm_tol=20.0, open_tol_da=75.0) -> DenseSearchResult:
    """Plain cosine (vectors are normalised) under both windows."""
    scores = q_vec @ r_vec.T
    return DenseSearchResult(*_dual_window_argmax(
        scores, q_pmz, r_pmz, q_charge, r_charge, ppm_tol, open_tol_da))


def shifted_cosine(q_vec, r_vec, q_pmz, r_pmz, q_charge, r_charge,
                   *, bin_size, ppm_tol=20.0, open_tol_da=75.0,
                   shift_chunk: int = 128) -> DenseSearchResult:
    """ANN-SoLo-style shifted dot product for the open window.

    For pair (q, r) with precursor delta Δ, fragment peaks of q may match
    reference peaks at their own bin (unmodified ions) or at bin + Δ/bin_size
    (ions carrying the modification). Score = cos(q, r + roll(r, Δbins))
    clipped to [0, 1] — an upper-bound variant of the tier-wise scheme that
    preserves its key property: modified spectra score high despite the shift.

    Computed one query at a time (the reference's ``lax.map``), so the
    intermediate is (R, bins). ``shift_chunk`` is kept only for signature
    parity with the reference, which does not use it either.
    """
    R, n_bins = r_vec.shape
    cols = torch.arange(n_bins, device=r_vec.device)
    std_s = torch.empty((q_vec.shape[0], R), dtype=torch.float32,
                        device=r_vec.device)
    open_s = torch.empty_like(std_s)
    for i in range(q_vec.shape[0]):
        qv, qp = q_vec[i], q_pmz[i]
        delta_bins = torch.round((qp - r_pmz) / bin_size).to(torch.int64)
        # jnp.roll(rv, d)[j] == rv[(j - d) mod n_bins]
        shifted = torch.gather(
            r_vec, 1, torch.remainder(cols[None, :] - delta_bins[:, None],
                                      n_bins))
        both = torch.maximum(r_vec, shifted)
        open_s[i] = torch.clamp_max(both @ qv, 1.0)
        std_s[i] = r_vec @ qv
    std = _dual_window_argmax(std_s, q_pmz, r_pmz, q_charge, r_charge,
                              ppm_tol, open_tol_da)[:2]
    opn = _dual_window_argmax(open_s, q_pmz, r_pmz, q_charge, r_charge,
                              ppm_tol, open_tol_da)[2:]
    return DenseSearchResult(std[0], std[1], opn[0], opn[1])
