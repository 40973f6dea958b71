"""Target-decoy FDR filtering (paper §II-D) and its subgroup variants.

Counterpart of ``repro.core.fdr``: matches are ranked by score; at any
cutoff FDR ≈ decoys / targets above it; each match's q-value is the minimal
FDR at which it is accepted (suffix minimum). Accepted identifications are
valid targets with q ≤ threshold. Three competitions: pooled over every
(query, rank) match (:func:`fdr_filter`), per query over its own top-k
list (:func:`fdr_filter_per_query`, the serve mode: a query's decision
does not depend on its batchmates), and shift-grouped, separately over the
standard (|Δpmz| ≤ narrow tol) and the open population
(:func:`fdr_filter_grouped`, the narrow→open cascade's final filter).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FDRResult(NamedTuple):
    accept: torch.Tensor      # (Q,) / (Q, k) bool — identified at the threshold
    q_values: torch.Tensor    # (Q,) / (Q, k) float32 — 1.0 for no-match
    n_accepted: torch.Tensor  # () int32


def _validate_threshold(threshold: float) -> None:
    if not 0.0 < threshold <= 1.0:
        raise ValueError(f"FDR threshold must be in (0, 1], got {threshold!r}")


def _q_values_rows(scores: torch.Tensor, is_decoy: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """q-values of (n, m) matches, one independent competition per row."""
    # Invalid rows sink to the bottom of the ranking.
    neg_inf = float(np.finfo(np.float32).min)
    s = torch.where(valid, scores.to(torch.float32), neg_inf)
    order = torch.argsort(-s, dim=1, stable=True)     # descending, stable
    d = torch.gather(is_decoy, 1, order).to(torch.float32)
    v = torch.gather(valid, 1, order).to(torch.float32)
    cum_decoy = torch.cumsum(d * v, dim=1)
    cum_target = torch.cumsum((1.0 - d) * v, dim=1)
    fdr = torch.clamp_max(cum_decoy / torch.clamp_min(cum_target, 1.0), 1.0)
    q_sorted = torch.flip(torch.cummin(torch.flip(fdr, [1]), dim=1).values, [1])
    q = torch.zeros_like(q_sorted).scatter(1, order, q_sorted)
    return torch.where(valid, q, 1.0)


def compute_q_values(scores: torch.Tensor, is_decoy: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q-value per match, higher score is better. (Q,) or (Q, k) inputs; for
    top-k the competition runs over the pooled (query, rank) matches."""
    return _q_values_rows(scores.reshape(1, -1), is_decoy.reshape(1, -1),
                          valid.reshape(1, -1)).reshape(scores.shape)


def compute_q_values_grouped(scores: torch.Tensor, is_decoy: torch.Tensor,
                             valid: torch.Tensor,
                             in_narrow: torch.Tensor) -> torch.Tensor:
    """Shift-grouped q-values: separate competitions over the ``in_narrow``
    (standard) and the remaining (open) matches; invalid matches get 1.0."""
    q_std = compute_q_values(scores, is_decoy, valid & in_narrow)
    q_open = compute_q_values(scores, is_decoy, valid & ~in_narrow)
    return torch.where(valid, torch.where(in_narrow, q_std, q_open), 1.0)


def _filtered(q: torch.Tensor, is_decoy: torch.Tensor, valid: torch.Tensor,
              threshold: float) -> FDRResult:
    # The reference compares float32 q-values with a weakly typed Python
    # float, i.e. with the threshold rounded to float32.
    accept = valid & ~is_decoy & (q <= float(np.float32(threshold)))
    return FDRResult(accept=accept, q_values=q,
                     n_accepted=accept.sum(dtype=torch.int32))


def fdr_filter(scores: torch.Tensor, is_decoy: torch.Tensor,
               valid: torch.Tensor, threshold: float = 0.01) -> FDRResult:
    _validate_threshold(threshold)
    return _filtered(compute_q_values(scores, is_decoy, valid), is_decoy,
                     valid, threshold)


def fdr_filter_per_query(scores: torch.Tensor, is_decoy: torch.Tensor,
                         valid: torch.Tensor,
                         threshold: float = 0.01) -> FDRResult:
    """Per-query competition over each query's own (k,) top-k list, never
    across queries (the reference's ``vmap`` of the pooled q-values), so
    coalescing queries into a batch cannot change a decision. Needs (Q, k)
    inputs."""
    _validate_threshold(threshold)
    if scores.dim() != 2:
        raise ValueError(
            f"fdr_filter_per_query needs (Q, k) matches, got {tuple(scores.shape)}")
    return _filtered(_q_values_rows(scores, is_decoy, valid), is_decoy, valid,
                     threshold)


def fdr_filter_grouped(scores: torch.Tensor, is_decoy: torch.Tensor,
                       valid: torch.Tensor, in_narrow: torch.Tensor,
                       threshold: float = 0.01) -> FDRResult:
    """Accept a match when its own subgroup's q-value clears the threshold."""
    _validate_threshold(threshold)
    return _filtered(compute_q_values_grouped(scores, is_decoy, valid, in_narrow),
                     is_decoy, valid, threshold)
