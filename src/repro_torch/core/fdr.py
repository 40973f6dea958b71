"""Target-decoy FDR filtering (paper §II-D).

Counterpart of the pooled half of ``repro.core.fdr``: matches are ranked by
score; at any cutoff FDR ≈ decoys / targets above it; each match's q-value
is the minimal FDR at which it is accepted (suffix minimum). Accepted
identifications are valid targets with q ≤ threshold. The shift-grouped and
per-query variants come with the cascade slice.
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


def compute_q_values(scores: torch.Tensor, is_decoy: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q-value per match, higher score is better. (Q,) or (Q, k) inputs; for
    top-k the competition runs over the pooled (query, rank) matches."""
    shape = scores.shape
    scores = scores.reshape(-1)
    is_decoy = is_decoy.reshape(-1)
    valid = valid.reshape(-1)
    # Invalid rows sink to the bottom of the ranking.
    neg_inf = float(np.finfo(np.float32).min)
    s = torch.where(valid, scores.to(torch.float32), neg_inf)
    order = torch.argsort(-s, stable=True)            # descending, stable
    d = is_decoy[order].to(torch.float32)
    v = valid[order].to(torch.float32)
    cum_decoy = torch.cumsum(d * v, dim=0)
    cum_target = torch.cumsum((1.0 - d) * v, dim=0)
    fdr = torch.clamp_max(cum_decoy / torch.clamp_min(cum_target, 1.0), 1.0)
    q_sorted = torch.flip(torch.cummin(torch.flip(fdr, [0]), dim=0).values, [0])
    q = torch.zeros_like(q_sorted).scatter(0, order, q_sorted)
    return torch.where(valid, q, 1.0).reshape(shape)


def fdr_filter(scores: torch.Tensor, is_decoy: torch.Tensor,
               valid: torch.Tensor, threshold: float = 0.01) -> FDRResult:
    _validate_threshold(threshold)
    q = compute_q_values(scores, is_decoy, valid)
    accept = valid & ~is_decoy & (q <= float(np.float32(threshold)))
    return FDRResult(accept=accept, q_values=q,
                     n_accepted=accept.sum(dtype=torch.int32))
