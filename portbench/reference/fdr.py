"""Target-decoy FDR over the pooled (query, rank) matches of one run.

Frozen copy of ``compute_q_values`` / ``fdr_filter`` of
``src/repro_torch/core/fdr.py`` at commit 0d012dd: matches ranked by
similarity (stable, descending), FDR at each cutoff = decoys / targets above
it, q-value = the suffix minimum of the FDR; accepted = a valid target with
q <= the threshold rounded to float32. Invalid matches (no winner) sink to
the bottom and get q = 1.
"""
from __future__ import annotations

import numpy as np
import torch


def fdr_filter(sims: torch.Tensor, is_decoy: torch.Tensor, valid: torch.Tensor,
               threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(accept, q_values) of (Q, k) matches, same shape."""
    shape = sims.shape
    s = torch.where(valid, sims.to(torch.float32), float(np.finfo(np.float32).min)).reshape(1, -1)
    d0, v0 = is_decoy.reshape(1, -1), valid.reshape(1, -1)
    order = torch.argsort(-s, dim=1, stable=True)
    d = torch.gather(d0, 1, order).to(torch.float32)
    v = torch.gather(v0, 1, order).to(torch.float32)
    cum_decoy = torch.cumsum(d * v, dim=1)
    cum_target = torch.cumsum((1.0 - d) * v, dim=1)
    fdr = torch.clamp_max(cum_decoy / torch.clamp_min(cum_target, 1.0), 1.0)
    q_sorted = torch.flip(torch.cummin(torch.flip(fdr, [1]), dim=1).values, [1])
    q = torch.zeros_like(q_sorted).scatter(1, order, q_sorted).reshape(shape)
    q = torch.where(valid, q, 1.0)
    accept = valid & ~is_decoy & (q <= float(np.float32(threshold)))
    return accept, q
