"""Running-argmax top-k selection under the winner-ranking contract.

Counterpart of ``repro.kernels.topk``. Candidates are ranked by (similarity
desc, column asc): ties resolve to the first maximum (``torch.argmax``
returns the first one), ranks past the valid candidates report -1. Invalid
inputs are marked -1; consumed entries sink to -2 so they are never
re-selected. ``torch.topk`` promises no tie order, so it is not used. The
CUDA fused_search kernel keeps the same contract on the device with an
exact composite key.
"""
from __future__ import annotations

import torch


def select_topk(s: torch.Tensor, k: int):
    """s: (Q, C) int32 masked sims, -1 = invalid.

    Returns ((Q, k) sims, (Q, k) column or -1).
    """
    s = s.clone()
    rows = torch.arange(s.shape[0], device=s.device)
    # A device scalar: a Python -2 would be copied from the host each round.
    consumed = s.new_full((), -2)
    sims_out, col_out = [], []
    for _ in range(k):
        arg = torch.argmax(s, dim=1)
        best = torch.clamp_min(s[rows, arg], -1)
        sims_out.append(best)
        col_out.append(torch.where(best >= 0, arg.to(torch.int32), -1))
        s.index_put_((rows, arg), consumed)
    return torch.stack(sims_out, dim=1), torch.stack(col_out, dim=1)


def merge_topk(sim_a, idx_a, sim_b, idx_b, k: int):
    """Merge two (Q, k) ranked winner lists (sim, payload-idx) into one.
    ``a`` must hold the earlier (lower-index) candidates: on sim ties the
    first occurrence wins."""
    sims = torch.cat([sim_a, sim_b], dim=1)
    idxs = torch.cat([idx_a, idx_b], dim=1)
    best, col = select_topk(sims, k)
    picked = torch.gather(idxs, 1, col.clamp(0, idxs.shape[1] - 1).long())
    return best, torch.where(col >= 0, picked, -1)
