"""Plain version of the planner's reach kernel (csrc/plan_reach.cu), and
the exact (charge, float32) pair keys both search."""
from __future__ import annotations

import torch


def pair_key(charge: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (charge, float32 ``x``) pairs as numpy compares
    them and round nothing: the charge above 32 bits, below them the bits
    of ``x`` made monotone (a negative float's magnitude bits flipped;
    -0.0 is first read as +0.0, which numpy counts equal to it)."""
    b = (x + 0.0).view(torch.int32)
    return charge.to(torch.int64) * (1 << 32) + (b ^ ((b >> 31) & 0x7FFFFFFF))


def plan_reach(qp: torch.Tensor, qc: torch.Tensor, kmin: torch.Tensor,
               kmax: torch.Tensor, *, q_block: int,
               open_tol_da: float) -> torch.Tensor:
    """The most library blocks one q-block segment of the queries reaches.

    ``qp`` / ``qc`` are the queries sorted by (charge, pmz); a segment is a
    charge run cut at every ``q_block``-th query from the run's start. Each
    position gives ``lo = its segment's first pmz - tol`` and ``hi = its
    pmz + tol`` (float32); the blocks in reach are those of its charge with
    max pmz >= lo and min pmz <= hi, whose count is that of ``kmin`` keys <=
    (charge, hi) less that of ``kmax`` keys < (charge, lo) (the blocks of
    one charge ascend in both). ``hi`` ascends within a segment, so the
    largest count over all positions is the largest over the segments' last
    ones. Returns it as a one-element tensor, 0 where no segment reaches a
    block."""
    pos = torch.arange(qp.shape[0], device=qp.device)
    first = pos - (pos - torch.searchsorted(qc, qc)) % q_block
    hi = pair_key(qc, qp + open_tol_da)
    lo = pair_key(qc, qp[first] - open_tol_da)
    return (torch.searchsorted(kmin, hi, right=True)
            - torch.searchsorted(kmax, lo)).max().clamp(min=0)
