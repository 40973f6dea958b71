"""Decoy reference generation for target-decoy FDR (paper §II-D).

Counterpart of ``repro.core.decoys``: fragment peaks keep their intensities
but move to uniform random m/z; the precursor stays, so decoys compete in
their targets' precursor windows. Randomness is row-keyed — global library
row r draws from ``fold_in(key, row_offset + r)`` — so any slice of the
library yields the same decoys as a whole-library pass, and the draws are
bit-identical with the reference's (see :mod:`repro_torch.core.rng`).
"""
from __future__ import annotations

import torch

from repro_torch.core import rng


def make_decoy_peaks(key: torch.Tensor, mz: torch.Tensor,
                     intensity: torch.Tensor, mz_min: float, mz_max: float, *,
                     row_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Shuffle peak positions: same intensities, random m/z. (B,P) -> (B,P).

    ``row_offset`` is the global library index of row 0 of this slice.
    """
    B, P = mz.shape
    rows = torch.arange(B, dtype=torch.int64, device=key.device) + row_offset
    keys = rng.fold_in(key, rows)                               # (B, 2)
    new_mz = rng.uniform(keys, (P,), minval=mz_min, maxval=mz_max)
    valid = intensity > 0
    return torch.where(valid, new_mz.to(mz.dtype), 0.0), intensity
