"""Plain PyTorch version of the hdencode kernel: the word-tiled encode of
:mod:`repro_torch.core.encoding`, bit-identical to the oracle."""
from __future__ import annotations

import torch

from repro_torch.core.encoding import (Codebooks, PreprocessedSpectra,
                                       encode_spectra_word_tiled)


def hdencode(bins: torch.Tensor, levels: torch.Tensor, mask: torch.Tensor,
             id_hvs: torch.Tensor, level_hvs: torch.Tensor,
             tiebreak: torch.Tensor) -> torch.Tensor:
    """bins/levels (B, P) int32, mask (B, P) bool, codebooks packed int32
    -> (B, W) int32 packed HVs."""
    cb = Codebooks(id_hvs=id_hvs, level_hvs=level_hvs, tiebreak=tiebreak,
                   dim=32 * id_hvs.shape[1])
    return encode_spectra_word_tiled(
        PreprocessedSpectra(bins, levels, mask, None, None), cb)
