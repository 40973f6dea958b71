"""Plain PyTorch versions of the +-1 int8 kernels.

The tile is the plain MXU formulation ``(dim - q.r) // 2``
(:func:`repro_torch.core.packing.hamming_matrix_mxu`); the fused search is
the popc kernels' plain fused search with that tile. Used by the CUDA
wrappers for CPU tensors and as the yardsticks the kernels are held
against on the card.
"""
from __future__ import annotations

from repro_torch.core.packing import hamming_matrix_mxu
from repro_torch.kernels.hamming import ref as href


def hamming_matrix(q, r, dim: int):
    """All-pairs Hamming q (Q, W) x r (R, W) -> (Q, R) int32 via a +-1 dot."""
    return hamming_matrix_mxu(q, r, dim)


def fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows,
                 *, q_block: int, rk: int, dim: int, k: int,
                 ppm_tol: float = 20.0, open_tol_da: float = 75.0):
    """:func:`repro_torch.kernels.hamming.ref.fused_search` on the +-1 tile."""
    return href.fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge,
                             start_rows, q_block=q_block, rk=rk, dim=dim, k=k,
                             ppm_tol=ppm_tol, open_tol_da=open_tol_da,
                             tile_fn=hamming_matrix)
