"""Wrappers of the CUDA +-1 int8 tensor-core kernels: the all-pairs Hamming
tile (csrc/hamming_mxu.cu) and the fused dual-window search
(csrc/fused_search_mxu.cu).

Both need ``dim == 32 * W``, as the reference's wrappers do, and raise
``ValueError`` otherwise on every device. On CPU tensors they run the plain
versions (:mod:`.ref`); on CUDA tensors they launch the kernel or raise —
there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hamming import ops as hops
from repro_torch.kernels.hamming_mxu import ref

# fused_search_mxu's route scratch: one slice of expanded A fragments a
# query tile (csrc: Pm1Route::scratch_bytes), counted in its shared-memory
# bound.
FUSED_SCRATCH_PER_TILE = 8 * 32 * 16

launches = _build.LaunchCounter()           # fused_search_mxu
matrix_launches = _build.LaunchCounter()    # hamming_mxu


def _check_dim(dim: int, W: int) -> None:
    if dim != 32 * W:
        raise ValueError(f"the MXU kernels require dim == 32*W, got dim={dim} "
                         f"for W={W} words (pad HVs to words)")


@_build.kernel_op("hamming_mxu")
def hamming_matrix(q: torch.Tensor, r: torch.Tensor, dim: int, *,
                   ctas_per_sm: int = 0) -> torch.Tensor:
    """All-pairs Hamming q (Q, W) x r (R, W) int32 words -> (Q, R) int32,
    as ``(dim - dot) // 2`` of the +-1 product. ``ctas_per_sm`` sets the
    grid (0: the kernel's occupancy fill)."""
    _check_dim(dim, q.shape[1])
    if q.device.type == "cpu":
        return ref.hamming_matrix(q, r, dim)
    hops.check_pair("hamming_mxu", q, r)
    return hops.launch_tile("hamming_mxu", matrix_launches, q, r, dim,
                            ctas_per_sm)


@_build.kernel_op("fused_search_mxu")
def fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows,
                 *, q_block: int, rk: int, dim: int, k: int,
                 ppm_tol: float = 20.0, open_tol_da: float = 75.0,
                 waves: int = hops.FUSED_WAVES,
                 min_split_rows: int = hops.MIN_SPLIT_ROWS):
    """Dual-window top-k for every query block in one launch, the Hamming
    tile from the +-1 int8 dot; the contract of
    :func:`repro_torch.kernels.hamming.ops.fused_search`, bit for bit."""
    W = q_hvs.shape[1]
    _check_dim(dim, W)
    kw = dict(q_block=q_block, rk=rk, dim=dim, k=k, ppm_tol=ppm_tol,
              open_tol_da=open_tol_da)
    args = (q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows)
    if q_hvs.device.type == "cpu":
        return ref.fused_search(*args, **kw)
    return hops.launch_fused("fused_search_mxu", launches, *args, **kw,
                             waves=waves, min_split_rows=min_split_rows,
                             scratch_per_tile=FUSED_SCRATCH_PER_TILE)
