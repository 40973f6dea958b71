"""Wrappers of the CUDA +-1 int8 tensor-core kernels: the all-pairs Hamming
tile (csrc/hamming_mxu.cu) and the fused dual-window search
(csrc/fused_search_mxu.cu).

Both need ``dim == 32 * W``, as the reference's wrappers do, and raise
``ValueError`` otherwise on every device. On CPU tensors they run the plain
versions (:mod:`.ref`); on CUDA tensors they launch the kernel or raise —
there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hamming import ops as hops
from repro_torch.kernels.hamming_mxu import ref

W_MAX_FUSED = 256   # the fused kernel's limit (csrc: MXU_W_MAX)

launches = _build.LaunchCounter()           # fused_search_mxu
matrix_launches = _build.LaunchCounter()    # hamming_mxu


def _check_dim(dim: int, W: int) -> None:
    if dim != 32 * W:
        raise ValueError(f"the MXU kernels require dim == 32*W, got dim={dim} "
                         f"for W={W} words (pad HVs to words)")


def hamming_matrix(q: torch.Tensor, r: torch.Tensor, dim: int) -> torch.Tensor:
    """All-pairs Hamming q (Q, W) x r (R, W) int32 words -> (Q, R) int32,
    as ``(dim - dot) // 2`` of the +-1 product."""
    _check_dim(dim, q.shape[1])
    if q.device.type == "cpu":
        return ref.hamming_matrix(q, r, dim)
    dev = hops.check_pair("hamming_mxu", q, r)
    Q, W = q.shape
    R = r.shape[0]
    out = torch.empty((Q, R), dtype=torch.int32, device=dev)
    if Q == 0 or R == 0:
        return out
    rc = _build.library().hamming_mxu_launch(
        _build.ptr(q), _build.ptr(r), _build.ptr(out), ctypes.c_int(Q),
        ctypes.c_int(R), ctypes.c_int(W), ctypes.c_int(dim),
        _build.stream_ptr(dev))
    _build.check(rc, "hamming_mxu_launch")
    matrix_launches.count += 1
    return out


def fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows,
                 *, q_block: int, rk: int, dim: int, k: int,
                 ppm_tol: float = 20.0, open_tol_da: float = 75.0):
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
    if W > W_MAX_FUSED:
        raise ValueError(f"fused_search_mxu: the CUDA kernel takes at most "
                         f"{W_MAX_FUSED} words, got {W}")
    return hops.launch_fused("fused_search_mxu", launches, *args, **kw)
