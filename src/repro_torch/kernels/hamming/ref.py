"""Plain PyTorch versions of the popc kernels: the all-pairs Hamming tile
and the fused dual-window top-k search.

The fused search materialises each query block's (Qb, rk) similarity tile
and reduces it with :func:`repro_torch.kernels.topk.select_topk`, exactly
as the reference's ``fused_xla`` backend and matrix backends do. Used by
the CUDA wrappers for CPU tensors, by backend ``fused_xla`` and the matrix
backends, and as the yardsticks the kernels are held against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blocking import PAD_PMZ
from repro_torch.core.packing import hamming_matrix_packed
from repro_torch.kernels.topk import select_topk

# All-pairs Hamming q (Q, W) x r (R, W) -> (Q, R) int32 (XOR + popcount).
hamming_matrix = hamming_matrix_packed


def std_scale(ppm_tol: float) -> float:
    """The standard-window factor as the reference applies it: the Python
    product ``ppm_tol * 1e-6`` rounded once to float32 (weak typing)."""
    return float(np.float32(ppm_tol * 1e-6))


def window_masks(q_pmz, r_pmz, q_charge, r_charge, *, ppm_tol: float,
                 open_tol_da: float):
    """(std_mask, open_mask), each (Qb, R) bool: charge and PAD validity
    with the standard ppm and the open Da window, in the reference's float32
    arithmetic."""
    dpmz = torch.abs(q_pmz[:, None] - r_pmz[None, :])
    valid = (r_pmz[None, :] < PAD_PMZ) & (q_charge[:, None] == r_charge[None, :])
    std_mask = valid & (dpmz <= q_pmz[:, None] * std_scale(ppm_tol))
    open_mask = valid & (dpmz <= float(np.float32(open_tol_da)))
    return std_mask, open_mask


def dual_window_topk(sims, q_pmz, r_pmz, q_charge, r_charge, *, k: int,
                     ppm_tol: float, open_tol_da: float):
    """Dual-window top-k over one (Qb, R) similarity tile.

    Returns (std_sim, std_col, open_sim, open_col), each (Qb, k) int32 with
    col = column in the tile or -1.
    """
    std_mask, open_mask = window_masks(q_pmz, r_pmz, q_charge, r_charge,
                                       ppm_tol=ppm_tol, open_tol_da=open_tol_da)
    std_s, std_a = select_topk(torch.where(std_mask, sims, -1), k)
    open_s, open_a = select_topk(torch.where(open_mask, sims, -1), k)
    return std_s, std_a, open_s, open_a


def fused_search_block(q_hvs, r_hvs, q_pmz, r_pmz, q_charge, r_charge, *,
                       dim: int, k: int, ppm_tol: float, open_tol_da: float,
                       tile_fn=None):
    """One query block against one contiguous row slice; columns relative
    to the slice. ``tile_fn(q, r, dim)`` gives the Hamming tile (default:
    packed XOR + popcount)."""
    ham = (hamming_matrix_packed(q_hvs, r_hvs) if tile_fn is None
           else tile_fn(q_hvs, r_hvs, dim))
    return dual_window_topk(dim - ham, q_pmz, r_pmz, q_charge, r_charge, k=k,
                            ppm_tol=ppm_tol, open_tol_da=open_tol_da)


def fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows,
                 *, q_block: int, rk: int, dim: int, k: int,
                 ppm_tol: float = 20.0, open_tol_da: float = 75.0, tile_fn=None):
    """All query blocks: block b (rows ``[b*q_block, (b+1)*q_block)`` of the
    sorted/padded queries) scans DB rows ``[start_rows[b], start_rows[b] +
    rk)``, cut at the last row. Returns (std_sim, std_row, open_sim,
    open_row), each (Qp, k) int32 with GLOBAL rows (or -1).

    The start rows stay on the device: each block gathers its rows by a
    device index (:func:`scan_rows`), so the loop never waits for the
    device to hand a start row to the host."""
    outs = []
    for b in range(start_rows.shape[0]):
        qs = slice(b * q_block, (b + 1) * q_block)
        s = start_rows[b]
        _, r_b, pmz_b, charge_b = scan_rows(s, rk, r_hvs, r_pmz, r_charge)
        ss, sa, os_, oa = fused_search_block(
            q_hvs[qs], r_b, q_pmz[qs], pmz_b, q_charge[qs], charge_b,
            dim=dim, k=k, ppm_tol=ppm_tol, open_tol_da=open_tol_da,
            tile_fn=tile_fn)
        outs.append((ss, torch.where(ss >= 0, s + sa, -1),
                     os_, torch.where(os_ >= 0, s + oa, -1)))
    return tuple(torch.cat(col) for col in zip(*outs))


def scan_rows(start: torch.Tensor, rk: int, r_hvs, r_pmz, r_charge):
    """Rows ``[start, start + rk)`` of the reference arrays, ``start`` a 0-d
    device tensor: the (rk,) row index, then (rk, W) words, (rk,) pmz and
    charge gathered by it. Rows past the last one repeat it with a PAD pmz,
    which no window admits, so a block near the end scans as its cut slice
    would."""
    n = r_pmz.shape[0]
    idx = start.to(torch.int64) + torch.arange(rk, device=r_pmz.device)
    inside = idx < n
    idx = idx.clamp_max(n - 1)
    return (idx, r_hvs.index_select(0, idx),
            torch.where(inside, r_pmz.index_select(0, idx), PAD_PMZ),
            r_charge.index_select(0, idx))
