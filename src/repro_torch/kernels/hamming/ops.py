"""Wrappers of the CUDA packed Hamming kernels: the fused dual-window search
(csrc/fused_search.cu, grouped query tiles on the binary tensor cores) and
the all-pairs Hamming tile (csrc/hamming_matrix.cu, binary tensor-core
MMA).

On CPU tensors they run the plain versions (:mod:`.ref`); on CUDA tensors
they launch the kernel or raise — there is no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.blocking import PAD_PMZ
from repro_torch.kernels import _build
from repro_torch.kernels.hamming import ref

QT = 16            # queries per kernel tile (csrc: QT)
GROUP = 8          # query tiles per CTA of the fused kernels (csrc: GROUP)
K_MAX = 64         # largest top_k the fused kernels keep (csrc: KMAX)
# Shared memory of one fused CTA (csrc/fused_grouped.cuh: SMEM_BUDGET,
# RING_BYTES): G tiles' queries padded to 16-word steps, 2 * 16 lists of
# k 8-byte keys per tile, the row rings, and the route's scratch.
FUSED_SMEM_BUDGET = 220 * 1024
FUSED_RING_BYTES = 8 * 4 * 32 * 16 * 4
# hamming_matrix stages 16 queries' words (padded to 16) in shared memory,
# at most 232,448 bytes: wider rows run as word chunks whose tiles add up.
TILE_W_CHUNK = 3584
# Query tiles of one tile-kernel launch (gridDim.y); more run in batches.
TILE_Q_CHUNK = 65535 * QT
# Fused kernels: waves of CTAs to aim for (their register use fits one CTA
# per SM), so that groups of unequal row spans even out.
FUSED_WAVES = 4
MIN_SPLIT_ROWS = 1024   # never fewer rows per split (four passes of 256)
# Padding queries carry this charge, which no reference row has.
PAD_Q_CHARGE = -(2 ** 30)

launches = _build.LaunchCounter()           # fused_search
matrix_launches = _build.LaunchCounter()    # hamming_matrix


def n_splits_for(n_tiles: int, rk: int, n_sms: int, *,
                 waves: int = FUSED_WAVES,
                 min_split_rows: int = MIN_SPLIT_ROWS) -> int:
    """CTAs per group of GROUP query tiles: ``waves`` waves of one CTA per
    SM even for a handful of tiles, but never fewer than ``min_split_rows``
    rows of a tile's scan per CTA. The tunable launch parameters of the
    fused kernels (``repro_torch.tune``); the split merge makes the output
    bit-identical at every value."""
    n_groups = -(-n_tiles // GROUP)
    want = -(-waves * n_sms // n_groups)
    return max(1, min(want, -(-rk // min_split_rows)))


def fused_partial_bytes(n_queries: int, q_block: int, rk: int, k: int,
                        n_sms: int, *, waves: int = FUSED_WAVES,
                        min_split_rows: int = MIN_SPLIT_ROWS) -> int:
    """Bytes of the fused wrappers' largest allocation, the split kernel's
    ``partial`` buffer (n_tiles, n_splits, 2 * QT, k) int64, for a batch of
    ``n_queries`` sorted/padded queries in blocks of ``q_block``."""
    n_tiles = n_queries // q_block * (-(-q_block // QT))
    n_splits = n_splits_for(n_tiles, rk, n_sms, waves=waves,
                            min_split_rows=min_split_rows)
    return n_tiles * n_splits * 2 * QT * k * 8


def group_spans(tile_start: torch.Tensor, rk: int, n_rows: int) -> torch.Tensor:
    """(n_groups, 2) int64 [begin, end) of the rows each CTA group of the
    fused kernels walks: the union of its GROUP consecutive tiles' scans
    ``[min start, max start + rk)``, clipped to ``n_rows`` (the kernel
    computes the same on the device)."""
    s = tile_start.to(torch.int64)
    pad = (-s.shape[0]) % GROUP
    lo = torch.cat([s, s.new_full((pad,), s.max())]).reshape(-1, GROUP).amin(dim=1)
    hi = torch.cat([s, s.new_full((pad,), s.min())]).reshape(-1, GROUP).amax(dim=1)
    return torch.stack([lo, torch.maximum(lo, torch.clamp(hi + rk, max=n_rows))], dim=1)


def _pad_blocks(x, nqb, q_block, per_block, value):
    """(nqb*q_block, ...) -> (nqb*per_block, ...), each block padded."""
    xb = x.reshape(nqb, q_block, *x.shape[1:])
    pad = xb.new_full((nqb, per_block - q_block, *x.shape[1:]), value)
    return torch.cat([xb, pad], dim=1).reshape(nqb * per_block, *x.shape[1:])


def fused_smem_bytes(G: int, W: int, k: int, scratch_per_tile: int = 0) -> int:
    """Dynamic shared memory of one fused CTA of G query tiles (the
    kernel's smem_for); ``scratch_per_tile`` is the route's (fused_mxu:
    4,096 bytes a tile)."""
    wp = -(-W // 16) * 16
    return 4 * G * QT * wp + 8 * G * 2 * QT * k + FUSED_RING_BYTES + scratch_per_tile * G


@_build.kernel_op("hamming_matrix")
def hamming_matrix(q: torch.Tensor, r: torch.Tensor, *,
                   ctas_per_sm: int = 0) -> torch.Tensor:
    """All-pairs Hamming: q (Q, W) x r (R, W) int32 words -> (Q, R) int32.
    Rows wider than TILE_W_CHUNK words run as word chunks (one launch each,
    tiles summed); more than TILE_Q_CHUNK queries as query batches.
    ``ctas_per_sm`` sets the grid (0: the kernel's occupancy fill)."""
    if q.device.type == "cpu":
        return ref.hamming_matrix(q, r)
    check_pair("hamming_matrix", q, r)
    W = q.shape[1]
    if W > TILE_W_CHUNK:
        out = None
        for w0 in range(0, W, TILE_W_CHUNK):
            part = hamming_matrix(q[:, w0:w0 + TILE_W_CHUNK].contiguous(),
                                  r[:, w0:w0 + TILE_W_CHUNK].contiguous(),
                                  ctas_per_sm=ctas_per_sm)
            out = part if out is None else out.add_(part)
        return out
    return launch_tile("hamming_matrix", matrix_launches, q, r, ctas_per_sm)


def launch_tile(kernel: str, counter: _build.LaunchCounter, q, r, *extra):
    """Launch ``<kernel>_launch(q, r, out, Q, R, W, *extra, stream)`` over
    batches of at most TILE_Q_CHUNK queries; ``counter`` counts each."""
    Q, W = q.shape
    R = r.shape[0]
    dev = q.device
    out = torch.empty((Q, R), dtype=torch.int32, device=dev)
    if Q == 0 or R == 0:
        return out
    launcher = getattr(_build.library(), f"{kernel}_launch")
    rest = [ctypes.c_int(R), ctypes.c_int(W), *map(ctypes.c_int, extra)]
    # One launch on the whole tensors unless the batch must be cut.
    parts = ([(q, out)] if Q <= TILE_Q_CHUNK else
             [(q[i:i + TILE_Q_CHUNK], out[i:i + TILE_Q_CHUNK])
              for i in range(0, Q, TILE_Q_CHUNK)])
    for qs, os_ in parts:
        with _build.on_device(dev):
            rc = launcher(_build.ptr(qs), _build.ptr(r), _build.ptr(os_),
                          ctypes.c_int(qs.shape[0]), *rest, _build.stream_ptr(dev))
        _build.check(rc, f"{kernel}_launch")
        counter.count += 1
    return out


def check_pair(kernel: str, q: torch.Tensor, r: torch.Tensor) -> torch.device:
    """Validate a (Q, W) x (R, W) pair of packed-word tensors for a tile
    kernel; returns their device."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    _build.check_tensor(kernel, "q", q, torch.int32, 2, dev)
    _build.check_tensor(kernel, "r", r, torch.int32, 2, dev)
    if q.shape[1] != r.shape[1] or q.shape[1] < 1:
        raise ValueError(f"{kernel}: query width {q.shape[1]} != reference "
                         f"width {r.shape[1]}")
    return dev


@_build.kernel_op("fused_search")
def fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows,
                 *, q_block: int, rk: int, dim: int, k: int,
                 ppm_tol: float = 20.0, open_tol_da: float = 75.0,
                 waves: int = FUSED_WAVES, min_split_rows: int = MIN_SPLIT_ROWS):
    """Dual-window top-k for every query block in one launch.

    q_hvs (Qp, W) int32, q_pmz (Qp,) float32, q_charge (Qp,) int32 are the
    sorted, q_block-padded queries; r_* the whole reference DB; block b
    scans rows ``[start_rows[b], start_rows[b] + rk)``. Returns (std_sim,
    std_row, open_sim, open_row), each (Qp, k) int32 with global rows or -1.
    ``waves`` and ``min_split_rows`` set the split count (:func:`n_splits_for`).
    """
    if q_hvs.device.type == "cpu":
        return ref.fused_search(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge,
                                start_rows, q_block=q_block, rk=rk, dim=dim,
                                k=k, ppm_tol=ppm_tol, open_tol_da=open_tol_da)
    return launch_fused("fused_search", launches, q_hvs, q_pmz, q_charge,
                        r_hvs, r_pmz, r_charge, start_rows, q_block=q_block,
                        rk=rk, dim=dim, k=k, ppm_tol=ppm_tol,
                        open_tol_da=open_tol_da, waves=waves,
                        min_split_rows=min_split_rows)


def launch_fused(kernel: str, counter: _build.LaunchCounter, q_hvs, q_pmz,
                 q_charge, r_hvs, r_pmz, r_charge, start_rows, *, q_block: int,
                 rk: int, dim: int, k: int, ppm_tol: float, open_tol_da: float,
                 waves: int = FUSED_WAVES, min_split_rows: int = MIN_SPLIT_ROWS,
                 scratch_per_tile: int = 0):
    """Validate, pad and launch ``<kernel>_launch`` — any launcher with the
    fused_search C signature — on CUDA tensors; ``counter`` counts it.
    ``scratch_per_tile`` is the kernel's route scratch (shared memory a
    query tile) for the shared-memory bound."""
    dev = q_hvs.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    for name, t, dt, nd in (("q_hvs", q_hvs, torch.int32, 2),
                            ("q_pmz", q_pmz, torch.float32, 1),
                            ("q_charge", q_charge, torch.int32, 1),
                            ("r_hvs", r_hvs, torch.int32, 2),
                            ("r_pmz", r_pmz, torch.float32, 1),
                            ("r_charge", r_charge, torch.int32, 1),
                            ("start_rows", start_rows, torch.int32, 1)):
        _build.check_tensor(kernel, name, t, dt, nd, dev)
    Qp, W = q_hvs.shape
    N = r_hvs.shape[0]
    if r_hvs.shape[1] != W:
        raise ValueError(f"{kernel}: query width {W} != reference width "
                         f"{r_hvs.shape[1]}")
    if q_block < 1 or Qp % q_block or start_rows.shape[0] != Qp // q_block:
        raise ValueError(f"{kernel}: {Qp} queries do not form "
                         f"{start_rows.shape[0]} blocks of {q_block}")
    if q_pmz.shape[0] != Qp or q_charge.shape[0] != Qp:
        raise ValueError(f"{kernel}: query sidecars must have one entry per query")
    if r_pmz.shape[0] != N or r_charge.shape[0] != N:
        raise ValueError(f"{kernel}: reference sidecars must have one entry per row")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"{kernel}: the CUDA kernel keeps 1..{K_MAX} "
                         f"winners, got top_k={k}")
    smem = fused_smem_bytes(1, W, k, scratch_per_tile)
    if smem > FUSED_SMEM_BUDGET:
        raise ValueError(f"{kernel}: W={W} words at top_k={k} need {smem} bytes "
                         f"of shared memory per query tile, over the kernel's "
                         f"{FUSED_SMEM_BUDGET}")
    if not 1 <= rk <= N:
        raise ValueError(f"{kernel}: rk={rk} must be in [1, {N}]")
    nqb = Qp // q_block
    if nqb == 0:
        z = torch.empty((0, k), dtype=torch.int32, device=dev)
        return z, z, z, z

    per_block = -(-q_block // QT) * QT
    if per_block != q_block:
        q_hvs = _pad_blocks(q_hvs, nqb, q_block, per_block, 0)
        q_pmz = _pad_blocks(q_pmz, nqb, q_block, per_block, 0.0)
        q_charge = _pad_blocks(q_charge, nqb, q_block, per_block, PAD_Q_CHARGE)
    tile_start = start_rows.repeat_interleave(per_block // QT)
    n_tiles = tile_start.shape[0]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits = n_splits_for(n_tiles, rk, n_sms, waves=waves,
                            min_split_rows=min_split_rows)

    partial = torch.empty((n_tiles, n_splits, 2 * QT, k), dtype=torch.int64,
                          device=dev)
    outs = [torch.empty((n_tiles * QT, k), dtype=torch.int32, device=dev)
            for _ in range(4)]
    launcher = getattr(_build.library(), f"{kernel}_launch")
    with _build.on_device(dev):
        rc = launcher(
            _build.ptr(q_hvs), _build.ptr(q_pmz), _build.ptr(q_charge),
            _build.ptr(r_hvs), _build.ptr(r_pmz), _build.ptr(r_charge),
            _build.ptr(tile_start), _build.ptr(partial),
            *(_build.ptr(o) for o in outs),
            ctypes.c_int(n_tiles), ctypes.c_int(N), ctypes.c_int(W),
            ctypes.c_int(dim), ctypes.c_int(k), ctypes.c_int(rk),
            ctypes.c_int(n_splits), ctypes.c_float(ref.std_scale(ppm_tol)),
            ctypes.c_float(float(np.float32(open_tol_da))),
            ctypes.c_float(PAD_PMZ), _build.stream_ptr(dev))
    _build.check(rc, f"{kernel}_launch")
    counter.count += 1
    if per_block != q_block:
        outs = [o.reshape(nqb, per_block, k)[:, :q_block].reshape(Qp, k)
                for o in outs]
    return tuple(outs)
