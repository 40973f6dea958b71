"""PMZ-sorted, charge-partitioned block layout of the reference DB (paper §II-B).

Counterpart of ``repro.core.blocking``. References are sorted by (charge,
pmz), each charge partition is padded to a multiple of ``max_r`` (blocks
never straddle charges), and per-block [min, max] pmz metadata lets the
orchestrator scan only the blocks a query block's window can reach. The
layout is built with numpy on the host — a one-time ingest step — and
uploaded to the device once at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

PAD_PMZ = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class ReferenceDB:
    """Encoded reference library in search-ready (sorted, blocked) layout,
    every array on ``device``."""

    hvs: torch.Tensor           # (Rp, W) int32 — packed HVs, sorted, padded
    pmz: torch.Tensor           # (Rp,) float32 — PAD_PMZ on padding rows
    charge: torch.Tensor        # (Rp,) int32 — -1 on padding rows
    is_decoy: torch.Tensor      # (Rp,) bool
    orig_idx: torch.Tensor      # (Rp,) int32 — caller's library index; -1 pad
    block_min: torch.Tensor     # (n_blocks,) float32 — per-block min pmz
    block_max: torch.Tensor     # (n_blocks,) float32 — per-block max pmz
    block_charge: torch.Tensor  # (n_blocks,) int32
    max_r: int = 4096

    @property
    def device(self) -> torch.device:
        return self.hvs.device

    @property
    def n_blocks(self) -> int:
        return self.block_min.shape[0]

    @property
    def n_rows(self) -> int:
        return self.hvs.shape[0]

    @property
    def n_words(self) -> int:
        return self.hvs.shape[-1]


def reference_db_from_arrays(hvs, pmz, charge, is_decoy, orig_idx, block_min,
                             block_max, block_charge, *, max_r: int,
                             device) -> ReferenceDB:
    """Upload host layout arrays; packed HVs may be uint32 or int32."""
    hvs = np.ascontiguousarray(hvs)
    if hvs.dtype == np.uint32:
        hvs = hvs.view(np.int32)
    if not hvs.flags.writeable:
        hvs = hvs.copy()

    def up(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    return ReferenceDB(
        hvs=torch.from_numpy(hvs).to(device),
        pmz=up(pmz, np.float32), charge=up(charge, np.int32),
        is_decoy=up(is_decoy, bool), orig_idx=up(orig_idx, np.int32),
        block_min=up(block_min, np.float32), block_max=up(block_max, np.float32),
        block_charge=up(block_charge, np.int32), max_r=max_r)


def build_reference_db(hvs, pmz, charge, is_decoy, *, max_r: int = 4096,
                       device="cpu") -> ReferenceDB:
    """Sort by (charge, pmz), pad each charge partition to a block boundary."""
    hvs_n = np.asarray(hvs)
    pmz_n = np.asarray(pmz, dtype=np.float32)
    charge_n = np.asarray(charge, dtype=np.int32)
    decoy_n = np.asarray(is_decoy, dtype=bool)
    order = np.lexsort((pmz_n, charge_n))
    return _layout_sorted(hvs_n[order], pmz_n[order], charge_n[order],
                          decoy_n[order], order.astype(np.int32), max_r=max_r,
                          device=device)


def padded_partition_plan(charge_sorted: np.ndarray,
                          max_r: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-selection plan padding every charge partition to a ``max_r``
    multiple. Input must be (charge, pmz)-sorted. Returns ``(sel,
    block_charge)``: ``sel`` (Rp,) int64 source rows with -1 on padding, and
    the per-block partition charge (Rp/max_r,) int32."""
    charge_sorted = np.asarray(charge_sorted)
    charges, counts = np.unique(charge_sorted, return_counts=True)
    sel_parts: list[np.ndarray] = []
    b_charge: list[int] = []
    start = 0
    for c, n in zip(charges, counts):
        n = int(n)
        n_pad = (-n) % max_r
        sel_parts.append(np.arange(start, start + n, dtype=np.int64))
        sel_parts.append(np.full((n_pad,), -1, dtype=np.int64))
        b_charge.extend([int(c)] * ((n + n_pad) // max_r))
        start += n
    sel = (np.concatenate(sel_parts) if sel_parts
           else np.zeros((0,), dtype=np.int64))
    return sel, np.asarray(b_charge, dtype=np.int32)


def block_pmz_ranges(pmz_padded: np.ndarray,
                     max_r: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-block [min, max] pmz over real rows (PAD rows excluded);
    (inf, -inf) for all-padding blocks."""
    fmax = np.float32(np.finfo(np.float32).max)
    pb = np.asarray(pmz_padded).reshape(-1, max_r)
    real = pb < fmax
    any_real = real.any(axis=1)
    b_min = np.where(any_real, np.where(real, pb, np.inf).min(axis=1), np.inf)
    b_max = np.where(any_real, np.where(real, pb, -np.inf).max(axis=1), -np.inf)
    return b_min.astype(np.float32), b_max.astype(np.float32)


def _layout_sorted(hvs_n, pmz_n, charge_n, decoy_n, orig_n, *, max_r: int,
                   device) -> ReferenceDB:
    """Pad (charge, pmz)-sorted rows per charge partition, emit block
    metadata, upload. ``orig_n`` carries the caller's library index."""
    sel, b_charge = padded_partition_plan(charge_n, max_r)
    pad = sel < 0
    idx = np.where(pad, 0, sel)
    ph = np.ascontiguousarray(hvs_n[idx])
    ph[pad] = 0
    pp = pmz_n[idx].astype(np.float32, copy=True)
    pp[pad] = np.float32(np.finfo(np.float32).max)
    pc = charge_n[idx].astype(np.int32, copy=True)
    pc[pad] = -1
    pd = decoy_n[idx].astype(bool, copy=True)
    pd[pad] = False
    po = orig_n[idx].astype(np.int32, copy=True)
    po[pad] = -1
    b_min, b_max = block_pmz_ranges(pp, max_r)
    return reference_db_from_arrays(ph, pp, pc, pd, po, b_min, b_max, b_charge,
                                    max_r=max_r, device=device)


# ---------------------------------------------------------------------------
# Building from (charge, pmz)-sorted runs (ingest chunks)
# ---------------------------------------------------------------------------


class LibraryRun(NamedTuple):
    """One (charge, pmz)-sorted run of encoded references (host arrays)."""

    hvs: np.ndarray       # (n, W) packed HVs (int32 or uint32 bit patterns)
    pmz: np.ndarray       # (n,) float32
    charge: np.ndarray    # (n,) int32
    is_decoy: np.ndarray  # (n,) bool
    orig_idx: np.ndarray  # (n,) int32 — caller's library index


def sort_key_offset(max_pmz: float) -> float:
    """Charge multiplier for :func:`composite_sort_key`."""
    return float(np.ceil(max(float(max_pmz), 1.0)) + 1.0)


def composite_sort_key(pmz, charge, *, off: float) -> np.ndarray:
    """Composite float64 (charge, pmz) sort key, ``charge * off + pmz``;
    lexicographic for non-negative charges and pmz in ``[0, off)``."""
    c = np.asarray(charge, dtype=np.float64)
    p = np.asarray(pmz, dtype=np.float64)
    if len(p) and (p.min() < 0.0 or c.min() < 0.0 or p.max() >= off):
        raise ValueError("composite_sort_key needs 0 <= pmz < off and charge >= 0")
    return c * off + p


def run_sort_keys(runs: Sequence[LibraryRun]) -> list[np.ndarray]:
    """Composite (charge, pmz) sort keys for each run, on a shared offset."""
    hi = max((float(np.max(r.pmz)) for r in runs if len(r.pmz)), default=0.0)
    off = sort_key_offset(hi)
    return [composite_sort_key(r.pmz, r.charge, off=off) for r in runs]


def _merge_two(a, b):
    """Stable vectorised merge of two sorted (key, run, row) triples; rows
    of ``a`` (the earlier runs) win ties via the searchsorted sides."""
    ka, ra, wa = a
    kb, rb, wb = b
    pos_a = np.arange(len(ka), dtype=np.int64) + np.searchsorted(kb, ka, side="left")
    pos_b = np.arange(len(kb), dtype=np.int64) + np.searchsorted(ka, kb, side="right")
    n = len(ka) + len(kb)
    k = np.empty(n, dtype=np.float64)
    r = np.empty(n, dtype=np.int32)
    w = np.empty(n, dtype=np.int64)
    k[pos_a] = ka
    k[pos_b] = kb
    r[pos_a] = ra
    r[pos_b] = rb
    w[pos_a] = wa
    w[pos_b] = wb
    return k, r, w


def merge_sorted_runs(keys: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Stable k-way merge of sorted key runs (tournament of two-run merges).
    Returns ``(run_id, row_in_run)`` of the merged order; equal keys keep
    earlier-run-first, earlier-row-first order, as a stable lexsort would."""
    items = [(np.ascontiguousarray(k, dtype=np.float64),
              np.full(len(k), i, dtype=np.int32),
              np.arange(len(k), dtype=np.int64))
             for i, k in enumerate(keys)]
    if not items:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64))
    while len(items) > 1:
        items = [_merge_two(items[j], items[j + 1])
                 if j + 1 < len(items) else items[j]
                 for j in range(0, len(items), 2)]
    _, run_id, row_in_run = items[0]
    return run_id, row_in_run


def build_reference_db_from_runs(runs: Iterable[LibraryRun], *,
                                 max_r: int = 4096, device="cpu") -> ReferenceDB:
    """Build the blocked DB by merging (charge, pmz)-sorted runs —
    bit-identical, tie order included, to :func:`build_reference_db` over
    the runs' concatenation."""
    runs = [LibraryRun(*(np.asarray(a) for a in r)) for r in runs]
    runs = [r for r in runs if len(r.pmz)]
    if not runs:
        raise ValueError("build_reference_db_from_runs: no rows")
    run_id, row_in_run = merge_sorted_runs(run_sort_keys(runs))

    R = sum(len(r.pmz) for r in runs)
    W = runs[0].hvs.shape[1]
    hvs_s = np.empty((R, W), dtype=runs[0].hvs.dtype)
    pmz_s = np.empty((R,), dtype=np.float32)
    charge_s = np.empty((R,), dtype=np.int32)
    decoy_s = np.empty((R,), dtype=bool)
    orig_s = np.empty((R,), dtype=np.int32)
    # One stable argsort groups output positions by run (rows stay ascending
    # within each group), so the gather is a single pass per run.
    pos = np.argsort(run_id, kind="stable")
    bounds = np.cumsum([0] + [len(r.pmz) for r in runs])
    for i, r in enumerate(runs):
        at = pos[bounds[i]:bounds[i + 1]]
        rows = row_in_run[at]
        hvs_s[at] = r.hvs[rows]
        pmz_s[at] = r.pmz[rows]
        charge_s[at] = r.charge[rows]
        decoy_s[at] = r.is_decoy[rows]
        orig_s[at] = r.orig_idx[rows]
    return _layout_sorted(hvs_s, pmz_s, charge_s, decoy_s, orig_s, max_r=max_r,
                          device=device)
