"""Blocked dual-window OMS search (paper §II-B orchestrator + §II-C kernel).

Counterpart of the full-width half of ``repro.core.search``. Queries are
(charge, pmz)-sorted and padded so no block of ``q_block`` queries
straddles a charge; each query block scans ``k_blocks * max_r`` contiguous
reference rows from a start row found by ``searchsorted`` on monotonic
block keys; per query a top-k list is kept under the standard ppm window
and one under the open Da window, ranked by (similarity desc, row asc),
with -1 for empty ranks. Exhaustive mode (the HyperOMS baseline) scans the
whole DB from row 0.

The per-block start rows are computed on the device with the reference's
float32 key arithmetic. A ``fused`` backend then covers every query block
in one call; ``matrix`` backends run block by block through the plain
fused version (``kernels/hamming/ref.py``), whose ``dual_window_topk`` is
the reference's ``_find_topk_dual``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import backends as backends_mod
from repro_torch.core.blocking import ReferenceDB
from repro_torch.kernels.hamming import ref as href

# Charge multiplier for monotonic (charge, pmz) sort keys; pmz is clipped
# below it so keys of different charges never interleave.
_CHARGE_KEY = 8192.0


class SearchParams(NamedTuple):
    ppm_tol: float = 20.0          # standard-search window, parts-per-million
    open_tol_da: float = 75.0      # open-search window, Daltons
    q_block: int = 16              # queries per kernel iteration (paper Q_BLOCK)
    k_blocks: int = 8              # static cap of ref blocks scanned per q-block
    min_sim: int = 0               # matches below this similarity report idx=-1
    backend: str = "vpu"           # any name in repro_torch.core.backends.names()
    exhaustive: bool = False       # True = HyperOMS-style full scan (baseline)
    top_k: int = 1                 # ranked winners kept per query and window
    # Dimension cascade: not ported yet (prefix_words must stay 0).
    prefix_words: int = 0
    prefix_margin: int = -1
    prefix_seed_da: float = 1.0


class SearchResult(NamedTuple):
    """Per query: top-k standard-window and top-k open-window matches, all
    (Q, top_k) int32, ranked by (sim desc, row asc); empty ranks are -1."""

    std_idx: torch.Tensor     # original library index, -1 if none
    std_sim: torch.Tensor     # Hamming similarity (Dhv - distance)
    open_idx: torch.Tensor
    open_sim: torch.Tensor
    std_row: torch.Tensor     # row in the sorted/padded DB (decoy lookup)
    open_row: torch.Tensor


def _block_keys(db: ReferenceDB) -> torch.Tensor:
    """Monotonic float32 block sort keys: per-charge block_max plus a large
    per-charge offset, so the concatenation is globally ascending."""
    off = db.block_charge * _CHARGE_KEY
    return torch.where(torch.isfinite(db.block_max),
                       torch.clamp(db.block_max, 0.0, _CHARGE_KEY - 1.0) + off,
                       off + (_CHARGE_KEY - 1.0))


def _qblock_start_row(db: ReferenceDB, p: SearchParams, bkey, qp, qc):
    """First scanned row of every query block: qp/qc (nqb, q_block) ->
    (nqb,) int32, by searchsorted on the block keys."""
    if p.exhaustive:
        return torch.zeros((qp.shape[0],), dtype=torch.int32, device=qp.device)
    # Lowest key any query of the block can match: pmz - open_tol.
    lo = (torch.clamp(qp - p.open_tol_da, 0.0, _CHARGE_KEY - 1.0)
          + qc * _CHARGE_KEY).amin(dim=1)
    start_blk = torch.searchsorted(bkey, lo)
    # one-block guard against key rounding at block boundaries
    start_blk = torch.clamp(start_blk - 1, 0, max(db.n_blocks - p.k_blocks, 0))
    return (start_blk * db.max_r).to(torch.int32)


def scan_rows_per_block(db: ReferenceDB, p: SearchParams) -> int:
    """Rows every query block scans: ``k_blocks * max_r`` (whole DB when
    exhaustive)."""
    return (p.k_blocks if not p.exhaustive else db.n_blocks) * db.max_r


def block_start_rows(db: ReferenceDB, p: SearchParams, q_pmz: torch.Tensor,
                     q_charge: torch.Tensor) -> torch.Tensor:
    """(nqb,) int32 start rows of sorted/padded queries (Qp,) on the device."""
    nqb = q_pmz.shape[0] // p.q_block
    return _qblock_start_row(db, p, _block_keys(db),
                             q_pmz.reshape(nqb, p.q_block),
                             q_charge.reshape(nqb, p.q_block))


def _search_sorted_padded(db: ReferenceDB, q_hvs, q_pmz, q_charge, *,
                          params: SearchParams, dim: int):
    """Search queries already (charge, pmz)-sorted and padded to q_block.
    Returns four (Qp, top_k) int32 tensors: std_sim, std_row, open_sim,
    open_row (global DB rows or -1)."""
    p = params
    if p.top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {p.top_k}")
    rk = scan_rows_per_block(db, p)
    if rk > db.n_rows:
        raise ValueError(f"k_blocks={p.k_blocks} exceeds the DB's "
                         f"{db.n_blocks} blocks")
    starts = block_start_rows(db, p, q_pmz, q_charge)
    be = backends_mod.get(p.backend)
    kw = dict(q_block=p.q_block, rk=rk, dim=dim, k=p.top_k, ppm_tol=p.ppm_tol,
              open_tol_da=p.open_tol_da)
    args = (q_hvs, q_pmz, q_charge, db.hvs, db.pmz, db.charge, starts)
    if be.kind == backends_mod.FUSED:
        return be.fn(*args, **kw)
    return href.fused_search(*args, **kw, tile_fn=be.fn)


@functools.lru_cache(maxsize=512)
def _padding_plan(q_block: int, group_sizes: tuple[int, ...]):
    """Row-selection plan for (charge, pmz)-sorted queries: each charge group
    padded to a ``q_block`` multiple by repeating its last (highest-pmz)
    row. Depends only on the per-charge counts, hence the memoization."""
    sel_rows, is_real = [], []
    start = 0
    for n in group_sizes:
        g = list(range(start, start + n))
        sel_rows.extend(g)
        is_real.extend([True] * n)
        padn = (-n) % q_block
        sel_rows.extend([g[-1]] * padn)
        is_real.extend([False] * padn)
        start += n
    sel = np.asarray(sel_rows, dtype=np.int64)
    real = np.asarray(is_real, dtype=bool)
    sel.setflags(write=False)
    real.setflags(write=False)
    return sel, real


def validate_search_params(params: SearchParams, n_rows: int | None = None) -> None:
    """Reject invalid static search settings with a clear error."""
    if params.top_k < 1:
        raise ValueError(f"SearchParams.top_k must be >= 1, got {params.top_k}")
    if n_rows is not None and params.top_k > n_rows:
        raise ValueError(
            f"SearchParams.top_k={params.top_k} exceeds the reference DB's "
            f"{n_rows} rows — no query can have that many candidates; "
            f"lower top_k or grow the library")
    if params.prefix_words < 0:
        raise ValueError(
            f"SearchParams.prefix_words must be >= 0, got {params.prefix_words}")
    if params.prefix_words:
        raise NotImplementedError(
            "prefix_words > 0 (the dimension cascade) is not ported yet: "
            "ROADMAP.md, queue 1 item 13 (cascade + dimension cascade)")


def sort_pad_plan(q_pmz: torch.Tensor, q_charge: torch.Tensor, q_block: int, *,
                  q_charge_np: np.ndarray | None = None):
    """Composed sort+pad row selection for a query batch.

    Returns ``(gather, unpad)`` device index tensors: ``x[gather]`` maps raw
    query rows into the (charge, pmz)-sorted, q_block-padded layout, and
    ``y[unpad]`` drops the padding and restores input order.
    """
    Q = q_pmz.shape[0]
    dev = q_pmz.device
    key = torch.clamp(q_pmz, 0.0, _CHARGE_KEY - 1.0) + q_charge * _CHARGE_KEY
    order = torch.argsort(key, stable=True)
    qc_np = (q_charge.cpu().numpy() if q_charge_np is None
             else np.asarray(q_charge_np))
    counts = np.unique(qc_np, return_counts=True)[1]
    sel_np, real_np = _padding_plan(q_block, tuple(int(c) for c in counts))
    gather = order[torch.from_numpy(sel_np.copy()).to(dev)]
    keep = torch.from_numpy(np.flatnonzero(real_np)).to(dev)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(Q, device=dev)
    return gather, keep[inverse]


def oms_search(db: ReferenceDB, q_hvs: torch.Tensor, q_pmz: torch.Tensor,
               q_charge: torch.Tensor, params: SearchParams, *, dim: int,
               q_charge_np: np.ndarray | None = None) -> SearchResult:
    """Full OMS search: sort queries, run the blocked scan, unsort, map rows
    back to original library indices, apply the min-similarity threshold.
    ``q_charge_np`` is an optional host copy of the query charges (saves a
    device-to-host copy for the padding plan)."""
    validate_search_params(params, db.n_rows)
    gather, unpad = sort_pad_plan(q_pmz, q_charge, params.q_block,
                                  q_charge_np=q_charge_np)
    # Padding queries keep their charge (the block stays charge-pure) and
    # are dropped on output.
    std_b, std_row, open_b, open_row = _search_sorted_padded(
        db, q_hvs[gather], q_pmz[gather], q_charge[gather], params=params,
        dim=dim)
    std_b, std_row = std_b[unpad], std_row[unpad]
    open_b, open_row = open_b[unpad], open_row[unpad]

    def _finalize(best, row):
        ok = (best >= params.min_sim) & (row >= 0)
        idx = torch.where(ok, db.orig_idx[row.clamp(0, db.n_rows - 1).long()], -1)
        ok = ok & (idx >= 0)  # padding rows carry orig_idx == -1
        return (torch.where(ok, idx, -1), torch.where(ok, best, -1),
                torch.where(ok, row, -1))

    std_idx, std_sim, std_row = _finalize(std_b, std_row)
    open_idx, open_sim, open_row = _finalize(open_b, open_row)
    return SearchResult(std_idx, std_sim, open_idx, open_sim, std_row, open_row)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plan_search(db: ReferenceDB, q_pmz, q_charge, *, open_tol_da: float,
                q_block: int, safety_blocks: int = 2) -> int:
    """Pick the static ``k_blocks`` cap on the host: the most contiguous
    blocks any q_block run of (charge, pmz)-sorted queries can touch under
    the open window, plus a guard."""
    bmin, bmax = _host(db.block_min), _host(db.block_max)
    bch = _host(db.block_charge)
    qp, qc = _host(q_pmz), _host(q_charge)
    Q = len(qp)
    if Q == 0:
        return min(1 + safety_blocks, db.n_blocks)
    order = np.lexsort((qp, qc))
    qp, qc = qp[order], qc[order]

    # Segments mirror the device layout: each charge group is padded to a
    # q_block multiple, so q-blocks align to charge-run-local offsets.
    charge_starts = np.flatnonzero(np.r_[True, np.diff(qc) != 0])
    run_start = np.repeat(charge_starts, np.diff(np.r_[charge_starts, Q]))
    group = (np.arange(Q) - run_start) // q_block
    starts = np.flatnonzero(
        np.r_[True, (np.diff(group) != 0) | (np.diff(qc) != 0)])
    ends = np.r_[starts[1:], Q]               # exclusive
    lo = qp[starts] - open_tol_da
    hi = qp[ends - 1] + open_tol_da
    seg_c = qc[starts]

    # Blocks of one charge are contiguous with ascending bmin/bmax, so the
    # hit set is [first bmax >= lo, last bmin <= hi].
    worst = 1
    for c in np.unique(seg_c):
        blocks = np.flatnonzero(bch == c)
        if len(blocks) == 0:
            continue
        m = seg_c == c
        first = np.searchsorted(bmax[blocks], lo[m], side="left")
        last = np.searchsorted(bmin[blocks], hi[m], side="right") - 1
        spans = (last - first + 1)[first <= last]
        if len(spans):
            worst = max(worst, int(spans.max()))
    return min(worst + safety_blocks, db.n_blocks)


def scanned_rows(db: ReferenceDB, n_queries: int, params: SearchParams) -> int:
    """Static comparison count of a search call."""
    nqb = -(-n_queries // params.q_block)
    k = db.n_blocks if params.exhaustive else params.k_blocks
    return nqb * k * db.max_r * params.q_block
