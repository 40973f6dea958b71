"""Blocked dual-window OMS search (paper §II-B orchestrator + §II-C kernel).

Counterpart of the resident half of ``repro.core.search``. Queries are
(charge, pmz)-sorted and padded so no block of ``q_block`` queries
straddles a charge; each query block scans ``k_blocks * max_r`` contiguous
reference rows from a start row found by ``searchsorted`` on monotonic
block keys; per query a top-k list is kept under the standard ppm window
and one under the open Da window, ranked by (similarity desc, row asc),
with -1 for empty ranks. Exhaustive mode (the HyperOMS baseline) scans the
whole DB from row 0.

The per-block start rows are computed on the device with the reference's
float32 key arithmetic and stay there. A ``fused`` backend then covers
every query block in one call; ``matrix`` backends run block by block
through the plain fused version (``kernels/hamming/ref.py``), whose
``dual_window_topk`` is the reference's ``_find_topk_dual``, each block
gathering its rows by a device index.

With ``prefix_words > 0`` the scan runs as the dimension cascade: a seed
pass rescoring rows near each precursor sets exact per-query thresholds, a
prefix-word scan flags every row whose best-case full similarity reaches
them, and the survivors are rescored at full width — bit-identical to the
full scan in exact mode.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import backends as backends_mod
from repro_torch.core.blocking import PAD_PMZ, ReferenceDB
from repro_torch.kernels.hamming import ref as href
from repro_torch.kernels.plan import ops as plan_ops
from repro_torch.kernels.plan import ref as plan_ref
from repro_torch.obs.trace import NOOP_SPAN, span

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
    # -- dimension cascade (FeNOMS-style prefix-word pruning) ---------------
    prefix_words: int = 0          # stage-A packed words (0 = full-width scan)
    prefix_margin: int = -1        # survivor slack in bits; -1 = exact bound
    #                                (dim - 32*prefix_words: bit-identical)
    prefix_seed_da: float = 1.0    # seed-pass precursor window (Da) that
    #                                bootstraps per-query thresholds


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


# ---------------------------------------------------------------------------
# Dimension cascade: prefix-word prune + exact full-width rescore
# ---------------------------------------------------------------------------
#
# Stage A scans every in-window candidate over only the first
# ``prefix_words`` (P) packed words: ``ham_p`` mismatches over 32*P bits.
# The remaining ``rest = dim - 32*P`` bits add at most ``rest`` mismatches,
# so the full similarity is bounded by ub = (32*P - ham_p) + rest. A row
# survives iff ub >= T for a per-(query, window) threshold T: in exact mode
# the k-th best full similarity over a subset of the query's in-window
# candidates (the seed pass), so no true top-k row (nor a tie) is pruned and
# the stage-B rescore of the survivors is bit-identical to the full scan.
# ``prefix_margin >= 0`` replaces the slack ``rest`` with a smaller one:
# harder pruning that may drop true winners.

_NEG_THRESHOLD = -(1 << 30)     # "no threshold yet": everything in-window survives

def prefix_margin_bits(params: SearchParams, dim: int) -> int:
    """Effective stage-A slack in bits (the exact bound unless overridden)."""
    rest = dim - 32 * params.prefix_words
    if params.prefix_margin < 0:
        return rest
    return min(params.prefix_margin, rest)


def _prefix_flags(db: ReferenceDB, prefix_hvs, q_hvs_p, q_pmz, q_charge,
                  thr_std, thr_open, *, params: SearchParams, dim: int):
    """Stage A: (n_rows,) bool survivor flags — the OR over query blocks of
    the bound-based keep decision on each block's scanned rows.

    ``prefix_hvs`` (n_rows, P) and ``q_hvs_p`` (Qp, P) hold only the first
    ``params.prefix_words`` words, contiguous; ``thr_std``/``thr_open`` are
    per padded-query full-similarity thresholds (``_NEG_THRESHOLD`` where
    unknown)."""
    p = params
    pdim = 32 * p.prefix_words
    margin = prefix_margin_bits(p, dim)
    QB = p.q_block
    rk = scan_rows_per_block(db, p)
    tile = backends_mod.hamming_tile_fn(p.backend)
    starts = block_start_rows(db, p, q_pmz, q_charge)
    # Keep counts per row, gathered and added by device indices (the start
    # rows never go to the host).
    hits = torch.zeros((db.n_rows,), dtype=torch.int32, device=db.device)
    for b in range(starts.shape[0]):
        qs = slice(b * QB, (b + 1) * QB)
        rows, r_p, pmz_b, charge_b = href.scan_rows(starts[b], rk, prefix_hvs,
                                                    db.pmz, db.charge)
        ub = (pdim - tile(q_hvs_p[qs], r_p, pdim)) + margin
        std_m, open_m = href.window_masks(
            q_pmz[qs], pmz_b, q_charge[qs], charge_b,
            ppm_tol=p.ppm_tol, open_tol_da=p.open_tol_da)
        keep = ((std_m & (ub >= thr_std[qs, None]))
                | (open_m & (ub >= thr_open[qs, None])))
        hits.index_add_(0, rows, keep.any(dim=0).to(torch.int32))
    return hits > 0


def _rescore_rows_padded(r_hvs, r_rows, r_pmz, r_charge, q_hvs, q_pmz,
                         q_charge, *, params: SearchParams, dim: int):
    """Stage B / seed pass: exact dual-window top-k over a gathered row set.

    ``r_*`` are (S,) padded candidate arrays — global DB rows in ASCENDING
    order (selection ties resolve to the lowest row, as in the full scan),
    padding entries carrying ``r_pmz == PAD_PMZ`` / ``r_rows == -1``. Every
    query block is scored against the whole set, as the reference does.
    Returns four (Qp, top_k) int32 tensors, rows global."""
    p = params
    QB = p.q_block
    S = r_rows.shape[0]
    tile = backends_mod.hamming_tile_fn(p.backend)
    outs = []
    for b in range(q_hvs.shape[0] // QB):
        qs = slice(b * QB, (b + 1) * QB)
        ss, sa, os_, oa = href.fused_search_block(
            q_hvs[qs], r_hvs, q_pmz[qs], r_pmz, q_charge[qs], r_charge,
            dim=dim, k=p.top_k, ppm_tol=p.ppm_tol, open_tol_da=p.open_tol_da,
            tile_fn=tile)
        outs.append((ss, torch.where(ss >= 0, r_rows[sa.clamp(0, S - 1).long()], -1),
                     os_, torch.where(os_ >= 0, r_rows[oa.clamp(0, S - 1).long()], -1)))
    return tuple(torch.cat(col) for col in zip(*outs))


def kth_thresholds(run, k: int):
    """Per-query (thr_std, thr_open) int32 thresholds from (Qp, k) winner
    tensors ``run = (std_sim, std_row, open_sim, open_row)``: the k-th sim
    where a k-th winner exists, ``_NEG_THRESHOLD`` otherwise."""
    thr_std = torch.where(run[1][:, k - 1] >= 0, run[0][:, k - 1], _NEG_THRESHOLD)
    thr_open = torch.where(run[3][:, k - 1] >= 0, run[2][:, k - 1], _NEG_THRESHOLD)
    return thr_std, thr_open


def plan_seed_rows(row_pmz: np.ndarray, row_charge: np.ndarray,
                   q_pmz_np: np.ndarray, q_charge_np: np.ndarray,
                   tol_da: float) -> np.ndarray:
    """Host seed plan: ascending DB rows within ``tol_da`` Da (same charge)
    of ANY query precursor. Within one charge the layout's real rows are
    pmz-ascending, so per charge this is two searchsorteds."""
    n = row_pmz.shape[0]
    mark = np.zeros((n,), bool)
    for c in np.unique(q_charge_np):
        rows_c = np.flatnonzero((row_charge == c) & (row_pmz < np.float32(
            np.finfo(np.float32).max)))
        if rows_c.size == 0:
            continue
        pm = row_pmz[rows_c]
        q = np.sort(q_pmz_np[q_charge_np == c])
        lo = np.searchsorted(q, pm - tol_da, side="left")
        hi = np.searchsorted(q, pm + tol_da, side="right")
        mark[rows_c[hi > lo]] = True
    return np.flatnonzero(mark).astype(np.int64)


def row_bucket(n: int, *, lo: int | None = None, device=None) -> int:
    """Power-of-two padding bucket for a candidate-set size, so the rescore
    sees a bounded family of shapes. The floor ``lo`` defaults to the tuned
    per-device base of ``device`` (``repro_torch.tune.row_bucket_lo``)."""
    if lo is None:
        from repro_torch import tune
        lo = tune.row_bucket_lo(device)
    b = lo
    while b < max(n, 1):
        b <<= 1
    return b


def pad_candidate_rows(rows: np.ndarray, bucket: int):
    """(rows_padded, valid) host arrays for a candidate set: rows stay
    ascending, padding gathers row 0 but is masked out via PAD sidecars."""
    S = int(rows.shape[0])
    rows_pad = np.zeros((bucket,), np.int64)
    rows_pad[:S] = rows
    valid = np.zeros((bucket,), bool)
    valid[:S] = True
    return rows_pad, valid


def _gather_rows(db: ReferenceDB, rows_np: np.ndarray):
    """(r_hvs, r_rows, r_pmz, r_charge) of a bucket-padded candidate set."""
    rows_pad, valid = pad_candidate_rows(
        rows_np, row_bucket(rows_np.shape[0], device=db.device))
    rows_t = torch.from_numpy(rows_pad).to(db.device)
    valid_t = torch.from_numpy(valid).to(db.device)
    return (db.hvs[rows_t],
            torch.where(valid_t, rows_t.to(torch.int32), -1),
            torch.where(valid_t, db.pmz[rows_t], PAD_PMZ),
            torch.where(valid_t, db.charge[rows_t], -1))


def _stage_clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _prefix_search_padded(db: ReferenceDB, qh, qp, qc, *, params: SearchParams,
                          dim: int, row_pmz_np: np.ndarray,
                          row_charge_np: np.ndarray, qp_np: np.ndarray,
                          qc_np: np.ndarray, prefix_hvs=None,
                          stats: dict | None = None):
    """Resident two-stage cascade over sorted/padded queries: seed pass
    (exact thresholds) -> stage-A prefix flags over the DB -> stage-B exact
    rescore of the survivors. Returns the four (Qp, k) tensors of
    :func:`_search_sorted_padded`, bit-identical in exact mode.

    ``prefix_hvs`` is a contiguous copy of ``db.hvs[:, :prefix_words]``
    (made here when absent). ``stats``, when given, receives the seed-row,
    survivor and bucket counts and each stage's seconds (device-synced)."""
    p = params
    K = p.top_k
    P = p.prefix_words
    dev = db.device
    if stats is not None:
        t0 = _stage_clock(dev)
    seed_rows = plan_seed_rows(row_pmz_np, row_charge_np, qp_np, qc_np,
                               p.prefix_seed_da)
    if seed_rows.size:
        thr_std, thr_open = kth_thresholds(_rescore_rows_padded(
            *_gather_rows(db, seed_rows), qh, qp, qc, params=p, dim=dim), K)
    else:
        thr_std = thr_open = torch.full((qh.shape[0],), _NEG_THRESHOLD,
                                        dtype=torch.int32, device=dev)
    if stats is not None:
        t1 = _stage_clock(dev)
    if prefix_hvs is None:
        prefix_hvs = db.hvs[:, :P].contiguous()
    flags = _prefix_flags(db, prefix_hvs, qh[:, :P].contiguous(), qp, qc,
                          thr_std, thr_open, params=p, dim=dim)
    surv = np.flatnonzero(flags.cpu().numpy())
    if p.prefix_margin >= 0:
        # Margin mode may prune true winners; folding the seed rows back in
        # makes it no worse than the seed pass. Extra ascending candidates
        # never change the exact selection, so exact mode needs no union.
        surv = np.union1d(surv, seed_rows)
    if stats is not None:
        t2 = _stage_clock(dev)
    if surv.size == 0:
        z = torch.full((qh.shape[0], K), -1, dtype=torch.int32, device=dev)
        out = (z, z, z, z)
    else:
        out = _rescore_rows_padded(*_gather_rows(db, surv), qh, qp, qc,
                                   params=p, dim=dim)
    if stats is not None:
        t3 = _stage_clock(dev)
        stats.update(seed_rows=int(seed_rows.size),
                     seed_bucket=row_bucket(int(seed_rows.size), device=dev),
                     survivors=int(surv.size),
                     survivor_bucket=row_bucket(int(surv.size), device=dev),
                     seed_s=t1 - t0, prefix_s=t2 - t1, rescore_s=t3 - t2)
    return out


@functools.lru_cache(maxsize=512)
def _padding_plan(q_block: int, group_sizes: tuple[int, ...]):
    """Row-selection plan for (charge, pmz)-sorted queries: each charge group
    padded to a ``q_block`` multiple by repeating its last (highest-pmz)
    row. Depends only on the per-charge counts, hence the memoization; the
    span ``scan.pad_plan`` opens only on a miss."""
    with span("scan.pad_plan"):
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
    if params.prefix_words and params.prefix_seed_da <= 0.0:
        raise ValueError(
            f"SearchParams.prefix_seed_da must be > 0 when prefix_words is "
            f"set, got {params.prefix_seed_da!r}")


def validate_prefix_words(params: SearchParams, dim: int) -> None:
    """The prefix must leave at least one full-width word of headroom —
    ``prefix_words == n_words`` would be a slower full scan in disguise."""
    n_words = dim // 32
    if params.prefix_words >= n_words:
        raise ValueError(
            f"SearchParams.prefix_words={params.prefix_words} must be < "
            f"n_words={n_words} (dim={dim}); use prefix_words=0 for a "
            f"full-width scan")


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
    gather = order[_upload(sel_np.copy(), dev, "sync.scan.pad_upload")]
    keep = _upload(np.flatnonzero(real_np), dev, "sync.scan.pad_upload")
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(Q, device=dev)
    return gather, keep[inverse]


def oms_search(db: ReferenceDB, q_hvs: torch.Tensor, q_pmz: torch.Tensor,
               q_charge: torch.Tensor, params: SearchParams, *, dim: int,
               q_pmz_np: np.ndarray | None = None,
               q_charge_np: np.ndarray | None = None,
               row_pmz_np: np.ndarray | None = None,
               row_charge_np: np.ndarray | None = None,
               prefix_hvs: torch.Tensor | None = None,
               stats: dict | None = None) -> SearchResult:
    """Full OMS search: sort queries, run the blocked scan, unsort, map rows
    back to original library indices, apply the min-similarity threshold.

    ``q_pmz_np``/``q_charge_np`` are optional host copies of the query
    sidecars (``q_charge_np`` saves a device-to-host copy for the padding
    plan). With ``params.prefix_words > 0`` the scan runs as the dimension
    cascade; ``row_pmz_np``/``row_charge_np`` are host copies of the DB
    sidecars for its seed pass and ``prefix_hvs`` a contiguous copy of
    ``db.hvs[:, :prefix_words]`` (each made here when absent), and
    ``stats`` receives its stage counts and times."""
    validate_search_params(params, db.n_rows)
    if params.prefix_words:
        validate_prefix_words(params, dim)
    with span("scan.sort_pad"):
        gather, unpad = sort_pad_plan(q_pmz, q_charge, params.q_block,
                                      q_charge_np=q_charge_np)
    # Padding queries keep their charge (the block stays charge-pure) and
    # are dropped on output.
    qh, qp, qc = q_hvs[gather], q_pmz[gather], q_charge[gather]
    if params.prefix_words:
        std_b, std_row, open_b, open_row = _prefix_search_padded(
            db, qh, qp, qc, params=params, dim=dim,
            row_pmz_np=_host(db.pmz) if row_pmz_np is None else row_pmz_np,
            row_charge_np=(_host(db.charge) if row_charge_np is None
                           else row_charge_np),
            qp_np=_host(q_pmz) if q_pmz_np is None else q_pmz_np,
            qc_np=_host(q_charge) if q_charge_np is None else q_charge_np,
            prefix_hvs=prefix_hvs, stats=stats)
    else:
        with span("scan.launch"):
            std_b, std_row, open_b, open_row = _search_sorted_padded(
                db, qh, qp, qc, params=params, dim=dim)
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


def _host(x, sync: str | None = None) -> np.ndarray:
    """``x`` as a host array. A tensor's copy runs inside span ``sync`` when
    one is named (``repro_torch.obs.trace``: one ``sync.*`` span a copy)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    with span(sync) if sync else NOOP_SPAN:
        return x.cpu().numpy()


def _upload(x, device, sync: str) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)``, the copy inside span ``sync``;
    a tensor already on ``device`` is returned as it is and opens none."""
    device = torch.device(device)
    if (isinstance(x, torch.Tensor) and x.device.type == device.type
            and device.index in (None, x.device.index)):
        return x
    with span(sync):
        return torch.as_tensor(x, device=device)


def plan_search(db, q_pmz, q_charge, *, open_tol_da: float,
                q_block: int, safety_blocks: int = 2, block_keys=None) -> int:
    """Pick the static ``k_blocks`` cap: the most contiguous blocks any
    q_block run of (charge, pmz)-sorted queries can touch under the open
    window, plus a guard. ``db`` is anything exposing the block sidecars: a
    resident ReferenceDB (tensors) or a serve StoreLayout (numpy).

    Query tensors on the device of a ReferenceDB's block sidecars are
    planned there (:func:`plan_search_device`, ``block_keys`` its keys when
    made already); anything else is planned on the host, as below. Both
    give the same integer."""
    if isinstance(db, ReferenceDB) and all(
            isinstance(x, torch.Tensor) and x.device == db.block_min.device
            for x in (q_pmz, q_charge)):
        return plan_search_device(db, q_pmz, q_charge, open_tol_da=open_tol_da,
                                  q_block=q_block, safety_blocks=safety_blocks,
                                  block_keys=block_keys)
    bmin, bmax, bch = (_host(x, "sync.plan.block_meta")
                       for x in (db.block_min, db.block_max, db.block_charge))
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


def plan_block_keys(db: ReferenceDB) -> tuple[torch.Tensor, torch.Tensor]:
    """The device planner's block keys: every block's (charge, min pmz) and
    (charge, max pmz) as exact int64 pair keys (``kernels.plan.ref.
    pair_key``), each list sorted; two (n_blocks,) int64 tensors on the DB's
    device. Padding blocks (charge -1, bounds +inf / -inf) sort with their
    charge and match no query."""
    return (torch.sort(plan_ref.pair_key(db.block_charge, db.block_min)).values,
            torch.sort(plan_ref.pair_key(db.block_charge, db.block_max)).values)


def plan_search_device(db: ReferenceDB, q_pmz: torch.Tensor,
                       q_charge: torch.Tensor, *, open_tol_da: float,
                       q_block: int, safety_blocks: int = 2,
                       block_keys=None) -> int:
    """:func:`plan_search` on the device of ``db``'s block sidecars, from
    float32 query tensors there, reading back one scalar (span
    ``sync.plan.k_blocks``). ``block_keys`` is :func:`plan_block_keys` of
    ``db`` (made here when absent).

    The queries are sorted as ``np.lexsort((pmz, charge))`` sorts them: by
    pmz, then stably by charge (the float32 ``_CHARGE_KEY`` key would tie
    pmz within ~0.004 Da at charge 4 and could move a q-block boundary).
    ``kernels.plan.ops.plan_reach`` then gives the most blocks one q-block
    segment reaches, as the host's per-charge ``searchsorted``s count
    them."""
    Q = q_pmz.shape[0]
    if Q == 0:
        return min(1 + safety_blocks, db.n_blocks)
    if q_pmz.dtype != torch.float32:
        raise TypeError(f"q_pmz must be float32, got {q_pmz.dtype}")
    kmin, kmax = plan_block_keys(db) if block_keys is None else block_keys
    qp, by_pmz = torch.sort(q_pmz, stable=True)
    qc, by_charge = torch.sort(q_charge[by_pmz], stable=True)
    reach = plan_ops.plan_reach(qp[by_charge], qc, kmin, kmax, q_block=q_block,
                                open_tol_da=open_tol_da)
    with span("sync.plan.k_blocks"):
        worst = max(int(reach.item()), 1)
    return min(worst + safety_blocks, db.n_blocks)


def narrow_search_params(block_meta, q_pmz, q_charge, params: SearchParams, *,
                         narrow_tol_da: float) -> SearchParams:
    """Stage-1 (narrow-window) variant of ``params`` for the cascade: the
    open window shrinks to ``narrow_tol_da`` and ``k_blocks`` is re-planned
    for it with :func:`plan_search`. ``block_meta`` is a ReferenceDB or a
    StoreLayout."""
    if not 0.0 < narrow_tol_da <= params.open_tol_da:
        raise ValueError(
            f"narrow_tol_da must be in (0, open_tol_da={params.open_tol_da}]"
            f", got {narrow_tol_da!r}")
    k = plan_search(block_meta, _host(q_pmz), _host(q_charge),
                    open_tol_da=narrow_tol_da, q_block=params.q_block)
    return params._replace(open_tol_da=narrow_tol_da, k_blocks=k)


def scanned_rows(db, n_queries: int, params: SearchParams) -> int:
    """Static comparison count of a search call (``db``: a ReferenceDB or a
    StoreLayout)."""
    nqb = -(-n_queries // params.q_block)
    k = db.n_blocks if params.exhaustive else params.k_blocks
    return nqb * k * db.max_r * params.q_block
