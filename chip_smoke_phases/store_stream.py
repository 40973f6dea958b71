"""Phases 12-15: the store, streamed search and the two cascades on it.

12. the store: OMSPipeline.ingest of the Table I library (chunks of 65,536
    rows) into a store under build/ (its free space printed first), then
    from_store(resident=True): its DB equals phase 3's in all eight fields
    and its fused search equals phase 3's result.
13. streamed search: from_store(resident=False) at 2^18 rows a slab, at 37
    blocks (a prime) and at the whole store, with fused and fused_mxu: each
    equal to phase 3's result (6 arrays, both FDRs), one fused launch per
    streamed slab; per slab the host gather, upload and search times, slabs
    touched, rows and bytes read, and the peak device memory above the
    baseline beside the resident DB's bytes.
14. the streamed exact dimension cascade at prefix_words 8 with fused: equal
    to the resident cascade, run beside it, and to phase 3's result.
15. the narrow→open cascade at 1 Da with fused, resident and streamed: equal
    to each other (merged result, both FDRs, stage-1 identified, stage
    queries and results); with run_stage1 False equal to search_encoded;
    identified count, each stage's time, scanned rows against
    pure_open_scanned_rows, and bytes streamed.

``times_streamed`` (a warm streamed search at each slab size) is
scripts/chip_times.py's.
"""
from __future__ import annotations

import json
import shutil
import time

from . import common as C
from .common import counted, equal, log, require
from .oms_common import (DB_FIELDS, NARROW_TOL_DA, STREAM_KERNELS, db_nbytes,
                         outputs_equal, slab_line)

# Streamed slab sizes in rows: 2^18, a prime number of blocks (37 of 4,096
# rows), the whole store. The first is the ``streamed`` resource's.
STREAM_SLAB_ROWS = (1 << 18, 37 * 4096, 1 << 30)
STREAM_CASCADE_PREFIX = 8


# ---------------------------------------------------------------------------
# Phase 12: the store (the ``store`` resource is its ingest)
# ---------------------------------------------------------------------------


def ingest_store(ctx):
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.kernels.hdencode import ops as hd_ops
    torch = ctx.torch
    cfg = ctx.cfg
    _, ds = ctx.data()
    store_dir = ctx.store_dir
    n_rows = ctx.main().pipe.db.n_rows
    store_dir.parent.mkdir(parents=True, exist_ok=True)
    need = n_rows * (4 * cfg.n_words + 13)
    free = shutil.disk_usage(store_dir.parent).free
    log(f"[store] free space at {store_dir.parent}: "
        f"{free / 1e9:.2f} GB; the store needs ~{need / 1e9:.2f} GB")
    require(free > 2 * need, f"not enough free disk for the store: {free} bytes "
            f"free, {2 * need} wanted")
    shutil.rmtree(store_dir, ignore_errors=True)
    hd_ops.launches.reset()
    t0 = time.perf_counter()
    store = OMSPipeline.ingest(cfg, ds.refs, str(store_dir), device=C.DEVICE,
                               chunk_rows=C.CHUNK_ROWS)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    n_hd = hd_ops.launches.count
    require(n_hd > 0, "the store ingest launched no hdencode kernel")
    ctx.by_path["hdencode"]["store ingest"] = n_hd
    log(f"[store] ingest of {store.n_targets} spectra + decoys into {len(store.shards)} "
        f"shards, {store.nbytes() / 1e9:.3f} GB, in {t_ingest:.2f}s ({n_hd} hdencode "
        f"launches)")
    return store


def store(ctx) -> None:
    from repro_torch.core.pipeline import OMSPipeline
    torch = ctx.torch
    m = ctx.main()
    st = ctx.store()
    t0 = time.perf_counter()
    spipe = OMSPipeline.from_store(st, ctx.cfg, device=C.DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    for f in DB_FIELDS:
        require(equal(getattr(spipe.db, f), getattr(m.pipe.db, f)),
                f"store-loaded DB differs from the in-memory one ({f})")
    sout, t_search, counts = counted(torch, lambda: spipe.search_encoded(*m.batch))
    require(outputs_equal(sout, m.out), "store-loaded fused search differs from phase 3")
    require(counts["fused_search"] > 0, "store-loaded search launched no fused_search")
    ctx.by_path["fused_search"]["store-loaded search"] = counts["fused_search"]
    log(f"[store] from_store(resident=True) in {t_load:.2f}s: DB == in-memory DB in "
        f"all 8 fields; fused search == phase 3 (6 arrays, both FDRs) in "
        f"{t_search:.3f}s")


# ---------------------------------------------------------------------------
# Phase 13: streamed search (the ``streamed`` resource is its first layout)
# ---------------------------------------------------------------------------


def open_streamed(ctx, slab_rows: int | None = None):
    from repro_torch.core.pipeline import OMSPipeline
    return OMSPipeline.from_store(ctx.store(), ctx.cfg, device=C.DEVICE, resident=False,
                                  slab_rows=slab_rows or STREAM_SLAB_ROWS[0])


def _layouts(ctx):
    """(slab_rows, streamed pipeline, seconds to open it) at every size."""
    for slab_rows in STREAM_SLAB_ROWS:
        t0 = time.perf_counter()
        spipe = ctx.streamed() if slab_rows == STREAM_SLAB_ROWS[0] else open_streamed(
            ctx, slab_rows)
        yield slab_rows, spipe, time.perf_counter() - t0


def streamed(ctx) -> None:
    torch = ctx.torch
    m = ctx.main()
    db_bytes = db_nbytes(m.pipe.db)
    for _, spipe, t_open in _layouts(ctx):
        plan = spipe.engine.plan
        # Baseline before this pipeline's first search: the peaks below
        # include the slab buffers the engine keeps between searches.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for be, kernel in STREAM_KERNELS.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats = {}
            res, t_first, counts = counted(torch, lambda: spipe.search_encoded(
                *m.batch, backend=be, stats=stats))
            peak = torch.cuda.max_memory_allocated() - base
            st = spipe.engine.last_stats
            require(outputs_equal(res, m.out), f"streamed {be} at {plan.slab_rows} rows a "
                    f"slab differs from the resident fused result")
            require(counts[kernel] == st.n_scanned > 0, f"streamed {be}: {counts[kernel]} "
                    f"{kernel} launches for {st.n_scanned} slabs")
            ctx.by_path[kernel][f"streamed {be}, {plan.slab_blocks} blocks a slab"] = (
                counts[kernel])
            log(f"[stream] {be}, {plan.slab_rows} rows a slab ({plan.slab_blocks} blocks, "
                f"{plan.n_slabs} slabs; layout in {t_open:.2f}s): == resident fused (6 "
                f"arrays, both FDRs); slabs touched {st.n_scanned}/{st.n_slabs}, rows read "
                f"{st.scanned_rows}, bytes {st.scanned_bytes}; first {t_first:.3f}s; "
                f"{slab_line(stats)}; peak device memory above the "
                f"baseline {peak / 2**30:.3f} GiB (resident DB {db_bytes / 2**30:.3f} GiB); "
                f"launches {json.dumps(counts)}")
        del spipe


def times_streamed(ctx) -> dict:
    """Each slab size and fused backend: a first search, then a warm one
    with its per-slab times (host clock ended by a synchronize)."""
    torch = ctx.torch
    m = ctx.main()
    out = {}
    for slab_rows, spipe, _ in _layouts(ctx):
        for be in STREAM_KERNELS:
            spipe.search_encoded(*m.batch, backend=be)
            torch.cuda.synchronize()
            stats = {}
            t0 = time.perf_counter()
            spipe.search_encoded(*m.batch, backend=be, stats=stats)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            out[f"{be} {spipe.engine.plan.slab_rows} rows a slab"] = t
            log(f"[stream] {be}, {spipe.engine.plan.slab_rows} rows a slab, warm: "
                f"{t:.3f}s; {slab_line(stats)}")
        del spipe
    return out


# ---------------------------------------------------------------------------
# Phases 14-15: the streamed dimension cascade; the narrow→open cascade
# ---------------------------------------------------------------------------


def streamed_cascade(ctx) -> None:
    torch = ctx.torch
    m = ctx.main()
    spipe = ctx.streamed()
    P = STREAM_CASCADE_PREFIX
    resident, t_res, _ = counted(torch, lambda: m.pipe.search_encoded(
        *m.batch, prefix_words=P))
    res, t, counts = counted(torch, lambda: spipe.search_encoded(
        *m.batch, prefix_words=P))
    require(outputs_equal(res, resident) and outputs_equal(res, m.out),
            f"streamed cascade prefix_words={P} differs from the resident cascade")
    require(counts["hamming_matrix"] > 0, "streamed cascade launched no hamming_matrix")
    ctx.by_path["hamming_matrix"][f"streamed cascade prefix_words={P}"] = (
        counts["hamming_matrix"])
    st = spipe.engine.last_stats
    log(f"[stream] exact cascade prefix_words={P}, fused, {spipe.engine.plan.slab_rows} "
        f"rows a slab: == resident cascade ({t_res:.2f}s) and phase 3's result (6 "
        f"arrays, both FDRs) in {t:.2f}s; slabs "
        f"{st.n_scanned}/{st.n_slabs}, rows read {st.scanned_rows}, bytes "
        f"{st.scanned_bytes}; launches {json.dumps(counts)}")


def _timed_stages(torch, p, fn):
    """Run ``fn`` with ``p``'s per-stage search timed (device-synced)."""
    times = []
    orig = p._run_search

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return r
    p._run_search = timed
    try:
        return fn(), times
    finally:
        del p._run_search


def _cascades_equal(a, b) -> bool:
    same = all(equal(getattr(a.result, f), getattr(b.result, f)) for f in a.result._fields)
    for fa, fb in ((a.open_fdr, b.open_fdr), (a.std_fdr, b.std_fdr)):
        same = same and all(equal(getattr(fa, f), getattr(fb, f)) for f in fa._fields)
    same = same and bool((a.identified_stage1 == b.identified_stage1).all())
    for sa, sb in ((a.stage1, b.stage1), (a.stage2, b.stage2)):
        same = same and (sa is None) == (sb is None)
        if sa is not None and sb is not None:
            same = same and bool((sa.query_idx == sb.query_idx).all()) and all(
                equal(getattr(sa.result, f), getattr(sb.result, f)) for f in sa.result._fields)
    return same


def narrow_cascade(ctx) -> None:
    torch = ctx.torch
    m = ctx.main()
    spipe = ctx.streamed()
    hvs, q_pmz, q_charge = m.batch
    Q = hvs.shape[0]
    outs = {}
    pure = m.pipe.pure_open_scanned_rows(Q, q_pmz, q_charge)
    for name, p in (("resident", m.pipe), ("streamed", spipe)):
        (cout, t, counts), times = _timed_stages(torch, p, lambda: counted(
            torch, lambda: p.search_cascade_encoded(hvs, q_pmz, q_charge,
                                                    narrow_tol_da=NARROW_TOL_DA)))
        require(counts["fused_search"] > 0, f"{name} cascade launched no fused_search")
        require(cout.stage1 is not None and cout.stage2 is not None
                and cout.identified_stage1.any(),
                f"{name} cascade: stage 1 identified nothing or everything")
        outs[name] = cout
        ctx.by_path["fused_search"][f"narrow→open cascade, {name}"] = counts["fused_search"]
        n_id = int(cout.identified_stage1.sum())
        stream = ""
        if cout.scanned_bytes_total is not None:
            s1, s2 = cout.stage1.stream_stats, cout.stage2.stream_stats
            stream = (f"; bytes streamed {cout.scanned_bytes_total}, slabs stage 1 "
                      f"{s1.n_scanned}/{s1.n_slabs}, stage 2 {s2.n_scanned}/{s2.n_slabs}")
        log(f"[narrow] {name} cascade at {NARROW_TOL_DA} Da, fused, {Q} queries in "
            f"{t:.3f}s: stage 1 identified {n_id} ({times[0]:.3f}s), stage 2 on "
            f"{Q - n_id} queries ({times[1]:.3f}s); open identifications "
            f"{int(cout.open_fdr.n_accepted)}; scanned rows {cout.scanned_rows_total} "
            f"against pure open {pure} ({cout.scanned_rows_total / pure:.4f}){stream}; "
            f"launches {json.dumps(counts)}")
        c0 = p.search_cascade_encoded(hvs, q_pmz, q_charge, run_stage1=False)
        require(all(equal(getattr(c0.result, f), getattr(m.out.result, f))
                    for f in m.out.result._fields)
                and all(equal(getattr(c0.std_fdr, f), getattr(m.out.std_fdr, f))
                        for f in m.out.std_fdr._fields),
                f"{name} cascade with run_stage1=False differs from search_encoded")
    require(_cascades_equal(outs["resident"], outs["streamed"]),
            "streamed narrow→open cascade differs from the resident one")
    log("[narrow] streamed cascade == resident cascade (merged result, both FDRs, "
        "stage-1 identified, stage queries and results); run_stage1=False == "
        "search_encoded on both paths")
