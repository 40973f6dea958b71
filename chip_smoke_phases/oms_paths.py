"""Phases 3-4 and 8-9: the main path and the paths held against it.

 3. the main path at the iPRG2012 scale of Table I: OMSPipeline ingest of
    1,160,000 spectra plus as many decoys, 16,000 queries encoded and
    searched (backend ``fused``, encode backend ``pallas``), FDR at 1%; both
    kernels' launch counts are read around this path. Then the fused_search
    kernel against its plain version on 8 of its query blocks, at k = 1 and
    k = 4, and at 7 words (the scalar-load variant); both fused kernels
    (grouped: 8 consecutive query tiles per CTA) against their plain
    versions on two runs of 2G + 1 consecutive main-path blocks at k = 1, 4
    and 16, with the groups' union/rk; and at the grouped design's edges on
    seeded synthetic data (tie-heavy duplicate rows): batches of 1, 2 and
    G + 1 blocks, identical starts, ranges past the last row, q_block 20,
    W = 7, 9, 12 and 256, k = 1, 4 and 16.
 4. path against path: the first 512 queries through the plain torch ops
    (vpu, word_tiled) and through the kernels (fused, pallas) against the
    full DB; a 4,096-row library slice re-encoded with word_tiled against the
    kernel-built DB; and a small dataset through the kernels on the card
    against the plain versions on the CPU. Then the planner: on PLAN_CASES
    seeded small libraries and runs at its edges (absent charges, padding
    blocks, tied and negative pmz, -0.0, the n_blocks cap, runs shorter
    than q_block) the plan_reach kernel against its plain version and
    ``plan_search`` on the card's tensors against the host planner; at the
    size of each configuration of the benchmark (``portbench/configs``, its
    generator and ingest): on PLAN_RUNS of its pool's runs ``plan_search``
    on the run's device tensors returns the host planner's ``k_blocks``,
    and in one search torch's sync debug mode flags one copy inside span
    ``pipeline.plan``, the one inside ``sync.plan.k_blocks``.
 8. the kernel backends end to end: search_encoded with kernel_vpu,
    kernel_mxu and fused_mxu on the full batch, each equal to phase 3's
    fused result (6 SearchResult arrays, both FDR results); each run's
    launch counts are set to 0 just before it and read just after.
 9. the dimension cascade, exact mode, at prefix_words 8 and 64 with fused,
    kernel_vpu and fused_mxu on the full batch, each equal to the
    full-width fused result; seed rows, survivors, buckets, stage times and
    the tile launches by shape (rows x words) are printed. Then margin mode
    (prefix_margin = half the rest), which prunes: the stage-A keep flags of
    the whole batch (thresholds from the full scan) through the kernel_vpu
    and fused_mxu tiles against the plain tile, a strict subset kept; and on
    the first 512 queries the same three backends' searches against a run
    whose tile is the plain version (row-chunked), all results and survivor
    counts equal, survivors a strict subset.

``times_backends`` (a warm run of each kernel backend) is
scripts/chip_times.py's.
"""
from __future__ import annotations

import json
import time

from . import common as C
from .common import counted, equal, log, require
from .context import MainPath
from .oms_common import (FUSED_GROUP_KS, FUSED_GROUP_RUN, FUSED_OUTS, NARROW_W,
                         check_blocks, fused_edge_inputs, fused_pair_check,
                         outputs_equal, plain_tile, sorted_batch, union_stats)

PATH_CHECK_QUERIES = 512
SLICE_ROWS = 4096
# The benchmark's cells whose configurations phase 4 plans at full size
# (the top-10 cell shares iprg2012's), and the pool runs planned in each.
PLAN_CELLS = ("iprg2012.open_batch", "hek293.open_batch")
PLAN_RUNS = 4
PLAN_CASES = 200
# The kernel backends of phase 8 and the kernel each of them launches.
BACKEND_KERNELS = {"kernel_vpu": "hamming_matrix", "kernel_mxu": "hamming_mxu",
                   "fused_mxu": "fused_search_mxu"}
CASCADE_PREFIX_WORDS = (8, 64)
# The cascade's backends and the tile kernel each routes its stages to.
CASCADE_TILES = {"fused": "hamming_matrix", "kernel_vpu": "hamming_matrix",
                 "fused_mxu": "hamming_mxu"}
MARGIN_QUERIES = PATH_CHECK_QUERIES
PLAIN_TILE_BACKEND = "plain_tile"   # registered by phase 9 for its yardstick
# (what, rows, W, start rows, rk, q_block) on seeded synthetic data whose
# rows repeat 8 HVs (ties); every case at k = 1, 4 and 16, both kernels.
FUSED_EDGE_CASES = (
    ("1 block", 3000, 128, (5,), 2000, 16),
    ("2 blocks, identical starts", 3000, 128, (7, 7), 2000, 16),
    ("G + 1 blocks (a partial last group)", 12000, 128, tuple(range(0, 9 * 1100, 1100)),
     2048, 16),
    ("ranges past the last row", 3000, 8, (0,) * 9 + (2990, 2995), 64, 16),
    ("q_block 20", 4000, 128, (0, 100, 200, 300, 400), 1000, 20),
    ("W = 7", 3000, 7, (0, 8, 16, 1000, 1000, 2700, 2750), 300, 16),
    ("W = 9", 3000, 9, tuple(range(0, 90, 10)), 1024, 16),
    ("W = 12", 3000, 12, tuple(range(0, 900, 100)), 1024, 16),
    ("W = 256", 3000, 256, tuple(range(0, 90, 10)), 1024, 16),
)


# ---------------------------------------------------------------------------
# The main path (the ``main`` resource) and phase 3
# ---------------------------------------------------------------------------


def ingest_main(ctx) -> MainPath:
    """The main path: ingest, encode, search, with hdencode's and
    fused_search's launches counted around it, then the checks of its
    result."""
    import numpy as np
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.kernels.hamming import ops as fs_ops
    from repro_torch.kernels.hdencode import ops as hd_ops
    torch = ctx.torch
    cfg = ctx.cfg
    _, ds = ctx.data()

    hd_ops.launches.reset()
    fs_ops.launches.reset()
    t0 = time.perf_counter()
    pipe = OMSPipeline(cfg, ds.refs, device=C.DEVICE, chunk_rows=C.CHUNK_ROWS)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    hvs, q_pmz, q_charge = pipe.encode_queries(ds.queries)
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = pipe.search_encoded(hvs, q_pmz, q_charge)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = {"hdencode": hd_ops.launches.count,
                "fused_search": fs_ops.launches.count}

    Q = ds.queries.mz.shape[0]
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    log(f"[main] ingested {pipe.db.n_rows} rows ({pipe.db.n_blocks} blocks of "
        f"{cfg.max_r}, {2 * pipe.n_targets} spectra) in {t_ingest:.2f}s")
    log(f"[main] encoded {Q} queries in {t_encode:.3f}s; searched in "
        f"{t_search:.3f}s (backend={cfg.backend}, encode_backend="
        f"{cfg.encode_backend}, k_blocks={params.k_blocks}, "
        f"rows/block={params.k_blocks * cfg.max_r})")
    src = ds.query_source
    mod = ds.query_modified
    open_hit = out.result.open_idx[:, 0].cpu().numpy() == src
    std_hit = out.result.std_idx[:, 0].cpu().numpy() == src
    log(f"[main] open-search recall@1:     {open_hit.mean():.3f} "
        f"(modified queries: {open_hit[mod].mean():.3f})")
    log(f"[main] standard-search recall@1: {std_hit.mean():.3f} "
        f"(modified queries: {std_hit[mod].mean():.3f})")
    n_id = pipe.identifications(out)
    log(f"[main] identifications @ {cfg.fdr_threshold:.0%} FDR: {n_id} / "
        f"{Q * cfg.top_k}")
    log(f"[main] launches: {json.dumps(launches)}")

    r = out.result
    for f in r._fields:
        t = getattr(r, f)
        require(tuple(t.shape) == (Q, cfg.top_k) and t.dtype == torch.int32,
                f"SearchResult.{f} has shape {tuple(t.shape)} {t.dtype}")
    for f in ("std_sim", "open_sim"):
        t = getattr(r, f)
        require(bool(((t >= -1) & (t <= cfg.dim)).all()), f"{f} out of range")
    for f in ("std_idx", "open_idx"):
        t = getattr(r, f)
        require(bool(((t >= -1) & (t < 2 * pipe.n_targets)).all()),
                f"{f} out of range")
    for fd in (out.open_fdr, out.std_fdr):
        require(bool(torch.isfinite(fd.q_values).all()
                     & (fd.q_values >= 0).all() & (fd.q_values <= 1).all()),
                "q-values not finite in [0, 1]")
    require(n_id > 0 and np.isfinite(open_hit.mean()), "no identifications")
    for name, n in launches.items():
        require(n > 0, f"the main path launched the {name} kernel {n} times")
        ctx.by_path[name]["main path"] = n
    return MainPath(pipe, hvs, q_pmz, q_charge, out)


def main_path(ctx) -> None:
    m = ctx.main()
    fused_check(ctx.torch, m)
    fused_groups(ctx.torch, m)
    fused_edges(ctx.torch)


def fused_check(torch, m) -> None:
    from repro_torch.kernels.hamming import ops, ref
    pipe = m.pipe
    params, args, pick, rk = check_blocks(torch, pipe, *m.batch)
    QB = params.q_block
    db = pipe.db
    for k in (1, 4):
        kw = dict(q_block=QB, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        got = ops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        want = ref.fused_search(*args, **kw)
        for name, g, w in zip(FUSED_OUTS, got, want):
            require(equal(g, w), f"fused_search kernel differs from plain ({name}, k={k})")
        log(f"[check] fused_search kernel == plain on {len(pick)} main-path query "
            f"blocks x {rk} rows at k={k}: bit-identical "
            f"(in-window open winners: {int((want[3] >= 0).sum())})")
    # A word count that is not a multiple of 4 takes the scalar-load variant.
    narrow = (args[0][:, :NARROW_W].contiguous(), *args[1:3],
              db.hvs[:, :NARROW_W].contiguous(), *args[4:])
    kw = dict(q_block=QB, rk=rk, dim=32 * NARROW_W, k=4,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    got = ops.fused_search(*narrow, **kw)
    torch.cuda.synchronize()
    want = ref.fused_search(*narrow, **kw)
    for name, g, w in zip(FUSED_OUTS, got, want):
        require(equal(g, w), f"fused_search kernel differs from plain ({name}, "
                f"W={NARROW_W})")
    log(f"[check] fused_search kernel == plain at W = {NARROW_W} words (scalar "
        f"loads), k=4: bit-identical")


def fused_groups(torch, m) -> None:
    """The grouped fused kernels on runs of consecutive main-path blocks:
    groups of 8 tiles form, the last group of each run is partial, and the
    second run's start rows differ (masks inside a group's union)."""
    pipe = m.pipe
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, *m.batch)
    db, QB = pipe.db, params.q_block
    rk = params.k_blocks * db.max_r
    nqb = starts.shape[0]
    kw = dict(q_block=QB, rk=rk, dim=pipe.cfg.dim, ppm_tol=params.ppm_tol,
              open_tol_da=params.open_tol_da)
    # A run from block 0 and, after it, the first run whose start rows are
    # not all equal (a group whose union is wider than rk).
    st = starts.cpu()
    shifted = next((b for b in range(FUSED_GROUP_RUN, nqb - FUSED_GROUP_RUN + 1)
                    if st[b + FUSED_GROUP_RUN - 1] > st[b]), nqb // 2)
    for b0 in (0, shifted):
        blocks = slice(b0, min(b0 + FUSED_GROUP_RUN, nqb))
        rows = slice(blocks.start * QB, blocks.stop * QB)
        run_starts = starts[blocks].contiguous()
        args = (qh[rows].contiguous(), qp[rows].contiguous(), qc[rows].contiguous(),
                db.hvs, db.pmz, db.charge, run_starts)
        fused_pair_check(torch, f"blocks {blocks.start}..{blocks.stop - 1}", args, kw)
        u_mean, u_max = union_stats(run_starts, rk, db.n_rows)
        log(f"[check] fused_search and fused_search_mxu kernels == plain on "
            f"{blocks.stop - blocks.start} consecutive main-path blocks "
            f"({blocks.start}..{blocks.stop - 1}) x {rk} rows at k = "
            f"{', '.join(map(str, FUSED_GROUP_KS))}: bit-identical (groups' "
            f"union/rk mean {u_mean:.4f}, max {u_max:.4f})")


def fused_edges(torch) -> None:
    g = torch.Generator(device=C.DEVICE).manual_seed(C.SEED + 4)
    for what, n_rows, W, starts, rk, q_block in FUSED_EDGE_CASES:
        args = fused_edge_inputs(torch, g, n_rows, W, starts, rk, q_block)
        fused_pair_check(torch, what, args, dict(q_block=q_block, rk=rk, dim=32 * W))
    log(f"[check] fused_search and fused_search_mxu kernels == plain at the grouped "
        f"design's edges ({'; '.join(c[0] for c in FUSED_EDGE_CASES)}) at k = "
        f"{', '.join(map(str, FUSED_GROUP_KS))}, tie-heavy rows: bit-identical")


# ---------------------------------------------------------------------------
# Phase 4: path against path
# ---------------------------------------------------------------------------


def paths(ctx) -> None:
    import dataclasses

    import numpy as np
    from repro_torch.core import encode_backends
    from repro_torch.core.pipeline import OMSConfig, OMSPipeline
    from repro_torch.data.spectra import LibraryConfig, SpectraSet, make_dataset
    torch = ctx.torch
    pipe = ctx.main().pipe
    _, ds = ctx.data()

    n = PATH_CHECK_QUERIES
    sub = SpectraSet(*(x[:n] for x in ds.queries))
    plain_pipe_cfg = dataclasses.replace(pipe.cfg, encode_backend="word_tiled")
    kern_hvs, kqp, kqc = pipe.encode_queries(sub)
    plain_hvs, pqp, pqc = encode_backends.preprocess_encode(
        sub.mz, sub.intensity, sub.pmz, sub.charge, pipe.codebooks,
        plain_pipe_cfg.preprocess_params, backend="word_tiled",
        batch=plain_pipe_cfg.encode_batch)
    require(equal(kern_hvs, plain_hvs) and equal(kqp, pqp) and equal(kqc, pqc),
            "query HVs differ between pallas and word_tiled")
    kern = pipe.search_encoded(kern_hvs, kqp, kqc, backend="fused")
    plain = pipe.search_encoded(plain_hvs, pqp, pqc, backend="vpu")
    torch.cuda.synchronize()
    require(outputs_equal(kern, plain),
            "(fused, pallas) and (vpu, word_tiled) disagree on the full DB")
    log(f"[paths] {n} queries: (fused, pallas) == (vpu, word_tiled) against the "
        f"full DB — 6 SearchResult arrays and both FDR results identical "
        f"(open identifications {int(kern.open_fdr.n_accepted)})")

    # Re-encode a library slice with word_tiled; find the same rows in the DB.
    lib = SpectraSet(*(x[:SLICE_ROWS] for x in ds.refs))
    hv, _, _ = encode_backends.preprocess_encode(
        lib.mz, lib.intensity, lib.pmz, lib.charge, pipe.codebooks,
        pipe.cfg.preprocess_params, backend="word_tiled", batch=512)
    orig = pipe.db.orig_idx
    rows = torch.nonzero((orig >= 0) & (orig < SLICE_ROWS)).reshape(-1)
    rows = rows[torch.argsort(orig[rows])]
    require(equal(pipe.db.hvs[rows], hv),
            "library HVs built by the hdencode kernel differ from word_tiled")
    log(f"[paths] {SLICE_ROWS}-row library slice: kernel-built DB rows == "
        f"word_tiled re-encode")

    # A small dataset: kernels on the card against plain versions on the CPU.
    small = make_dataset(LibraryConfig(n_refs=1024, n_queries=64, seed=C.SEED + 1))
    cfg = OMSConfig(dim=1024, bin_size=0.5, max_r=256, top_k=2)
    on_card = OMSPipeline(dataclasses.replace(cfg, backend="fused",
                                              encode_backend="pallas"),
                          small.refs, device=C.DEVICE)
    on_cpu = OMSPipeline(cfg, small.refs, device="cpu")
    a = on_card.search(small.queries)
    b = on_cpu.search(small.queries)
    same_db = all(equal(getattr(on_card.db, f).cpu(), getattr(on_cpu.db, f))
                  for f in ("hvs", "pmz", "charge", "is_decoy", "orig_idx"))
    a_cpu = type(a)(*(type(x)(*(t.cpu() for t in x)) for x in a))
    require(same_db and outputs_equal(a_cpu, b),
            "small dataset: card kernels disagree with CPU plain versions")
    hit = np.mean(a.result.open_idx[:, 0].cpu().numpy() == small.query_source)
    log(f"[paths] small dataset (1024 refs, 64 queries, dim 1024, top_k 2): card "
        f"(fused, pallas) == CPU (vpu, word_tiled); open recall@1 {hit:.3f}")
    planner_edges(torch)
    for cell in PLAN_CELLS:
        planner_cell(torch, cell)


def planner_edges(torch) -> None:
    """The plan_reach kernel == its plain version, and the device plan ==
    the host plan, on PLAN_CASES seeded small cases."""
    import numpy as np
    from repro_torch.core import blocking, search
    from repro_torch.kernels.plan import ops, ref
    rng = np.random.default_rng(C.SEED + 32)
    ks = set()
    for _ in range(PLAN_CASES):
        n, max_r = int(rng.integers(1, 400)), int(rng.choice([1, 4, 16]))
        scale = float(rng.choice([10.0, 1000.0, 8000.0]))
        pmz = (rng.uniform(-0.2, 1.0, n) * scale).astype(np.float32)
        tied = rng.random(n) < 0.3
        pmz[tied] = np.round(pmz[tied])
        charge = rng.choice([2, 3, 4], n).astype(np.int32)
        db = blocking.build_reference_db(np.zeros((n, 1), np.int32), pmz, charge,
                                         np.zeros(n, bool), max_r=max_r, device=C.DEVICE)
        if rng.random() < 0.3:
            db = blocking.shard_reference_db(db, int(rng.integers(2, 6)))
        Q = int(rng.choice([0, 1, 7, 300, 2000]))
        qp = (rng.uniform(-0.2, 1.0, Q) * scale).astype(np.float32)
        tied = rng.random(Q) < 0.2
        qp[tied] = np.round(qp[tied])
        qp[rng.random(Q) < 0.1] = np.float32(-0.0)
        qc = rng.choice([1, 2, 3, 4, 5, -1], Q).astype(np.int32)
        kw = dict(open_tol_da=float(rng.choice([0.0, 20.0, 75.0, 1e4])),
                  q_block=int(rng.choice([1, 8, 16])))
        qp_t, qc_t = (torch.from_numpy(x).to(C.DEVICE) for x in (qp, qc))
        host = search.plan_search(db, qp, qc, **kw)
        on_device = search.plan_search(db, qp_t, qc_t, **kw)
        require(on_device == host, f"planner edge case (n={n}, max_r={max_r}, "
                f"Q={Q}, {kw}): device plan {on_device} != host plan {host}")
        ks.add(host)
        if Q:
            sp, by_pmz = torch.sort(qp_t, stable=True)
            sc, by_charge = torch.sort(qc_t[by_pmz], stable=True)
            args = (sp[by_charge], sc, *search.plan_block_keys(db))
            got = int(ops.plan_reach(*args, **kw).item())
            want = int(ref.plan_reach(*args, **kw).item())
            require(got == want, f"plan_reach kernel {got} != plain {want} "
                    f"(n={n}, max_r={max_r}, Q={Q}, {kw})")
    log(f"[paths] planner edges: {PLAN_CASES} seeded cases, plan_reach kernel == "
        f"plain and device plan == host plan (k_blocks {min(ks)}..{max(ks)})")


def planner_cell(torch, name: str) -> None:
    """The device planner on one benchmark configuration at its size: the
    host planner's ``k_blocks`` on PLAN_RUNS pool runs, and one copy that
    synchronises inside ``pipeline.plan`` (torch's sync debug mode)."""
    import warnings

    from portbench import gen_spectra, harness
    from repro_torch.core import search
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.obs import trace
    cell = harness.resolve(harness.load_benchmark(), name)
    seed = C.SEED + 31
    library, pool, _ = gen_spectra.make_inputs(
        cell.config, {**cell.traffic, "pool_runs": PLAN_RUNS, "warm_runs": 0},
        seed, C.DEVICE)
    pipe = OMSPipeline(harness.driver(cell.traffic["driver"]).oms_config(
        cell.config, seed), library, device=C.DEVICE)
    del library
    cfg = pipe.cfg
    ks = []
    for run in pool:
        _, qp, qc = pipe.encode_queries(run)
        kw = dict(open_tol_da=cfg.open_tol_da, q_block=cfg.q_block)
        on_device = search.plan_search(pipe.db, qp, qc, **kw)
        host = search.plan_search(pipe.db, qp.cpu().numpy(), qc.cpu().numpy(), **kw)
        require(on_device == host, f"{name}: device plan k_blocks {on_device} != "
                f"host plan {host}")
        ks.append(host)
    pipe.search(pool[0])
    torch.cuda.synchronize()
    flagged = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            flagged.append(time.perf_counter_ns())

    tracer = trace.install(trace.Tracer())
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pipe.search(pool[1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        trace.uninstall()
    one = {e.name: e for e in tracer.events()}
    plan, k_span = one["pipeline.plan"], one["sync.plan.k_blocks"]
    in_plan = [t for t in flagged if plan.t_start_ns <= t <= plan.t_end_ns]
    require(len(in_plan) == 1 and k_span.t_start_ns <= in_plan[0] <= k_span.t_end_ns,
            f"{name}: {len(in_plan)} synchronising copies inside pipeline.plan")
    log(f"[paths] {name} at size ({pipe.db.n_blocks} blocks, "
        f"{pool[0].pmz.shape[0]} queries a run): device plan == host plan on "
        f"{len(ks)} pool runs (k_blocks {ks}); one synchronising copy in "
        f"pipeline.plan, in sync.plan.k_blocks ({len(flagged)} in the search)")
    del pipe, pool
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: the kernel backends end to end
# ---------------------------------------------------------------------------


def backends(ctx) -> None:
    torch = ctx.torch
    m = ctx.main()
    Q = m.hvs.shape[0]
    for be, kernel in BACKEND_KERNELS.items():
        out, t_first, counts = counted(
            torch, lambda: m.pipe.search_encoded(*m.batch, backend=be))
        require(outputs_equal(out, m.out), f"backend {be} differs from fused "
                f"on the full batch")
        require(counts[kernel] > 0, f"backend {be} launched {kernel} "
                f"{counts[kernel]} times")
        ctx.by_path[kernel][f"backend {be}"] = counts[kernel]
        log(f"[backends] {be}: 6 SearchResult arrays and both FDR results == "
            f"fused on {Q} queries in {t_first:.3f}s; launches {json.dumps(counts)}")


def times_backends(ctx) -> dict:
    """A warm run of the main path's search and of each kernel backend on
    the full batch (host clock ended by a synchronize)."""
    torch = ctx.torch
    m = ctx.main()
    Q = m.hvs.shape[0]
    out = {}
    for be in ("fused", *BACKEND_KERNELS):
        m.pipe.search_encoded(*m.batch, backend=be)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.pipe.search_encoded(*m.batch, backend=be)
        torch.cuda.synchronize()
        out[be] = time.perf_counter() - t0
        log(f"[backends] {be} on {Q} queries, warm: {out[be]:.4f}s "
            f"({Q / out[be]:.0f} queries/s)")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the dimension cascade
# ---------------------------------------------------------------------------


def stats_line(stats, n_real) -> str:
    return (f"seed rows {stats['seed_rows']} (bucket {stats['seed_bucket']}), "
            f"survivors {stats['survivors']} of {n_real} real rows "
            f"({stats['survivors'] / n_real:.4f}; bucket "
            f"{stats['survivor_bucket']}); stages seed {stats['seed_s']:.2f}s, "
            f"prefix {stats['prefix_s']:.2f}s, rescore {stats['rescore_s']:.2f}s")


def tile_shapes(kernel: str, fn):
    """Run ``fn`` with the ``kernel`` tile wrapper wrapped to tally the
    (rows, words) of every call; returns (fn's result, the tally)."""
    import collections
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    mod = hops if kernel == "hamming_matrix" else mops
    orig, shapes = mod.hamming_matrix, collections.Counter()

    def tallied(q, r, *rest, **kw):
        shapes[f"{r.shape[0]} x {r.shape[1]}"] += 1
        return orig(q, r, *rest, **kw)
    mod.hamming_matrix = tallied
    try:
        return fn(), dict(shapes)
    finally:
        mod.hamming_matrix = orig


def cascade(ctx) -> None:
    torch = ctx.torch
    m = ctx.main()
    pipe = m.pipe
    Q = m.hvs.shape[0]
    n_real = int((pipe.db.orig_idx >= 0).sum())
    for P in CASCADE_PREFIX_WORDS:
        for be, kernel in CASCADE_TILES.items():
            stats = {}
            (out, t, counts), shapes = tile_shapes(kernel, lambda: counted(
                torch, lambda: pipe.search_encoded(*m.batch, backend=be,
                                                   prefix_words=P, stats=stats)))
            require(outputs_equal(out, m.out), f"cascade prefix_words={P} "
                    f"backend={be} differs from the full-width fused search")
            require(counts[kernel] > 0, f"cascade backend {be} launched {kernel} "
                    f"{counts[kernel]} times")
            log(f"[cascade] prefix_words={P} ({32 * P} bits) backend={be}, exact: "
                f"== full-width fused on {Q} queries in {t:.2f}s; "
                f"{stats_line(stats, n_real)}; launches {json.dumps(counts)}; "
                f"{kernel} launches by rows x words {json.dumps(shapes)}")
    cascade_margin(torch, m)


def cascade_margin(torch, m) -> None:
    """Margin mode prunes. First the stage-A keep flags of the whole batch,
    from the full scan's exact thresholds, through each kernel tile against
    the plain tile; then margin-mode searches, whose survivors are a strict
    subset, gathered and rescored: every kernel backend must equal a run
    whose prefix and rescore tiles are the plain version."""
    from repro_torch.core import backends as B
    from repro_torch.core import search
    from repro_torch.kernels.hamming import ops as hops
    B.register(PLAIN_TILE_BACKEND, B.MATRIX, plain_tile)
    pipe = m.pipe
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, *m.batch)
    db, dim = pipe.db, pipe.cfg.dim
    n_real = int((db.orig_idx >= 0).sum())
    run = hops.fused_search(qh, qp, qc, db.hvs, db.pmz, db.charge, starts,
                            q_block=params.q_block, rk=params.k_blocks * db.max_r,
                            dim=dim, k=params.top_k, ppm_tol=params.ppm_tol,
                            open_tol_da=params.open_tol_da)
    thr_std, thr_open = search.kth_thresholds(run, params.top_k)
    for P in CASCADE_PREFIX_WORDS:
        margin = (dim - 32 * P) // 2
        flags = {}
        for be in (PLAIN_TILE_BACKEND, "kernel_vpu", "fused_mxu"):
            p = params._replace(backend=be, prefix_words=P, prefix_margin=margin)
            flags[be] = search._prefix_flags(db, pipe.prefix_hvs(P),
                                             qh[:, :P].contiguous(), qp, qc,
                                             thr_std, thr_open, params=p, dim=dim)
        kept = int(flags[PLAIN_TILE_BACKEND].sum())
        require(0 < kept < n_real, f"stage-A flags at prefix_words={P} keep "
                f"{kept} of {n_real} rows: the check needs a strict subset")
        for be in ("kernel_vpu", "fused_mxu"):
            require(equal(flags[be], flags[PLAIN_TILE_BACKEND]), f"stage-A flags "
                    f"at prefix_words={P} through {be}'s tile differ from the "
                    f"plain tile")
        log(f"[cascade] stage-A flags, prefix_words={P} margin={margin}, "
            f"{starts.shape[0]} blocks, exact thresholds: kernel_vpu and fused_mxu "
            f"tiles == plain tile; {kept} of {n_real} rows kept")
    del run, flags
    n = MARGIN_QUERIES
    sub = (m.hvs[:n], m.q_pmz[:n], m.q_charge[:n])
    for P in CASCADE_PREFIX_WORDS:
        margin = (dim - 32 * P) // 2
        runs = {}
        for be in (PLAIN_TILE_BACKEND, *CASCADE_TILES):
            stats = {}
            out, t, counts = counted(torch, lambda: pipe.search_encoded(
                *sub, backend=be, prefix_words=P, prefix_margin=margin,
                stats=stats))
            runs[be] = out, stats
            head = (f"[cascade] prefix_words={P} margin={margin} backend={be} on "
                    f"{n} queries in {t:.2f}s")
            if be == PLAIN_TILE_BACKEND:
                require(stats["survivors"] < n_real, f"margin-mode cascade at "
                        f"prefix_words={P} kept every row: nothing was pruned")
                log(f"{head} (plain tile): {stats_line(stats, n_real)}")
                continue
            want, want_stats = runs[PLAIN_TILE_BACKEND]
            require(outputs_equal(out, want) and stats["survivors"]
                    == want_stats["survivors"], f"margin-mode cascade at "
                    f"prefix_words={P} backend={be} differs from the plain tile")
            kernel = CASCADE_TILES[be]
            require(counts[kernel] > 0, f"cascade backend {be} launched {kernel} "
                    f"{counts[kernel]} times")
            log(f"{head}: == plain tile (6 SearchResult arrays, both FDR results, "
                f"survivor count); {stats_line(stats, n_real)}; launches "
                f"{json.dumps(counts)}")
