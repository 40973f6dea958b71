"""Phase 18: multi-device OMS, run after phase 15 (before phase 16).

18. S distinct cards where the machine has more than one (dealt
    round-robin), else S entries of the one card. ``sharded_search`` of
    phase 3's sorted batch on a ("model",) mesh at S = 2 and 4 (both pad the
    567 blocks by one), with fused and fused_mxu at top_k 1 and 16, each bit
    for bit against the resident fused search at that top_k (the padding is
    appended, so real rows keep their numbers) and launching its kernel once
    a shard; the peak device memory. Then ``from_store(resident=False,
    stream_devices=...)`` with 2 and 4 entries on phase 12's store at 2^18
    rows a slab, bit for bit against the one-device streamed result,
    StreamStats included, with its per-slab times.

``times_multi`` (warm sharded searches, one shard's search and the merge in
CUDA events, warm streamed searches over the entries) is
scripts/chip_times.py's and scripts/multi_gpu_check.py's.
"""
from __future__ import annotations

import statistics
import time

from . import common as C
from .common import counted, cuda_ms, equal, log, require
from .oms_common import FUSED_OUTS, STREAM_KERNELS, outputs_equal, slab_line, sorted_batch

SHARD_COUNTS = (2, 4)
SHARD_KS = (1, 16)
SHARD_WARM_RUNS = 5
STREAM_DEVICE_COUNTS = (2, 4)


def smoke_devices(torch, n: int) -> list:
    """``n`` device entries: distinct cards dealt round-robin where the
    machine has more than one, else ``n`` entries of the one card (bit-exact,
    but the entries run one after another)."""
    if C.DEVICE == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _resident(ctx, params0, qh, qp, qc) -> dict:
    """The resident fused search of the sorted batch at every SHARD_KS."""
    from repro_torch.core.search import _search_sorted_padded
    pipe = ctx.main().pipe
    return {k: _search_sorted_padded(pipe.db, qh, qp, qc,
                                     params=params0._replace(backend="fused", top_k=k),
                                     dim=ctx.cfg.dim) for k in SHARD_KS}


def _sharded(ctx, S: int):
    """(devices, mesh, ShardedDB) of the main path's DB over S entries."""
    from repro_torch.core.blocking import shard_reference_db
    from repro_torch.distributed import make_mesh, place_shards
    devs = smoke_devices(ctx.torch, S)
    mesh = make_mesh((S,), ("model",), devices=devs)
    return devs, mesh, place_shards(shard_reference_db(ctx.main().pipe.db, S), devs)


def multi_device(ctx) -> None:
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.distributed import sharded_search
    torch = ctx.torch
    m = ctx.main()
    pipe, cfg = m.pipe, ctx.cfg
    spipe = ctx.streamed()
    cards = torch.cuda.device_count() if C.DEVICE != "cpu" else 0
    log(f"[multi] {cards} CUDA device(s): " + (
        "shards and slab streams go to distinct cards, round-robin" if cards > 1 else
        "every shard and slab stream on the one card (bit-exact, no overlap; the "
        "launch guard across cards is not exercised)"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params0, qh, qp, qc, _ = sorted_batch(torch, pipe, *m.batch)
    resident = _resident(ctx, params0, qh, qp, qc)
    for S in SHARD_COUNTS:
        t0 = time.perf_counter()
        devs, mesh, sdb = _sharded(ctx, S)
        torch.cuda.synchronize()
        t_place = time.perf_counter() - t0
        log(f"[multi] S={S} on {[str(d) for d in devs]}: padded to {sdb.n_blocks} blocks "
            f"({sdb.n_blocks - pipe.db.n_blocks} pad), {sdb.blocks_per_shard} blocks = "
            f"{sdb.rows_per_shard} rows = {sdb.shards[0].hvs.numel() * 4 / 1e6:.1f} MB of "
            f"HVs a shard; padded and placed in {t_place:.3f}s")
        for be, kernel in STREAM_KERNELS.items():
            for k in SHARD_KS:
                params = params0._replace(backend=be, top_k=k)
                (outs, same), t_first, counts = counted(torch, lambda: sharded_search(
                    sdb, qh, qp, qc, params, dim=cfg.dim, mesh=mesh))
                require(same is sdb, "sharded_search did not take the ShardedDB as it is")
                for f, a, b in zip(FUSED_OUTS, outs, resident[k]):
                    require(equal(a, b), f"sharded {be} S={S} top_k={k}: {f} differs "
                            f"from the resident fused result")
                require(counts[kernel] == S, f"sharded {be} S={S}: {counts[kernel]} "
                        f"{kernel} launches, expected one a shard")
                path = f"sharded {be}, S={S}, top_k={k}"
                ctx.by_path[kernel][path] = counts[kernel]
                log(f"[multi] {path}: == resident fused (4 arrays, global rows) in "
                    f"{t_first:.4f}s; {kernel} launches {counts[kernel]}")
        del sdb, same, outs
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[multi] sharded search: peak memory of the current card above its "
        f"baseline {peak / 2**30:.3f} GiB (the padded DB copy, the per-shard "
        f"partials)")

    one, _, _ = counted(torch, lambda: spipe.search_encoded(*m.batch))
    one_stats = spipe.engine.last_stats
    slab_rows = spipe.engine.plan.slab_rows
    for n in STREAM_DEVICE_COUNTS:
        devs = smoke_devices(torch, n)
        mpipe = OMSPipeline.from_store(ctx.store_dir, cfg, resident=False,
                                       slab_rows=slab_rows, stream_devices=devs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mbase = torch.cuda.memory_allocated()
        stats = {}
        res, t_first, counts = counted(torch, lambda: mpipe.search_encoded(
            *m.batch, stats=stats))
        st = mpipe.engine.last_stats
        require(outputs_equal(res, one), f"streamed over {n} device entries differs "
                f"from the one-device streamed result")
        require(st == one_stats, f"streamed over {n} device entries: StreamStats {st} "
                f"!= one device's {one_stats}")
        require(counts["fused_search"] == st.n_scanned > 0, f"streamed over {n} "
                f"entries: {counts['fused_search']} fused launches for "
                f"{st.n_scanned} slabs")
        peak = torch.cuda.max_memory_allocated() - mbase
        ctx.by_path["fused_search"][f"streamed fused over {n} device entries"] = (
            counts["fused_search"])
        log(f"[multi] streamed fused over {n} entries {[str(d) for d in devs]}, "
            f"{slab_rows} rows a slab: == one-device streamed (6 arrays, both FDRs, "
            f"StreamStats {tuple(st)}) in {t_first:.3f}s; {slab_line(stats)}; peak "
            f"memory of the current card above its baseline {peak / 2**30:.3f} GiB; "
            f"fused_search launches {counts['fused_search']}")
        del mpipe


def times_multi(ctx) -> dict:
    """Warm sharded searches (median of SHARD_WARM_RUNS), one shard's search
    and the merge in CUDA events, and a warm streamed search over the
    device entries."""
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.core.search import _search_sorted_padded
    from repro_torch.distributed import sharded_search
    from repro_torch.distributed.collectives import _merge_best
    torch = ctx.torch
    m = ctx.main()
    pipe, cfg = m.pipe, ctx.cfg
    params0, qh, qp, qc, _ = sorted_batch(torch, pipe, *m.batch)
    out = {}
    for k in SHARD_KS:
        params = params0._replace(backend="fused", top_k=k)
        _search_sorted_padded(pipe.db, qh, qp, qc, params=params, dim=cfg.dim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _search_sorted_padded(pipe.db, qh, qp, qc, params=params, dim=cfg.dim)
        torch.cuda.synchronize()
        out[f"resident fused top_k={k}"] = time.perf_counter() - t0
        log(f"[multi] resident fused top_k={k}: warm {out[f'resident fused top_k={k}']:.4f}s "
            f"({pipe.db.n_blocks} blocks, k_blocks {params.k_blocks})")
    for S in SHARD_COUNTS:
        devs, mesh, sdb = _sharded(ctx, S)
        for be in STREAM_KERNELS:
            for k in SHARD_KS:
                params = params0._replace(backend=be, top_k=k)
                sharded_search(sdb, qh, qp, qc, params, dim=cfg.dim, mesh=mesh)
                t_warm = statistics.median(counted(torch, lambda: sharded_search(
                    sdb, qh, qp, qc, params, dim=cfg.dim, mesh=mesh))[1]
                    for _ in range(SHARD_WARM_RUNS))
                local = params._replace(k_blocks=min(params.k_blocks, sdb.blocks_per_shard))
                parts = [_search_sorted_padded(sh, *(x.to(sh.device) for x in (qh, qp, qc)),
                                               params=local, dim=cfg.dim)
                         for sh in sdb.shards]
                shard_ms = cuda_ms(lambda: _search_sorted_padded(
                    sdb.shards[0], qh, qp, qc, params=local, dim=cfg.dim), iters=5)
                merge_ms = cuda_ms(lambda: [_merge_best([p[i] for p in parts],
                                                        [p[i + 1] for p in parts], k,
                                                        devs[0]) for i in (0, 2)])
                path = f"sharded {be}, S={S}, top_k={k}"
                out[path] = {"warm_s": t_warm, "shard_ms": shard_ms, "merge_ms": merge_ms}
                log(f"[multi] {path}: warm {t_warm:.4f}s (median of {SHARD_WARM_RUNS}); "
                    f"one shard's search {shard_ms:.3f} ms, merge (2 x _merge_best over "
                    f"{S} x {k}) {merge_ms:.3f} ms (CUDA events)")
                del parts
        del sdb
    slab_rows = ctx.streamed().engine.plan.slab_rows
    for n in STREAM_DEVICE_COUNTS:
        devs = smoke_devices(torch, n)
        mpipe = OMSPipeline.from_store(ctx.store_dir, cfg, resident=False,
                                       slab_rows=slab_rows, stream_devices=devs)
        mpipe.search_encoded(*m.batch)
        torch.cuda.synchronize()
        stats = {}
        t0 = time.perf_counter()
        mpipe.search_encoded(*m.batch, stats=stats)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        out[f"streamed fused over {n} entries"] = t_warm
        log(f"[multi] streamed fused over {n} entries {[str(d) for d in devs]}, "
            f"{slab_rows} rows a slab, warm: {t_warm:.3f}s; {slab_line(stats)}")
        del mpipe
    return out
