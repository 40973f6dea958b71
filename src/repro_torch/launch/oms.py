"""OMS serving launcher — the paper's end-to-end flow as a service.

Counterpart of ``repro.launch.oms``: the same subcommands, flags, printed
lines and JSON-lines schema, on the card unless ``--device cpu``.

Entry points:

  * ``build``   — ingest: encode a reference library chunk-by-chunk into a
    persistent sharded LibraryStore (the near-storage step, paid once);
  * ``search``  — serve (batch): cold-start from the store (packed HVs
    only, zero reference re-encoding) and run batched query searches;
  * ``serve``   — serve (online): JSON-lines request loop on stdio with a
    micro-batching scheduler; by default the library is NOT device-resident
    — the streaming engine scans the store one bounded slab at a time;
  * ``queries`` — emit a synthetic query workload as JSON-lines (pipes into
    ``serve``);
  * ``trace-report`` — load a trace written by ``serve --trace`` (Chrome
    ``trace_event`` JSON or JSON-lines), validate it against the export
    schema, and print the per-stage rollup table (count, total wall time,
    share, deterministic p50/p95/p99, summed rows/bytes);
  * ``tune``    — per-device launch-parameter sweep: benchmark the tunable
    backends' run-time parameters (the fused kernels' split count, the
    tile kernels' grid, the rescore bucket floor), print the winner table
    and persist the winners to a JSON cache that ``search``/``serve``
    load via ``--tune-cache`` (or the ``REPRO_TUNE_CACHE`` env var);
    every value gives bit-identical results, only the time differs;
  * ``analyze`` — contract analysis: run every hot-path combination once
    at smoke shapes under the op recorder and check the declared
    contracts (``--imports`` adds the import-graph check); exits nonzero
    on any violation.
  * legacy one-shot (no subcommand): in-memory ingest + search.

    PYTHONPATH=src python -m repro_torch.launch.oms build --store /tmp/oms \\
        --refs 8192 [--dim 4096] [--append] [--encode-backend pallas]
    PYTHONPATH=src python -m repro_torch.launch.oms search --store /tmp/oms \\
        --queries 512 [--backend fused] [--top-k 4] [--encode-backend fused]
    PYTHONPATH=src python -m repro_torch.launch.oms queries --refs 8192 \\
        --queries 512 | PYTHONPATH=src python -m repro_torch.launch.oms \\
        serve --store /tmp/oms [--slab-rows 262144] [--resident] > out.jsonl
    PYTHONPATH=src python -m repro_torch.launch.oms --refs 8192 --queries 512 \\
        [--backend vpu|mxu|kernel_vpu|kernel_mxu|fused|fused_mxu|fused_xla]

``build``, ``search``, ``serve``, ``tune``, ``analyze`` and the one-shot
form take ``--device`` (default ``cuda``, which raises without a GPU;
``cpu`` runs the kernels' plain PyTorch versions), the port's counterpart
of ``JAX_PLATFORMS``.

``search``, ``serve`` and the legacy one-shot accept ``--cascade``
(``--narrow-tol-da``, ``--no-stage1``): stage 1 is a narrow-window scan that
identifies unmodified spectra at the configured FDR, and only the
fall-through queries pay for the open scan. ``--cascade --no-stage1`` is
byte-identical to the plain search.

``serve`` requests are one JSON object per line:
``{"id": ..., "pmz": f, "charge": i, "mz": [...], "intensity": [...]}``
(optional: ``"deadline_ms"``, ``"tenant"`` — per-request SLO overrides of
the ``--deadline-ms``/``--tenant`` defaults); responses echo the id with
the dual-window top-k matches. Responses are bit-identical between
``--resident`` and streaming runs, independent of micro-batch composition
(``--cascade`` gates stage 1 per query), and byte-identical to the
reference launcher's for the same store and requests.

``serve`` production knobs: ``--deadline-ms`` sheds requests the queue
cannot meet (fast-fail with an error response), ``--tenant`` names the
traffic source for round-robin fair batching, ``--result-cache``/
``--no-result-cache`` controls the HV-keyed LRU response cache
(byte-identical hits by construction), and ``--hot-reload S`` polls the
store manifest every S seconds and re-plans the slab layout over appended
shards without dropping a single in-flight query.

Every search of ``serve`` runs on the micro-batcher's worker thread, so on
the card its launches, the streaming engine's copy stream and events and
the first call's kernel-library load all happen on that thread.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import backends, encode_backends
from repro_torch.core.blocking import candidate_block_stats
from repro_torch.core.pipeline import OMSConfig, OMSPipeline
from repro_torch.data.spectra import LibraryConfig, make_dataset

def _dataset_args(ap, refs_default=8192):
    ap.add_argument("--refs", type=int, default=refs_default)
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic dataset seed (codebook seed is cfg.seed)")


def _encoding_args(ap):
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--n-levels", type=int, default=32)
    _dataset_args(ap)


def _device_args(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (the port's counterpart of "
                         "JAX_PLATFORMS); 'cuda' raises without a GPU, "
                         "'cpu' runs the kernels' plain versions")


def _encode_backend_args(ap):
    """Encoder hot-path knobs — on build (ingest encode) AND search (query
    encode); all encode backends are bit-identical, only speed/memory differ."""
    ap.add_argument("--encode-backend", default="word_tiled",
                    choices=encode_backends.names(),
                    help="'word_tiled' bounds the unpacked intermediate; "
                         "'pallas' is the hdencode CUDA kernel; 'fused' runs "
                         "preprocess+encode in one pass")
    ap.add_argument("--encode-batch", type=int, default=512,
                    help="spectra per encode chunk (memory bound)")


def _serving_args(ap):
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--max-r", type=int, default=1024)
    ap.add_argument("--q-block", type=int, default=16)
    ap.add_argument("--open-tol", type=float, default=75.0)
    ap.add_argument("--backend", default="vpu", choices=backends.names(),
                    help="matrix backends reduce outside the kernel; "
                         "'fused' is the single-pass §II-C CUDA kernel")
    ap.add_argument("--top-k", type=int, default=1,
                    help="ranked winners kept per query and window")
    ap.add_argument("--exhaustive", action="store_true",
                    help="HyperOMS-style full scan (baseline)")
    _prefix_args(ap)


def _tune_args(ap):
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="launch-parameter winner cache JSON written by "
                         "`oms.py tune`; tuned values override the kernel "
                         "defaults at dispatch (env REPRO_TUNE_CACHE works "
                         "too)")


def _apply_tune_cache(args) -> None:
    if getattr(args, "tune_cache", None):
        from repro_torch import tune
        tune.set_cache_path(args.tune_cache)


def _tune_stats_line(tag: str) -> None:
    """One stderr line on whether a configured tune cache was picked up."""
    from repro_torch import tune
    st = tune.cache_stats()
    if st["path"] is None:
        return
    print(f"[{tag}] tune-cache {st['path']}: {st['entries']} entries, "
          f"{st['hits']} hits / {st['misses']} misses at dispatch",
          file=sys.stderr, flush=True)


def _prefix_args(ap):
    """Dimension-cascade knobs (search/oneshot/serve): prefix-word prune at
    low Dhv, exact full-width rescore of the survivors."""
    ap.add_argument("--prefix-words", type=int, default=0,
                    help="stage-A packed words per candidate (0 = full-width "
                         "scan); with the default exact margin the results "
                         "stay bit-identical to the full scan")
    ap.add_argument("--prefix-margin", type=int, default=-1,
                    help="survivor slack in bits; -1 keeps the exact "
                         "lower-bound margin (dim - 32*prefix_words), "
                         "smaller values prune harder but may drop matches")
    ap.add_argument("--prefix-seed-da", type=float, default=1.0,
                    help="precursor window (Da) of the exact seed pass that "
                         "bootstraps the per-query pruning thresholds")


def _cascade_args(ap):
    """Cascaded narrow→open identification knobs (search/oneshot/serve)."""
    ap.add_argument("--cascade", action="store_true",
                    help="two-stage cascade: a narrow-window pass identifies "
                         "unmodified spectra first; only the fall-through "
                         "queries pay for the open scan")
    ap.add_argument("--narrow-tol-da", type=float, default=1.0,
                    help="stage-1 open window (Da) — also the shift-grouped "
                         "FDR subgroup boundary")
    ap.add_argument("--no-stage1", action="store_true",
                    help="run the cascade path with stage 1 disabled (pure "
                         "open search — bit-identical to a plain search)")


def _dataset(args):
    return make_dataset(LibraryConfig(n_refs=args.refs,
                                      n_queries=getattr(args, "queries", 1),
                                      open_tol_da=getattr(args, "open_tol", 75.0),
                                      seed=args.seed))


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the host clock then includes it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(pipe: OMSPipeline, ds, args) -> None:
    """Encode the query batch ONCE; search and block stats reuse it."""
    t0 = time.perf_counter()
    hvs, q_pmz, q_charge = pipe.encode_queries(ds.queries)
    _sync(pipe.device)
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    cascade = getattr(args, "cascade", False)
    if cascade:
        out = pipe.search_cascade_encoded(
            hvs, q_pmz, q_charge, narrow_tol_da=args.narrow_tol_da,
            run_stage1=not args.no_stage1, exhaustive=args.exhaustive)
    else:
        out = pipe.search_encoded(hvs, q_pmz, q_charge,
                                  exhaustive=args.exhaustive)
    _sync(pipe.device)
    t_search = time.perf_counter() - t0
    t_total = t_encode + t_search

    src = np.asarray(ds.query_source)
    open_idx = out.result.open_idx.cpu().numpy()   # (Q, top_k)
    std_idx = out.result.std_idx.cpu().numpy()
    mod = np.asarray(ds.query_modified)
    stats = candidate_block_stats(pipe.db, q_pmz, q_charge, args.open_tol)

    cfg = pipe.cfg
    print(f"[oms] searched {args.queries} queries in {t_total:.2f}s "
          f"({args.queries / t_total:.0f} q/s, backend={cfg.backend}, "
          f"top_k={cfg.top_k}, "
          f"{'exhaustive' if args.exhaustive else 'blocked'})")
    print(f"[oms] stage split: encode {t_encode:.2f}s "
          f"({args.queries / t_encode:.0f} sp/s, "
          f"encode_backend={cfg.encode_backend}) | search {t_search:.2f}s "
          f"({100 * t_encode / t_total:.0f}% / {100 * t_search / t_total:.0f}%)")
    print(f"[oms] comparisons reduction at +/-{args.open_tol} Da: "
          f"{stats['reduction']:.2f}x vs exhaustive")
    if cascade:
        pure = pipe.pure_open_scanned_rows(args.queries, q_pmz, q_charge,
                                           exhaustive=args.exhaustive)
        n_id = int(out.identified_stage1.sum())
        s1 = out.stage1.scanned_rows if out.stage1 else 0
        s2 = out.stage2.scanned_rows if out.stage2 else 0
        print(f"[oms] cascade: stage1 identified {n_id}/{args.queries} "
              f"({'off' if args.no_stage1 else f'{args.narrow_tol_da} Da'}); "
              f"scanned rows {s1}+{s2}={out.scanned_rows_total} "
              f"vs pure-open {pure} "
              f"({out.scanned_rows_total / max(pure, 1):.2f}x)")
    print(f"[oms] open-search recall@1:     {np.mean(open_idx[:, 0] == src):.3f} "
          f"(modified queries: {np.mean((open_idx[:, 0] == src)[mod]):.3f})")
    print(f"[oms] standard-search recall@1: {np.mean(std_idx[:, 0] == src):.3f} "
          f"(modified queries: {np.mean((std_idx[:, 0] == src)[mod]):.3f})")
    if cfg.top_k > 1:
        hit_any = (open_idx == src[:, None]).any(axis=1)
        print(f"[oms] open-search recall@{cfg.top_k}:     "
              f"{hit_any.mean():.3f} (modified: {hit_any[mod].mean():.3f})")
    print(f"[oms] identifications @ {cfg.fdr_threshold:.0%} FDR: "
          f"{int(out.open_fdr.n_accepted)} / {args.queries * cfg.top_k}")


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------


def cmd_build(argv) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms build")
    ap.add_argument("--store", required=True, help="store directory")
    ap.add_argument("--chunk-rows", type=int, default=4096)
    ap.add_argument("--append", action="store_true",
                    help="grow an existing store (new shards only)")
    _encoding_args(ap)
    _encode_backend_args(ap)
    _device_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = OMSConfig(dim=args.dim, n_levels=args.n_levels,
                    encode_backend=args.encode_backend,
                    encode_batch=args.encode_batch)
    ds = _dataset(args)
    t0 = time.perf_counter()
    store = OMSPipeline.ingest(cfg, ds.refs, args.store, device=device,
                               chunk_rows=args.chunk_rows, append=args.append)
    t = time.perf_counter() - t0
    print(f"[oms build] {'appended to' if args.append else 'wrote'} "
          f"{args.store}: {store.n_rows} rows "
          f"({store.n_targets} targets, {len(store.shards)} shards, "
          f"{store.nbytes() / 2**20:.1f} MiB) in {t:.2f}s")


def cmd_search(argv) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms search")
    ap.add_argument("--store", required=True, help="store directory")
    # --refs/--seed regenerate the synthetic queries (and their ground
    # truth); --refs defaults to the store's own target count so a plain
    # `search --store S` matches the `build` that produced S.
    _dataset_args(ap, refs_default=None)
    _serving_args(ap)
    _cascade_args(ap)
    _encode_backend_args(ap)
    _tune_args(ap)
    _device_args(ap)
    args = ap.parse_args(argv)
    _apply_tune_cache(args)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    pipe = OMSPipeline.from_store(
        args.store, device=device, max_r=args.max_r, q_block=args.q_block,
        open_tol_da=args.open_tol, backend=args.backend, top_k=args.top_k,
        encode_backend=args.encode_backend, encode_batch=args.encode_batch,
        prefix_words=args.prefix_words, prefix_margin=args.prefix_margin,
        prefix_seed_da=args.prefix_seed_da)
    _sync(device)
    t_load = time.perf_counter() - t0
    print(f"[oms search] cold-started {pipe.db.n_rows} rows "
          f"({pipe.db.n_blocks} blocks of {pipe.cfg.max_r}) from {args.store} "
          f"in {t_load:.2f}s — no reference re-encoding")

    if args.refs is None:
        args.refs = pipe.n_targets
    ds = _dataset(args)
    _serve(pipe, ds, args)
    _tune_stats_line("oms search")


def cmd_queries(argv) -> None:
    """Emit a synthetic query workload as JSON-lines (pipes into `serve`)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms queries")
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--open-tol", type=float, default=75.0)
    _dataset_args(ap)
    args = ap.parse_args(argv)

    qs = _dataset(args).queries
    mz = np.asarray(qs.mz)
    inten = np.asarray(qs.intensity)
    pmz = np.asarray(qs.pmz)
    charge = np.asarray(qs.charge)
    for i in range(mz.shape[0]):
        keep = inten[i] > 0          # drop padding; encode is peak-set based
        sys.stdout.write(json.dumps(
            {"id": i, "pmz": float(pmz[i]), "charge": int(charge[i]),
             "mz": [float(v) for v in mz[i][keep]],
             "intensity": [float(v) for v in inten[i][keep]]},
            sort_keys=True, separators=(",", ":")) + "\n")


def cmd_serve(argv) -> None:
    """Online JSON-lines serve loop: micro-batched, streamed by default."""
    from repro_torch.obs import trace as trace_mod
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import MicroBatcher, QuerySpec, ResultCache
    from repro_torch.store import LibraryStore

    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms serve")
    ap.add_argument("--store", required=True, help="store directory")
    ap.add_argument("--max-r", type=int, default=1024)
    ap.add_argument("--q-block", type=int, default=16)
    ap.add_argument("--open-tol", type=float, default=75.0)
    ap.add_argument("--backend", default="vpu", choices=backends.names())
    ap.add_argument("--top-k", type=int, default=1)
    ap.add_argument("--resident", action="store_true",
                    help="pin the whole library on device (legacy path) "
                         "instead of streaming bounded slabs")
    ap.add_argument("--slab-rows", type=int, default=1 << 18,
                    help="rows per streamed device slab (the device-memory "
                         "bound; rounded up to whole blocks)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="micro-batch coalescing cap (queries per scan)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="max wait after the first queued query before the "
                         "coalesced batch is scanned")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record host-side stage spans and write them here "
                         "on exit; '.json' suffix -> Chrome/Perfetto "
                         "trace_event format, anything else -> JSON-lines "
                         "(inspect either with `oms trace-report`)")
    ap.add_argument("--heartbeat-s", type=float, default=0.0,
                    help="if > 0, print a one-line serve heartbeat to "
                         "stderr every this many seconds (answered count, "
                         "queue depth, wait/e2e percentiles)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the final metrics snapshot JSON here "
                         "('-' for stderr)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="default per-request latency budget; requests the "
                         "queue cannot meet are shed with an error response "
                         "(0 = no deadline; per-request 'deadline_ms' "
                         "overrides)")
    ap.add_argument("--tenant", default="default",
                    help="default tenant label for fair round-robin "
                         "batching (per-request 'tenant' overrides)")
    ap.add_argument("--result-cache", type=int, default=4096, metavar="N",
                    help="HV-keyed LRU result cache capacity (entries); "
                         "hits are byte-identical to recomputation")
    ap.add_argument("--no-result-cache", action="store_true",
                    help="bypass the result cache (the byte-identity "
                         "reference)")
    ap.add_argument("--hot-reload", type=float, default=0.0, metavar="S",
                    help="if > 0, poll the store manifest every S seconds "
                         "and pick up appended shards without a restart "
                         "(streaming mode only); in-flight queries are "
                         "never dropped")
    _prefix_args(ap)
    _cascade_args(ap)
    _encode_backend_args(ap)
    _tune_args(ap)
    _device_args(ap)
    args = ap.parse_args(argv)
    _apply_tune_cache(args)
    if args.cascade and not args.no_stage1 \
            and not args.narrow_tol_da < args.open_tol:
        ap.error(f"--narrow-tol-da {args.narrow_tol_da} must be < --open-tol "
                 f"{args.open_tol} (fail now, not per micro-batch)")
    if args.hot_reload > 0 and args.resident:
        ap.error("--hot-reload needs the streaming path (drop --resident): "
                 "a device-resident DB cannot grow in place")
    if args.result_cache < 1:
        ap.error(f"--result-cache must be >= 1, got {args.result_cache}")
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    pipe = OMSPipeline.from_store(
        args.store, device=device, max_r=args.max_r, q_block=args.q_block,
        open_tol_da=args.open_tol, backend=args.backend, top_k=args.top_k,
        encode_backend=args.encode_backend, encode_batch=args.encode_batch,
        resident=args.resident, slab_rows=args.slab_rows,
        prefix_words=args.prefix_words, prefix_margin=args.prefix_margin,
        prefix_seed_da=args.prefix_seed_da)
    _sync(device)
    t_load = time.perf_counter() - t0
    if args.resident:
        mode = "resident"
    else:
        plan = pipe.engine.plan
        mode = (f"streaming {plan.n_slabs} slabs x {plan.slab_rows} rows "
                f"({plan.slab_blocks} blocks)")
    if args.cascade:
        mode += (", cascade off-stage1" if args.no_stage1 else
                 f", cascade narrow={args.narrow_tol_da} Da")
    if args.prefix_words:
        mode += (f", prefix {args.prefix_words} words"
                 + ("" if args.prefix_margin < 0
                    else f" (margin {args.prefix_margin})"))
    if args.no_result_cache:
        mode += ", cache off"
    else:
        mode += f", cache {args.result_cache}"
    if args.deadline_ms > 0:
        mode += f", deadline {args.deadline_ms}ms"
    if args.hot_reload > 0:
        mode += f", hot-reload {args.hot_reload}s"
    print(f"[oms serve] cold-started {args.store} in {t_load:.2f}s — {mode}; "
          f"backend={args.backend} top_k={args.top_k} "
          f"max_batch={args.max_batch} max_wait={args.max_wait_ms}ms",
          file=sys.stderr, flush=True)

    reg = Metrics()
    cache = (None if args.no_result_cache
             else ResultCache(args.result_cache, metrics=reg))
    reloads = reg.counter("hot_reloads")
    # Everything that could change an answer goes into the cache key token;
    # the cache is also cleared outright on hot-reload (new library).
    cache_token = json.dumps(
        {"backend": args.backend, "top_k": args.top_k,
         "open_tol": args.open_tol, "max_r": args.max_r,
         "q_block": args.q_block, "slab": args.slab_rows,
         "prefix": [args.prefix_words, args.prefix_margin,
                    args.prefix_seed_da],
         "cascade": [args.cascade, args.no_stage1, args.narrow_tol_da]},
        sort_keys=True)

    reload_pending = threading.Event()
    watch_stop = threading.Event()

    def watch_manifest():
        seen = LibraryStore.manifest_token(args.store)
        while not watch_stop.wait(args.hot_reload):
            try:
                tok = LibraryStore.manifest_token(args.store)
            except OSError:
                continue            # mid-commit rename; next poll sees it
            if tok != seen:
                seen = tok
                reload_pending.set()

    def maybe_reload():
        # Runs on the batcher worker thread BETWEEN scans, so a swap never
        # splits a batch: layout, slab plan, sidecars, and cache generation
        # all change together while zero queries are in the slab loop. The
        # engine's slab buffers are keyed by slab shape and returned only
        # when a scan has settled, so no scan of the old plan shares them.
        if not reload_pending.is_set():
            return
        reload_pending.clear()
        pipe.reload_store(args.store)
        if cache is not None:
            cache.clear()
        reloads.inc()
        eng = pipe.engine
        print(f"[oms serve] hot-reload: re-planned "
              f"{eng.plan.n_slabs} slabs over {eng.layout.n_rows} rows",
              file=sys.stderr, flush=True)

    def payloads_of(result, n):
        r = result
        std_i = r.std_idx.cpu().numpy(); std_s = r.std_sim.cpu().numpy()
        opn_i = r.open_idx.cpu().numpy(); opn_s = r.open_sim.cpu().numpy()
        return [
            {"std": {"idx": std_i[i].tolist(), "sim": std_s[i].tolist()},
             "open": {"idx": opn_i[i].tolist(), "sim": opn_s[i].tolist()}}
            for i in range(n)
        ]

    def search_subset(hvs, q_pmz, q_charge, sel):
        # A search restricted to a query subset is bit-identical per query
        # (the coalescing-independence contract), so cache misses can be
        # scanned alone without changing any response byte. Cascade serving
        # gates stage 1 PER QUERY for the same reason — batch composition
        # must never leak into an answer.
        sel_t = torch.from_numpy(sel.astype(np.int64)).to(hvs.device)
        hv_s, qp_s, qc_s = hvs[sel_t], q_pmz[sel_t], q_charge[sel_t]
        if args.cascade:
            out = pipe.search_cascade_encoded(
                hv_s, qp_s, qc_s, narrow_tol_da=args.narrow_tol_da,
                run_stage1=not args.no_stage1, stage1_per_query=True)
        else:
            out = pipe.search_encoded(hv_s, qp_s, qc_s)
        return payloads_of(out.result, len(sel))

    def run_batch(spectra):
        maybe_reload()
        hvs, q_pmz, q_charge = pipe.encode_queries(spectra)
        B = int(q_pmz.shape[0])
        if cache is None:
            return search_subset(hvs, q_pmz, q_charge,
                                 np.arange(B, dtype=np.int32))
        hv_np = hvs.cpu().numpy()
        qp_np = q_pmz.cpu().numpy()
        qc_np = q_charge.cpu().numpy()
        keys = [ResultCache.key(hv_np[i], qp_np[i], int(qc_np[i]),
                                cache_token) for i in range(B)]
        payloads = [cache.get(k) for k in keys]
        miss = np.asarray([i for i, p in enumerate(payloads) if p is None],
                          np.int32)
        if miss.size:
            fresh = search_subset(hvs, q_pmz, q_charge, miss)
            for j, i in enumerate(miss):
                payloads[i] = fresh[j]
                cache.put(keys[i], fresh[j])
        return payloads

    def emit(rid, fut):
        # One bad request (or a poisoned micro-batch) answers with an error
        # object; the serve loop itself must stay up for everyone else.
        try:
            payload = fut.result()
        except Exception as e:
            payload = {"error": f"{type(e).__name__}: {e}"}
        sys.stdout.write(json.dumps({"id": rid, **payload}, sort_keys=True,
                                    separators=(",", ":")) + "\n")
        sys.stdout.flush()
        state["answered"] += 1

    tracer = None
    if args.trace:
        tracer = trace_mod.install(trace_mod.Tracer())

    pending: deque = deque()
    n = 0
    n_bad = 0
    t0 = time.perf_counter()
    state = {"answered": 0}
    hb_stop = threading.Event()

    def heartbeat():
        while not hb_stop.wait(args.heartbeat_s):
            qw, e2e = batcher.queue_wait, batcher.e2e_latency
            print(f"[oms serve] hb answered={state['answered']} "
                  f"batches={batcher.n_batches} "
                  f"depth={int(batcher.queue_depth.value)} "
                  f"wait_p50={qw.p50 * 1e3:.2f}ms "
                  f"e2e_p99={e2e.p99 * 1e3:.2f}ms",
                  file=sys.stderr, flush=True)

    try:
        with MicroBatcher(run_batch, max_batch=args.max_batch,
                          max_wait_s=args.max_wait_ms / 1e3,
                          metrics=reg) as batcher:
            if args.heartbeat_s > 0:
                threading.Thread(target=heartbeat, name="oms-heartbeat",
                                 daemon=True).start()
            if args.hot_reload > 0:
                threading.Thread(target=watch_manifest, name="oms-hot-reload",
                                 daemon=True).start()
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                rid = None
                try:
                    req = json.loads(line)
                    rid = req.get("id")
                    spec = QuerySpec(mz=np.asarray(req["mz"], np.float32),
                                     intensity=np.asarray(req["intensity"],
                                                          np.float32),
                                     pmz=float(req["pmz"]),
                                     charge=int(req["charge"]))
                    ddl_ms = float(req.get("deadline_ms", args.deadline_ms))
                    fut = batcher.submit(
                        spec,
                        deadline_s=ddl_ms / 1e3 if ddl_ms > 0 else None,
                        tenant=str(req.get("tenant", args.tenant)))
                except Exception as e:      # malformed line: answer, don't die
                    n_bad += 1
                    fut = Future()
                    fut.set_exception(e)
                pending.append((rid, fut))
                n += 1
                while pending and pending[0][1].done():  # stream out, in order
                    emit(*pending.popleft())
            while pending:
                emit(*pending.popleft())
            dt = time.perf_counter() - t0
            hb_stop.set()
            watch_stop.set()
            qw, e2e = batcher.queue_wait, batcher.e2e_latency
            stats = (f", {batcher.n_queries / max(batcher.n_batches, 1):.1f} "
                     f"q/batch (depth max {int(batcher.queue_depth.max)}), "
                     f"wait p50/p99 {qw.p50 * 1e3:.2f}/{qw.p99 * 1e3:.2f}ms, "
                     f"e2e p50/p99 {e2e.p50 * 1e3:.2f}/{e2e.p99 * 1e3:.2f}ms")
            if pipe.engine is not None and pipe.engine.total_stats.n_scans:
                ts = pipe.engine.total_stats
                stats += (f", {ts.n_scans} scans over {ts.slabs_scanned} slabs "
                          f"({ts.scanned_rows} row-reads, "
                          f"{ts.scanned_bytes / 2**20:.2f} MiB)")
            if cache is not None:
                stats += (f", cache {cache.hits.value}/"
                          f"{cache.hits.value + cache.misses.value} hits")
            n_shed = batcher.shed_admit.value + batcher.shed_expired.value
            if n_shed:
                stats += (f", shed {n_shed} "
                          f"({batcher.shed_admit.value} admit / "
                          f"{batcher.shed_expired.value} expired)")
            if reloads.value:
                stats += f", {reloads.value} hot-reloads"
            bad = f", {n_bad} malformed rejected" if n_bad else ""
            print(f"[oms serve] answered {n} queries in {dt:.2f}s "
                  f"({n / max(dt, 1e-9):.0f} q/s, {batcher.n_batches} "
                  f"micro-batches{stats}{bad})", file=sys.stderr)
            if args.metrics:
                snap = json.dumps(batcher.metrics.snapshot(), sort_keys=True)
                if args.metrics == "-":
                    print(f"[oms serve] metrics {snap}", file=sys.stderr)
                else:
                    with open(args.metrics, "w") as f:
                        f.write(snap + "\n")
    finally:                    # also on an error: no thread or tracer leaks
        hb_stop.set()
        watch_stop.set()
        if tracer is not None:
            trace_mod.uninstall()
    if tracer is not None:
        if args.trace.endswith(".json"):
            n_ev = tracer.to_chrome(args.trace)
        else:
            n_ev = tracer.to_jsonl(args.trace)
        dropped = (f" ({tracer.n_dropped} evicted by the ring buffer)"
                   if tracer.n_dropped else "")
        print(f"[oms serve] trace: {n_ev} spans -> {args.trace}{dropped}",
              file=sys.stderr)
    _tune_stats_line("oms serve")


def cmd_trace_report(argv) -> None:
    """Validate a serve trace against the export schema and print the
    per-stage rollup table (the encode/scan/merge stage split)."""
    from repro_torch.obs import report as report_mod

    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms trace-report")
    ap.add_argument("trace", help="trace file from `serve --trace` "
                                  "(Chrome .json or .jsonl)")
    ap.add_argument("--json", action="store_true",
                    help="dump the rollup as JSON instead of the table")
    args = ap.parse_args(argv)

    try:
        events = report_mod.load_trace(args.trace)
    except (OSError, report_mod.TraceFormatError) as e:
        print(f"[trace-report] invalid trace: {e}", file=sys.stderr)
        raise SystemExit(1)
    roll = report_mod.rollup(events)
    if args.json:
        json.dump(roll, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(report_mod.format_table(roll))
    print(f"[trace-report] {len(events)} spans across {len(roll)} stages "
          f"in {args.trace}", file=sys.stderr)


def cmd_analyze(argv) -> None:
    """Contract analysis: record every hot-path combination at smoke shapes,
    check every declared contract, exit nonzero on violation."""
    from repro_torch.analysis import imports as imports_mod
    from repro_torch.analysis import runner as runner_mod

    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms analyze")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full JSON report here ('-' for stdout)")
    ap.add_argument("--imports", action="store_true",
                    help="also run the import-graph check (cycle-free "
                         "package, dependency-free leaf modules)")
    ap.add_argument("--imports-only", action="store_true",
                    help="run ONLY the import-graph check (fast, runs "
                         "nothing on the device)")
    ap.add_argument("--no-recompile", action="store_true",
                    help="skip the runtime recompile_guard pass (faster)")
    _device_args(ap)
    args = ap.parse_args(argv)

    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    report: dict = {}
    ok = True

    if args.imports or args.imports_only:
        imp = imports_mod.check_imports(src_root, "repro_torch")
        report["imports"] = imp
        ok = ok and imp["ok"]
        status = "OK" if imp["ok"] else "FAIL"
        print(f"[analyze] imports: {imp['modules']} modules, "
              f"{imp['edges']} edges — {status}")
        for cyc in imp["cycles"]:
            print(f"  FAIL import cycle: {' -> '.join(cyc)}")
        for leaf, deps in imp["leaf_violations"].items():
            print(f"  FAIL leaf module {leaf} imports: {', '.join(deps)}")

    if not args.imports_only:
        contracts_report = runner_mod.run(
            with_recompile=not args.no_recompile,
            device=resolve_device(args.device))
        report["contracts"] = contracts_report
        ok = ok and contracts_report["ok"]
        print(runner_mod.summarize(contracts_report))

    if args.json == "-":
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"[analyze] report written to {args.json}")

    if not ok:
        raise SystemExit(1)


def cmd_tune(argv) -> None:
    """Per-device launch-parameter sweep: time every candidate of the
    tunable backends at the given shapes, print the winner table, persist
    winners to the JSON cache that dispatch loads."""
    import subprocess

    from repro_torch import tune
    from repro_torch.tune import sweep

    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms tune")
    ap.add_argument("--dim", type=int, default=4096, help="HV width (bits)")
    ap.add_argument("--top-k", type=int, default=1,
                    help="static k the fused kernels are swept at")
    ap.add_argument("--q", type=int, default=16,
                    help="query rows per hot call (q_block-sized)")
    ap.add_argument("--rows", type=int, default=1024,
                    help="reference rows per hot call (scanned rows of a "
                         "query block / rescore candidates)")
    ap.add_argument("--backends", default=",".join(tune.SWEPT_BACKENDS),
                    help="comma-separated subset of: "
                         + ", ".join(tune.SWEPT_BACKENDS))
    ap.add_argument("--grid", default="default", choices=sorted(sweep.GRIDS),
                    help="'tiny' is the test grid")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed repeats per candidate (median kept)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="winner cache JSON to merge into (default: "
                         "$REPRO_TUNE_CACHE or ./tune_cache.json)")
    ap.add_argument("--table", default=None, metavar="PATH",
                    help="also write the winner table here")
    ap.add_argument("--full-table", action="store_true",
                    help="print every swept candidate, not just the winners")
    _device_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    swept = [b.strip() for b in args.backends.split(",") if b.strip()]
    for be in swept:
        if be not in tune.SWEPT_BACKENDS:
            ap.error(f"unknown backend {be!r}; tunable: "
                     + ", ".join(tune.SWEPT_BACKENDS))
    cache_path = args.cache or tune.cache_path() or "tune_cache.json"
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except Exception:
        rev = ""

    t0 = time.perf_counter()
    results = sweep.run_sweeps(swept, dim=args.dim, k=args.top_k,
                               q_rows=args.q, r_rows=args.rows,
                               grid=args.grid, iters=args.iters,
                               seed=args.seed, device=device)
    dt = time.perf_counter() - t0
    sweep.save_winners(cache_path, results, dim=args.dim, k=args.top_k,
                       q_rows=args.q, r_rows=args.rows, git_rev=rev,
                       device=device)

    n_cand = sum(len(r) for r in results.values())
    table = sweep.format_table(results, winners_only=not args.full_table)
    print(table)
    if args.table:
        with open(args.table, "w") as f:
            f.write(table + "\n")
    print(f"[oms tune] device={tune.device_kind(device)} dim={args.dim} "
          f"k={args.top_k} q={args.q} rows={args.rows} grid={args.grid}: "
          f"{n_cand} candidates over {len(swept)} backends in {dt:.1f}s; "
          f"winners -> {cache_path}", file=sys.stderr)


def cmd_oneshot(argv) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.oms")
    _encoding_args(ap)
    _serving_args(ap)
    _cascade_args(ap)
    _encode_backend_args(ap)
    _device_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = OMSConfig(dim=args.dim, n_levels=args.n_levels, max_r=args.max_r,
                    q_block=args.q_block, open_tol_da=args.open_tol,
                    backend=args.backend, top_k=args.top_k,
                    encode_backend=args.encode_backend,
                    encode_batch=args.encode_batch,
                    prefix_words=args.prefix_words,
                    prefix_margin=args.prefix_margin,
                    prefix_seed_da=args.prefix_seed_da)
    ds = _dataset(args)
    t0 = time.perf_counter()
    pipe = OMSPipeline(cfg, ds.refs, device=device)
    _sync(device)
    t_ingest = time.perf_counter() - t0
    print(f"[oms] ingested {pipe.db.n_rows} rows "
          f"({pipe.db.n_blocks} blocks of {cfg.max_r}) in {t_ingest:.2f}s")
    _serve(pipe, ds, args)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"build": cmd_build, "search": cmd_search, "serve": cmd_serve,
            "queries": cmd_queries, "trace-report": cmd_trace_report,
            "analyze": cmd_analyze, "tune": cmd_tune}
    if argv and argv[0] in cmds:
        cmds[argv[0]](argv[1:])
    else:
        cmd_oneshot(argv)


if __name__ == "__main__":
    main()
