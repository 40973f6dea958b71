"""Phase 16: the launcher, ``python -m repro_torch.launch.oms``, as
subprocesses from the repository root.

16. free disk printed first. ``build`` of the Table I library,
    byte-identical to phase 12's store; ``search`` (fused, pallas), its
    recall and identification lines equal to phase 3's, ``search
    --cascade``, stage 1 identifying as many as the in-process cascade, and
    ``search --top-k 128``, its recall@1 lines phase 3's and its recall@128
    line the in-process search's; ``queries`` of the 16,000 requests;
    ``serve --resident`` (no cache, traced) on all of them, every response
    equal to phase 3's row; streamed ``serve`` at 2^18 rows a slab on the
    first 1,024 at 256 a batch (a scan reads the whole store),
    byte-identical to the resident lines; ``serve`` with the result cache on
    the first 1,024 twice, the second copy all hits and the lines unchanged;
    ``serve --cascade`` on all, a sample of 256 responses equal to
    single-query in-process cascades; ``trace-report --json`` on both
    traces, span counts equal to the micro-batches and slabs served. Each
    serve mode runs once more in process (``oms.main``; the 16,000-request
    modes on the first 1,024) for the launch counts, and must answer byte
    for byte as the subprocess did. Hot reload: a streamed ``serve
    --hot-reload`` in process on the launcher's own store (``build``'s
    output) while ``build --append`` grows it; the responses before equal
    the resident ones, those after a cold start on the grown store.

The subprocesses that do not read each other's output run side by side:
``build``, the three searches and both ``queries`` together, then the four
serve modes together while the hot reload and the in-process runs go on.

``times_serve`` (each serve mode alone for its q/s and latencies, the
resident trace's host spans, the device's busy share in process, one
micro-batch's kernel calls replayed, ``search`` alone) is
scripts/chip_times.py's.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

from . import common as C
from .common import cuda_ms, fail, graph_ms, log, require
from .oms_common import NARROW_TOL_DA

LAUNCHER_TOP_K = 128     # one `search --top-k` run past the old cap of 64
CLI_STORE_DIR = C.BUILD / "smoke_store_cli"
REQUESTS_FILE = C.BUILD / "smoke_requests.jsonl"
HEAD_FILE = C.BUILD / "smoke_requests_head.jsonl"
TWICE_FILE = C.BUILD / "smoke_requests_twice.jsonl"
IN_PROCESS_FILE = C.BUILD / "smoke_requests_in_process.jsonl"
NEW_FILE = C.BUILD / "smoke_requests_new.jsonl"
SERVE_TRACE = C.BUILD / "smoke_serve.trace.json"
STREAM_TRACE = C.BUILD / "smoke_stream.trace.json"
RELOAD_TRACE = C.BUILD / "smoke_reload.trace.json"
# A streamed scan reads the whole 1.19 GB store (~1.2-1.5 s), so streamed
# serve takes the first 1,024 requests at 256 a micro-batch; the cache run
# sends the first 1,024 twice; the cascade responses are held against
# single-query in-process cascades on a sample of 256 ids.
STREAM_SERVE_REQUESTS = 1024
STREAM_SERVE_BATCH = 256
STREAM_SERVE_SLAB_ROWS = 1 << 18
CACHE_REQUESTS = 1024
# The in-process serve runs (launch counts) of the modes that serve all
# 16,000 requests take the first 1,024.
IN_PROCESS_REQUESTS = 1024
CASCADE_SAMPLE = 256
# Hot reload: streamed serve of 256 requests, then `build --append` of
# 65,536 more library spectra (seed 1), then 256 requests drawn from them.
HOT_RELOAD_REQUESTS = 256
HOT_RELOAD_REFS = 1 << 16
HOT_RELOAD_POLL_S = 0.1
FILES = (CLI_STORE_DIR, REQUESTS_FILE, HEAD_FILE, TWICE_FILE, IN_PROCESS_FILE, NEW_FILE,
         SERVE_TRACE, STREAM_TRACE, RELOAD_TRACE)


def _dev():
    return ["--device", C.DEVICE]


def _encode_args():
    """``build``'s encode flags: the main path's encode backend and batch."""
    return ["--encode-backend", "pallas", "--encode-batch", C.ENCODE_BATCH,
            "--chunk-rows", C.CHUNK_ROWS, *_dev()]


def search_args(ctx) -> list:
    lib_cfg, _ = ctx.data()
    return ["search", "--store", ctx.store_dir, "--queries", lib_cfg.n_queries,
            "--seed", C.SEED, "--backend", "fused", "--encode-backend", "pallas",
            "--encode-batch", C.ENCODE_BATCH, "--max-r", ctx.cfg.max_r, *_dev()]


def serve_args(ctx, store_dir=None) -> list:
    return ["serve", "--store", store_dir or ctx.store_dir, "--backend", "fused",
            "--encode-backend", "pallas", "--max-r", ctx.cfg.max_r, *_dev()]


class ServeMode:
    """One serve mode: its subprocess (``args`` and ``cli_only``) on
    ``stdin``, its in-process run on ``in_process``."""

    def __init__(self, name, label, args, stdin, cli_only=(), in_process=None):
        self.name, self.label, self.args, self.stdin = name, label, list(args), stdin
        self.cli_only, self.in_process = list(cli_only), in_process or stdin


MODES = (
    ServeMode("resident", "resident", ["--resident", "--no-result-cache"], REQUESTS_FILE,
              cli_only=["--trace", SERVE_TRACE, "--metrics", "-"],
              in_process=IN_PROCESS_FILE),
    ServeMode("streamed", f"streamed {STREAM_SERVE_SLAB_ROWS} rows a slab",
              ["--slab-rows", STREAM_SERVE_SLAB_ROWS, "--max-batch", STREAM_SERVE_BATCH,
               "--no-result-cache"], HEAD_FILE, cli_only=["--trace", STREAM_TRACE]),
    ServeMode("cached", "resident cached", ["--resident"], TWICE_FILE),
    ServeMode("cascade", "resident cascade",
              ["--resident", "--cascade", "--narrow-tol-da", NARROW_TOL_DA,
               "--no-result-cache"], REQUESTS_FILE, in_process=IN_PROCESS_FILE),
)


# ---------------------------------------------------------------------------
# The requests (a resource: ``queries`` of the 16,000)
# ---------------------------------------------------------------------------


def start_requests(ctx, threads=None) -> C.Proc:
    """``queries`` of phase 3's 16,000 requests into REQUESTS_FILE, started
    once (``ctx.requests()`` waits for it)."""
    def make():
        lib_cfg, _ = ctx.data()
        ctx.remove_later(*FILES)
        REQUESTS_FILE.parent.mkdir(parents=True, exist_ok=True)
        return C.launch(["queries", "--queries", lib_cfg.n_queries, "--refs",
                         lib_cfg.n_refs, "--seed", C.SEED], "queries",
                        stdout=REQUESTS_FILE, threads=threads)
    return ctx._get("requests_proc", make)


def wait_requests(ctx) -> list[str]:
    """The request lines, each checked against phase 3's query at three
    ids; the head, twice and in-process request files written from them."""
    _, ds = ctx.data()
    _, _, t = start_requests(ctx).result()
    reqs = REQUESTS_FILE.read_text().splitlines(keepends=True)
    Q = ds.queries.mz.shape[0]
    require(len(reqs) == Q, f"queries wrote {len(reqs)} lines for {Q} queries")
    for i in (0, Q // 2, Q - 1):
        r = json.loads(reqs[i])
        require(r["id"] == i and r["pmz"] == float(ds.queries.pmz[i])
                and r["charge"] == int(ds.queries.charge[i]),
                f"request {i} is not phase 3's query {i}")
    log(f"[cli] queries (process {t:.1f}s): {Q} requests, "
        f"{REQUESTS_FILE.stat().st_size / 1e6:.1f} MB")
    HEAD_FILE.write_text("".join(reqs[:STREAM_SERVE_REQUESTS]))
    TWICE_FILE.write_text("".join(reqs[:CACHE_REQUESTS]) * 2)
    IN_PROCESS_FILE.write_text("".join(reqs[:IN_PROCESS_REQUESTS]))
    return reqs


# ---------------------------------------------------------------------------
# In-process runs of the launcher
# ---------------------------------------------------------------------------


class FirstRead:
    """The lines of ``lines``; ``start()`` runs just before the first is
    read, which ``serve`` does once its store is loaded."""

    def __init__(self, lines, start):
        self.lines, self.start = lines, start

    def __iter__(self):
        self.start()
        yield from self.lines


def oms_in_process(args, stdin, *, profile=False):
    """``repro_torch.launch.oms.main(args)`` in this process reading the
    lines of ``stdin`` (a file or any iterable), stdout and stderr
    captured, every kernel's launch count set to 0 just before and read
    just after. With ``profile``, the device's activity is recorded from
    the first request read to the return (``device_profile``). Returns
    (stdout, stderr, counts, seconds, profile or None)."""
    import contextlib
    import io

    import torch
    from repro_torch.kernels.hdencode import ops as hd_ops
    from repro_torch.launch import oms
    counters = {**C.counters(), "hdencode": hd_ops.launches}
    out, err = io.StringIO(), io.StringIO()
    prof, started = (C.device_profiler(torch) if profile else None), []

    def start():
        torch.cuda.synchronize()
        prof.start()
        started.append(time.perf_counter())
    old = sys.stdin
    sys.stdin = FirstRead(stdin, start) if profile else stdin
    try:
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            oms.main([str(a) for a in args])
        t = time.perf_counter() - t0
        counts = {n: c.count for n, c in counters.items()}
        if started:
            torch.cuda.synchronize()
            wall = time.perf_counter() - started[0]
    finally:
        sys.stdin = old
        if started:
            prof.stop()
    return (out.getvalue(), err.getvalue(), counts, t,
            C.device_profile(prof, wall) if started else None)


_SERVE_STATS = (
    r"answered (?P<answered>\d+) queries in (?P<s>[\d.]+)s \((?P<qps>\d+) q/s, "
    r"(?P<batches>\d+) micro-batches, (?P<qpb>[\d.]+) q/batch .*?wait p50/p99 "
    r"(?P<wait50>[\d.]+)/(?P<wait99>[\d.]+)ms, e2e p50/p99 (?P<e2e50>[\d.]+)/"
    r"(?P<e2e99>[\d.]+)ms")


def serve_stats(err: str) -> dict:
    """The numbers of ``serve``'s closing stderr line."""
    import re
    m = re.search(_SERVE_STATS, err)
    require(m is not None, f"serve printed no summary line: {err[-2000:]}")
    st = {k: float(v) for k, v in m.groupdict().items()}
    slabs = re.search(r"scans over (\d+) slabs", err)
    st["slabs"] = int(slabs.group(1)) if slabs else 0
    cache = re.search(r"cache (\d+)/(\d+) hits", err)
    st["cache"] = (int(cache.group(1)), int(cache.group(2))) if cache else None
    return st


class GrowingStdin:
    """Request lines for ``serve --hot-reload``: ``first``, then, once all of
    them have been searched (their ``serve.batch`` spans closed), ``grow()``
    and a wait of 10 watcher polls, then ``rest``."""

    def __init__(self, first, rest, grow):
        self.first, self.rest, self.grow = first, rest, grow

    def __iter__(self):
        from repro_torch.obs import trace
        yield from self.first
        deadline = time.monotonic() + C.CLI_TIMEOUT_S
        while sum(e.attrs["n"] for e in trace.current().events()
                  if e.name == "serve.batch") < len(self.first):
            require(time.monotonic() < deadline, "hot reload: the first "
                    "requests were never served")
            time.sleep(0.01)
        self.grow()
        time.sleep(10 * HOT_RELOAD_POLL_S)
        yield from self.rest


def payloads_of(result) -> list[dict]:
    """Every query's response payload as ``serve`` writes it."""
    r = {f: getattr(result, f).cpu().numpy()
         for f in ("std_idx", "std_sim", "open_idx", "open_sim")}
    return [{"std": {"idx": r["std_idx"][i].tolist(), "sim": r["std_sim"][i].tolist()},
             "open": {"idx": r["open_idx"][i].tolist(), "sim": r["open_sim"][i].tolist()}}
            for i in range(r["std_idx"].shape[0])]


def same_bytes(a: Path, b: Path) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def result_lines(out, ds, cfg, Q: int) -> list[str]:
    """The recall and identification lines the launcher prints for ``out``
    (the same format strings)."""
    import numpy as np
    src, mod = ds.query_source, ds.query_modified
    o = out.result.open_idx.cpu().numpy()[:, 0] == src
    s = out.result.std_idx.cpu().numpy()[:, 0] == src
    return [f"[oms] open-search recall@1:     {np.mean(o):.3f} "
            f"(modified queries: {np.mean(o[mod]):.3f})",
            f"[oms] standard-search recall@1: {np.mean(s):.3f} "
            f"(modified queries: {np.mean(s[mod]):.3f})",
            f"[oms] identifications @ {cfg.fdr_threshold:.0%} FDR: "
            f"{int(out.open_fdr.n_accepted)} / {Q * cfg.top_k}"]


def _serve_line(name: str, st: dict, t: float, counts: dict, timed: bool = True) -> str:
    """``serve``'s summary; untimed where it ran beside other processes."""
    used = json.dumps({k: v for k, v in counts.items() if v})
    if not timed:
        return (f"[cli] serve {name}: answered {int(st['answered'])} in "
                f"{int(st['batches'])} micro-batches (process {t:.1f}s beside the "
                f"others); launches (in-process run) {used}")
    return (f"[cli] serve {name}: answered {int(st['answered'])} in {st['s']:.2f}s "
            f"({int(st['qps'])} q/s; process {t:.1f}s), {int(st['batches'])} "
            f"micro-batches ({st['qpb']:.1f} q/batch), wait p50/p99 "
            f"{st['wait50']:.2f}/{st['wait99']:.2f} ms, e2e p50/p99 "
            f"{st['e2e50']:.2f}/{st['e2e99']:.2f} ms; launches (in-process run) {used}")


# ---------------------------------------------------------------------------
# Phase 16
# ---------------------------------------------------------------------------


def launcher(ctx) -> None:
    """build, search, queries, serve (resident, streamed, cached, cascade),
    trace-report and the hot reload through ``python -m
    repro_torch.launch.oms``."""
    import torch
    from repro_torch.data.spectra import LibraryConfig
    lib_cfg, ds = ctx.data()
    m = ctx.main()
    cfg = ctx.cfg
    ctx.store()
    store_dir = ctx.store_dir
    Q = lib_cfg.n_queries
    require(lib_cfg == LibraryConfig(n_refs=lib_cfg.n_refs, n_queries=Q,
                                     open_tol_da=75.0, seed=C.SEED),
            "the launcher's --refs/--queries/--seed do not give phase 3's dataset")
    names = sorted(os.listdir(store_dir))
    need = sum((store_dir / n).stat().st_size for n in names)
    free = shutil.disk_usage(store_dir.parent).free
    log(f"[cli] free space at {store_dir.parent}: {free / 1e9:.2f} GB; a second "
        f"store needs {need / 1e9:.2f} GB")
    require(free > 2 * need, f"not enough free disk for the launcher's store: "
            f"{free} bytes free, {2 * need} wanted")
    ctx.remove_later(*FILES)
    shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)

    # 1. what reads only the store and the seed, started together
    side = C.SIDE_THREADS
    search = search_args(ctx)
    procs = {
        "build": C.launch(["build", "--store", CLI_STORE_DIR, "--refs", lib_cfg.n_refs,
                           "--seed", C.SEED, *_encode_args()], "build", threads=side),
        "search": C.launch(search, "search", threads=side),
        "cascade": C.launch([*search, "--cascade", "--narrow-tol-da", NARROW_TOL_DA],
                            "search --cascade", threads=side),
        "top_k": C.launch([*search, "--top-k", LAUNCHER_TOP_K],
                          f"search --top-k {LAUNCHER_TOP_K}", threads=side),
        "new": C.launch(["queries", "--refs", HOT_RELOAD_REFS, "--seed", C.SEED + 1,
                         "--queries", HOT_RELOAD_REQUESTS], "queries of the appended spectra",
                        stdout=NEW_FILE, threads=side),
    }
    start_requests(ctx, threads=side)
    # what the searches must print, from the in-process pipeline meanwhile
    expect = result_lines(m.out, ds, cfg, Q)
    casc = m.pipe.search_cascade_encoded(*m.batch, narrow_tol_da=NARROW_TOL_DA)
    n_id = int(casc.identified_stage1.sum())
    expect_casc = result_lines(casc, ds, cfg, Q)
    kout = m.pipe.search_encoded(*m.batch, top_k=LAUNCHER_TOP_K)
    hit = (kout.result.open_idx.cpu().numpy() == ds.query_source[:, None]).any(axis=1)
    want_k = (f"[oms] open-search recall@{LAUNCHER_TOP_K}:     {hit.mean():.3f} "
              f"(modified: {hit[ds.query_modified].mean():.3f})")
    del kout, casc

    # 2. the four serve modes as subprocesses, side by side
    reqs = ctx.requests()
    serve = serve_args(ctx)
    serving = {md.name: C.launch([*serve, *md.args, *md.cli_only], f"serve {md.name}",
                                 stdin=md.stdin, threads=side) for md in MODES}

    # 3. build: the same store as phase 12, byte for byte
    o, _, t = procs["build"].result()
    require(sorted(os.listdir(CLI_STORE_DIR)) == names,
            "the launcher's store has other files than phase 12's")
    for n in names:
        require(same_bytes(store_dir / n, CLI_STORE_DIR / n),
                f"the launcher's {n} differs from phase 12's")
    log(f"[cli] build (process {t:.1f}s): {o.strip().splitlines()[-1]}; "
        f"{len(names)} files byte-identical to phase 12's store")

    # 4. hot reload on the launcher's own store, in process, while the serve
    # subprocesses run; its first responses are held against serve resident's
    # below
    procs["new"].result()
    reload_lines = hot_reload(ctx, reqs)

    # 5. each serve mode in process: the launch counts
    in_process = {}
    for md in MODES:
        with open(md.in_process) as fin:
            n_in = sum(1 for _ in fin)
        with open(md.in_process) as fin:
            o2, _, counts, _, _ = oms_in_process([*serve, *md.args], fin)
        for k in ("hdencode", "fused_search"):
            require(counts[k] > 0, f"serve {md.name} launched no {k}")
            ctx.by_path[k][f"serve {md.label} ({n_in:,} requests, in process)"] = counts[k]
        in_process[md.name] = (o2.splitlines(keepends=True), n_in, counts)

    # 6. the searches
    o, _, t = procs["search"].result()
    ctx.cli["search_stdout"] = o
    lines = o.splitlines()
    for want in expect:
        require(want in lines, f"search printed no line {want!r}:\n{o}")
    split = [x for x in lines if "stage split" in x or "searched" in x]
    log(f"[cli] search (process {t:.1f}s): recall@1 and identification lines == "
        f"phase 3's ({' | '.join(x[6:] for x in expect)}); {' | '.join(split)}")
    o, _, t = procs["cascade"].result()
    lines = o.splitlines()
    cl = [x for x in lines if x.startswith("[oms] cascade:")]
    require(len(cl) == 1 and f"stage1 identified {n_id}/{Q} ({NARROW_TOL_DA} Da)"
            in cl[0], f"search --cascade: stage 1 did not identify {n_id}:\n{o}")
    for want in expect_casc:
        require(want in lines, f"search --cascade printed no line {want!r}:\n{o}")
    split = [x for x in lines if "stage split" in x]
    log(f"[cli] search --cascade (process {t:.1f}s): {cl[0][6:]}; recall and "
        f"identification lines == the in-process cascade's; {' | '.join(split)}")
    # past the old top_k cap of 64: the recall@1 lines are phase 3's and
    # recall@k is the in-process search's at that k
    o, _, t = procs["top_k"].result()
    lines = o.splitlines()
    for want in (*expect[:2], want_k):
        require(want in lines, f"search --top-k {LAUNCHER_TOP_K} printed no line "
                f"{want!r}:\n{o}")
    log(f"[cli] search --top-k {LAUNCHER_TOP_K} (process {t:.1f}s): {want_k[6:].strip()}; "
        f"recall@1 lines == phase 3's, recall@{LAUNCHER_TOP_K} == the in-process search's")

    # 7. the serve subprocesses: each as its in-process run, then each mode's
    # own check
    out_lines, stats = {}, {}
    for md in MODES:
        o, e, t = serving[md.name].result()
        lines = o.splitlines(keepends=True)
        mine, n_in, counts = in_process[md.name]
        require(mine == lines[:n_in] and len(lines) >= n_in,
                f"serve {md.name}: the in-process run answered otherwise")
        stats[md.name] = serve_stats(e)
        out_lines[md.name] = lines
        log(_serve_line(md.name, stats[md.name], t, counts, timed=False))
    res_lines = out_lines["resident"]
    ctx.cli["resident_lines"] = res_lines
    require(len(res_lines) == Q and int(stats["resident"]["answered"]) == Q,
            "serve resident did not answer every request")
    for i, (line, want) in enumerate(zip(res_lines, payloads_of(m.out.result))):
        if json.loads(line) != {"id": i, **want}:
            fail(f"serve resident: response {i} differs from phase 3's row: {line}")
    log(f"[cli] serve resident: all {Q} responses == phase 3's result rows")
    require("".join(out_lines["streamed"]) == "".join(res_lines[:STREAM_SERVE_REQUESTS]),
            "serve streamed differs from serve resident")
    log(f"[cli] serve streamed: {STREAM_SERVE_REQUESTS} responses byte-identical to "
        f"serve resident; {stats['streamed']['slabs']} slabs scanned")
    require("".join(out_lines["cached"]) == "".join(res_lines[:CACHE_REQUESTS]) * 2,
            "serve with the result cache differs from serve without it")
    require(stats["cached"]["cache"] == (CACHE_REQUESTS, 2 * CACHE_REQUESTS),
            f"result cache hits {stats['cached']['cache']}, want {CACHE_REQUESTS} of "
            f"{2 * CACHE_REQUESTS}")
    log(f"[cli] serve cached: byte-identical to the uncached lines; cache "
        f"{stats['cached']['cache'][0]}/{stats['cached']['cache'][1]} hits")
    k_lines = out_lines["cascade"]
    require(len(k_lines) == Q, "serve --cascade did not answer every request")
    hvs, q_pmz, q_charge = m.batch
    sample = sorted({int(i) for i in torch.linspace(0, Q - 1, CASCADE_SAMPLE).round()})
    for i in sample:
        c = m.pipe.search_cascade_encoded(hvs[i:i + 1], q_pmz[i:i + 1], q_charge[i:i + 1],
                                          narrow_tol_da=NARROW_TOL_DA,
                                          stage1_per_query=True)
        want = {"id": i, **payloads_of(c.result)[0]}
        require(json.loads(k_lines[i]) == want, f"serve --cascade response {i} "
                f"differs from a single-query cascade: {k_lines[i]} vs {want}")
    log(f"[cli] serve cascade: {len(sample)} sampled responses == single-query "
        f"in-process cascades (stage1_per_query)")
    first = reload_lines[:HOT_RELOAD_REQUESTS]
    require(first == res_lines[:HOT_RELOAD_REQUESTS],
            "hot reload: the responses before the append differ from serve resident")
    log(f"[cli] serve --hot-reload: the first {len(first)} responses == serve resident")

    # 8. trace-report on both serve traces
    reports = [C.launch(["trace-report", "--json", f], "trace-report", threads=side)
               for f in (SERVE_TRACE, STREAM_TRACE)]
    roll, roll5 = (json.loads(p.result()[0]) for p in reports)
    batches = int(stats["resident"]["batches"])
    require(roll.get("serve.batch", {}).get("count") == batches,
            f"trace: {roll.get('serve.batch')} serve.batch spans for {batches} "
            f"micro-batches")
    missing = {"pipeline.encode", "pipeline.plan", "pipeline.scan",
               "pipeline.fdr"} - set(roll)
    require(not missing, f"the serve trace has no {sorted(missing)} spans")
    slabs = stats["streamed"]["slabs"]
    require(roll5.get("serve.slab.search", {}).get("count") == slabs,
            f"trace: {roll5.get('serve.slab.search')} serve.slab.search spans for "
            f"{slabs} slabs scanned")
    log(f"[cli] trace-report: resident trace validates, serve.batch == {batches} "
        f"micro-batches, pipeline.encode/plan/scan/fdr spans present; streamed trace "
        f"serve.slab.search == {slabs} slabs")
    shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)


def hot_reload(ctx, reqs) -> list[str]:
    """``serve --hot-reload`` (streamed) in process on the launcher's store:
    HOT_RELOAD_REQUESTS requests, then ``build --append`` of the seed + 1
    spectra, then as many requests drawn from them. The responses after the
    reload equal a cold start on the grown store, and the appended spectra
    change some. Returns every response line (the first ones are checked
    against serve resident by the caller)."""
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.serve import QuerySpec, coalesce_queries
    m = ctx.main()
    cfg = ctx.cfg
    first = reqs[:HOT_RELOAD_REQUESTS]
    rest = NEW_FILE.read_text().splitlines(keepends=True)
    require(len(rest) == HOT_RELOAD_REQUESTS,
            f"queries of the appended spectra wrote {len(rest)} lines")
    grown = []

    def grow():
        o, _, t = C.cli(["build", "--store", CLI_STORE_DIR, "--append", "--refs",
                         HOT_RELOAD_REFS, "--seed", C.SEED + 1, *_encode_args()],
                        "build --append")
        grown.append(f"{o.strip()} (process {t:.1f}s)")

    o, err, counts, t, _ = oms_in_process(
        [*serve_args(ctx, CLI_STORE_DIR), "--slab-rows", STREAM_SERVE_SLAB_ROWS,
         "--max-batch", STREAM_SERVE_BATCH, "--no-result-cache", "--hot-reload",
         HOT_RELOAD_POLL_S, "--trace", RELOAD_TRACE], GrowingStdin(first, rest, grow))
    got = o.splitlines(keepends=True)
    require(len(grown) == 1 and "1 hot-reloads" in err,
            f"serve --hot-reload did not reload once: {err[-2000:]}")
    spectra = coalesce_queries([QuerySpec(
        mz=r["mz"], intensity=r["intensity"], pmz=r["pmz"], charge=r["charge"])
        for r in map(json.loads, rest)])
    cold = OMSPipeline.from_store(CLI_STORE_DIR, cfg, device=C.DEVICE).search(spectra)
    old_answers = m.pipe.search(spectra)
    want = [{"id": json.loads(r)["id"], **p} for r, p in zip(rest, payloads_of(cold.result))]
    require([json.loads(x) for x in got[len(first):]] == want,
            "hot reload: the responses after the append differ from a cold "
            "start on the grown store")
    n_new = sum(a != b for a, b in zip(payloads_of(old_answers.result),
                                       payloads_of(cold.result)))
    require(n_new > 0, "hot reload: the appended spectra changed no answer")
    log(_serve_line("streamed + hot reload", serve_stats(err), t, counts, timed=False))
    log(f"[cli] serve --hot-reload: {grown[0]}; the {len(rest)} responses after the "
        f"reload == a cold start on the grown store ({n_new} of them changed by the "
        f"appended spectra); "
        f"{[x for x in err.splitlines() if 'hot-reload:' in x][0].split('] ', 1)[1]}")
    for k in ("hdencode", "fused_search"):
        require(counts[k] > 0, f"serve --hot-reload launched no {k}")
        ctx.by_path[k][f"serve streamed + hot reload ({2 * HOT_RELOAD_REQUESTS} "
                       f"requests, in process)"] = counts[k]
    return got


# ---------------------------------------------------------------------------
# Timing runs (scripts/chip_times.py)
# ---------------------------------------------------------------------------


class LargestCall:
    """Wraps ``mod.<name>`` (a kernel wrapper) to keep the arguments of its
    first call with the most rows in its first argument; ``replay()``
    calls the wrapper on them again."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.orig = mod, name, getattr(mod, name)
        self.rows, self.args, self.kw = -1, None, None

    def __enter__(self):
        def kept(*a, **kw):
            if a[0].shape[0] > self.rows:
                self.rows, self.args, self.kw = a[0].shape[0], a, kw
            return self.orig(*a, **kw)
        setattr(self.mod, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def replay(self):
        return self.orig(*self.args, **self.kw)


def _profile_line(name: str, prof: dict, batches: int) -> str:
    if not prof["n_events"]:
        return (f"[cli] serve {name} device profile: torch.profiler recorded no "
                f"device activity (idle share and kernel times not measured)")
    ks = ", ".join(f"{k} {n} kernels {ms:.3f} ms ({ms / batches:.4f} ms a batch)"
                   for k, (n, ms) in prof["kernels"].items())
    return (f"[cli] serve {name} device profile ({batches} micro-batches in "
            f"process): device busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
            f"from the first request read to the return, idle share "
            f"{prof['idle_share']:.4f}; copies {prof['copy_ms']:.2f} ms; {ks}")


def times_serve(ctx) -> dict:
    """``search`` alone; each serve mode's subprocess alone (q/s, latency)
    and in process under torch.profiler (the device's busy share, the
    serve kernels' device time a micro-batch); the resident trace's host
    spans; one resident micro-batch's kernel calls replayed."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hdencode import ops as hd_ops
    ctx.store()
    ctx.remove_later(*FILES)
    out = {}
    o, _, t = C.cli(search_args(ctx), "search")
    split = [x for x in o.splitlines() if "stage split" in x or "searched" in x]
    log(f"[cli] search alone (process {t:.1f}s): {' | '.join(split)}")
    out["search_process_s"] = t
    ctx.requests()
    serve = serve_args(ctx)
    for md in MODES:
        o, e, t = C.cli([*serve, *md.args, *md.cli_only], f"serve {md.name}", stdin=md.stdin)
        st = serve_stats(e)
        hd = LargestCall(hd_ops, "hdencode")
        fs = LargestCall(hops, "fused_search")
        with open(md.in_process) as fin, hd, fs:
            o2, e2, counts, _, prof = oms_in_process([*serve, *md.args], fin, profile=True)
        log(_serve_line(md.name, st, t, counts))
        log(_profile_line(md.name, prof, int(serve_stats(e2)["batches"])))
        out[md.name] = {"stats": st, "process_s": t, "device_profile": prof}
        if md.name == "resident":
            hd_ms, hd_dev, fs_ms = cuda_ms(hd.replay), graph_ms(hd.replay), cuda_ms(fs.replay)
            log(f"[cli] one resident micro-batch's kernel calls replayed at their serve "
                f"shapes (CUDA events, median of {C.TIMING_ITERS}): hdencode "
                f"{tuple(hd.args[0].shape)} peaks {hd_ms:.4f} ms (device {hd_dev:.4f} ms "
                f"in a graph), fused_search {fs.rows} padded queries x "
                f"{fs.args[6].shape[0]} blocks x {fs.kw['rk']} rows {fs_ms:.4f} ms")
            out["replay"] = {"hdencode_ms": hd_ms, "hdencode_device_ms": hd_dev,
                             "fused_search_ms": fs_ms}
    o, _, _ = C.cli(["trace-report", "--json", SERVE_TRACE], "trace-report")
    roll = json.loads(o)
    parts = ", ".join(f"{n} {roll[n]['count']} x {roll[n]['total_us'] / roll[n]['count']:.0f} us "
                      f"(p50/p99 buckets {roll[n]['p50_us']:.0f}/{roll[n]['p99_us']:.0f})"
                      for n in ("serve.batch", "pipeline.encode", "pipeline.plan",
                                "pipeline.scan", "pipeline.fdr"))
    o, _, _ = C.cli(["trace-report", "--json", STREAM_TRACE], "trace-report")
    roll5 = json.loads(o)
    sparts = ", ".join(f"{n} {roll5[n]['count']} x "
                       f"{roll5[n]['total_us'] / roll5[n]['count'] / 1e3:.1f} ms"
                       for n in ("serve.batch", "serve.scan", "serve.slab.fetch",
                                 "serve.slab.search", "serve.slab.merge"))
    log(f"[cli] trace-report: resident host span means {parts}; streamed {sparts}")
    out["resident_spans"] = {n: roll[n] for n in ("serve.batch", "pipeline.encode",
                                                  "pipeline.plan", "pipeline.scan",
                                                  "pipeline.fdr")}
    return out
