"""Phase 17: the autotuner and the contract analyzer.

17. the card's float32 sqrt (the preprocess's) against the float64 one
    rounded once; ``tune`` in process at the main path's shapes (the tile
    and fused backends on one block of 16 queries x its scanned rows at dim
    4096, k = 1; rescore on the cascade's real rows), every candidate held
    bit for bit against the defaults' output by the sweep; ``search`` and
    resident ``serve`` (the first 1,024 requests) in process with the
    winners' cache: output byte-identical to the untuned runs (clock
    readings masked; phase 16's where it ran, else run here) and the cache
    hit at dispatch. ``analyze --imports`` on the card as a subprocess
    (started with phase 16), every recording under sync debug mode "error";
    it exits 0; n_checks and each combination's allocator peak.

``times_tune`` (the sweep timed at 20 iterations a candidate, the winner
table with each winner against the default) is scripts/chip_times.py's.
"""
from __future__ import annotations

import contextlib
import io
import json
import time

from . import common as C
from .common import equal, log, require
from .launcher import HEAD_FILE, STREAM_SERVE_REQUESTS, oms_in_process, search_args, serve_args
from .oms_common import check_blocks

TUNE_CACHE = C.BUILD / "smoke_tune_cache.json"
TUNE_ITERS = 20          # a candidate's timed calls in the timing run
TUNE_CHECK_ITERS = 3     # in the check (the launcher's default)
TUNE_QUERIES = 16
ANALYZE_REPORT = C.BUILD / "smoke_analyze.json"
SQRT_CHECK_SPECTRA = 1 << 16


def _mask_times(text: str) -> str:
    """A launcher's stdout with its clock readings masked."""
    import re
    return re.sub(r"\d+(\.\d+)?( ?q/s| ?sp/s|s\b|%)", "<t>", text)


def _tune_table(table: str) -> dict:
    """{backend: [row, ...]} of a ``tune --full-table`` table, winner first;
    a row is {tiles, us, bound_us, frac}."""
    import re
    rows = {}
    for line in table.splitlines()[1:]:
        be, rest = line.split(None, 1)
        m = re.match(r"(?P<tiles>.*?)\s+(?P<us>[\d.]+)\s+(?P<bound>[\d.]+)\s+"
                     r"(?P<frac>[\d.]+)%\*?$", rest.rstrip())
        require(m is not None, f"tune table row not understood: {line!r}")
        rows.setdefault(be, []).append({
            "tiles": {k: int(v) for k, v in (x.split("=") for x in m["tiles"].split())},
            "us": float(m["us"]), "bound_us": float(m["bound"]),
            "frac": float(m["frac"]) / 100})
    return rows


def _tune_stats(err: str, tag: str) -> tuple[int, int]:
    import re
    m = re.search(rf"\[oms {tag}\] tune-cache .*: (\d+) entries, (\d+) hits / "
                  rf"(\d+) misses", err)
    require(m is not None, f"{tag} --tune-cache printed no tune-cache line: {err[-2000:]}")
    return int(m[2]), int(m[3])


def sweep(ctx, iters: int, table: bool) -> tuple[dict, dict]:
    """``tune`` in process at the main path's shapes into TUNE_CACHE, every
    candidate checked bit for bit against the defaults' output by the
    sweep. Returns ({backend: rows}, the launches by kernel); with
    ``table`` the full table is printed."""
    from repro_torch import tune
    from repro_torch.launch import oms
    m = ctx.main()
    pipe = m.pipe
    params, _, _, rk = check_blocks(ctx.torch, pipe, *m.batch)
    n_real = int((pipe.db.orig_idx >= 0).sum())
    ctx.remove_later(TUNE_CACHE)
    TUNE_CACHE.unlink(missing_ok=True)
    counters = C.counters()
    for c in counters.values():
        c.reset()
    tables = {}
    for backends, rows in (("kernel_vpu,kernel_mxu,fused,fused_mxu", rk),
                           ("rescore", n_real)):
        buf, ebuf = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(ebuf):
            oms.main(["tune", "--backends", backends, "--dim", str(pipe.cfg.dim),
                      "--top-k", "1", "--q", str(TUNE_QUERIES), "--rows", str(rows),
                      "--grid", "default", "--iters", str(iters), "--cache",
                      str(TUNE_CACHE), "--full-table", "--device", C.DEVICE])
        found = _tune_table(buf.getvalue())
        n = sum(len(v) for v in found.values())
        log(f"[tune] `tune --backends {backends} --q {TUNE_QUERIES} --rows {rows} --dim "
            f"{pipe.cfg.dim} --iters {iters}` in {time.perf_counter() - t0:.1f}s: {n} "
            f"candidates, each bit-identical to the defaults' output")
        if table:
            log(f"[tune]   {ebuf.getvalue().strip().splitlines()[-1]}")
            for line in buf.getvalue().splitlines():
                log(f"[tune]   {line}")
        tables.update(found)
    require(set(tables) == set(tune.SWEPT_BACKENDS), f"tune swept {sorted(tables)}")
    return tables, {n: c.count for n, c in counters.items()}


def start_analyze(ctx) -> C.Proc:
    """``analyze --imports`` on the card as a subprocess."""
    ctx.remove_later(ANALYZE_REPORT)
    return C.launch(["analyze", "--imports", "--json", ANALYZE_REPORT, "--device",
                     C.DEVICE], "analyze", threads=C.SIDE_THREADS)


def tune_analyze(ctx) -> None:
    from repro_torch import tune
    from repro_torch.core import encoding
    torch = ctx.torch
    analyze = ctx.background.pop("tune_analyze", None) or start_analyze(ctx)
    _, ds = ctx.data()

    # The device path takes torch's float32 sqrt (the CPU path numpy's):
    # both must be the correctly rounded one, the float64 sqrt rounded once.
    inten = torch.as_tensor(ds.refs.intensity[:SQRT_CHECK_SPECTRA], device=C.DEVICE)
    rand = torch.rand(1 << 24, device=C.DEVICE) * 1e6
    for x in (inten, rand):
        require(equal(encoding.sqrt_f32(x), torch.sqrt(x.double()).float()),
                "the device's float32 sqrt is not the correctly rounded one")
    log(f"[tune] float32 sqrt on the card == float64 sqrt rounded once on "
        f"{inten.numel():,} library intensities and {rand.numel():,} uniform values")
    del inten, rand

    _, sweep_counts = sweep(ctx, TUNE_CHECK_ITERS, table=False)
    search = search_args(ctx)
    serve = serve_args(ctx)
    untuned = ctx.cli.get("search_stdout")
    if untuned is None:
        untuned = oms_in_process(search, [])[0]
    ctx.requests()
    head = ctx.cli.get("resident_lines", [])[:STREAM_SERVE_REQUESTS]
    if not head:
        with open(HEAD_FILE) as fin:
            head = oms_in_process([*serve, "--resident", "--no-result-cache"], fin)[0]
    head = "".join(head)
    # Tuned search and resident serve, in process: the same bytes, hits > 0.
    try:
        o, e, s_counts, t, _ = oms_in_process([*search, "--tune-cache", TUNE_CACHE], [])
        require(_mask_times(o) == _mask_times(untuned),
                f"search --tune-cache printed otherwise:\n{o}\nvs\n{untuned}")
        hits, misses = _tune_stats(e, "search")
        require(hits > 0, f"search --tune-cache: no cache hit ({misses} misses)")
        log(f"[tune] search --tune-cache (in process, {t:.1f}s): stdout == the "
            f"untuned search's but for its clock readings; {hits} hits / {misses} "
            f"misses at dispatch")
        tune.reset_runtime()
        with open(HEAD_FILE) as fin:
            o, e, v_counts, t, _ = oms_in_process(
                [*serve, "--resident", "--no-result-cache", "--tune-cache", TUNE_CACHE], fin)
        require(o == head, "serve --resident --tune-cache answered otherwise than untuned")
        hits, misses = _tune_stats(e, "serve")
        require(hits > 0, f"serve --tune-cache: no cache hit ({misses} misses)")
        log(f"[tune] serve --resident --tune-cache (in process, {t:.1f}s): "
            f"{STREAM_SERVE_REQUESTS} responses byte-identical to the untuned serve's; "
            f"{hits} hits / {misses} misses at dispatch")
    finally:
        tune.reset_runtime()
    for k in ("hdencode", "fused_search"):
        require(s_counts[k] > 0 and v_counts[k] > 0, f"tuned search/serve launched no {k}")
    for k, n in sweep_counts.items():
        if n:
            ctx.by_path[k]["tune sweep (in process)"] = n
    for k in ("fused_search", "hdencode"):
        ctx.by_path[k]["search --tune-cache (in process)"] = s_counts[k]
        ctx.by_path[k][f"serve resident --tune-cache ({STREAM_SERVE_REQUESTS:,} "
                       f"requests, in process)"] = v_counts[k]
    collect_analyze(analyze)


def collect_analyze(proc) -> None:
    """analyze exits 0 with every contract held; n_checks and each
    combination's allocator peak."""
    from repro_torch.analysis import runner
    o, _, t = proc.result()
    rep = json.loads(ANALYZE_REPORT.read_text())
    ANALYZE_REPORT.unlink()
    con = rep["contracts"]
    require(rep["imports"]["ok"] and con["ok"], f"analyze failed:\n{o[-3000:]}")
    peaks = runner.allocator_peaks(con)
    require(len(peaks) == con["n_combinations"] - 1,
            f"allocator peaks for {len(peaks)} of {con['n_combinations']} combinations")
    by_target = {}
    for c in con["combos"]:
        for r in c["contracts"]:
            if "allocator_bytes" in r:
                by_target[r["target"]] = max(by_target.get(r["target"], 0),
                                             r["allocator_bytes"])
    log(f"[analyze] `analyze --imports --device {C.DEVICE}` exited 0 (process {t:.1f}s): "
        f"{con['n_combinations']} combinations, n_checks {con['n_checks']}, "
        f"imports {rep['imports']['modules']} modules / {rep['imports']['edges']} edges; "
        f"{next(x for x in o.splitlines() if 'ALL CONTRACTS HOLD' in x)}")
    log(f"[analyze] allocator peak per combination (bytes, the largest rise of "
        f"torch.cuda.max_memory_allocated over one recorded call): {json.dumps(peaks)}")
    log(f"[analyze] allocator peak per target (bytes): {json.dumps(by_target)}")


def times_tune(ctx) -> dict:
    """The sweep at TUNE_ITERS timed calls a candidate: the table, and each
    backend's winner against its default."""
    from repro_torch import tune
    tables, _ = sweep(ctx, TUNE_ITERS, table=True)
    summary = {}
    for be, rows in sorted(tables.items()):
        default = next(r for r in rows if r["tiles"] == tune.kernel_defaults(be))
        win = rows[0]
        summary[be] = {"winner": win["tiles"], "winner_ms": win["us"] / 1e3,
                       "default_ms": default["us"] / 1e3,
                       "bound_ms": win["bound_us"] / 1e3, "fraction": win["frac"],
                       "default_fraction": default["frac"], "candidates": len(rows)}
        log(f"[tune] {be}: winner {win['tiles']} {win['us'] / 1e3:.4f} ms, default "
            f"{default['tiles']} {default['us'] / 1e3:.4f} ms "
            f"({default['us'] / win['us']:.3f}x), bound {win['bound_us'] / 1e3:.4f} ms, "
            f"fraction {win['frac']:.4f} (default {default['frac']:.4f}); "
            f"{len(rows)} candidates")
    log(f"[tune] winners {json.dumps(summary)}")
    return summary
