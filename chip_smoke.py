"""Drive the PyTorch/CUDA port's resident OMS main path on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught into a success):
  1. environment: card, power limit, torch/CUDA/nvcc versions, triton;
     build the CUDA kernels from the sources in this checkout.
  2. hdencode kernel against its plain PyTorch version on the card, at
     dim 4096 and at 7 words, and at the bit-sliced counters' edges: a
     count of 64 (P = 64, every peak valid with one bin and level), P = 1,
     63, 100 and 2100 (the general plane path), and B = 1. Then
     hamming_matrix and hamming_mxu against the plain tile at the shapes
     the main path does not give them: W = 1 and 9, Q = 1 and 17, R = 1, 7
     and 8k + 3, row slices whose base is not 16-byte aligned (W = 7 from
     an odd row, W = 4 at a 4-byte offset), and W = 300 (hamming_mxu's
     128-word chunks of A fragments).
  3. the main path at the iPRG2012 scale of Table I: OMSPipeline ingest of
     1,160,000 spectra plus as many decoys, 16,000 queries encoded and
     searched (backend ``fused``, encode backend ``pallas``), FDR at 1%;
     both kernels' launch counts are read around this phase. Then the
     fused_search kernel against its plain version on 8 of its query
     blocks, at k = 1 and k = 4, and at 7 words (the scalar-load variant);
     both fused kernels (grouped: 8 consecutive query tiles per CTA) against
     their plain versions on two runs of 2G + 1 consecutive main-path
     blocks at k = 1, 4 and 16, with the groups' union/rk; and at the
     grouped design's edges on seeded synthetic data (tie-heavy duplicate
     rows): batches of 1, 2 and G + 1 blocks, identical starts, ranges past
     the last row, q_block 20, W = 7, 9, 12 and 256, k = 1, 4 and 16.
  4. path against path: the first 512 queries through the plain torch ops
     (vpu, word_tiled) and through the kernels (fused, pallas) against the
     full DB; a 4,096-row library slice re-encoded with word_tiled against
     the kernel-built DB; and a small dataset through the kernels on the
     card against the plain versions on the CPU.
  5. kernel times (CUDA events, median of 10 after a warm-up) beside their
     plain versions at the same shapes (fused_search's plain version on the
     whole batch, held bit for bit against the kernel there and timed as
     the median of 3) and their lower bounds; for the short kernels also
     the device time of a CUDA graph of 20 launches, which leaves out the
     wrapper's host work, and hdencode's gathered codebook bytes.
  6. the all-pairs tile kernels (hamming_matrix: binary AND-popc tensor
     cores; hamming_mxu: +-1 int8 tensor cores) against their plain
     versions on 8 main-path query blocks at W = 128, at the cascade's
     prefix widths W = 64 and 8 and at W = 7, and on 2 query blocks against
     the cascade's 4,194,304-row bucket of gathered rows at W = 128 (the
     seed pass and the rescore), where hamming_matrix and hamming_mxu are
     also timed beside their bound and beside torch._int_mm on the
     bucket's rows unpacked to +-1 int8 beforehand; the fused_search_mxu
     kernel against its plain version on 8 blocks at k = 1 and k = 4, and
     at 7 words (dim 224, the scalar-load variant).
  7. fused_search_mxu against fused_search on the whole batch at k = 1
     and k = 4: all four arrays bit-identical.
  8. the kernel backends end to end: search_encoded with kernel_vpu,
     kernel_mxu and fused_mxu on the full batch, each equal to phase 3's
     fused result (6 SearchResult arrays, both FDR results); each run's
     launch counts are set to 0 just before it and read just after.
  9. the dimension cascade, exact mode, at prefix_words 8 and 64 with
     fused, kernel_vpu and fused_mxu on the full batch, each equal to the
     full-width fused result; seed rows, survivors, buckets, stage times
     and the tile launches by shape (rows x words) are printed. Then
     margin mode (prefix_margin = half the rest), which prunes: the stage-A
     keep flags of the whole batch (thresholds from the full scan) through
     the kernel_vpu and fused_mxu tiles against the plain tile, a strict
     subset kept; and on the first 512 queries the same three backends'
     searches against a run whose tile is the plain version (row-chunked),
     all results and survivor counts equal, survivors a strict subset.
 10. times and bounds of the tile kernels and fused_search_mxu (the tiles
     at one main-path block beside torch._int_mm on pre-unpacked +-1 int8;
     fused_search_mxu on the whole batch, its plain version run once,
     compared and timed).
 11. top_k above 16: both fused kernels against their plain versions on
     the main-path check blocks at k = 17, 32 and 64, and timed on the
     whole batch at k = 16, 17, 32 and 64; the limits that were widened
     (fused_search_mxu past 256 words, the fused kernels at their widest
     W, the tile kernels past 65,535 query tiles, hamming_matrix past
     3,632 words, the grouped launch past 65,535 groups) against the plain
     versions; the limits that remain raise their stated errors.
 12. the store: OMSPipeline.ingest of the Table I library (chunks of 65,536
     rows) into a store under build/ (its free space printed first), then
     from_store(resident=True): its DB equals phase 3's in all eight
     fields and its fused search equals phase 3's result.
 13. streamed search: from_store(resident=False) at 2^18 rows a slab, at
     37 blocks (a prime) and at the whole store, with fused and fused_mxu:
     each equal to phase 3's result (6 arrays, both FDRs), one fused launch
     per streamed slab; per slab the host gather, upload and search times,
     slabs touched, rows and bytes read, and the peak device memory above
     the baseline beside the resident DB's bytes.
 14. the streamed exact dimension cascade at prefix_words 8 with fused:
     equal to the resident cascade, run beside it, and to phase 3's result.
 15. the narrow→open cascade at 1 Da with fused, resident and streamed:
     equal to each other (merged result, both FDRs, stage-1 identified,
     stage queries and results); with run_stage1 False equal to
     search_encoded; identified count, each stage's time, scanned rows
     against pure_open_scanned_rows, and bytes streamed.
 16. the launcher, ``python -m repro_torch.launch.oms`` as subprocesses
     from the repository root (free disk printed first): ``build`` of the
     Table I library, byte-identical to phase 12's store (then deleted);
     ``search`` (fused, pallas), its recall and identification lines equal
     to phase 3's, and ``search --cascade``, stage 1 identifying as many as
     the in-process cascade; ``queries`` of the 16,000 requests; ``serve
     --resident`` (no cache, traced) on all of them, every response equal
     to phase 3's row; streamed ``serve`` at 2^18 rows a slab on the first
     1,024 at 256 a batch (a scan reads the whole store), byte-identical to
     the resident lines; ``serve`` with the result cache on the first
     1,024 twice, the second copy all hits and the lines unchanged; ``serve
     --cascade`` on all, a sample of 256 responses equal to single-query
     in-process cascades; ``trace-report --json`` on both traces, span
     counts equal to the micro-batches and slabs served. Each serve mode
     runs once more in process (``oms.main``; the 16,000-request modes on
     the first 1,024) for the launch counts, under ``torch.profiler``
     (device activity only) for the device's busy share and the kernels'
     device time per micro-batch, and must answer byte for byte as the
     subprocess did; one resident micro-batch's ``hdencode`` and
     ``fused_search`` calls are replayed at their serve shapes and timed
     with CUDA events.
 17. the autotuner and the contract analyzer. Inside phase 16, before
     its hot reload grows the store: the card's float32 sqrt (the
     preprocess's) against the float64 one rounded once; ``tune`` in
     process at the main path's shapes (the tile and fused backends on one
     block of 16 queries x its scanned rows at dim 4096, k = 1; rescore on
     the cascade's real rows), every candidate held bit for bit against
     the defaults' output by the sweep, the winner table (ms, bound ms from
     ``repro_torch.utils.roofline``, fraction) with each winner against
     the default; ``search`` and resident ``serve`` (the first 1,024
     requests) in process with the winners' cache: output byte-identical
     to the untuned runs (clock readings masked) and the cache hit at
     dispatch. After phase 16: ``analyze --imports`` on the card, every
     recording under sync debug mode "error"; it exits 0; n_checks and
     each combination's allocator peak.
All five kernels go into one ``kernels`` JSON line; ``launches`` is the
main path's count (the backend's own path for the tile and fused_mxu
kernels) and ``launches_by_path`` each path's, counts set to 0 just before
the path and read just after.

The last line is ``{"ok": true, "device": {...}}``. The script imports
neither jax nor the reference package.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

SEED = 0
DEVICE = "cuda"
HDENCODE_SPECTRA = 4096
FUSED_CHECK_BLOCKS = 8
PATH_CHECK_QUERIES = 512
SLICE_ROWS = 4096
ENCODE_BATCH = 4096      # spectra per hdencode launch on the main path
CHUNK_ROWS = 1 << 16     # library rows per ingest chunk
TIMING_ITERS = 10
GRAPH_LAUNCHES = 20      # launches per captured CUDA graph (device times)

FUSED_PLAIN_ITERS = 3    # the plain search takes ~20 s per full batch
NARROW_W = 7             # a word count that takes the kernels' scalar paths
TILE_CHECK_W = (64, 8, NARROW_W)   # the prefix widths and a scalar-load width
BUCKET_CHECK_BLOCKS = 2  # query blocks held against the cascade's row bucket
PLAIN_TILE_ROWS = 1 << 16  # row chunk of the plain tile at bucket sizes
# Edge shapes of the redesigned kernels against their plain versions.
HDENCODE_EDGE_SPECTRA = 256
# P = 1: no upper counter plane; 63, 100: three and four; 2100: the general
# plane path (P >> 3 >= 256).
HDENCODE_EDGE_P = (1, 63, 100, 2100)
TILE_EDGE_ROWS = 8 * 512 + 3
# (Q, R, W, word offset of the rows): k-step tails (W = 1, 9), a partial and
# a second query tile, R = 1, 7 and 8k + 3 (odd: the scalar stores), a W = 7
# row slice from an odd row and a W = 4 one at a 4-byte offset (scalar loads
# for a row base that is not 16-byte aligned), and W = 300 (hamming_mxu
# takes its A fragments in 128-word chunks: two full and a partial one).
TILE_EDGE_SHAPES = ((16, TILE_EDGE_ROWS, 1, 0), (16, TILE_EDGE_ROWS, 9, 0),
                    (1, TILE_EDGE_ROWS, 128, 0), (17, TILE_EDGE_ROWS, 128, 0),
                    (16, 1, 128, 0), (16, 7, 128, 0), (16, TILE_EDGE_ROWS, 128, 0),
                    (16, TILE_EDGE_ROWS, 7, 7), (16, TILE_EDGE_ROWS, 4, 1),
                    (16, TILE_EDGE_ROWS, 300, 0))
# The kernel backends of phase 8 and the kernel each of them launches.
BACKEND_KERNELS = {"kernel_vpu": "hamming_matrix", "kernel_mxu": "hamming_mxu",
                   "fused_mxu": "fused_search_mxu"}
CASCADE_PREFIX_WORDS = (8, 64)
# The cascade's backends and the tile kernel each routes its stages to.
CASCADE_TILES = {"fused": "hamming_matrix", "kernel_vpu": "hamming_matrix",
                 "fused_mxu": "hamming_mxu"}
MARGIN_QUERIES = PATH_CHECK_QUERIES
PLAIN_TILE_BACKEND = "plain_tile"   # registered by phase 9 for its yardstick

# Device peaks and the kernels' work counts for the lower bounds live in
# src/repro_torch/utils/roofline.py, which the tune sweep reads too.
# Grouped fused kernels: runs of consecutive main-path query blocks (2G + 1
# with G = 8 tiles per CTA) held against the plain versions at these k.
FUSED_GROUP_RUN = 2 * 8 + 1
FUSED_GROUP_KS = (1, 4, 16)
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


# Phases 11-15: top_k above the old cap of 16, the store, the streaming
# engine and the narrow→open cascade.
TOPK_CHECK_KS = (17, 32, 64)
TOPK_TIME_KS = (16, 17, 32, 64)
STORE_DIR = HERE / "build" / "smoke_store"
# Streamed slab sizes in rows: 2^18, a prime number of blocks (37 of 4,096
# rows), the whole store.
STREAM_SLAB_ROWS = (1 << 18, 37 * 4096, 1 << 30)
STREAM_KERNELS = {"fused": "fused_search", "fused_mxu": "fused_search_mxu"}
STREAM_CASCADE_PREFIX = 8
NARROW_TOL_DA = 1.0
GRID_Y_MAX = 65535       # CUDA's grid y limit: groups of one fused launch

# Phase 16: the launcher, ``python -m repro_torch.launch.oms``, as
# subprocesses from the repository root.
CLI_STORE_DIR = HERE / "build" / "smoke_store_cli"
REQUESTS_FILE = HERE / "build" / "smoke_requests.jsonl"
SERVE_TRACE = HERE / "build" / "smoke_serve.trace.json"
STREAM_TRACE = HERE / "build" / "smoke_stream.trace.json"
# A streamed scan reads the whole 1.19 GB store (~1.2-1.5 s), so streamed
# serve takes the first 1,024 requests at 256 a micro-batch; the cache run
# sends the first 1,024 twice; the cascade responses are held against
# single-query in-process cascades on a sample of 256 ids.
STREAM_SERVE_REQUESTS = 1024
STREAM_SERVE_BATCH = 256
STREAM_SERVE_SLAB_ROWS = 1 << 18
CACHE_REQUESTS = 1024
# The in-process serve runs (launch counts, device profile) of the modes
# that serve all 16,000 requests take the first 1,024.
IN_PROCESS_REQUESTS = 1024
SERVE_PROFILE = HERE / "build" / "smoke_serve_profile.json"
# Device activity in a torch.profiler (Kineto) trace, and the serve path's
# kernels by the names of their __global__ functions.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SERVE_KERNELS = {"hdencode": ("hdencode_kernel",),
                 "fused_search": ("fused_grouped_partial", "fused_search_merge")}
CASCADE_SAMPLE = 256
CLI_TIMEOUT_S = 300
# Hot reload: streamed serve of 256 requests, then `build --append` of
# 65,536 more library spectra (seed 1), then 256 requests drawn from them.
HOT_RELOAD_REQUESTS = 256
HOT_RELOAD_REFS = 1 << 16
HOT_RELOAD_POLL_S = 0.1
RELOAD_TRACE = HERE / "build" / "smoke_reload.trace.json"

# Phase 17: the autotuner and the contract analyzer. The sweep runs at the
# main path's shapes (one query block of 16 x its scanned rows at dim
# 4096; the fused backends at k = 1; rescore on the cascade's real rows,
# whose bucket the survivor rescore pads to), each candidate timed as the
# median of TUNE_ITERS; tuned `search` and resident `serve` (the first
# 1,024 requests) run in process with the winners' cache.
TUNE_CACHE = HERE / "build" / "smoke_tune_cache.json"
TUNE_ITERS = 20
TUNE_QUERIES = 16
ANALYZE_REPORT = HERE / "build" / "smoke_analyze.json"
SQRT_CHECK_SPECTRA = 1 << 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: bool = True) -> float:
    """Median milliseconds of ``fn()`` on the card over ``iters`` runs (after
    one warm-up run unless the caller has just run it), each bracketed by
    CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device milliseconds of one ``fn()``: ``launches`` calls captured in a
    CUDA graph, the graph's replay timed as cuda_ms times a call, divided
    by ``launches``. Around a single call, cuda_ms also counts the
    wrapper's host work whenever the kernel is shorter than it; a replay
    has none between its events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = cuda_ms(graph.replay) / launches
    del graph
    return ms


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def phase_environment(torch) -> dict:
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock = nvidia_smi("clocks.max.sm")
    try:
        nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip().splitlines()[-1]
    except (OSError, IndexError) as e:
        fail(f"nvcc not usable: {e}")
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    log(f"[env] device: {name} (count {torch.cuda.device_count()})")
    log(f"[env] nvidia-smi name, power.limit: {smi}")
    log(f"[env] max SM clock: {clock}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc}")
    log(f"[env] triton: {triton_v or 'not importable'}")
    return {"name": name, "smi": smi, "clock_hz": float(clock.split()[0]) * 1e6,
            "n_sms": torch.cuda.get_device_properties(0).multi_processor_count}


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build(log=lambda s: log("\n".join(
        f"[build] {line}" for line in s.splitlines()
        if "registers" in line or "Compiling" in line or "error" in line.lower()
        or line.startswith("[nvcc"))))
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> {lib.relative_to(HERE)} "
        f"in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 2: hdencode kernel against its plain version
# ---------------------------------------------------------------------------


def hdencode_inputs(torch, dev, n_bins: int, n_levels: int, B: int, P: int = 64):
    """Random spectra plus the edge rows: all-masked, 2 and 4 valid peaks
    (majority ties wherever the bound HVs differ)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    bins = torch.randint(0, n_bins, (B, P), generator=g, device=dev, dtype=torch.int32)
    levels = torch.randint(0, n_levels, (B, P), generator=g, device=dev,
                           dtype=torch.int32)
    mask = torch.rand((B, P), generator=g, device=dev) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, :2] = True
    mask[2] = False
    mask[2, :4] = True
    return bins, levels, mask


def phase_hdencode_check(torch, cb) -> None:
    from repro_torch.kernels.hdencode import ops, ref
    dev = cb.device
    bins, levels, mask = hdencode_inputs(torch, dev, cb.id_hvs.shape[0],
                                         cb.level_hvs.shape[0], HDENCODE_SPECTRA)
    args = (bins, levels, mask, cb.id_hvs, cb.level_hvs, cb.tiebreak)
    got = ops.hdencode(*args)
    torch.cuda.synchronize()
    want = ref.hdencode(*args)
    require(equal(got, want), "hdencode kernel differs from its plain version")
    require(equal(got[0], cb.tiebreak), "all-masked spectrum is not the tiebreak HV")
    log(f"[check] hdencode kernel == plain on {tuple(bins.shape)} spectra x "
        f"peaks at dim {cb.dim} (all-masked and tie rows included): bit-identical")
    # A word count that is neither a warp nor a block multiple.
    narrow = tuple(t[..., :NARROW_W].contiguous()
                   for t in (cb.id_hvs, cb.level_hvs, cb.tiebreak))
    got = ops.hdencode(bins, levels, mask, *narrow)
    torch.cuda.synchronize()
    require(equal(got, ref.hdencode(bins, levels, mask, *narrow)),
            f"hdencode kernel differs from its plain version at W = {NARROW_W}")
    log(f"[check] hdencode kernel == plain at W = {NARROW_W} words: bit-identical")
    phase_hdencode_edges(torch, cb)


def phase_hdencode_edges(torch, cb) -> None:
    """The bit-sliced counters at their edges: a count of 64 (the top plane
    at P = 64), P from one plane to the general plane path, and B = 1."""
    from repro_torch.kernels.hdencode import ops, ref
    dev = cb.device
    n_bins, n_levels = cb.id_hvs.shape[0], cb.level_hvs.shape[0]
    B = HDENCODE_EDGE_SPECTRA
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    # one bin and one level per spectrum, repeated over all 64 peaks
    same = [torch.randint(0, n, (B, 1), generator=g, device=dev,
                          dtype=torch.int32).expand(B, 64).contiguous()
            for n in (n_bins, n_levels)]
    cases = [("P = 64, every peak valid with one bin and level (count 64)",
              (*same, torch.ones((B, 64), dtype=torch.bool, device=dev)))]
    cases += [(f"P = {P}", hdencode_inputs(torch, dev, n_bins, n_levels, B, P))
              for P in HDENCODE_EDGE_P]
    cases.append(("B = 1, P = 64", tuple(t[3:4].contiguous() for t in hdencode_inputs(
        torch, dev, n_bins, n_levels, 4))))
    for what, (bins, levels, mask) in cases:
        args = (bins, levels, mask, cb.id_hvs, cb.level_hvs, cb.tiebreak)
        got = ops.hdencode(*args)
        torch.cuda.synchronize()
        require(equal(got, ref.hdencode(*args)),
                f"hdencode kernel differs from its plain version at {what}")
        log(f"[check] hdencode kernel == plain at {what} ({tuple(bins.shape)} "
            f"spectra x peaks): bit-identical")


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------


def sorted_batch(torch, pipe, hvs, q_pmz, q_charge):
    """The main path's sorted/padded query layout, its params and start rows."""
    from repro_torch.core import search
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    gather, _ = search.sort_pad_plan(q_pmz, q_charge, params.q_block)
    qh, qp, qc = hvs[gather], q_pmz[gather], q_charge[gather]
    starts = search.block_start_rows(pipe.db, params, qp, qc)
    return params, qh, qp, qc, starts


def phase_main_path(torch, ds, cfg):
    import numpy as np
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.kernels.hamming import ops as fs_ops
    from repro_torch.kernels.hdencode import ops as hd_ops

    hd_ops.launches.reset()
    fs_ops.launches.reset()
    t0 = time.perf_counter()
    pipe = OMSPipeline(cfg, ds.refs, device=DEVICE, chunk_rows=CHUNK_ROWS)
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
    # The same search again: the first call also pays one-time costs (lazy
    # module load of the kernel library on the device, allocator growth).
    t0 = time.perf_counter()
    pipe.search_encoded(hvs, q_pmz, q_charge)
    torch.cuda.synchronize()
    t_search_warm = time.perf_counter() - t0

    Q = ds.queries.mz.shape[0]
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    log(f"[main] ingested {pipe.db.n_rows} rows ({pipe.db.n_blocks} blocks of "
        f"{cfg.max_r}, {2 * pipe.n_targets} spectra) in {t_ingest:.2f}s")
    log(f"[main] encoded {Q} queries in {t_encode:.3f}s; searched in "
        f"{t_search:.3f}s (backend={cfg.backend}, encode_backend="
        f"{cfg.encode_backend}, k_blocks={params.k_blocks}, "
        f"rows/block={params.k_blocks * cfg.max_r}); searched again in "
        f"{t_search_warm:.3f}s ({Q / t_search_warm:.0f} queries/s)")
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
    return pipe, hvs, q_pmz, q_charge, launches, out


def check_blocks(torch, pipe, hvs, q_pmz, q_charge):
    """FUSED_CHECK_BLOCKS evenly spaced query blocks of the main path: the
    search params, the fused-kernel arguments restricted to those blocks,
    and the rows each block scans."""
    import numpy as np
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    QB = params.q_block
    nqb = starts.shape[0]
    pick = np.unique(np.linspace(0, nqb - 1, FUSED_CHECK_BLOCKS).astype(np.int64))
    rows = (pick[:, None] * QB + np.arange(QB)[None, :]).reshape(-1)
    rows_t = torch.from_numpy(rows).to(qh.device)
    db = pipe.db
    args = (qh[rows_t].contiguous(), qp[rows_t].contiguous(), qc[rows_t].contiguous(),
            db.hvs, db.pmz, db.charge,
            starts[torch.from_numpy(pick).to(qh.device)].contiguous())
    return params, args, pick, params.k_blocks * db.max_r


def phase_fused_check(torch, pipe, hvs, q_pmz, q_charge) -> int:
    from repro_torch.kernels.hamming import ops, ref
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    QB = params.q_block
    db = pipe.db
    for k in (1, 4):
        kw = dict(q_block=QB, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        got = ops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        want = ref.fused_search(*args, **kw)
        for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
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
    for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
        require(equal(g, w), f"fused_search kernel differs from plain ({name}, "
                f"W={NARROW_W})")
    log(f"[check] fused_search kernel == plain at W = {NARROW_W} words (scalar "
        f"loads), k=4: bit-identical")
    return len(pick)


FUSED_OUTS = ("std_sim", "std_row", "open_sim", "open_row")


def _fused_pair_check(torch, what, args, kw) -> None:
    """Both fused kernels against their plain versions at every k of
    FUSED_GROUP_KS."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    for k in FUSED_GROUP_KS:
        kk = dict(kw, k=k)
        for name, kern, plain in (("fused_search", hops, href), ("fused_search_mxu", mops, mref)):
            got = kern.fused_search(*args, **kk)
            torch.cuda.synchronize()
            want = plain.fused_search(*args, **kk)
            for out, g, w in zip(FUSED_OUTS, got, want):
                require(equal(g, w), f"{name} kernel differs from plain ({out}, k={k}) "
                        f"on {what}")


def union_stats(starts, rk: int, n_rows: int) -> tuple[float, float]:
    """(mean, max) over the fused kernels' CTA groups of union rows / rk."""
    from repro_torch.kernels.hamming import ops as hops
    span = hops.group_spans(starts, rk, n_rows)
    u = (span[:, 1] - span[:, 0]).double() / rk
    return float(u.mean()), float(u.max())


def phase_fused_groups(torch, pipe, hvs, q_pmz, q_charge) -> None:
    """The grouped fused kernels on runs of consecutive main-path blocks:
    groups of 8 tiles form, the last group of each run is partial, and the
    second run's start rows differ (masks inside a group's union)."""
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
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
        _fused_pair_check(torch, f"blocks {blocks.start}..{blocks.stop - 1}", args, kw)
        u_mean, u_max = union_stats(run_starts, rk, db.n_rows)
        log(f"[check] fused_search and fused_search_mxu kernels == plain on "
            f"{blocks.stop - blocks.start} consecutive main-path blocks "
            f"({blocks.start}..{blocks.stop - 1}) x {rk} rows at k = "
            f"{', '.join(map(str, FUSED_GROUP_KS))}: bit-identical (groups' "
            f"union/rk mean {u_mean:.4f}, max {u_max:.4f})")


def fused_edge_inputs(torch, g, n_rows: int, W: int, starts, rk: int, q_block: int):
    """Seeded synthetic fused-search arguments: rows drawn from 8 HVs (ties),
    ascending pmz with a PAD tail, queries copied from rows of their block's
    range or random, near those rows' pmz (std-window hits), one padded
    query per block."""
    pool = random_words(torch, g, 8, W)
    r = pool[torch.randint(0, 8, (n_rows,), generator=g, device=DEVICE)]
    rp = torch.sort(torch.rand(n_rows, generator=g, device=DEVICE) * 20 + 400).values
    rc = torch.randint(2, 4, (n_rows,), generator=g, device=DEVICE, dtype=torch.int32)
    rp[-6:] = float(torch.finfo(torch.float32).max)
    rc[-6:] = -1
    st = torch.tensor(starts, dtype=torch.int32, device=DEVICE)
    Q = st.shape[0] * q_block
    src = torch.clamp(st.repeat_interleave(q_block).long()
                      + torch.randint(0, rk, (Q,), generator=g, device=DEVICE), max=n_rows - 7)
    q = r[src].clone()
    q[1::3] = random_words(torch, g, q[1::3].shape[0], W)
    qp = rp[src] + (torch.rand(Q, generator=g, device=DEVICE) - 0.5) * 1.2
    qp[::4] = rp[src][::4]
    qc = rc[src].clone()
    qc[q_block - 1::q_block] = -(2 ** 30)
    return (q, qp.contiguous(), qc, r, rp, rc, st)


def phase_fused_edges(torch) -> None:
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    for what, n_rows, W, starts, rk, q_block in FUSED_EDGE_CASES:
        args = fused_edge_inputs(torch, g, n_rows, W, starts, rk, q_block)
        _fused_pair_check(torch, what, args, dict(q_block=q_block, rk=rk, dim=32 * W))
    log(f"[check] fused_search and fused_search_mxu kernels == plain at the grouped "
        f"design's edges ({'; '.join(c[0] for c in FUSED_EDGE_CASES)}) at k = "
        f"{', '.join(map(str, FUSED_GROUP_KS))}, tie-heavy rows: bit-identical")


# ---------------------------------------------------------------------------
# Phase 4: path against path
# ---------------------------------------------------------------------------


def _outputs_equal(a, b) -> bool:
    same = all(equal(getattr(a.result, f), getattr(b.result, f))
               for f in a.result._fields)
    for fa, fb in ((a.open_fdr, b.open_fdr), (a.std_fdr, b.std_fdr)):
        same = same and all(equal(getattr(fa, f), getattr(fb, f))
                            for f in fa._fields)
    return same


def phase_paths(torch, pipe, ds):
    import dataclasses

    import numpy as np
    from repro_torch.core import encode_backends
    from repro_torch.core.pipeline import OMSConfig, OMSPipeline
    from repro_torch.data.spectra import LibraryConfig, SpectraSet, make_dataset

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
    require(_outputs_equal(kern, plain),
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
    small = make_dataset(LibraryConfig(n_refs=1024, n_queries=64, seed=SEED + 1))
    cfg = OMSConfig(dim=1024, bin_size=0.5, max_r=256, top_k=2)
    on_card = OMSPipeline(dataclasses.replace(cfg, backend="fused",
                                              encode_backend="pallas"),
                          small.refs, device=DEVICE)
    on_cpu = OMSPipeline(cfg, small.refs, device="cpu")
    a = on_card.search(small.queries)
    b = on_cpu.search(small.queries)
    same_db = all(equal(getattr(on_card.db, f).cpu(), getattr(on_cpu.db, f))
                  for f in ("hvs", "pmz", "charge", "is_decoy", "orig_idx"))
    a_cpu = type(a)(*(type(x)(*(t.cpu() for t in x)) for x in a))
    require(same_db and _outputs_equal(a_cpu, b),
            "small dataset: card kernels disagree with CPU plain versions")
    hit = np.mean(a.result.open_idx[:, 0].cpu().numpy() == small.query_source)
    log(f"[paths] small dataset (1024 refs, 64 queries, dim 1024, top_k 2): card "
        f"(fused, pallas) == CPU (vpu, word_tiled); open recall@1 {hit:.3f}")


# ---------------------------------------------------------------------------
# Phase 5: times and bounds
# ---------------------------------------------------------------------------


def phase_times(torch, env, pipe, hvs, q_pmz, q_charge, launches, ds):
    from repro_torch.core import encode_backends
    from repro_torch.data.spectra import SpectraSet
    from repro_torch.kernels.hamming import ops as fs_ops
    from repro_torch.kernels.hamming import ref as fs_ref
    from repro_torch.kernels.hdencode import ops as hd_ops
    from repro_torch.kernels.hdencode import ref as hd_ref
    import numpy as np

    from repro_torch.utils import roofline
    card = dict(clock_hz=env["clock_hz"], n_sms=env["n_sms"])
    cb = pipe.codebooks
    W = cb.id_hvs.shape[1]

    # hdencode at its main-path launch shape: one ENCODE_BATCH of library
    # spectra, preprocessed as the ingest does.
    lib = SpectraSet(*(x[:ENCODE_BATCH] for x in ds.refs))
    pre = encode_backends._preprocess(
        *(torch.as_tensor(x, device=DEVICE) for x in lib), pipe.cfg.preprocess_params)
    hd_args = (pre.bins, pre.levels, pre.mask, cb.id_hvs, cb.level_hvs, cb.tiebreak)
    hd_out = hd_ops.hdencode(*hd_args)
    hd_plain = hd_ref.hdencode(*hd_args)
    require(equal(hd_out, hd_plain), "hdencode timing shape: kernel != plain")
    hd_ms = cuda_ms(lambda: hd_ops.hdencode(*hd_args))
    hd_device_ms = graph_ms(lambda: hd_ops.hdencode(*hd_args))
    hd_plain_ms = cuda_ms(lambda: hd_ref.hdencode(*hd_args))
    B, P = pre.bins.shape
    n_valid = int(pre.mask.sum())
    # The least work the function needs (roofline.hdencode_roofline): the
    # bind XOR and bit-sliced counter adds per valid peak word, the
    # majority compare per output word; the peaks, the codebook rows this
    # batch touches, the tiebreak and the output moved once.
    valid_bins = torch.unique(pre.bins[pre.mask]).numel()
    valid_levels = torch.unique(pre.levels[pre.mask]).numel()
    hd_roof = roofline.hdencode_roofline(B, P, W, n_valid, valid_bins + valid_levels,
                                         **card)
    hd_ops_s, hd_bytes_s = hd_roof.t_compute, hd_roof.t_memory
    hd_bound = hd_roof.t_bound * 1e3
    hd_by = hd_roof.bound_by
    # What the kernel gathers: one ID row and one level row per valid peak
    # (served by L2 and L1, not HBM: the touched codebook rows fit in L2).
    hd_gather = 2 * n_valid * W * 4

    # fused_search on the whole main-path batch, kernel and plain version.
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    rk = params.k_blocks * db.max_r
    nqb = starts.shape[0]
    fs_args = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=params.top_k,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fs_ms = cuda_ms(lambda: fs_ops.fused_search(*fs_args, **kw))
    # The plain version materialises a (16, rk, W) tile per block (~20 s a
    # batch): its comparison call is its warm-up, then a few timed runs.
    fs_err = max_abs_err(zip(fs_ops.fused_search(*fs_args, **kw),
                             fs_ref.fused_search(*fs_args, **kw)))
    require(fs_err == 0, "fused_search on the whole main-path batch: kernel != plain")
    fs_plain_ms = cuda_ms(lambda: fs_ref.fused_search(*fs_args, **kw),
                          iters=FUSED_PLAIN_ITERS, warmup=False)
    pairs = qh.shape[0] * rk
    # Operations: the cheapest of three routes to the same Hamming tiles
    # (roofline.hamming_routes: popc, int8 +-1 dot, binary tensor cores);
    # bytes: the rows the blocks cover, the queries, the outputs.
    routes = {name: ops / rate for name, (ops, rate) in roofline.hamming_routes(
        pairs, W, pipe.cfg.dim, **card).items()}
    u_mean, u_max = union_stats(starts, rk, db.n_rows)
    scanned = torch.unique(starts).cpu().numpy()
    covered = np.zeros(db.n_rows, bool)
    for s in scanned:
        covered[s:s + rk] = True
    fs_roof = roofline.fused_roofline(qh.shape[0], rk, int(covered.sum()), W,
                                      pipe.cfg.dim, params.top_k, nqb, **card)
    fs_bytes_s = fs_roof.t_memory
    fs_bound = fs_roof.t_bound * 1e3
    fs_by = fs_roof.bound_by
    fs_route = fs_roof.route if fs_by == "operations" else "HBM"
    log(f"[times] hdencode ({B} x {P} peaks, {n_valid} valid, {valid_bins} bins "
        f"touched, dim {cb.dim}): kernel {hd_ms:.4f} ms (device {hd_device_ms:.4f} ms "
        f"in a graph), plain {hd_plain_ms:.4f} ms, bound {hd_bound:.4f} ms "
        f"({hd_by}; ops {hd_ops_s * 1e3:.4f} ms, bytes "
        f"{hd_bytes_s * 1e3:.4f} ms); gathered ID + level rows {hd_gather / 1e6:.1f} "
        f"MB from L2/L1, {hd_gather / (hd_device_ms * 1e-3) / 1e12:.2f} TB/s of "
        f"device time")
    log(f"[times] fused_search ({qh.shape[0]} queries, {nqb} blocks x {rk} rows, "
        f"{pairs:.4e} pairs; groups' union/rk mean {u_mean:.4f}, max {u_max:.4f}): "
        f"kernel {fs_ms:.3f} ms, plain {fs_plain_ms:.1f} ms (median of "
        f"{FUSED_PLAIN_ITERS}), bound {fs_bound:.3f} ms ({fs_by}, {fs_route}; "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in routes.items())
        + f", bytes {fs_bytes_s * 1e3:.3f} ms)")

    return [
        {"name": "hdencode", "route": "cuda",
         "source": "src/repro_torch/kernels/hdencode/csrc/hdencode.cu",
         "replaces": "src/repro/kernels/hdencode/hdencode.py:46",
         "tpu_kernel": "hdencode_kernel", "launches": launches["hdencode"],
         "bit_identical": True, "max_abs_err": max_abs_err([(hd_out, hd_plain)]),
         "ms": hd_ms, "device_ms": hd_device_ms, "plain_ms": hd_plain_ms,
         "bound_ms": hd_bound, "bound_by": hd_by, "library_ms": None,
         "shape": f"{B}x{P} peaks, dim {cb.dim}", "gather_bytes": hd_gather},
        {"name": "fused_search", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming/csrc/fused_search.cu",
         "replaces": "src/repro/kernels/hamming/hamming.py:102",
         "tpu_kernel": "fused_search_kernel", "launches": launches["fused_search"],
         "bit_identical": True, "max_abs_err": fs_err,
         "ms": fs_ms, "plain_ms": fs_plain_ms, "bound_ms": fs_bound,
         "bound_by": fs_by, "bound_route": fs_route, "library_ms": None,
         "shape": f"{qh.shape[0]} queries x {rk} rows, k={params.top_k}",
         "route_bounds_ms": {k: max(v, fs_bytes_s) * 1e3 for k, v in routes.items()},
         "union_over_rk": {"mean": u_mean, "max": u_max}},
    ]


# ---------------------------------------------------------------------------
# Phase 6: the tile kernels and fused_search_mxu against their plain versions
# ---------------------------------------------------------------------------


def _block_pairs(pipe, params, args, rk):
    """(queries, scanned rows) of every checked main-path block."""
    QB = params.q_block
    qh, starts = args[0], args[6]
    return [(qh[b * QB:(b + 1) * QB], pipe.db.hvs[s:s + rk])
            for b, s in enumerate(starts.tolist())]


def plain_tile(q, r, dim=None):
    """The plain popc tile, row-chunked so that a bucket-sized row set fits
    (its columns are independent)."""
    import torch
    from repro_torch.kernels.hamming import ref as href
    return torch.cat([href.hamming_matrix(q, r[i:i + PLAIN_TILE_ROWS])
                      for i in range(0, r.shape[0], PLAIN_TILE_ROWS)], dim=1)


def random_words(torch, g, n: int, w: int):
    """(n, w) packed words, uniform over all 32-bit patterns."""
    return torch.randint(0, 2 ** 32, (n, w), generator=g, device=DEVICE,
                         dtype=torch.int64).to(torch.int32)


def phase_tile_edges(torch) -> None:
    """hamming_matrix and hamming_mxu (dim 32 * W) at the shapes the main
    path does not give them. The first query and reference row are all
    ones and the second row all zeros, the extremes of |q| and |r|."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    for Q, R, W, off in TILE_EDGE_SHAPES:
        q = random_words(torch, g, Q, W)
        base = random_words(torch, g, R * W + off, 1).reshape(-1)
        r = base[off:].reshape(R, W)
        q[0] = -1
        r[0] = -1
        r[1:2] = 0
        require(r.is_contiguous() and (off == 0 or r.data_ptr() % 16 != 0),
                "tile edge case: the row slice is not where the case needs it")
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * W)
        torch.cuda.synchronize()
        want = plain_tile(q, r)
        where = f"at Q = {Q}, R = {R}, W = {W}, row offset {off} words"
        require(equal(vpu, want), f"hamming_matrix kernel differs from plain {where}")
        require(equal(mxu, want), f"hamming_mxu kernel differs from plain {where}")
    log(f"[check] hamming_matrix and hamming_mxu kernels == plain at (Q, R, W, row "
        f"offset in words) {', '.join(str(c) for c in TILE_EDGE_SHAPES)}: bit-identical")


def phase_tile_check(torch, env, pipe, hvs, q_pmz, q_charge) -> dict:
    import numpy as np
    from repro_torch.core import packing, search
    from repro_torch.utils import roofline
    card = dict(clock_hz=env["clock_hz"], n_sms=env["n_sms"])
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    W = pipe.db.hvs.shape[1]
    for w in (W, *TILE_CHECK_W):
        for q, r in _block_pairs(pipe, params, args, rk):
            q, r = q[:, :w].contiguous(), r[:, :w].contiguous()
            vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * w)
            torch.cuda.synchronize()
            want = href.hamming_matrix(q, r)
            require(equal(vpu, want), f"hamming_matrix kernel differs from plain "
                    f"at W = {w}")
            require(equal(mxu, mref.hamming_matrix(q, r, 32 * w)) and equal(mxu, want),
                    f"hamming_mxu kernel differs from plain at W = {w}")
        log(f"[check] hamming_matrix and hamming_mxu kernels == plain on "
            f"{len(pick)} main-path query blocks ({q.shape[0]} x {r.shape[0]} at "
            f"W = {w}, dim {32 * w}): bit-identical")
    # The seed pass and the survivor rescore score each query block against
    # every real row, gathered in ascending order and padded to the bucket.
    dim = pipe.cfg.dim
    rows = np.flatnonzero(pipe.db.orig_idx.cpu().numpy() >= 0)
    r = search._gather_rows(pipe.db, rows)[0]
    require(r.shape[0] == search.row_bucket(rows.size), "bucket gather shape")
    QB = params.q_block
    for b in np.linspace(0, len(pick) - 1, BUCKET_CHECK_BLOCKS).astype(np.int64):
        q = args[0][b * QB:(b + 1) * QB].contiguous()
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, dim)
        torch.cuda.synchronize()
        want = plain_tile(q, r)
        require(equal(vpu, want), "hamming_matrix kernel differs from plain on "
                "the row bucket")
        require(equal(mxu, want), "hamming_mxu kernel differs from plain on the "
                "row bucket")
        del vpu, mxu, want
    log(f"[check] hamming_matrix and hamming_mxu kernels == plain on "
        f"{BUCKET_CHECK_BLOCKS} main-path query blocks x the cascade's "
        f"{r.shape[0]}-row bucket ({rows.size} real rows gathered) at "
        f"W = {r.shape[1]}: bit-identical")
    # hamming_matrix at the bucket shape, as the seed pass and the survivor
    # rescore launch it; bound: the rows and queries read once, the tile
    # written once.
    Rb, Wb = r.shape
    bucket = {"ms": cuda_ms(lambda: hops.hamming_matrix(q, r)),
              "mxu_ms": cuda_ms(lambda: mops.hamming_matrix(q, r, dim)),
              "bound_ms": roofline.tile_roofline(
                  QB, Rb, Wb, dim, **card).t_bound * 1e3,
              "shape": f"{QB} x {Rb} x {Wb}"}
    # Library yardstick at the bucket shape: one torch._int_mm on +-1 int8
    # operands unpacked beforehand (not timed; B 17.2 GB, unpacked in row
    # chunks, multiplied in one call), A padded to the 32 rows its shape
    # rules want.
    a8 = torch.zeros((32, dim), dtype=torch.int8, device=DEVICE)
    a8[:QB] = packing.packed_to_pm1(q)
    b8 = torch.empty((Rb, dim), dtype=torch.int8, device=DEVICE)
    for i in range(0, Rb, PLAIN_TILE_ROWS):
        b8[i:i + PLAIN_TILE_ROWS] = packing.packed_to_pm1(r[i:i + PLAIN_TILE_ROWS])
    dot = torch._int_mm(a8, b8.t())
    require(equal((dim - dot[:QB]) // 2, mops.hamming_matrix(q, r, dim)),
            "torch._int_mm yardstick != hamming_mxu on the row bucket")
    del dot
    bucket["library_ms"] = cuda_ms(lambda: torch._int_mm(a8, b8.t()))
    del a8, b8
    log(f"[times] at the cascade's bucket shape ({bucket['shape']} words): "
        f"hamming_matrix kernel {bucket['ms']:.4f} ms, hamming_mxu kernel "
        f"{bucket['mxu_ms']:.4f} ms, bound {bucket['bound_ms']:.4f} ms (bytes), "
        f"torch._int_mm {bucket['library_ms']:.4f} ms")
    del r
    for k in (1, 4):
        kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        got = mops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        want = mref.fused_search(*args, **kw)
        for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
            require(equal(g, w), f"fused_search_mxu kernel differs from plain "
                    f"({name}, k={k})")
        log(f"[check] fused_search_mxu kernel == plain on {len(pick)} main-path "
            f"query blocks x {rk} rows at k={k}: bit-identical")
    # A word count that is not a multiple of 4 takes the scalar-load variant.
    db = pipe.db
    narrow = (args[0][:, :NARROW_W].contiguous(), *args[1:3],
              db.hvs[:, :NARROW_W].contiguous(), *args[4:])
    kw = dict(q_block=QB, rk=rk, dim=32 * NARROW_W, k=4,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    got = mops.fused_search(*narrow, **kw)
    torch.cuda.synchronize()
    want = mref.fused_search(*narrow, **kw)
    for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
        require(equal(g, w), f"fused_search_mxu kernel differs from plain "
                f"({name}, W={NARROW_W})")
    log(f"[check] fused_search_mxu kernel == plain at W = {NARROW_W} words "
        f"(dim {32 * NARROW_W}, scalar loads), k=4: bit-identical")
    return bucket


# ---------------------------------------------------------------------------
# Phase 7: fused_search_mxu against fused_search on the whole batch
# ---------------------------------------------------------------------------


def phase_fused_mxu_batch(torch, pipe, hvs, q_pmz, q_charge) -> None:
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    rk = params.k_blocks * db.max_r
    args = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    for k in (1, 4):
        kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        popc, mxu = hops.fused_search(*args, **kw), mops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("std_sim", "std_row", "open_sim", "open_row"), popc, mxu):
            require(equal(a, b), f"fused_mxu differs from fused on the whole "
                    f"batch ({name}, k={k})")
        log(f"[check] fused_search_mxu == fused_search on the whole batch "
            f"({starts.shape[0]} blocks x {rk} rows) at k={k}: all four "
            f"({qh.shape[0]}, {k}) arrays bit-identical")


# ---------------------------------------------------------------------------
# Phase 8: the kernel backends end to end
# ---------------------------------------------------------------------------


def _counters():
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    return {"hamming_matrix": hops.matrix_launches, "hamming_mxu": mops.matrix_launches,
            "fused_search_mxu": mops.launches, "fused_search": hops.launches}


def _counted(torch, fn):
    """Run ``fn`` with every tile/fused launch count set to 0 just before;
    returns (result, seconds to the device's end, counts read just after)."""
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    return out, t, {n: c.count for n, c in counters.items()}


def phase_backends(torch, pipe, hvs, q_pmz, q_charge, fused_out) -> dict:
    Q = hvs.shape[0]
    launches = {}
    for be, kernel in BACKEND_KERNELS.items():
        out, t_first, counts = _counted(
            torch, lambda: pipe.search_encoded(hvs, q_pmz, q_charge, backend=be))
        t0 = time.perf_counter()
        pipe.search_encoded(hvs, q_pmz, q_charge, backend=be)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        require(_outputs_equal(out, fused_out), f"backend {be} differs from fused "
                f"on the full batch")
        require(counts[kernel] > 0, f"backend {be} launched {kernel} "
                f"{counts[kernel]} times")
        launches[kernel] = counts[kernel]
        log(f"[backends] {be}: 6 SearchResult arrays and both FDR results == "
            f"fused on {Q} queries; first {t_first:.3f}s, warm {t_warm:.3f}s "
            f"({Q / t_warm:.0f} queries/s); launches {json.dumps(counts)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the dimension cascade
# ---------------------------------------------------------------------------


def _stats_line(stats, n_real) -> str:
    return (f"seed rows {stats['seed_rows']} (bucket {stats['seed_bucket']}), "
            f"survivors {stats['survivors']} of {n_real} real rows "
            f"({stats['survivors'] / n_real:.4f}; bucket "
            f"{stats['survivor_bucket']}); stages seed {stats['seed_s']:.2f}s, "
            f"prefix {stats['prefix_s']:.2f}s, rescore {stats['rescore_s']:.2f}s")


def _tile_shapes(kernel: str, fn):
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


def phase_cascade(torch, pipe, hvs, q_pmz, q_charge, fused_out) -> None:
    Q = hvs.shape[0]
    n_real = int((pipe.db.orig_idx >= 0).sum())
    for P in CASCADE_PREFIX_WORDS:
        for be, kernel in CASCADE_TILES.items():
            stats = {}
            (out, t, counts), shapes = _tile_shapes(kernel, lambda: _counted(
                torch, lambda: pipe.search_encoded(hvs, q_pmz, q_charge, backend=be,
                                                   prefix_words=P, stats=stats)))
            require(_outputs_equal(out, fused_out), f"cascade prefix_words={P} "
                    f"backend={be} differs from the full-width fused search")
            require(counts[kernel] > 0, f"cascade backend {be} launched {kernel} "
                    f"{counts[kernel]} times")
            log(f"[cascade] prefix_words={P} ({32 * P} bits) backend={be}, exact: "
                f"== full-width fused on {Q} queries in {t:.2f}s; "
                f"{_stats_line(stats, n_real)}; launches {json.dumps(counts)}; "
                f"{kernel} launches by rows x words {json.dumps(shapes)}")


def phase_cascade_margin(torch, pipe, hvs, q_pmz, q_charge) -> None:
    """Margin mode prunes. First the stage-A keep flags of the whole batch,
    from the full scan's exact thresholds, through each kernel tile against
    the plain tile; then margin-mode searches, whose survivors are a strict
    subset, gathered and rescored: every kernel backend must equal a run
    whose prefix and rescore tiles are the plain version."""
    from repro_torch.core import backends, search
    from repro_torch.kernels.hamming import ops as hops
    backends.register(PLAIN_TILE_BACKEND, backends.MATRIX, plain_tile)
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
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
    sub = (hvs[:n], q_pmz[:n], q_charge[:n])
    for P in CASCADE_PREFIX_WORDS:
        margin = (pipe.cfg.dim - 32 * P) // 2
        runs = {}
        for be in (PLAIN_TILE_BACKEND, *CASCADE_TILES):
            stats = {}
            out, t, counts = _counted(torch, lambda: pipe.search_encoded(
                *sub, backend=be, prefix_words=P, prefix_margin=margin,
                stats=stats))
            runs[be] = out, stats
            head = (f"[cascade] prefix_words={P} margin={margin} backend={be} on "
                    f"{n} queries in {t:.2f}s")
            if be == PLAIN_TILE_BACKEND:
                require(stats["survivors"] < n_real, f"margin-mode cascade at "
                        f"prefix_words={P} kept every row: nothing was pruned")
                log(f"{head} (plain tile): {_stats_line(stats, n_real)}")
                continue
            want, want_stats = runs[PLAIN_TILE_BACKEND]
            require(_outputs_equal(out, want) and stats["survivors"]
                    == want_stats["survivors"], f"margin-mode cascade at "
                    f"prefix_words={P} backend={be} differs from the plain tile")
            kernel = CASCADE_TILES[be]
            require(counts[kernel] > 0, f"cascade backend {be} launched {kernel} "
                    f"{counts[kernel]} times")
            log(f"{head}: == plain tile (6 SearchResult arrays, both FDR results, "
                f"survivor count); {_stats_line(stats, n_real)}; launches "
                f"{json.dumps(counts)}")


# ---------------------------------------------------------------------------
# Phase 10: times and bounds of the tile kernels and fused_search_mxu
# ---------------------------------------------------------------------------


def phase_times_mxu(torch, env, pipe, hvs, q_pmz, q_charge, launches,
                    fused_bound, bucket):
    from repro_torch.core import packing
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref

    from repro_torch.utils import roofline
    dim = pipe.cfg.dim
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    q, r = _block_pairs(pipe, params, args, rk)[0]
    Q, W = q.shape
    R = r.shape[0]
    tile = href.hamming_matrix(q, r)
    vpu_ms = cuda_ms(lambda: hops.hamming_matrix(q, r))
    vpu_device_ms = graph_ms(lambda: hops.hamming_matrix(q, r))
    vpu_plain_ms = cuda_ms(lambda: href.hamming_matrix(q, r))
    mxu_ms = cuda_ms(lambda: mops.hamming_matrix(q, r, dim))
    mxu_device_ms = graph_ms(lambda: mops.hamming_matrix(q, r, dim))
    mxu_plain_ms = cuda_ms(lambda: mref.hamming_matrix(q, r, dim))
    # Library yardstick: one int8 GEMM on operands unpacked beforehand
    # (not timed), A padded to the 32 rows its shape rules want.
    a8 = torch.zeros((32, dim), dtype=torch.int8, device=DEVICE)
    a8[:Q] = packing.packed_to_pm1(q)
    b8 = packing.packed_to_pm1(r).t()
    dot = torch._int_mm(a8, b8)
    require(equal((dim - dot[:Q]) // 2, tile), "torch._int_mm yardstick != tile")
    lib_ms = cuda_ms(lambda: torch._int_mm(a8, b8))
    lib_device_ms = graph_ms(lambda: torch._int_mm(a8, b8))
    del a8, b8, dot
    errs = {"hamming_matrix": max_abs_err([(hops.hamming_matrix(q, r), tile)]),
            "hamming_mxu": max_abs_err([(mops.hamming_matrix(q, r, dim), tile)])}
    # The least work for the tile (roofline.tile_roofline): read the rows
    # and queries once, write the tile once; operations by the cheaper route
    # (int8 +-1 dot or popc).
    t_roof = roofline.tile_roofline(Q, R, W, dim, clock_hz=env["clock_hz"],
                                    n_sms=env["n_sms"])
    t_bytes, t_ops = t_roof.t_memory, t_roof.t_compute
    t_bound = t_roof.t_bound * 1e3
    t_by = t_roof.bound_by

    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    fargs = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    kw = dict(q_block=params.q_block, rk=rk, dim=dim, k=params.top_k,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fm_ms = cuda_ms(lambda: mops.fused_search(*fargs, **kw))
    fm_out = mops.fused_search(*fargs, **kw)
    # The plain version on the whole batch runs once: timed and compared.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fm_plain = mref.fused_search(*fargs, **kw)
    end.record()
    torch.cuda.synchronize()
    fm_plain_ms = start.elapsed_time(end)
    fm_err = max_abs_err(zip(fm_out, fm_plain))
    require(fm_err == 0, "fused_search_mxu on the whole batch: kernel != plain")
    log(f"[times] hamming_matrix ({Q} x {R} x {W} words, one main-path block): "
        f"kernel {vpu_ms:.4f} ms (device {vpu_device_ms:.4f} ms in a graph), plain "
        f"{vpu_plain_ms:.3f} ms, bound {t_bound:.4f} ms ({t_by}; bytes "
        f"{t_bytes * 1e3:.4f} ms, ops {t_ops * 1e3:.4f} ms), torch._int_mm "
        f"{lib_ms:.4f} ms (device {lib_device_ms:.4f} ms)")
    log(f"[times] hamming_mxu (same block): kernel {mxu_ms:.4f} ms (device "
        f"{mxu_device_ms:.4f} ms), plain {mxu_plain_ms:.3f} ms, bound {t_bound:.4f} ms "
        f"({t_by})")
    log(f"[times] fused_search_mxu ({qh.shape[0]} queries, {starts.shape[0]} blocks "
        f"x {rk} rows, k={params.top_k}): kernel {fm_ms:.3f} ms, plain "
        f"{fm_plain_ms:.1f} ms (one run, compared bit for bit), bound "
        f"{fused_bound['bound_ms']:.3f} ms ({fused_bound['bound_by']}, "
        f"{fused_bound['bound_route']})")
    tile_shape = f"{Q} queries x {R} rows x {W} words (one main-path block)"
    return [
        {"name": "hamming_matrix", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming/csrc/hamming_matrix.cu",
         "replaces": "src/repro/kernels/hamming/hamming.py:67",
         "tpu_kernel": "hamming_matrix_kernel",
         "launches": launches["hamming_matrix"], "bit_identical": True,
         "max_abs_err": errs["hamming_matrix"], "ms": vpu_ms,
         "device_ms": vpu_device_ms, "plain_ms": vpu_plain_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": lib_ms, "library_device_ms": lib_device_ms,
         "shape": tile_shape,
         "bucket_ms": bucket["ms"], "bucket_bound_ms": bucket["bound_ms"],
         "bucket_library_ms": bucket["library_ms"], "bucket_shape": bucket["shape"]},
        {"name": "hamming_mxu", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming_mxu/csrc/hamming_mxu.cu",
         "replaces": "src/repro/kernels/hamming_mxu/hamming_mxu.py:60",
         "tpu_kernel": "hamming_mxu_kernel",
         "launches": launches["hamming_mxu"], "bit_identical": True,
         "max_abs_err": errs["hamming_mxu"], "ms": mxu_ms,
         "device_ms": mxu_device_ms, "plain_ms": mxu_plain_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": lib_ms, "library_device_ms": lib_device_ms,
         "shape": tile_shape,
         "bucket_ms": bucket["mxu_ms"], "bucket_bound_ms": bucket["bound_ms"],
         "bucket_library_ms": bucket["library_ms"], "bucket_shape": bucket["shape"]},
        {"name": "fused_search_mxu", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming_mxu/csrc/fused_search_mxu.cu",
         "replaces": "src/repro/kernels/hamming_mxu/hamming_mxu.py:99",
         "tpu_kernel": "fused_search_mxu_kernel",
         "launches": launches["fused_search_mxu"], "bit_identical": True,
         "max_abs_err": fm_err, "ms": fm_ms, "plain_ms": fm_plain_ms,
         "bound_ms": fused_bound["bound_ms"], "bound_by": fused_bound["bound_by"],
         "bound_route": fused_bound["bound_route"], "library_ms": None,
         "shape": f"{qh.shape[0]} queries x {rk} rows, k={params.top_k}"},
    ]


# ---------------------------------------------------------------------------
# Phase 11: top_k above 16, and the launch limits
# ---------------------------------------------------------------------------


def require_raises(fn, match: str, what: str) -> None:
    """``fn()`` must raise ValueError whose message contains ``match``."""
    try:
        fn()
    except ValueError as e:
        require(match in str(e), f"{what}: raised {e!r}, expected {match!r}")
        log(f"[limits] {what}: raises ValueError({str(e)!r})")
        return
    fail(f"{what}: did not raise")


def _plain_pair(torch, name, kern, plain, args, kw, what) -> None:
    got = kern.fused_search(*args, **kw)
    torch.cuda.synchronize()
    want = plain.fused_search(*args, **kw)
    for out, g, w in zip(FUSED_OUTS, got, want):
        require(equal(g, w), f"{name} kernel differs from plain ({out}) {what}")


def phase_topk(torch, pipe, hvs, q_pmz, q_charge) -> dict:
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    kernels = (("fused_search", hops, href), ("fused_search_mxu", mops, mref))
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    base = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim,
                ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    for k in TOPK_CHECK_KS:
        for name, kern, plain in kernels:
            _plain_pair(torch, name, kern, plain, args, dict(base, k=k),
                        f"at k={k} on the main-path check blocks")
        log(f"[topk] fused_search and fused_search_mxu kernels == plain on "
            f"{len(pick)} main-path query blocks x {rk} rows at k={k}: bit-identical")
    # Times on the whole batch: k <= 16 is the old path; above, the lists
    # grow and G falls to 1 where a CTA's shared memory no longer fits 8.
    _, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    fargs = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    times = {}
    for name, kern, _ in kernels:
        scratch = mops.FUSED_SCRATCH_PER_TILE if kern is mops else 0
        for k in TOPK_TIME_KS:
            g = (hops.GROUP if hops.fused_smem_bytes(hops.GROUP, db.n_words, k, scratch)
                 <= hops.FUSED_SMEM_BUDGET else 1)
            ms = cuda_ms(lambda: kern.fused_search(*fargs, **dict(base, k=k)), iters=3)
            times[f"{name} k={k}"] = ms
            log(f"[topk] {name} on the whole batch ({starts.shape[0]} blocks x {rk} "
                f"rows) at k={k}: {ms:.3f} ms ({g} query tiles per CTA)")
    phase_limits(torch, kernels)
    return times


def phase_limits(torch, kernels) -> None:
    """The widened limits against the plain versions; the remaining ones
    raise their stated errors."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    # fused_search_mxu past its old 256 words; both at their widest W (k=1).
    for name, kern, plain, cases in (
            ("fused_search_mxu", mops, kernels[1][2], ((300, 4), (2416, 1))),
            ("fused_search", hops, kernels[0][2], ((2480, 1),))):
        for W, k in cases:
            args = fused_edge_inputs(torch, g, 600, W, (0, 40, 300), 256, 16)
            _plain_pair(torch, name, kern, plain, args,
                        dict(q_block=16, rk=256, dim=32 * W, k=k), f"at W={W}")
            log(f"[limits] {name} kernel == plain at W = {W} words, k={k} "
                f"(3 blocks x 256 rows): bit-identical")
    # Remaining limits: k > K_MAX; W past the shared-memory bound.
    args = fused_edge_inputs(torch, g, 600, 8, (0,), 256, 16)
    for name, kern, _ in kernels:
        require_raises(lambda: kern.fused_search(*args, q_block=16, rk=256, dim=256,
                                                 k=hops.K_MAX + 1),
                       f"keeps 1..{hops.K_MAX} winners", f"{name} at k={hops.K_MAX + 1}")
    for name, kern, W in (("fused_search", hops, 2496), ("fused_search_mxu", mops, 2432)):
        wide = fused_edge_inputs(torch, g, 64, W, (0,), 64, 16)
        require_raises(lambda: kern.fused_search(*wide, q_block=16, rk=64, dim=32 * W, k=1),
                       "of shared memory", f"{name} at W={W}")
    # The tile kernels past 65,535 query tiles (two launches each) and
    # hamming_matrix past its 3,632 staged words (word chunks, summed).
    for Q, R, W in ((hops.TILE_Q_CHUNK + 17, 9, 1), (16, 1000, 4000)):
        q, r = random_words(torch, g, Q, W), random_words(torch, g, R, W)
        counters = _counters()
        before = (counters["hamming_matrix"].count, counters["hamming_mxu"].count)
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * W)
        torch.cuda.synchronize()
        want = href.hamming_matrix(q, r)
        require(equal(vpu, want), f"hamming_matrix differs from plain at Q={Q}, W={W}")
        require(equal(mxu, want), f"hamming_mxu differs from plain at Q={Q}, W={W}")
        n = (counters["hamming_matrix"].count - before[0],
             counters["hamming_mxu"].count - before[1])
        log(f"[limits] hamming_matrix and hamming_mxu == plain at Q = {Q}, R = {R}, "
            f"W = {W} (launches {n[0]} / {n[1]}): bit-identical")
        del q, r, vpu, mxu, want
    # The grouped launch past 65,535 groups of 8 tiles: kernels on the
    # whole batch, plain versions on the blocks around the launch boundary.
    nqb = GRID_Y_MAX * hops.GROUP + 17
    n_rows, rk = 2048, 256
    starts = torch.sort(torch.randint(0, n_rows - rk, (nqb,), generator=g,
                                      device=DEVICE, dtype=torch.int32)).values
    q, qp, qc, r, rp, rc, st = fused_edge_inputs(torch, g, n_rows, 1, (0,), rk, 16)
    src = torch.clamp(starts.repeat_interleave(16).long()
                      + torch.randint(0, rk, (nqb * 16,), generator=g, device=DEVICE),
                      max=n_rows - 7)
    q = r[src].contiguous()
    qp = (rp[src] + 0.3).contiguous()
    qc = rc[src].contiguous()
    kw = dict(q_block=16, rk=rk, dim=32, k=2)
    b0 = GRID_Y_MAX * hops.GROUP - 10
    sub = slice(b0 * 16, nqb * 16)
    for name, kern, plain in kernels:
        got = kern.fused_search(q, qp, qc, r, rp, rc, starts, **kw)
        torch.cuda.synchronize()
        want = plain.fused_search(q[sub], qp[sub], qc[sub], r, rp, rc,
                                  starts[b0:].contiguous(), **kw)
        for out, a, b in zip(FUSED_OUTS, got, want):
            require(equal(a[sub], b), f"{name} past {GRID_Y_MAX} groups differs from "
                    f"plain ({out})")
    log(f"[limits] fused_search and fused_search_mxu on {nqb} query blocks "
        f"({-(-nqb // hops.GROUP)} groups of {hops.GROUP} tiles) == plain on the "
        f"{nqb - b0} blocks around the launch boundary: bit-identical")


# ---------------------------------------------------------------------------
# Phase 12: the store
# ---------------------------------------------------------------------------


DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")


def db_nbytes(db) -> int:
    return sum(getattr(db, f).numel() * getattr(db, f).element_size() for f in DB_FIELDS)


def phase_store(torch, ds, cfg, pipe, hvs, q_pmz, q_charge, out):
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.kernels.hdencode import ops as hd_ops
    STORE_DIR.parent.mkdir(parents=True, exist_ok=True)
    need = pipe.db.n_rows * (4 * cfg.n_words + 13)
    free = shutil.disk_usage(STORE_DIR.parent).free
    log(f"[store] free space at {STORE_DIR.parent}: "
        f"{free / 1e9:.2f} GB; the store needs ~{need / 1e9:.2f} GB")
    require(free > 2 * need, f"not enough free disk for the store: {free} bytes "
            f"free, {2 * need} wanted")
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    hd_ops.launches.reset()
    t0 = time.perf_counter()
    store = OMSPipeline.ingest(cfg, ds.refs, str(STORE_DIR), device=DEVICE,
                               chunk_rows=CHUNK_ROWS)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    n_hd = hd_ops.launches.count
    require(n_hd > 0, "the store ingest launched no hdencode kernel")
    t0 = time.perf_counter()
    spipe = OMSPipeline.from_store(store, cfg, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    for f in DB_FIELDS:
        require(equal(getattr(spipe.db, f), getattr(pipe.db, f)),
                f"store-loaded DB differs from the in-memory one ({f})")
    sout, t_search, counts = _counted(torch, lambda: spipe.search_encoded(hvs, q_pmz, q_charge))
    require(_outputs_equal(sout, out), "store-loaded fused search differs from phase 3")
    require(counts["fused_search"] > 0, "store-loaded search launched no fused_search")
    log(f"[store] ingest of {store.n_targets} spectra + decoys into {len(store.shards)} "
        f"shards, {store.nbytes() / 1e9:.3f} GB, in {t_ingest:.2f}s ({n_hd} hdencode "
        f"launches); from_store(resident=True) in {t_load:.2f}s: DB == in-memory DB in "
        f"all 8 fields; fused search == phase 3 (6 arrays, both FDRs) in "
        f"{t_search:.3f}s")
    del spipe, sout
    return store, {"hdencode": n_hd, "fused_search": counts["fused_search"]}


# ---------------------------------------------------------------------------
# Phase 13: streamed search
# ---------------------------------------------------------------------------


def _slab_line(stats) -> str:
    rows = stats["slabs"]
    g = [r["gather_s"] for r in rows]
    u = [r["upload_ms"] for r in rows]
    k = [r["search_ms"] for r in rows]
    return (f"per slab: host gather mean {statistics.mean(g):.4f} s (max {max(g):.4f}, "
            f"sum {sum(g):.3f}), upload mean {statistics.mean(u):.3f} ms, search "
            f"(kernel + merge) mean {statistics.mean(k):.3f} ms (sum {sum(k) / 1e3:.3f} s)")


def phase_streamed(torch, store, cfg, pipe, hvs, q_pmz, q_charge, out):
    from repro_torch.core.pipeline import OMSPipeline
    db_bytes = db_nbytes(pipe.db)
    launches, first = [], None
    for slab_rows in STREAM_SLAB_ROWS:
        t0 = time.perf_counter()
        spipe = OMSPipeline.from_store(store, cfg, device=DEVICE, resident=False,
                                       slab_rows=slab_rows)
        t_open = time.perf_counter() - t0
        plan = spipe.engine.plan
        # Baseline before this pipeline's first search: the peaks below
        # include the slab buffers the engine keeps between searches.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for be, kernel in STREAM_KERNELS.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res, t_first, counts = _counted(torch, lambda: spipe.search_encoded(
                hvs, q_pmz, q_charge, backend=be))
            peak = torch.cuda.max_memory_allocated() - base
            st = spipe.engine.last_stats
            require(_outputs_equal(res, out), f"streamed {be} at {plan.slab_rows} rows a "
                    f"slab differs from the resident fused result")
            require(counts[kernel] == st.n_scanned > 0, f"streamed {be}: {counts[kernel]} "
                    f"{kernel} launches for {st.n_scanned} slabs")
            stats = {}
            t0 = time.perf_counter()
            spipe.search_encoded(hvs, q_pmz, q_charge, backend=be, stats=stats)
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            launches.append((kernel, f"streamed {be}, {plan.slab_blocks} blocks a slab",
                             counts[kernel]))
            log(f"[stream] {be}, {plan.slab_rows} rows a slab ({plan.slab_blocks} blocks, "
                f"{plan.n_slabs} slabs; layout in {t_open:.2f}s): == resident fused (6 "
                f"arrays, both FDRs); slabs touched {st.n_scanned}/{st.n_slabs}, rows read "
                f"{st.scanned_rows}, bytes {st.scanned_bytes}; first {t_first:.3f}s, warm "
                f"{t_warm:.3f}s; {_slab_line(stats)}; peak device memory above the "
                f"baseline {peak / 2**30:.3f} GiB (resident DB {db_bytes / 2**30:.3f} GiB); "
                f"launches {json.dumps(counts)}")
        if first is None:
            first = spipe
        else:
            del spipe
    return first, launches


# ---------------------------------------------------------------------------
# Phases 14-15: the streamed dimension cascade; the narrow→open cascade
# ---------------------------------------------------------------------------


def phase_streamed_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge, out) -> dict:
    P = STREAM_CASCADE_PREFIX
    resident, t_res, _ = _counted(torch, lambda: pipe.search_encoded(
        hvs, q_pmz, q_charge, prefix_words=P))
    res, t, counts = _counted(torch, lambda: spipe.search_encoded(
        hvs, q_pmz, q_charge, prefix_words=P))
    require(_outputs_equal(res, resident) and _outputs_equal(res, out),
            f"streamed cascade prefix_words={P} differs from the resident cascade")
    require(counts["hamming_matrix"] > 0, "streamed cascade launched no hamming_matrix")
    st = spipe.engine.last_stats
    log(f"[stream] exact cascade prefix_words={P}, fused, {spipe.engine.plan.slab_rows} "
        f"rows a slab: == resident cascade ({t_res:.2f}s) and phase 3's result (6 "
        f"arrays, both FDRs) in {t:.2f}s; slabs "
        f"{st.n_scanned}/{st.n_slabs}, rows read {st.scanned_rows}, bytes "
        f"{st.scanned_bytes}; launches {json.dumps(counts)}")
    return {"hamming_matrix": counts["hamming_matrix"]}


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


def phase_narrow_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge, out) -> dict:
    Q = hvs.shape[0]
    outs, launches = {}, {}
    pure = pipe.pure_open_scanned_rows(Q, q_pmz, q_charge)
    for name, p in (("resident", pipe), ("streamed", spipe)):
        (cout, t, counts), times = _timed_stages(torch, p, lambda: _counted(
            torch, lambda: p.search_cascade_encoded(hvs, q_pmz, q_charge,
                                                    narrow_tol_da=NARROW_TOL_DA)))
        require(counts["fused_search"] > 0, f"{name} cascade launched no fused_search")
        require(cout.stage1 is not None and cout.stage2 is not None
                and cout.identified_stage1.any(),
                f"{name} cascade: stage 1 identified nothing or everything")
        outs[name] = cout
        launches[f"narrow→open cascade, {name}"] = counts["fused_search"]
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
        require(all(equal(getattr(c0.result, f), getattr(out.result, f))
                    for f in out.result._fields)
                and all(equal(getattr(c0.std_fdr, f), getattr(out.std_fdr, f))
                        for f in out.std_fdr._fields),
                f"{name} cascade with run_stage1=False differs from search_encoded")
    require(_cascades_equal(outs["resident"], outs["streamed"]),
            "streamed narrow→open cascade differs from the resident one")
    log("[narrow] streamed cascade == resident cascade (merged result, both FDRs, "
        "stage-1 identified, stage queries and results); run_stage1=False == "
        "search_encoded on both paths")
    return launches

# ---------------------------------------------------------------------------
# Phase 16: the launcher on the card
# ---------------------------------------------------------------------------


def oms_cli(args, what: str, *, stdin=None, stdout=None):
    """Run ``python -m repro_torch.launch.oms *args`` from the repository
    root (stdin / stdout from / to the given paths, else none / captured);
    fails unless it exits 0. Returns (stdout text, stderr text, seconds)."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.oms", *map(str, args)]
    env = {**os.environ, "PYTHONPATH": str(HERE / "src")}
    fin = open(stdin) if stdin else None
    fout = open(stdout, "w") if stdout else None
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=HERE, env=env,
                             stdin=fin or subprocess.DEVNULL,
                             stdout=fout or subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"{what}: `oms {' '.join(cmd[3:])}` ran past {CLI_TIMEOUT_S} s")
    finally:
        for f in (fin, fout):
            if f is not None:
                f.close()
    dt = time.perf_counter() - t0
    require(res.returncode == 0, f"{what}: `oms {' '.join(cmd[3:])}` exited "
            f"{res.returncode}: {res.stderr[-3000:]}")
    return res.stdout or "", res.stderr, dt


class FirstRead:
    """The lines of ``lines``; ``start()`` runs just before the first is
    read, which ``serve`` does once its store is loaded."""

    def __init__(self, lines, start):
        self.lines, self.start = lines, start

    def __iter__(self):
        self.start()
        yield from self.lines


def serve_profiler(torch):
    """A torch.profiler that records device activity only (CUPTI); the
    host work of the serve threads is not instrumented."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_profile(prof, wall_s: float) -> dict:
    """The device's busy time (the union of kernel, copy and set
    intervals) over ``wall_s``, and each serve kernel's launches and
    device milliseconds, from ``prof``'s trace."""
    prof.export_chrome_trace(str(SERVE_PROFILE))
    try:
        events = [e for e in json.loads(SERVE_PROFILE.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS]
    finally:
        SERVE_PROFILE.unlink(missing_ok=True)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernels = {k: [0, 0.0] for k in SERVE_KERNELS}
    for e in events:
        for k, names in SERVE_KERNELS.items():
            if e["cat"] == "kernel" and any(n in e["name"] for n in names):
                kernels[k][0] += 1
                kernels[k][1] += e["dur"] / 1e3
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
            "copy_ms": sum(e["dur"] for e in events if e["cat"] == "gpu_memcpy") / 1e3,
            "n_events": len(events), "kernels": kernels}


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
    counters = {**_counters(), "hdencode": hd_ops.launches}
    out, err = io.StringIO(), io.StringIO()
    prof, started = (serve_profiler(torch) if profile else None), []

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
            device_profile(prof, wall) if started else None)


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
        deadline = time.monotonic() + CLI_TIMEOUT_S
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


def _serve_line(name: str, st: dict, t: float, counts: dict) -> str:
    used = {k: v for k, v in counts.items() if v}
    return (f"[cli] serve {name}: answered {int(st['answered'])} in {st['s']:.2f}s "
            f"({int(st['qps'])} q/s; process {t:.1f}s), {int(st['batches'])} "
            f"micro-batches ({st['qpb']:.1f} q/batch), wait p50/p99 "
            f"{st['wait50']:.2f}/{st['wait99']:.2f} ms, e2e p50/p99 "
            f"{st['e2e50']:.2f}/{st['e2e99']:.2f} ms; launches (in-process run) "
            f"{json.dumps(used)}")


def phase_launcher(torch, lib_cfg, cfg, pipe, hvs, q_pmz, q_charge, out, ds,
                   before_reload=None) -> dict:
    """Phase 16: build, search, queries, serve (resident, streamed, cached,
    cascade) and trace-report through ``python -m repro_torch.launch.oms``.
    ``before_reload(search args, search stdout, serve args, resident serve
    lines, head requests file)`` runs before the hot reload grows the store
    and returns {kernel: {path: launches}} of its own. Returns {kernel:
    {path: launches}} of the in-process serve runs."""
    import os
    from repro_torch.data.spectra import LibraryConfig
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hdencode import ops as hd_ops
    t_phase = time.perf_counter()
    Q = lib_cfg.n_queries
    require(lib_cfg == LibraryConfig(n_refs=lib_cfg.n_refs, n_queries=Q,
                                     open_tol_da=75.0, seed=SEED),
            "the launcher's --refs/--queries/--seed do not give phase 3's dataset")
    data = ["--refs", lib_cfg.n_refs, "--seed", SEED]
    dev = ["--device", DEVICE]
    names = sorted(os.listdir(STORE_DIR))
    need = sum((STORE_DIR / n).stat().st_size for n in names)
    free = shutil.disk_usage(STORE_DIR.parent).free
    log(f"[cli] free space at {STORE_DIR.parent}: {free / 1e9:.2f} GB; a second "
        f"store needs {need / 1e9:.2f} GB")
    require(free > 2 * need, f"not enough free disk for the launcher's store: "
            f"{free} bytes free, {2 * need} wanted")

    # 1. build: the same store as phase 12, byte for byte
    shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)
    try:
        o, _, t = oms_cli(["build", "--store", CLI_STORE_DIR, *data,
                           "--encode-backend", "pallas", "--encode-batch",
                           ENCODE_BATCH, "--chunk-rows", CHUNK_ROWS, *dev], "build")
        require(sorted(os.listdir(CLI_STORE_DIR)) == names,
                "the launcher's store has other files than phase 12's")
        for n in names:
            require(same_bytes(STORE_DIR / n, CLI_STORE_DIR / n),
                    f"the launcher's {n} differs from phase 12's")
        log(f"[cli] build (process {t:.1f}s): {o.strip().splitlines()[-1]}; "
            f"{len(names)} files byte-identical to phase 12's store")
    finally:
        shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)

    # 2. search, plain and cascade: phase 3's and phase 15's lines
    search = ["search", "--store", STORE_DIR, "--queries", Q, "--seed", SEED,
              "--backend", "fused", "--encode-backend", "pallas",
              "--encode-batch", ENCODE_BATCH, "--max-r", cfg.max_r, *dev]
    o, _, t = oms_cli(search, "search")
    search_out = o
    lines = o.splitlines()
    expect = result_lines(out, ds, cfg, Q)
    for want in expect:
        require(want in lines, f"search printed no line {want!r}:\n{o}")
    split = [x for x in lines if "stage split" in x or "searched" in x]
    log(f"[cli] search (process {t:.1f}s): recall@1 and identification lines == "
        f"phase 3's ({' | '.join(x[6:] for x in expect)}); {' | '.join(split)}")
    casc = pipe.search_cascade_encoded(hvs, q_pmz, q_charge, narrow_tol_da=NARROW_TOL_DA)
    n_id = int(casc.identified_stage1.sum())
    o, _, t = oms_cli([*search, "--cascade", "--narrow-tol-da", NARROW_TOL_DA],
                      "search --cascade")
    lines = o.splitlines()
    cl = [x for x in lines if x.startswith("[oms] cascade:")]
    require(len(cl) == 1 and f"stage1 identified {n_id}/{Q} ({NARROW_TOL_DA} Da)"
            in cl[0], f"search --cascade: stage 1 did not identify {n_id}:\n{o}")
    for want in result_lines(casc, ds, cfg, Q):
        require(want in lines, f"search --cascade printed no line {want!r}:\n{o}")
    split = [x for x in lines if "stage split" in x]
    log(f"[cli] search --cascade (process {t:.1f}s): {cl[0][6:]}; recall and "
        f"identification lines == the in-process cascade's; {' | '.join(split)}")

    # 3. queries
    _, _, t = oms_cli(["queries", "--queries", Q, *data], "queries", stdout=REQUESTS_FILE)
    reqs = REQUESTS_FILE.read_text().splitlines(keepends=True)
    require(len(reqs) == Q, f"queries wrote {len(reqs)} lines for {Q} queries")
    for i in (0, Q // 2, Q - 1):
        r = json.loads(reqs[i])
        require(r["id"] == i and r["pmz"] == float(ds.queries.pmz[i])
                and r["charge"] == int(ds.queries.charge[i]),
                f"request {i} is not phase 3's query {i}")
    log(f"[cli] queries (process {t:.1f}s): {Q} requests, "
        f"{REQUESTS_FILE.stat().st_size / 1e6:.1f} MB")
    head_file = REQUESTS_FILE.with_name("smoke_requests_head.jsonl")
    head_file.write_text("".join(reqs[:STREAM_SERVE_REQUESTS]))
    twice_file = REQUESTS_FILE.with_name("smoke_requests_twice.jsonl")
    twice_file.write_text("".join(reqs[:CACHE_REQUESTS]) * 2)
    in_process_file = REQUESTS_FILE.with_name("smoke_requests_in_process.jsonl")
    in_process_file.write_text("".join(reqs[:IN_PROCESS_REQUESTS]))

    serve = ["serve", "--store", STORE_DIR, "--backend", "fused", "--encode-backend",
             "pallas", "--max-r", cfg.max_r, *dev]
    by_path = {"hdencode": {}, "fused_search": {}}
    stats = {}

    def run_serve(name, label, args, stdin, cli_only=(), in_process=None):
        """The subprocess (with ``cli_only`` added) on ``stdin``, then the
        profiled in-process run on ``in_process`` (default: ``stdin``),
        which reads the launch counts and must answer as the subprocess
        did for the same requests."""
        o, e, t = oms_cli([*serve, *args, *cli_only], f"serve {name}", stdin=stdin)
        lines = o.splitlines(keepends=True)
        src = in_process or stdin
        with open(src) as fin:
            n_in = sum(1 for _ in fin)
        with open(src) as fin:
            o2, e2, counts, _, prof = oms_in_process([*serve, *args], fin,
                                                     profile=True)
        require(o2.splitlines(keepends=True) == lines[:n_in] and len(lines) >= n_in,
                f"serve {name}: the in-process run answered otherwise")
        st = serve_stats(e)
        stats[name] = st
        log(_serve_line(name, st, t, counts))
        log(_profile_line(name, prof, int(serve_stats(e2)["batches"])))
        for k in by_path:
            require(counts[k] > 0, f"serve {name} launched no {k}")
            by_path[k][f"serve {label} ({n_in:,} requests, in process)"] = counts[k]
        return lines, st

    # 4. resident, every request: phase 3's rows; one micro-batch's kernel
    # calls kept from the in-process run and replayed
    with LargestCall(hd_ops, "hdencode") as hd, LargestCall(hops, "fused_search") as fs:
        res_lines, st4 = run_serve(
            "resident", "resident", ["--resident", "--no-result-cache"],
            REQUESTS_FILE, cli_only=["--trace", SERVE_TRACE, "--metrics", "-"],
            in_process=in_process_file)
    hd_ms, hd_dev, fs_ms = cuda_ms(hd.replay), graph_ms(hd.replay), cuda_ms(fs.replay)
    log(f"[cli] one resident micro-batch's kernel calls replayed at their serve "
        f"shapes (CUDA events, median of {TIMING_ITERS}): hdencode "
        f"{tuple(hd.args[0].shape)} peaks {hd_ms:.4f} ms (device {hd_dev:.4f} ms in "
        f"a graph), fused_search {fs.rows} padded queries x {fs.args[6].shape[0]} "
        f"blocks x {fs.kw['rk']} rows {fs_ms:.4f} ms")
    require(len(res_lines) == Q and int(st4["answered"]) == Q,
            "serve resident did not answer every request")
    for i, (line, want) in enumerate(zip(res_lines, payloads_of(out.result))):
        if json.loads(line) != {"id": i, **want}:
            fail(f"serve resident: response {i} differs from phase 3's row: {line}")
    log(f"[cli] serve resident: all {Q} responses == phase 3's result rows")

    # 5. streamed, the first requests: byte-identical to run 4's
    head = "".join(res_lines[:STREAM_SERVE_REQUESTS])
    st_lines, st5 = run_serve(
        "streamed", f"streamed {STREAM_SERVE_SLAB_ROWS} rows a slab",
        ["--slab-rows", STREAM_SERVE_SLAB_ROWS, "--max-batch", STREAM_SERVE_BATCH,
         "--no-result-cache"], head_file, cli_only=["--trace", STREAM_TRACE])
    require("".join(st_lines) == head, "serve streamed differs from serve resident")
    log(f"[cli] serve streamed: {STREAM_SERVE_REQUESTS} responses byte-identical to "
        f"serve resident; {st5['slabs']} slabs scanned")

    # 6. the result cache: the first requests twice, the second copy all hits
    c_lines, st6 = run_serve(
        "cached", "resident cached",
        ["--resident"], twice_file)
    require("".join(c_lines) == "".join(res_lines[:CACHE_REQUESTS]) * 2,
            "serve with the result cache differs from serve without it")
    require(st6["cache"] == (CACHE_REQUESTS, 2 * CACHE_REQUESTS),
            f"result cache hits {st6['cache']}, want {CACHE_REQUESTS} of "
            f"{2 * CACHE_REQUESTS}")
    log(f"[cli] serve cached: byte-identical to the uncached lines; cache "
        f"{st6['cache'][0]}/{st6['cache'][1]} hits")

    # 7. the cascade, per query: single-query in-process cascades on a sample
    k_lines, _ = run_serve(
        "cascade", "resident cascade",
        ["--resident", "--cascade", "--narrow-tol-da", NARROW_TOL_DA,
         "--no-result-cache"], REQUESTS_FILE, in_process=in_process_file)
    require(len(k_lines) == Q, "serve --cascade did not answer every request")
    sample = sorted({int(i) for i in torch.linspace(0, Q - 1, CASCADE_SAMPLE).round()})
    for i in sample:
        c = pipe.search_cascade_encoded(hvs[i:i + 1], q_pmz[i:i + 1], q_charge[i:i + 1],
                                        narrow_tol_da=NARROW_TOL_DA,
                                        stage1_per_query=True)
        want = {"id": i, **payloads_of(c.result)[0]}
        require(json.loads(k_lines[i]) == want, f"serve --cascade response {i} "
                f"differs from a single-query cascade: {k_lines[i]} vs {want}")
    log(f"[cli] serve cascade: {len(sample)} sampled responses == single-query "
        f"in-process cascades (stage1_per_query)")

    # 8. trace-report on both serve traces
    o, _, _ = oms_cli(["trace-report", "--json", SERVE_TRACE], "trace-report")
    roll = json.loads(o)
    require(roll.get("serve.batch", {}).get("count") == int(st4["batches"]),
            f"trace: {roll.get('serve.batch')} serve.batch spans for "
            f"{int(st4['batches'])} micro-batches")
    missing = {"pipeline.encode", "pipeline.plan", "pipeline.scan",
               "pipeline.fdr"} - set(roll)
    require(not missing, f"the serve trace has no {sorted(missing)} spans")
    o, _, _ = oms_cli(["trace-report", "--json", STREAM_TRACE], "trace-report")
    roll5 = json.loads(o)
    require(roll5.get("serve.slab.search", {}).get("count") == st5["slabs"],
            f"trace: {roll5.get('serve.slab.search')} serve.slab.search spans for "
            f"{st5['slabs']} slabs scanned")
    parts = ", ".join(f"{n} {roll[n]['count']} x {roll[n]['total_us'] / roll[n]['count']:.0f} us "
                      f"(p50/p99 buckets {roll[n]['p50_us']:.0f}/{roll[n]['p99_us']:.0f})"
                      for n in ("serve.batch", "pipeline.encode", "pipeline.plan",
                                "pipeline.scan", "pipeline.fdr"))
    sparts = ", ".join(f"{n} {roll5[n]['count']} x "
                       f"{roll5[n]['total_us'] / roll5[n]['count'] / 1e3:.1f} ms"
                       for n in ("serve.batch", "serve.scan", "serve.slab.fetch",
                                 "serve.slab.search", "serve.slab.merge"))
    log(f"[cli] trace-report: resident trace validates, serve.batch == "
        f"{int(st4['batches'])} micro-batches, host span means {parts}; streamed "
        f"trace serve.slab.search == {st5['slabs']} slabs, means {sparts}")

    if before_reload is not None:
        for k, paths in before_reload(search, search_out, serve, res_lines,
                                      head_file).items():
            by_path.setdefault(k, {}).update(paths)

    # 9. hot reload: the store grows under a streamed serve (last: it
    # changes phase 12's store, which the finally deletes)
    new_file = REQUESTS_FILE.with_name("smoke_requests_new.jsonl")
    oms_cli(["queries", "--refs", HOT_RELOAD_REFS, "--seed", SEED + 1, "--queries",
             HOT_RELOAD_REQUESTS], "queries of the appended spectra", stdout=new_file)
    first = reqs[:HOT_RELOAD_REQUESTS]
    rest = new_file.read_text().splitlines(keepends=True)
    grown = []

    def grow():
        o, _, t = oms_cli(["build", "--store", STORE_DIR, "--append", "--refs",
                           HOT_RELOAD_REFS, "--seed", SEED + 1, "--encode-backend",
                           "pallas", "--encode-batch", ENCODE_BATCH, "--chunk-rows",
                           CHUNK_ROWS, *dev], "build --append")
        grown.append(f"{o.strip()} (process {t:.1f}s)")

    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.serve import QuerySpec, coalesce_queries
    o, err, counts, t, _ = oms_in_process(
        [*serve, "--slab-rows", STREAM_SERVE_SLAB_ROWS, "--max-batch",
         STREAM_SERVE_BATCH, "--no-result-cache", "--hot-reload",
         HOT_RELOAD_POLL_S, "--trace", RELOAD_TRACE], GrowingStdin(first, rest, grow))
    got = o.splitlines(keepends=True)
    require(len(grown) == 1 and "1 hot-reloads" in err,
            f"serve --hot-reload did not reload once: {err[-2000:]}")
    require(got[:len(first)] == res_lines[:len(first)],
            "hot reload: the responses before the append differ from serve resident")
    spectra = coalesce_queries([QuerySpec(
        mz=r["mz"], intensity=r["intensity"], pmz=r["pmz"], charge=r["charge"])
        for r in map(json.loads, rest)])
    cold = OMSPipeline.from_store(STORE_DIR, cfg, device=DEVICE).search(spectra)
    old_answers = pipe.search(spectra)
    want = [{"id": json.loads(r)["id"], **p} for r, p in zip(rest, payloads_of(cold.result))]
    require([json.loads(x) for x in got[len(first):]] == want,
            "hot reload: the responses after the append differ from a cold "
            "start on the grown store")
    n_new = sum(a != b for a, b in zip(payloads_of(old_answers.result),
                                       payloads_of(cold.result)))
    require(n_new > 0, "hot reload: the appended spectra changed no answer")
    st = serve_stats(err)
    log(_serve_line("streamed + hot reload", st, t, counts))
    log(f"[cli] serve --hot-reload: {grown[0]}; the first {len(first)} responses "
        f"== serve resident, the {len(rest)} after the reload == a cold start on "
        f"the grown store ({n_new} of them changed by the appended spectra); "
        f"{[x for x in err.splitlines() if 'hot-reload:' in x][0].split('] ', 1)[1]}")
    for k in ("hdencode", "fused_search"):
        require(counts[k] > 0, f"serve --hot-reload launched no {k}")
        by_path[k][f"serve streamed + hot reload ({2 * HOT_RELOAD_REQUESTS} "
                   f"requests, in process)"] = counts[k]
    log(f"[cli] phase 16 in {time.perf_counter() - t_phase:.1f}s")
    return by_path


# ---------------------------------------------------------------------------
# Phase 17: the autotuner and the contract analyzer
# ---------------------------------------------------------------------------


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


def phase_tune(torch, pipe, ds, hvs, q_pmz, q_charge, search_args, search_out,
               serve_args, res_lines, head_file) -> dict:
    """Phase 17, part 1 (run inside phase 16, before the hot reload grows
    the store): the device's float32 sqrt held against the float64 one the
    CPU path stands for; ``tune`` in process at the main path's shapes,
    every candidate checked bit for bit against the defaults' output by the
    sweep, the winner table with each winner against the default; then
    ``search`` and resident ``serve`` (the first 1,024 requests) in process
    with the winners' cache: their output equals the untuned runs' and the
    cache hits. Returns {kernel: {path: launches}}."""
    import contextlib
    import io
    import numpy as np
    from repro_torch import tune
    from repro_torch.core import encoding
    from repro_torch.launch import oms
    t_phase = time.perf_counter()

    # The device path takes torch's float32 sqrt (the CPU path numpy's):
    # both must be the correctly rounded one, the float64 sqrt rounded once.
    inten = torch.as_tensor(ds.refs.intensity[:SQRT_CHECK_SPECTRA], device=DEVICE)
    rand = torch.rand(1 << 24, device=DEVICE) * 1e6
    for x in (inten, rand):
        require(equal(encoding.sqrt_f32(x), torch.sqrt(x.double()).float()),
                "the device's float32 sqrt is not the correctly rounded one")
    log(f"[tune] float32 sqrt on the card == float64 sqrt rounded once on "
        f"{inten.numel():,} library intensities and {rand.numel():,} uniform values")
    del inten, rand

    params, _, _, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    n_real = int((pipe.db.orig_idx >= 0).sum())
    dim = pipe.cfg.dim
    TUNE_CACHE.unlink(missing_ok=True)
    counters = _counters()
    for c in counters.values():
        c.reset()
    tables = {}
    for backends, rows in (("kernel_vpu,kernel_mxu,fused,fused_mxu", rk),
                           ("rescore", n_real)):
        buf, ebuf = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(ebuf):
            oms.main(["tune", "--backends", backends, "--dim", str(dim), "--top-k", "1",
                      "--q", str(TUNE_QUERIES), "--rows", str(rows), "--grid", "default",
                      "--iters", str(TUNE_ITERS), "--cache", str(TUNE_CACHE),
                      "--full-table", "--device", DEVICE])
        log(f"[tune] `tune --backends {backends} --q {TUNE_QUERIES} --rows {rows} "
            f"--dim {dim}` in {time.perf_counter() - t0:.1f}s: "
            f"{ebuf.getvalue().strip().splitlines()[-1]}")
        for line in buf.getvalue().splitlines():
            log(f"[tune]   {line}")
        tables.update(_tune_table(buf.getvalue()))
    sweep_counts = {n: c.count for n, c in counters.items()}
    require(set(tables) == set(tune.SWEPT_BACKENDS), f"tune swept {sorted(tables)}")
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
            f"{len(rows)} candidates, each bit-identical to the defaults' output")
    log(f"[tune] winners {json.dumps(summary)}")

    # Tuned search and resident serve, in process: the same bytes, hits > 0.
    try:
        o, e, s_counts, t, _ = oms_in_process(
            [*search_args, "--tune-cache", TUNE_CACHE], [])
        require(_mask_times(o) == _mask_times(search_out),
                f"search --tune-cache printed otherwise:\n{o}\nvs\n{search_out}")
        hits, misses = _tune_stats(e, "search")
        require(hits > 0, f"search --tune-cache: no cache hit ({misses} misses)")
        log(f"[tune] search --tune-cache (in process, {t:.1f}s): stdout == the "
            f"untuned search's but for its clock readings; {hits} hits / {misses} "
            f"misses at dispatch")
        tune.reset_runtime()
        with open(head_file) as fin:
            o, e, v_counts, t, _ = oms_in_process(
                [*serve_args, "--resident", "--no-result-cache", "--tune-cache",
                 TUNE_CACHE], fin)
        n = STREAM_SERVE_REQUESTS
        require(o == "".join(res_lines[:n]),
                "serve --resident --tune-cache answered otherwise than untuned")
        hits, misses = _tune_stats(e, "serve")
        require(hits > 0, f"serve --tune-cache: no cache hit ({misses} misses)")
        log(f"[tune] serve --resident --tune-cache (in process, {t:.1f}s): {n} "
            f"responses byte-identical to the untuned serve's; {hits} hits / "
            f"{misses} misses at dispatch")
    finally:
        tune.reset_runtime()
    for k in ("hdencode", "fused_search"):
        require(s_counts[k] > 0 and v_counts[k] > 0, f"tuned search/serve launched no {k}")
    log(f"[tune] phase 17 (sweep, tuned search and serve) in "
        f"{time.perf_counter() - t_phase:.1f}s")
    by_path = {k: {} for k in (*counters, "hdencode")}
    for k, n in sweep_counts.items():
        if n:
            by_path[k]["tune sweep (in process)"] = n
    by_path["fused_search"]["search --tune-cache (in process)"] = s_counts["fused_search"]
    by_path["hdencode"]["search --tune-cache (in process)"] = s_counts["hdencode"]
    by_path["fused_search"][f"serve resident --tune-cache ({STREAM_SERVE_REQUESTS:,} "
                            f"requests, in process)"] = v_counts["fused_search"]
    by_path["hdencode"][f"serve resident --tune-cache ({STREAM_SERVE_REQUESTS:,} "
                        f"requests, in process)"] = v_counts["hdencode"]
    return by_path


def phase_analyze() -> None:
    """Phase 17, part 2: ``analyze --imports`` on the card (every recording
    under sync debug mode "error"); exits 0; n_checks and each
    combination's allocator peak."""
    from repro_torch.analysis import runner
    t0 = time.perf_counter()
    o, _, t = oms_cli(["analyze", "--imports", "--json", ANALYZE_REPORT,
                       "--device", DEVICE], "analyze")
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
    log(f"[analyze] `analyze --imports --device {DEVICE}` exited 0 (process {t:.1f}s): "
        f"{con['n_combinations']} combinations, n_checks {con['n_checks']}, "
        f"imports {rep['imports']['modules']} modules / {rep['imports']['edges']} edges; "
        f"{next(x for x in o.splitlines() if 'ALL CONTRACTS HOLD' in x)}")
    log(f"[analyze] allocator peak per combination (bytes, the largest rise of "
        f"torch.cuda.max_memory_allocated over one recorded call): {json.dumps(peaks)}")
    log(f"[analyze] allocator peak per target (bytes): {json.dumps(by_target)}")
    log(f"[analyze] phase 17 (analyze) in {time.perf_counter() - t0:.1f}s")


def main() -> int:
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.core.pipeline import OMSConfig, _make_codebooks
    from repro_torch.data.spectra import iprg2012_config, make_dataset

    t_all = time.perf_counter()
    env = phase_environment(torch)
    phase_build()

    cfg = OMSConfig(backend="fused", encode_backend="pallas",
                    encode_batch=ENCODE_BATCH, seed=SEED)
    phase_hdencode_check(torch, _make_codebooks(cfg, torch.device(DEVICE)))
    phase_tile_edges(torch)

    t0 = time.perf_counter()
    lib_cfg = iprg2012_config(scale=1.0, seed=SEED)
    ds = make_dataset(lib_cfg)
    log(f"[data] iPRG2012 scale: {lib_cfg.n_refs} library spectra, "
        f"{lib_cfg.n_queries} queries, {lib_cfg.max_peaks} peaks "
        f"(numpy, seed {SEED}) in {time.perf_counter() - t0:.1f}s")
    pipe, hvs, q_pmz, q_charge, launches, out = phase_main_path(torch, ds, cfg)
    phase_fused_check(torch, pipe, hvs, q_pmz, q_charge)
    phase_fused_groups(torch, pipe, hvs, q_pmz, q_charge)
    phase_fused_edges(torch)
    phase_paths(torch, pipe, ds)
    kernels = phase_times(torch, env, pipe, hvs, q_pmz, q_charge, launches, ds)
    bucket = phase_tile_check(torch, env, pipe, hvs, q_pmz, q_charge)
    phase_fused_mxu_batch(torch, pipe, hvs, q_pmz, q_charge)
    launches.update(phase_backends(torch, pipe, hvs, q_pmz, q_charge, out))
    phase_cascade(torch, pipe, hvs, q_pmz, q_charge, out)
    phase_cascade_margin(torch, pipe, hvs, q_pmz, q_charge)
    kernels += phase_times_mxu(torch, env, pipe, hvs, q_pmz, q_charge, launches,
                               kernels[1], bucket)
    topk_ms = phase_topk(torch, pipe, hvs, q_pmz, q_charge)
    own_path = {"hdencode": "main path", "fused_search": "main path",
                "hamming_matrix": "backend kernel_vpu",
                "hamming_mxu": "backend kernel_mxu",
                "fused_search_mxu": "backend fused_mxu"}
    by_path = {k["name"]: {own_path[k["name"]]: k["launches"]} for k in kernels}
    try:
        store, store_launches = phase_store(torch, ds, cfg, pipe, hvs, q_pmz,
                                            q_charge, out)
        by_path["hdencode"]["store ingest"] = store_launches["hdencode"]
        by_path["fused_search"]["store-loaded search"] = store_launches["fused_search"]
        spipe, stream_launches = phase_streamed(torch, store, cfg, pipe, hvs, q_pmz,
                                                q_charge, out)
        for kernel, path, n in stream_launches:
            by_path[kernel][path] = n
        by_path["hamming_matrix"][f"streamed cascade prefix_words={STREAM_CASCADE_PREFIX}"] = (
            phase_streamed_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge,
                                   out)["hamming_matrix"])
        by_path["fused_search"].update(
            phase_narrow_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge, out))
        del spipe
        for kernel, paths in phase_launcher(
                torch, lib_cfg, cfg, pipe, hvs, q_pmz, q_charge, out, ds,
                before_reload=lambda *a: phase_tune(torch, pipe, ds, hvs, q_pmz,
                                                    q_charge, *a)).items():
            by_path[kernel].update(paths)
        phase_analyze()
    finally:
        shutil.rmtree(STORE_DIR, ignore_errors=True)
        shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)
        for f in (REQUESTS_FILE, SERVE_TRACE, STREAM_TRACE, RELOAD_TRACE, TUNE_CACHE,
                  ANALYZE_REPORT,
                  *(REQUESTS_FILE.with_name(f"smoke_requests_{x}.jsonl")
                    for x in ("head", "twice", "new", "in_process"))):
            f.unlink(missing_ok=True)
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
        if k["name"] in ("fused_search", "fused_search_mxu"):
            k["topk_ms"] = {kk: v for kk, v in topk_ms.items() if kk.startswith(k["name"] + " ")}
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f}s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
