"""Phases 1-2, 5-7 and 10-11: the build, and the five kernels against their
plain versions, timed beside their bounds.

 1. environment: card, power limit, torch/CUDA/nvcc versions, triton;
    build the CUDA kernels from the sources in this checkout.
 2. hdencode kernel against its plain PyTorch version on the card, at dim
    4096 and at 7 words, and at the bit-sliced counters' edges: a count of
    64 (P = 64, every peak valid with one bin and level), P = 1, 63, 100 and
    2100 (the general plane path), and B = 1. Then hamming_matrix and
    hamming_mxu against the plain tile at the shapes the main path does not
    give them: W = 1 and 9, Q = 1 and 17, R = 1, 7 and 8k + 3, row slices
    whose base is not 16-byte aligned (W = 7 from an odd row, W = 4 at a
    4-byte offset), and W = 300 (hamming_mxu's 128-word chunks of A
    fragments).
 5. kernel times (CUDA events, median of 10 after a warm-up) beside their
    plain versions at the same shapes (fused_search's plain version on the
    whole batch run once, held bit for bit against the kernel and timed)
    and their lower bounds; for the short kernels also the device time of a
    CUDA graph of 20 launches, which leaves out the wrapper's host work, and
    hdencode's gathered codebook bytes.
 6. the all-pairs tile kernels (hamming_matrix: binary AND-popc tensor
    cores; hamming_mxu: +-1 int8 tensor cores) against their plain versions
    on 8 main-path query blocks at W = 128, at the cascade's prefix widths
    W = 64 and 8 and at W = 7, and on 2 query blocks against the cascade's
    4,194,304-row bucket of gathered rows at W = 128 (the seed pass and the
    rescore), where hamming_matrix and hamming_mxu are also timed beside
    their bound and beside torch._int_mm on the bucket's rows unpacked to
    +-1 int8 beforehand; the fused_search_mxu kernel against its plain
    version on 8 blocks at k = 1 and k = 4, and at 7 words (dim 224, the
    scalar-load variant).
 7. fused_search_mxu against fused_search on the whole batch at k = 1 and
    k = 4: all four arrays bit-identical.
10. times and bounds of the tile kernels and fused_search_mxu (the tiles at
    one main-path block beside torch._int_mm on pre-unpacked +-1 int8;
    fused_search_mxu on the whole batch, its plain version run once,
    compared and timed).
11. top_k above 16: both fused kernels against their plain versions on the
    main-path check blocks at k = 17, 32, 64, 65, 128, 600 and 1024 (past 64
    the winner lists live in device memory); the limits that were widened
    against the plain versions: fused_search_mxu past 256 words, the fused
    kernels at their widest shared-list W, at k = 65, at k past the rows a
    block scans, at W = 2,496 / 2,432 (past the old shared-memory bound) and
    W = 4,096 (queries staged in word chunks), the tile kernels past 65,535
    query tiles, hamming_matrix past 3,632 words, the grouped launch past
    65,535 groups.

``times_topk`` (the whole batch at k = 16..1024) and ``times_wide`` (W =
4,096 on a seeded batch) are scripts/chip_times.py's.
"""
from __future__ import annotations

import subprocess
import sys
import time

from . import common as C
from .common import cuda_ms, equal, fail, graph_ms, log, max_abs_err, require
from .oms_common import (FUSED_OUTS, NARROW_W, PLAIN_TILE_ROWS, block_pairs, check_blocks,
                         fused_edge_inputs, plain_pair, plain_tile, plan_of, random_words,
                         sorted_batch, union_stats)

HDENCODE_SPECTRA = 4096
TILE_CHECK_W = (64, 8, NARROW_W)   # the prefix widths and a scalar-load width
BUCKET_CHECK_BLOCKS = 2  # query blocks held against the cascade's row bucket
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
TOPK_CHECK_KS = (17, 32, 64, 65, 128, 600, 1024)
TOPK_TIME_KS = (16, 17, 32, 64, 65, 128, 600, 1024)
TOPK_TIME_ITERS = 3
# Rows past the old shared-memory bound: (rows, W, blocks, rk) of the
# seeded batch each fused kernel is timed on at W = 4,096 words, k = 1.
WIDE_TIME = (1 << 15, 4096, 64, 8192)
GRID_Y_MAX = 65535       # CUDA's grid y limit: groups of one fused launch

KERNEL_SOURCES = {
    "hdencode": ("src/repro_torch/kernels/hdencode/csrc/hdencode.cu",
                 "src/repro/kernels/hdencode/hdencode.py:46", "hdencode_kernel"),
    "fused_search": ("src/repro_torch/kernels/hamming/csrc/fused_search.cu",
                     "src/repro/kernels/hamming/hamming.py:102", "fused_search_kernel"),
    "hamming_matrix": ("src/repro_torch/kernels/hamming/csrc/hamming_matrix.cu",
                       "src/repro/kernels/hamming/hamming.py:67", "hamming_matrix_kernel"),
    "hamming_mxu": ("src/repro_torch/kernels/hamming_mxu/csrc/hamming_mxu.cu",
                    "src/repro/kernels/hamming_mxu/hamming_mxu.py:60", "hamming_mxu_kernel"),
    "fused_search_mxu": ("src/repro_torch/kernels/hamming_mxu/csrc/fused_search_mxu.cu",
                         "src/repro/kernels/hamming_mxu/hamming_mxu.py:99",
                         "fused_search_mxu_kernel"),
}
# The path whose launches the kernels line reports as ``launches``.
OWN_PATH = {"hdencode": "main path", "fused_search": "main path",
            "hamming_matrix": "backend kernel_vpu", "hamming_mxu": "backend kernel_mxu",
            "fused_search_mxu": "backend fused_mxu"}


def kernel_entry(name: str, **fields) -> dict:
    source, replaces, tpu = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_kernel": tpu, "launches": None, "bit_identical": True, **fields}


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def env_build(ctx) -> None:
    ctx.env = environment(ctx.torch)
    build()


def environment(torch) -> dict:
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    smi = C.nvidia_smi("name,power.limit")
    clock = C.nvidia_smi("clocks.max.sm")
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


def build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build(log=lambda s: log("\n".join(
        f"[build] {line}" for line in s.splitlines()
        if "registers" in line or "Compiling" in line or "error" in line.lower()
        or line.startswith("[nvcc"))))
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> {lib.relative_to(C.HERE)} "
        f"in {time.perf_counter() - t0:.1f}s")


def card(ctx) -> dict:
    return dict(clock_hz=ctx.env["clock_hz"], n_sms=ctx.env["n_sms"])


def _timed_once(torch, fn):
    """(milliseconds between CUDA events, result) of one ``fn()``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


# ---------------------------------------------------------------------------
# Phase 2: hdencode, and the tile kernels at their edges
# ---------------------------------------------------------------------------


def hdencode_inputs(torch, dev, n_bins: int, n_levels: int, B: int, P: int = 64):
    """Random spectra plus the edge rows: all-masked, 2 and 4 valid peaks
    (majority ties wherever the bound HVs differ)."""
    g = torch.Generator(device=dev).manual_seed(C.SEED)
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


def hdencode_check(ctx) -> None:
    from repro_torch.core.pipeline import _make_codebooks
    from repro_torch.kernels.hdencode import ops, ref
    torch = ctx.torch
    cb = _make_codebooks(ctx.cfg, torch.device(C.DEVICE))
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
    hdencode_edges(torch, cb)
    tile_edges(torch)


def hdencode_edges(torch, cb) -> None:
    """The bit-sliced counters at their edges: a count of 64 (the top plane
    at P = 64), P from one plane to the general plane path, and B = 1."""
    from repro_torch.kernels.hdencode import ops, ref
    dev = cb.device
    n_bins, n_levels = cb.id_hvs.shape[0], cb.level_hvs.shape[0]
    B = HDENCODE_EDGE_SPECTRA
    g = torch.Generator(device=dev).manual_seed(C.SEED + 2)
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


def tile_edges(torch) -> None:
    """hamming_matrix and hamming_mxu (dim 32 * W) at the shapes the main
    path does not give them. The first query and reference row are all
    ones and the second row all zeros, the extremes of |q| and |r|."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    g = torch.Generator(device=C.DEVICE).manual_seed(C.SEED + 3)
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


# ---------------------------------------------------------------------------
# Phase 5: times and bounds of hdencode and fused_search
# ---------------------------------------------------------------------------


def fused_bound(ctx) -> dict:
    """The fused kernels' least time on the whole main-path batch
    (roofline.fused_roofline): the cheapest of three routes to the same
    Hamming tiles (popc, int8 +-1 dot, binary tensor cores) for operations;
    the rows the blocks cover, the queries and the outputs for bytes."""
    def make():
        import numpy as np
        import torch
        from repro_torch.utils import roofline
        m = ctx.main()
        pipe = m.pipe
        params, qh, qp, qc, starts = sorted_batch(torch, pipe, *m.batch)
        db = pipe.db
        rk = params.k_blocks * db.max_r
        W = db.hvs.shape[1]
        pairs = qh.shape[0] * rk
        routes = {name: ops / rate for name, (ops, rate) in roofline.hamming_routes(
            pairs, W, pipe.cfg.dim, **card(ctx)).items()}
        covered = np.zeros(db.n_rows, bool)
        for s in torch.unique(starts).cpu().numpy():
            covered[s:s + rk] = True
        roof = roofline.fused_roofline(qh.shape[0], rk, int(covered.sum()), W,
                                       pipe.cfg.dim, params.top_k, starts.shape[0],
                                       **card(ctx))
        by = roof.bound_by
        return {"bound_ms": roof.t_bound * 1e3, "bound_by": by,
                "bound_route": roof.route if by == "operations" else "HBM",
                "bytes_s": roof.t_memory, "routes": routes, "pairs": pairs}
    return ctx._get("fused_bound", make)


def times(ctx) -> None:
    from repro_torch.core import encode_backends
    from repro_torch.data.spectra import SpectraSet
    from repro_torch.kernels.hamming import ops as fs_ops
    from repro_torch.kernels.hamming import ref as fs_ref
    from repro_torch.kernels.hdencode import ops as hd_ops
    from repro_torch.kernels.hdencode import ref as hd_ref
    from repro_torch.utils import roofline
    torch = ctx.torch
    m = ctx.main()
    pipe = m.pipe
    _, ds = ctx.data()
    cb = pipe.codebooks
    W = cb.id_hvs.shape[1]

    # hdencode at its main-path launch shape: one ENCODE_BATCH of library
    # spectra, preprocessed as the ingest does.
    lib = SpectraSet(*(x[:C.ENCODE_BATCH] for x in ds.refs))
    pre = encode_backends._preprocess(
        *(torch.as_tensor(x, device=C.DEVICE) for x in lib), pipe.cfg.preprocess_params)
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
                                         **card(ctx))
    hd_bound = hd_roof.t_bound * 1e3
    # What the kernel gathers: one ID row and one level row per valid peak
    # (served by L2 and L1, not HBM: the touched codebook rows fit in L2).
    hd_gather = 2 * n_valid * W * 4

    # fused_search on the whole main-path batch, kernel and plain version.
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, *m.batch)
    db = pipe.db
    rk = params.k_blocks * db.max_r
    nqb = starts.shape[0]
    fs_args = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=params.top_k,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fs_ms = cuda_ms(lambda: fs_ops.fused_search(*fs_args, **kw))
    fs_out = fs_ops.fused_search(*fs_args, **kw)
    # The plain version materialises a (16, rk, W) tile per block (~20 s a
    # batch): it runs once, timed and compared.
    fs_plain_ms, fs_plain = _timed_once(torch, lambda: fs_ref.fused_search(*fs_args, **kw))
    fs_err = max_abs_err(zip(fs_out, fs_plain))
    require(fs_err == 0, "fused_search on the whole main-path batch: kernel != plain")
    fb = fused_bound(ctx)
    u_mean, u_max = union_stats(starts, rk, db.n_rows)
    log(f"[times] hdencode ({B} x {P} peaks, {n_valid} valid, {valid_bins} bins "
        f"touched, dim {cb.dim}): kernel {hd_ms:.4f} ms (device {hd_device_ms:.4f} ms "
        f"in a graph), plain {hd_plain_ms:.4f} ms, bound {hd_bound:.4f} ms "
        f"({hd_roof.bound_by}; ops {hd_roof.t_compute * 1e3:.4f} ms, bytes "
        f"{hd_roof.t_memory * 1e3:.4f} ms); gathered ID + level rows {hd_gather / 1e6:.1f} "
        f"MB from L2/L1, {hd_gather / (hd_device_ms * 1e-3) / 1e12:.2f} TB/s of "
        f"device time")
    log(f"[times] fused_search ({qh.shape[0]} queries, {nqb} blocks x {rk} rows, "
        f"{fb['pairs']:.4e} pairs; groups' union/rk mean {u_mean:.4f}, max {u_max:.4f}): "
        f"kernel {fs_ms:.3f} ms, plain {fs_plain_ms:.1f} ms (one run, compared bit for "
        f"bit), bound {fb['bound_ms']:.3f} ms ({fb['bound_by']}, "
        f"{fb['bound_route']}; "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in fb["routes"].items())
        + f", bytes {fb['bytes_s'] * 1e3:.3f} ms)")
    ctx.kernels["hdencode"] = kernel_entry(
        "hdencode", max_abs_err=max_abs_err([(hd_out, hd_plain)]),
        ms=hd_ms, device_ms=hd_device_ms, plain_ms=hd_plain_ms,
        bound_ms=hd_bound, bound_by=hd_roof.bound_by, library_ms=None,
        shape=f"{B}x{P} peaks, dim {cb.dim}", gather_bytes=hd_gather)
    ctx.kernels["fused_search"] = kernel_entry(
        "fused_search", max_abs_err=fs_err, ms=fs_ms, plain_ms=fs_plain_ms,
        bound_ms=fb["bound_ms"], bound_by=fb["bound_by"], bound_route=fb["bound_route"],
        library_ms=None, shape=f"{qh.shape[0]} queries x {rk} rows, k={params.top_k}",
        route_bounds_ms={k: max(v, fb["bytes_s"]) * 1e3 for k, v in fb["routes"].items()},
        union_over_rk={"mean": u_mean, "max": u_max})


# ---------------------------------------------------------------------------
# Phase 6: the tile kernels and fused_search_mxu against their plain versions
# ---------------------------------------------------------------------------


def tile_check(ctx) -> None:
    import numpy as np
    from repro_torch.core import packing, search
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    from repro_torch.utils import roofline
    torch = ctx.torch
    m = ctx.main()
    pipe = m.pipe
    params, args, pick, rk = check_blocks(torch, pipe, *m.batch)
    W = pipe.db.hvs.shape[1]
    for w in (W, *TILE_CHECK_W):
        for q, r in block_pairs(pipe, params, args, rk):
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
              "bound_ms": roofline.tile_roofline(QB, Rb, Wb, dim, **card(ctx)).t_bound * 1e3,
              "shape": f"{QB} x {Rb} x {Wb}"}
    # Library yardstick at the bucket shape: one torch._int_mm on +-1 int8
    # operands unpacked beforehand (not timed; B 17.2 GB, unpacked in row
    # chunks, multiplied in one call), A padded to the 32 rows its shape
    # rules want.
    a8 = torch.zeros((32, dim), dtype=torch.int8, device=C.DEVICE)
    a8[:QB] = packing.packed_to_pm1(q)
    b8 = torch.empty((Rb, dim), dtype=torch.int8, device=C.DEVICE)
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
    ctx.bucket = bucket
    del r
    for k in (1, 4):
        kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        got = mops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        want = mref.fused_search(*args, **kw)
        for name, g, w in zip(FUSED_OUTS, got, want):
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
    for name, g, w in zip(FUSED_OUTS, got, want):
        require(equal(g, w), f"fused_search_mxu kernel differs from plain "
                f"({name}, W={NARROW_W})")
    log(f"[check] fused_search_mxu kernel == plain at W = {NARROW_W} words "
        f"(dim {32 * NARROW_W}, scalar loads), k=4: bit-identical")


# ---------------------------------------------------------------------------
# Phase 7: fused_search_mxu against fused_search on the whole batch
# ---------------------------------------------------------------------------


def fused_mxu_batch(ctx) -> None:
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    torch = ctx.torch
    m = ctx.main()
    pipe = m.pipe
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, *m.batch)
    db = pipe.db
    rk = params.k_blocks * db.max_r
    args = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    for k in (1, 4):
        kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        popc, mxu = hops.fused_search(*args, **kw), mops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(FUSED_OUTS, popc, mxu):
            require(equal(a, b), f"fused_mxu differs from fused on the whole "
                    f"batch ({name}, k={k})")
        log(f"[check] fused_search_mxu == fused_search on the whole batch "
            f"({starts.shape[0]} blocks x {rk} rows) at k={k}: all four "
            f"({qh.shape[0]}, {k}) arrays bit-identical")


# ---------------------------------------------------------------------------
# Phase 10: times and bounds of the tile kernels and fused_search_mxu
# ---------------------------------------------------------------------------


def times_mxu(ctx) -> None:
    from repro_torch.core import packing
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    from repro_torch.utils import roofline
    torch = ctx.torch
    m = ctx.main()
    pipe = m.pipe
    dim = pipe.cfg.dim
    params, args, pick, rk = check_blocks(torch, pipe, *m.batch)
    q, r = block_pairs(pipe, params, args, rk)[0]
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
    a8 = torch.zeros((32, dim), dtype=torch.int8, device=C.DEVICE)
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
    t_roof = roofline.tile_roofline(Q, R, W, dim, **card(ctx))
    t_bound = t_roof.t_bound * 1e3
    t_by = t_roof.bound_by

    params, qh, qp, qc, starts = sorted_batch(torch, pipe, *m.batch)
    db = pipe.db
    fargs = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    kw = dict(q_block=params.q_block, rk=rk, dim=dim, k=params.top_k,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fm_ms = cuda_ms(lambda: mops.fused_search(*fargs, **kw))
    fm_out = mops.fused_search(*fargs, **kw)
    # The plain version on the whole batch runs once: timed and compared.
    fm_plain_ms, fm_plain = _timed_once(torch, lambda: mref.fused_search(*fargs, **kw))
    fm_err = max_abs_err(zip(fm_out, fm_plain))
    require(fm_err == 0, "fused_search_mxu on the whole batch: kernel != plain")
    fb = fused_bound(ctx)
    log(f"[times] hamming_matrix ({Q} x {R} x {W} words, one main-path block): "
        f"kernel {vpu_ms:.4f} ms (device {vpu_device_ms:.4f} ms in a graph), plain "
        f"{vpu_plain_ms:.3f} ms, bound {t_bound:.4f} ms ({t_by}; bytes "
        f"{t_roof.t_memory * 1e3:.4f} ms, ops {t_roof.t_compute * 1e3:.4f} ms), "
        f"torch._int_mm {lib_ms:.4f} ms (device {lib_device_ms:.4f} ms)")
    log(f"[times] hamming_mxu (same block): kernel {mxu_ms:.4f} ms (device "
        f"{mxu_device_ms:.4f} ms), plain {mxu_plain_ms:.3f} ms, bound {t_bound:.4f} ms "
        f"({t_by})")
    log(f"[times] fused_search_mxu ({qh.shape[0]} queries, {starts.shape[0]} blocks "
        f"x {rk} rows, k={params.top_k}): kernel {fm_ms:.3f} ms, plain "
        f"{fm_plain_ms:.1f} ms (one run, compared bit for bit), bound "
        f"{fb['bound_ms']:.3f} ms ({fb['bound_by']}, {fb['bound_route']})")
    tile_shape = f"{Q} queries x {R} rows x {W} words (one main-path block)"
    bucket = ctx.bucket or {}
    for name, ms, dev_ms, plain_ms, bucket_ms in (
            ("hamming_matrix", vpu_ms, vpu_device_ms, vpu_plain_ms, bucket.get("ms")),
            ("hamming_mxu", mxu_ms, mxu_device_ms, mxu_plain_ms, bucket.get("mxu_ms"))):
        ctx.kernels[name] = kernel_entry(
            name, max_abs_err=errs[name], ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=t_bound, bound_by=t_by, library_ms=lib_ms,
            library_device_ms=lib_device_ms, shape=tile_shape, bucket_ms=bucket_ms,
            bucket_bound_ms=bucket.get("bound_ms"),
            bucket_library_ms=bucket.get("library_ms"), bucket_shape=bucket.get("shape"))
    ctx.kernels["fused_search_mxu"] = kernel_entry(
        "fused_search_mxu", max_abs_err=fm_err, ms=fm_ms, plain_ms=fm_plain_ms,
        bound_ms=fb["bound_ms"], bound_by=fb["bound_by"], bound_route=fb["bound_route"],
        library_ms=None, shape=f"{qh.shape[0]} queries x {rk} rows, k={params.top_k}")


# ---------------------------------------------------------------------------
# Phase 11: top_k above 16, and the launch limits
# ---------------------------------------------------------------------------


def _fused_kernels():
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    return (("fused_search", hops, href), ("fused_search_mxu", mops, mref))


def topk_limits(ctx) -> None:
    torch = ctx.torch
    m = ctx.main()
    kernels = _fused_kernels()
    params, args, pick, rk = check_blocks(torch, m.pipe, *m.batch)
    base = dict(q_block=params.q_block, rk=rk, dim=m.pipe.cfg.dim,
                ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    for k in TOPK_CHECK_KS:
        for name, kern, plain in kernels:
            plain_pair(torch, name, kern, plain, args, dict(base, k=k),
                       f"at k={k} on the main-path check blocks")
        log(f"[topk] fused_search and fused_search_mxu kernels == plain on "
            f"{len(pick)} main-path query blocks x {rk} rows at k={k}: bit-identical")
    limits(torch, kernels)


def limits(torch, kernels) -> None:
    """The widened limits against the plain versions: the fused kernels at
    k past 64, past the rows a block scans, and at W past the old
    shared-memory bound."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    g = torch.Generator(device=C.DEVICE).manual_seed(C.SEED + 5)
    # fused_search_mxu past its old 256 words; both at their widest W (k=1).
    for name, kern, plain, cases in (
            ("fused_search_mxu", mops, kernels[1][2], ((300, 4), (2416, 1))),
            ("fused_search", hops, kernels[0][2], ((2480, 1),))):
        for W, k in cases:
            args = fused_edge_inputs(torch, g, 600, W, (0, 40, 300), 256, 16)
            plain_pair(torch, name, kern, plain, args,
                       dict(q_block=16, rk=256, dim=32 * W, k=k), f"at W={W}")
            log(f"[limits] {name} kernel == plain at W = {W} words, k={k} "
                f"(3 blocks x 256 rows): bit-identical")
    # The old limits, now widened: k = 65; k past the rows a block scans
    # (the last block's scan is cut at the last row to 60 rows, 6 of them
    # padding); W past the old one-tile bound (2,480 and 2,416 words) and
    # W = 4,096 (queries in word chunks), also with k past 64.
    for what, n_rows, W, starts, rk, k in (
            ("k = 65", 600, 8, (0, 40, 300), 256, 65),
            ("k past the rows scanned", 600, 8, (0, 540), 100, 128),
            ("k past the rows scanned", 600, 7, (0, 590), 64, 65),
            ("W past the old bound", 600, 2496, (0, 40, 300), 256, 1),
            ("W past the old bound", 600, 2432, (0, 40, 300), 256, 1),
            ("W = 4096", 600, 4096, (0, 40, 300), 256, 1),
            ("W = 4096", 600, 4096, (0, 40, 300), 256, 4),
            ("W = 4096", 600, 4096, (0, 40, 300), 256, 100)):
        args = fused_edge_inputs(torch, g, n_rows, W, starts, rk, 16)
        for name, kern, plain in kernels:
            plain_pair(torch, name, kern, plain, args,
                       dict(q_block=16, rk=rk, dim=32 * W, k=k), f"at {what} (W={W}, k={k})")
        scanned = min(rk, n_rows - starts[-1])
        log(f"[limits] fused_search and fused_search_mxu kernels == plain at {what}: "
            f"W = {W} words, k = {k}, {len(starts)} blocks x {rk} rows (last block scans "
            f"{scanned}); {plan_of(hops, W, k)} / {plan_of(mops, W, k)}: bit-identical")
    # The tile kernels past 65,535 query tiles (two launches each) and
    # hamming_matrix past its 3,632 staged words (word chunks, summed).
    for Q, R, W in ((hops.TILE_Q_CHUNK + 17, 9, 1), (16, 1000, 4000)):
        q, r = random_words(torch, g, Q, W), random_words(torch, g, R, W)
        cs = C.counters()
        before = (cs["hamming_matrix"].count, cs["hamming_mxu"].count)
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * W)
        torch.cuda.synchronize()
        want = href.hamming_matrix(q, r)
        require(equal(vpu, want), f"hamming_matrix differs from plain at Q={Q}, W={W}")
        require(equal(mxu, want), f"hamming_mxu differs from plain at Q={Q}, W={W}")
        n = (cs["hamming_matrix"].count - before[0], cs["hamming_mxu"].count - before[1])
        log(f"[limits] hamming_matrix and hamming_mxu == plain at Q = {Q}, R = {R}, "
            f"W = {W} (launches {n[0]} / {n[1]}): bit-identical")
        del q, r, vpu, mxu, want
    # The grouped launch past 65,535 groups of 8 tiles: kernels on the
    # whole batch, plain versions on the blocks around the launch boundary.
    nqb = GRID_Y_MAX * hops.GROUP + 17
    n_rows, rk = 2048, 256
    starts = torch.sort(torch.randint(0, n_rows - rk, (nqb,), generator=g,
                                      device=C.DEVICE, dtype=torch.int32)).values
    q, qp, qc, r, rp, rc, st = fused_edge_inputs(torch, g, n_rows, 1, (0,), rk, 16)
    src = torch.clamp(starts.repeat_interleave(16).long()
                      + torch.randint(0, rk, (nqb * 16,), generator=g, device=C.DEVICE),
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


def times_topk(ctx) -> dict:
    """Both fused kernels on the whole batch at TOPK_TIME_KS: k <= 16 is the
    old path; up to 64 the shared lists grow and G falls to 1 where a CTA's
    shared memory no longer fits 8; past 64 the lists live in device memory
    (G = 8). Returns {"<kernel> k=<k>": ms}."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    torch = ctx.torch
    m = ctx.main()
    params, qh, qp, qc, starts = sorted_batch(torch, m.pipe, *m.batch)
    db = m.pipe.db
    rk = params.k_blocks * db.max_r
    base = dict(q_block=params.q_block, rk=rk, dim=m.pipe.cfg.dim,
                ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fargs = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    out = {}
    for name, kern, _ in _fused_kernels():
        scratch = mops.FUSED_SCRATCH_PER_TILE if kern is mops else 0
        loaded = False
        for k in TOPK_TIME_KS:
            plan = hops.fused_plan(db.n_words, k, scratch)
            # A device-list run at these k takes 0.2-6 s: one run, after a
            # warm-up call at the first such k loads the kernel.
            once = plan.lists == "global"
            ms = cuda_ms(lambda: kern.fused_search(*fargs, **dict(base, k=k)),
                         iters=1 if once else TOPK_TIME_ITERS,
                         warmup=not (once and loaded))
            loaded = loaded or once
            out[f"{name} k={k}"] = ms
            log(f"[topk] {name} on the whole batch ({starts.shape[0]} blocks x {rk} "
                f"rows) at k={k}: {ms:.3f} ms ({plan.group} query tiles per CTA, "
                f"{plan.lists} lists)")
    return out


def times_wide(ctx) -> dict:
    """Both fused kernels at W = 4,096 words, k = 1, on a seeded batch."""
    torch = ctx.torch
    g = torch.Generator(device=C.DEVICE).manual_seed(C.SEED + 5)
    n_rows, W, nqb, rk = WIDE_TIME
    wide = fused_edge_inputs(
        torch, g, n_rows, W, tuple(range(0, n_rows - rk, (n_rows - rk) // nqb))[:nqb], rk, 16)
    out = {}
    for name, kern, _ in _fused_kernels():
        ms = cuda_ms(lambda: kern.fused_search(*wide, q_block=16, rk=rk, dim=32 * W, k=1),
                     iters=TOPK_TIME_ITERS)
        out[f"{name} W={W} k=1"] = ms
        log(f"[limits] {name} at W = {W} words, k = 1 ({nqb} blocks x {rk} rows of "
            f"{n_rows}; {plan_of(kern, W, 1)}): {ms:.3f} ms")
    return out
