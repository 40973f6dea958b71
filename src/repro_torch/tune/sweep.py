"""Launch-parameter sweep harness: benchmark a backend's hot fn across a
static grid.

Counterpart of ``repro.tune.sweep``. For every candidate assignment the
harness measures the median of ``iters`` timed calls of the real hot fn
(CUDA events on the card, after one warm-up) at caller-supplied shapes,
checks the candidate's output bit for bit against the default's (every
value of every parameter must give the same result; a mismatch or a failed
launch fails the sweep — there is no fallback), and prices the same call
with :mod:`repro_torch.utils.roofline`'s analytic work counts: a roofline
bound per candidate and the measured-vs-roofline fraction (``t_bound /
measured``; 1.0 would be a kernel running exactly at the bound).

Winners are deterministic under fixed timings: candidates sort by
``(median_us, sorted(tiles))``, so ties break to the lexicographically
smallest assignment. Tests inject a fake ``timer(fn, args, tiles)`` to pin
the timings.

Swept backends (``repro_torch.tune.SWEPT_BACKENDS``):

  * ``kernel_vpu`` / ``kernel_mxu`` — the CUDA tile kernels, over the grid
    size ``ctas_per_sm`` (0: the occupancy fill);
  * ``fused`` / ``fused_mxu``      — the fused CUDA kernels on one query
    block (``start_rows = [0]``, ``rk = r_rows``), over the split count's
    ``waves`` x ``min_split_rows`` (k rides in from the caller);
  * ``rescore``                    — the prefix-rescore path's
    ``row_bucket`` pow2 base (the padded survivor-bucket floor), on the
    ``fused`` backend's cascade tile (``kernel_vpu``).

This module imports the kernels and the search orchestrator, so the CLI
loads it lazily; dispatch-side resolution lives in
``repro_torch.tune.__init__`` and never touches this file.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.tune import cache as cache_mod
from repro_torch.tune import device_kind

MATRIX_BACKENDS = ("kernel_vpu", "kernel_mxu")
FUSED_BACKENDS = ("fused", "fused_mxu")

# Named grids. "tiny" is the test grid (two values of each parameter);
# "default" is the real per-device sweep.
GRIDS: dict[str, dict[str, dict[str, tuple[int, ...]]]] = {
    "default": {
        "fused": {"waves": (1, 2, 4, 8), "min_split_rows": (256, 1024, 4096)},
        "kernel": {"ctas_per_sm": (0, 1, 2, 4)},
        "rescore": {"row_bucket": (32, 64, 128, 256)},
    },
    "tiny": {
        "fused": {"waves": (1, 4), "min_split_rows": (256, 1024)},
        "kernel": {"ctas_per_sm": (0, 2)},
        "rescore": {"row_bucket": (64, 128)},
    },
}


@dataclasses.dataclass
class SweepRow:
    backend: str
    tiles: dict[str, int]
    median_us: float
    model_flops: float = 0.0      # roofline work: the route's operations
    model_bytes: float = 0.0      # roofline work: HBM bytes
    t_bound_us: float = 0.0       # roofline bound from the work terms
    roofline_frac: float = 0.0    # t_bound / measured (measured-vs-roofline)

    def tiles_str(self) -> str:
        return " ".join(f"{n}={v}" for n, v in sorted(self.tiles.items()))

    def sort_key(self):
        return (self.median_us, tuple(sorted(self.tiles.items())))


def _grid_kind(backend: str) -> str:
    if backend == "rescore":
        return "rescore"
    return "fused" if backend in FUSED_BACKENDS else "kernel"


def grid_candidates(backend: str, grid: str = "default") -> list[dict]:
    """Deterministically ordered candidate dicts for one backend: the
    product of the grid's values over the sorted parameter names."""
    spec = GRIDS[grid][_grid_kind(backend)]
    names = sorted(spec)
    out = []
    for combo in itertools.product(*(spec[n] for n in names)):
        out.append(dict(zip(names, combo)))
    return out


# ---------------------------------------------------------------------------
# Hot-fn builders (one synthetic case per backend at caller shapes)
# ---------------------------------------------------------------------------


def _synth(dim: int, q_rows: int, r_rows: int, seed: int, device):
    """The reference's synthetic draws (``np.random.default_rng(seed)``),
    as the port's int32 words on ``device``."""
    rng = np.random.default_rng(seed)
    W = dim // 32

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    q = t(rng.integers(0, 2 ** 32, (q_rows, W), dtype=np.uint32).view(np.int32))
    r = t(rng.integers(0, 2 ** 32, (r_rows, W), dtype=np.uint32).view(np.int32))
    qp = t(rng.uniform(100.0, 1500.0, q_rows).astype(np.float32))
    rp = t(rng.uniform(100.0, 1500.0, r_rows).astype(np.float32))
    qc = t(rng.integers(1, 4, q_rows).astype(np.int32))
    rc = t(rng.integers(1, 4, r_rows).astype(np.int32))
    return q, r, qp, rp, qc, rc


def make_case(backend: str, *, dim: int, k: int, q_rows: int, r_rows: int,
              seed: int = 0, device=None):
    """-> ``case(tiles) -> (fn, args)``: the hot fn and concrete args for
    one candidate. ``fn(*args)`` is what gets timed."""
    dev = resolve_device(device)
    q, r, qp, rp, qc, rc = _synth(dim, q_rows, r_rows, seed, dev)

    if backend == "kernel_vpu":
        from repro_torch.kernels.hamming import ops as hops

        def case(tiles):
            def fn(a, b):
                return hops.hamming_matrix(a, b, ctas_per_sm=tiles["ctas_per_sm"])
            return fn, (q, r)
        return case

    if backend == "kernel_mxu":
        from repro_torch.kernels.hamming_mxu import ops as mops

        def case(tiles):
            def fn(a, b):
                return mops.hamming_matrix(a, b, dim,
                                           ctas_per_sm=tiles["ctas_per_sm"])
            return fn, (q, r)
        return case

    if backend in FUSED_BACKENDS:
        if backend == "fused":
            from repro_torch.kernels.hamming import ops as kops
        else:
            from repro_torch.kernels.hamming_mxu import ops as kops
        starts = torch.zeros((1,), dtype=torch.int32, device=dev)

        def case(tiles):
            def fn(a, ap, ac, b, bp, bc, s):
                return kops.fused_search(
                    a, ap, ac, b, bp, bc, s, q_block=q_rows, rk=r_rows,
                    dim=dim, k=k, waves=tiles["waves"],
                    min_split_rows=tiles["min_split_rows"])
            return fn, (q, qp, qc, r, rp, rc, starts)
        return case

    if backend == "rescore":
        from repro_torch.core import search as search_mod
        from repro_torch.core.blocking import PAD_PMZ

        qb = 16 if q_rows % 16 == 0 else q_rows
        params = search_mod.SearchParams(backend="fused", top_k=k, q_block=qb)

        def case(tiles):
            bucket = search_mod.row_bucket(r_rows, lo=tiles["row_bucket"])
            rows_pad, valid = search_mod.pad_candidate_rows(
                np.arange(r_rows, dtype=np.int64), bucket)
            valid_t = torch.from_numpy(valid).to(dev)
            pad = bucket - r_rows
            r_hvs = torch.cat([r, r.new_zeros((pad, r.shape[1]))])
            rows_t = torch.where(
                valid_t, torch.from_numpy(rows_pad.astype(np.int32)).to(dev), -1)
            pmz = torch.where(valid_t, torch.cat([rp, rp.new_zeros((pad,))]),
                              PAD_PMZ)
            chg = torch.where(valid_t, torch.cat([rc, rc.new_zeros((pad,))]), -1)

            def fn(*a):
                return search_mod._rescore_rows_padded(*a, params=params,
                                                       dim=dim)
            return fn, (r_hvs, rows_t, pmz, chg, q, qp, qc)
        return case

    raise ValueError(f"backend {backend!r} is not sweepable")


# ---------------------------------------------------------------------------
# Measurement + model
# ---------------------------------------------------------------------------


def _median_time(fn, args, iters: int) -> float:
    """Median seconds of ``iters`` calls after one warm-up: CUDA events
    around each call on the card, the host clock on the CPU."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn(*args)                                   # warm-up (and kernel build)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _roofline(backend: str, tiles: dict, *, dim: int, k: int, q_rows: int,
              r_rows: int):
    """The candidate's analytic work on the H100 (utils.roofline)."""
    from repro_torch.core import search as search_mod
    from repro_torch.utils import roofline
    W = dim // 32
    if backend in FUSED_BACKENDS:
        return roofline.fused_roofline(q_rows, r_rows, r_rows, W, dim, k, 1)
    if backend == "rescore":
        bucket = search_mod.row_bucket(r_rows, lo=tiles["row_bucket"])
        return roofline.tile_roofline(q_rows, bucket, W, dim)
    return roofline.tile_roofline(q_rows, r_rows, W, dim)


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def sweep_backend(backend: str, *, dim: int, k: int, q_rows: int,
                  r_rows: int, grid: str = "default", iters: int = 3,
                  seed: int = 0, timer=None, model: bool = True,
                  device=None) -> list[SweepRow]:
    """All candidates for one backend, best (winner) first.

    Every candidate's output is held bit for bit against the output at the
    kernel defaults first; a mismatch raises. ``timer(fn, args, tiles) ->
    seconds`` overrides the timing (tests); ``model=False`` skips the
    roofline terms.
    """
    from repro_torch import tune

    case = make_case(backend, dim=dim, k=k, q_rows=q_rows, r_rows=r_rows,
                     seed=seed, device=device)
    fn, args = case(tune.kernel_defaults(backend))
    want = _outputs(fn(*args))
    rows = []
    for tiles in grid_candidates(backend, grid):
        fn, args = case(tiles)
        got = _outputs(fn(*args))
        if not all(g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got, want)) or len(got) != len(want):
            raise RuntimeError(f"tune {backend}: candidate {tiles} changed "
                               f"the output (against the defaults)")
        t = (timer(fn, args, tiles) if timer is not None
             else _median_time(fn, args, iters))
        if model:
            roof = _roofline(backend, tiles, dim=dim, k=k, q_rows=q_rows,
                             r_rows=r_rows)
            flops, nbytes, t_bound = roof.flops, roof.hbm_bytes, roof.t_bound
        else:
            flops = nbytes = t_bound = 0.0
        rows.append(SweepRow(
            backend=backend, tiles=dict(tiles), median_us=t * 1e6,
            model_flops=flops, model_bytes=nbytes,
            t_bound_us=t_bound * 1e6,
            roofline_frac=(t_bound / t) if t > 0 else 0.0))
    rows.sort(key=SweepRow.sort_key)
    return rows


def run_sweeps(backends, *, dim: int, k: int, q_rows: int, r_rows: int,
               grid: str = "default", iters: int = 3, seed: int = 0,
               timer=None, model: bool = True,
               device=None) -> dict[str, list[SweepRow]]:
    """Sweep several backends; {backend: rows best-first}. Matrix backends
    ignore ``k`` at dispatch, so their winners are keyed k=0 in the cache
    (see :func:`save_winners`)."""
    return {be: sweep_backend(be, dim=dim, k=k, q_rows=q_rows,
                              r_rows=r_rows, grid=grid, iters=iters,
                              seed=seed, timer=timer, model=model,
                              device=device)
            for be in backends}


def cache_key_for(backend: str, *, dim: int, k: int, q_rows: int,
                  r_rows: int) -> dict:
    """The cache-key fields dispatch will look this winner up under:
    matrix winners carry no k (keyed 0); the rescore base is global per
    device (keyed dim=k=0, unit bucket)."""
    if backend in MATRIX_BACKENDS:
        return {"dim": dim, "k": 0,
                "shape_bucket": cache_mod.shape_bucket(q_rows, r_rows)}
    if backend == "rescore":
        return {"dim": 0, "k": 0, "shape_bucket": cache_mod.shape_bucket(0, 0)}
    return {"dim": dim, "k": k,
            "shape_bucket": cache_mod.shape_bucket(q_rows, r_rows)}


def save_winners(path, results: dict[str, list[SweepRow]], *, dim: int,
                 k: int, q_rows: int, r_rows: int, git_rev: str = "",
                 device=None) -> cache_mod.TuneCache:
    """Merge each backend's winner into the cache file at ``path``, keyed
    by the device kind of ``device``."""
    cache = cache_mod.TuneCache.load(path)
    for be, rows in results.items():
        if not rows:
            continue
        w = rows[0]
        cache.put(device_kind=device_kind(device), backend=be,
                  tiles=w.tiles, median_us=round(w.median_us, 1),
                  roofline_frac=round(w.roofline_frac, 6),
                  git_rev=git_rev,
                  **cache_key_for(be, dim=dim, k=k, q_rows=q_rows,
                                  r_rows=r_rows))
    cache.save(path)
    return cache


def format_table(results: dict[str, list[SweepRow]], *,
                 winners_only: bool = False) -> str:
    """Winner table (or the full sweep), fixed-width, winner row starred."""
    lines = [f"{'backend':<12} {'tiles':<38} {'median_us':>10} "
             f"{'t_bound_us':>10} {'roofline':>9}"]
    for be in sorted(results):
        rows = results[be][:1] if winners_only else results[be]
        for i, r in enumerate(rows):
            star = "*" if i == 0 else " "
            lines.append(
                f"{be:<12} {r.tiles_str():<38} {r.median_us:>10.1f} "
                f"{r.t_bound_us:>10.2f} {r.roofline_frac * 100:>8.3f}%{star}")
    return "\n".join(lines)
