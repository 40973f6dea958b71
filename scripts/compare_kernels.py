"""Time this checkout's kernels against another checkout's, on one GPU, in
one process.

    python3 scripts/compare_kernels.py --other PATH

Each tree's kernel library is built from its own sources (by its own
``repro_torch/kernels/_build.py``, into its own ``build/``) and called
through its C launchers on the same device tensors:

* hamming_matrix and hamming_mxu at the main path's tile (16 queries x
  143,360 rows x 128 words), at the dimension cascade's prefix tile (the
  same rows at 8 words) and at its row bucket (16 x 4,194,304 x 128 words);
* hdencode on 4,096 library spectra x 64 peaks at dim 4096 (the synthetic
  iPRG2012-like generator, seed 0, preprocessed as the ingest does);
* fused_search and fused_search_mxu on the whole Table I batch (the
  iPRG2012-scale library and 16,000 queries of chip_smoke.py's main path
  (``chip_smoke_phases``' seed and encode batch), sorted and padded as the
  main path does, k = 1), each tree with its own
  split count (its own ``n_splits_for``).

Every shape runs other, this, this, other. Each run times one launch
between CUDA events (median of 10) and a CUDA graph of 20 launches (median
of 10 replays, divided by 20): the device's own time, left out for the
fused kernels, whose one launch dwarfs the host work. Both trees' outputs
must be bit-identical (all four arrays of a fused search). Needs a GPU and
``nvcc``; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke_phases import common as C  # noqa: E402
from repro_torch.core import encode_backends, search  # noqa: E402
from repro_torch.core.blocking import PAD_PMZ  # noqa: E402
from repro_torch.core.pipeline import OMSConfig, OMSPipeline, _make_codebooks  # noqa: E402
from repro_torch.data.spectra import LibraryConfig, iprg2012_config, make_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.kernels.hamming import ref as href  # noqa: E402

ITERS = C.TIMING_ITERS
GRAPH_LAUNCHES = C.GRAPH_LAUNCHES
MAIN_ROWS = 143_360
BUCKET_ROWS = 4_194_304
SPECTRA = C.ENCODE_BATCH


FUSED = ("fused_search_launch", "fused_search_mxu_launch")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_library(path: Path) -> ctypes.CDLL:
    """Build and load the kernel library of the checkout at ``path``."""
    mod = _load("other_build", path / "src" / "repro_torch" / "kernels" / "_build.py")
    lib = ctypes.CDLL(str(mod.build()))
    for name in ("hamming_matrix_launch", "hamming_mxu_launch", "hdencode_launch", *FUSED):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = mod._SIGNATURES[name]
    return lib


def tile_grid_args(lib) -> tuple:
    """The tile launchers' trailing grid argument (ctas_per_sm 0, the
    occupancy fill) where the library's launchers take one."""
    takes = len(lib.hamming_matrix_launch.argtypes) == 8
    return (0,) if takes else ()


def fused_cases(libs, n_splits_fns, dev) -> dict:
    """The two fused kernels on the whole Table I batch, called through each
    tree's C launcher with that tree's split count."""
    ds = make_dataset(iprg2012_config(scale=1.0, seed=C.SEED))
    cfg = OMSConfig(backend="fused", encode_backend="pallas", encode_batch=SPECTRA,
                    seed=C.SEED)
    pipe = OMSPipeline(cfg, ds.refs, device=dev, chunk_rows=C.CHUNK_ROWS)
    hvs, q_pmz, q_charge = pipe.encode_queries(ds.queries)
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    gather, _ = search.sort_pad_plan(q_pmz, q_charge, params.q_block)
    qh, qp, qc = hvs[gather], q_pmz[gather], q_charge[gather]
    starts = search.block_start_rows(pipe.db, params, qp, qc)
    if params.q_block != hops.QT:
        raise RuntimeError(f"q_block {params.q_block}: the comparison assumes 16")
    db = pipe.db
    rk = params.k_blocks * db.max_r
    n_tiles, k = starts.shape[0], params.top_k
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {}
    for launcher in FUSED:
        outs = {t: [torch.empty((n_tiles * hops.QT, k), dtype=torch.int32, device=dev)
                    for _ in range(4)] for t in libs}
        partial = {t: torch.empty((n_tiles, n_splits_fns[t](n_tiles, rk, n_sms), 2 * hops.QT,
                                   k), dtype=torch.int64, device=dev) for t in libs}

        def call(t, launcher=launcher, outs=outs, partial=partial):
            rc = getattr(libs[t], launcher)(
                *(x.data_ptr() for x in (qh, qp, qc, db.hvs, db.pmz, db.charge, starts,
                                         partial[t], *outs[t])),
                n_tiles, db.n_rows, qh.shape[1], cfg.dim, k, rk, partial[t].shape[1],
                href.std_scale(params.ppm_tol), float(params.open_tol_da), PAD_PMZ,
                stream())
            if rc:
                raise RuntimeError(f"{t} {launcher}: CUDA error {rc}")
        name = (f"{launcher.removesuffix('_launch')} whole batch {n_tiles} blocks x {rk} "
                f"rows x {qh.shape[1]} words, k={k}")
        cases[name] = (call, outs, False)
    return cases


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn) -> float:
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    ms = event_ms(graph.replay) / GRAPH_LAUNCHES
    del graph
    return ms


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout (e.g. the parent commit)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = C.nvidia_smi("name,power.limit")
    libs = {"other": other_library(args.other.resolve()), "this": _build.library()}
    other_ops = _load("other_hamming_ops", args.other.resolve() / "src" / "repro_torch"
                      / "kernels" / "hamming" / "ops.py")
    n_splits_fns = {"other": other_ops.n_splits_for, "this": hops.n_splits_for}

    g = torch.Generator(device=dev).manual_seed(0)

    def words(n, w):
        return torch.randint(0, 2 ** 32, (n, w), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    q = words(16, 128)
    rows = words(BUCKET_ROWS, 128)
    cases = {}
    for kernel in ("hamming_matrix", "hamming_mxu"):
        for what, r in (("main tile", rows[:MAIN_ROWS]),
                        ("prefix tile", rows[:MAIN_ROWS, :8].contiguous()),
                        ("bucket", rows)):
            qw = q[:, :r.shape[1]].contiguous()
            outs = {k: torch.empty((16, r.shape[0]), dtype=torch.int32, device=dev)
                    for k in libs}

            def call(k, kernel=kernel, qw=qw, r=r, outs=outs):
                R, W = r.shape
                args = (qw.data_ptr(), r.data_ptr(), outs[k].data_ptr(), 16, R, W)
                grid = tile_grid_args(libs[k])
                if kernel == "hamming_mxu":
                    rc = libs[k].hamming_mxu_launch(*args, 32 * W, *grid, stream())
                else:
                    rc = libs[k].hamming_matrix_launch(*args, *grid, stream())
                if rc:
                    raise RuntimeError(f"{k} {kernel}_launch: CUDA error {rc}")
            cases[f"{kernel} {what} 16 x {r.shape[0]} x {r.shape[1]}"] = (call, outs, True)

    cfg = OMSConfig(encode_batch=SPECTRA, seed=0)
    cb = _make_codebooks(cfg, dev)
    ds = make_dataset(LibraryConfig(n_refs=SPECTRA, n_queries=128, seed=0))
    pre = encode_backends._preprocess(*(torch.as_tensor(x, device=dev) for x in ds.refs),
                                      cfg.preprocess_params)
    B, P = pre.bins.shape
    W = cb.id_hvs.shape[1]
    hd_outs = {k: torch.empty((B, W), dtype=torch.int32, device=dev) for k in libs}

    def hd_call(k):
        rc = libs[k].hdencode_launch(
            pre.bins.data_ptr(), pre.levels.data_ptr(), pre.mask.data_ptr(),
            cb.id_hvs.data_ptr(), cb.level_hvs.data_ptr(), cb.tiebreak.data_ptr(),
            hd_outs[k].data_ptr(), B, P, W, stream())
        if rc:
            raise RuntimeError(f"{k} hdencode_launch: CUDA error {rc}")
    cases[f"hdencode {B} x {P} peaks, dim {32 * W} "
          f"({int(pre.mask.sum())} valid)"] = (hd_call, hd_outs, True)

    cases.update(fused_cases(libs, n_splits_fns, dev))

    result = {}
    for name, (call, outs, graphed) in cases.items():
        res = {k: {"event_ms": [], "graph_ms": []} for k in libs}
        for k in ("other", "this", "this", "other"):
            res[k]["event_ms"].append(event_ms(lambda: call(k)))
            if graphed:
                res[k]["graph_ms"].append(graph_ms(lambda: call(k)))
        torch.cuda.synchronize()
        same = all(bool((a == b).all()) for a, b in zip(
            *(o if isinstance(o, list) else [o] for o in (outs["this"], outs["other"]))))
        if not same:
            raise RuntimeError(f"{name}: the two trees' outputs differ")
        result[name] = res
        print(f"[compare] {name}: other event {res['other']['event_ms']} graph "
              f"{res['other']['graph_ms']}; this event {res['this']['event_ms']} "
              f"graph {res['this']['graph_ms']} (ms); outputs bit-identical",
              flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "other": str(args.other), "cases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
