"""Multi-pod dry run: every (arch x shape x mesh) cell laid out on the
production meshes, restated for PyTorch.

Counterpart of ``repro.launch.dryrun``. The reference forces 512 host
devices, lowers and compiles every cell's step under its in_shardings and
reads XLA's memory and cost analyses and the collectives of the
partitioned HLO. PyTorch has no such compile of a sharded program, so the
port restates what it can without one:

  * the cell's inputs are ``meta`` tensors (``launch/specs.py``), laid out
    on the production mesh of 256 or 512 ``meta`` entries;
  * ``arg_bytes_per_device``: the bytes each device holds under the
    sharding rules after ``enforce_divisibility`` (the reference's
    ``_sharded_arg_bytes``, equal to its numbers), and ``fits``: that
    against the card's memory;
  * ``per_chip`` FLOPs and bytes: the analytic work of the whole step
    (``utils/roofline.lm_train_roofline`` / ``lm_step_roofline``: the
    published model, real heads) over the chips, and ``roofline`` from
    them at the H100's peaks, ``model_flops`` by the reference's formulas.
    The analytic count covers decoders of attention blocks (dense, MoE,
    VLM); for MLA, recurrent, xLSTM and audio archs ``per_chip`` is null
    and ``roofline`` holds ``model_flops`` alone.

Written as null, with no PyTorch counterpart: ``memory_analysis`` (XLA's
argument / output / temp / peak bytes of the compiled program),
``cost_analysis_raw``, ``collectives`` and ``coll_bytes`` (collectives are
not reckoned: the port drives one device per step, and no partitioned
program exists to read them from), ``lower_s`` and ``compile_s``.
``--unroll`` is accepted and recorded; the analytic count is whole-step
either way. No environment variable is set.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.distributed.sharding import tree_items
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import make_cell
from repro_torch.utils import roofline as rl

# NVIDIA H100 SXM5 datasheet: 80 GB of HBM3, read when no card is present
H100_MEMORY_BYTES = 80e9


def _sharded_arg_bytes(args, in_specs, mesh) -> float:
    """Per-device bytes of the step inputs under their shardings."""
    total = 0.0
    for a_tree, s_tree in zip(args, in_specs):
        flat_a = [a for _, a in tree_items(a_tree)]
        flat_s = [s for _, s in tree_items(s_tree)]
        if len(flat_a) != len(flat_s):
            raise ValueError(f"{len(flat_a)} args, {len(flat_s)} specs")
        for a, s in zip(flat_a, flat_s):
            n = float(np.prod(a.shape)) * a.element_size()
            denom = 1
            for axis in (s or ()):
                if axis is None:
                    continue
                for ax in (axis if isinstance(axis, tuple) else (axis,)):
                    denom *= mesh.shape[ax]
            total += n / denom
    return total


def device_memory() -> tuple[float, str]:
    """The card's memory in bytes and where the number comes from."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                "torch.cuda.get_device_properties")
    return H100_MEMORY_BYTES, "NVIDIA H100 SXM5 datasheet (80 GB)"


def _work(cfg, cell, shape):
    """The whole step's analytic FLOPs and bytes, or None where
    ``utils/roofline`` does not count the arch."""
    try:
        if cell.kind == "train":
            return rl.lm_train_roofline(cfg, shape.global_batch, shape.seq_len,
                                        remat=cell.model.remat)
        if cell.kind == "prefill":
            return rl.lm_step_roofline(cfg, shape.global_batch, shape.seq_len,
                                       shape.seq_len)
        return rl.lm_step_roofline(cfg, shape.global_batch, 1, shape.seq_len)
    except ValueError:
        return None


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             n_microbatches: int = 4, verbose: bool = True,
             unroll: bool = False, chunk: int = 1024) -> dict:
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    chips = int(np.prod(list(mesh.shape.values())))
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "multi_pod": multi_pod, "chips": chips,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    t0 = time.time()
    cell = make_cell(arch, shape_name, mesh=mesh, n_microbatches=n_microbatches,
                     chunk=chunk)
    if cell.kind == "train":
        model_flops = rl.model_flops_train(cell.n_params_active, cell.tokens_per_step)
    elif cell.kind == "prefill":
        model_flops = 2.0 * cell.n_params_active * cell.tokens_per_step
    else:
        model_flops = rl.model_flops_decode(cell.n_params_active, cell.tokens_per_step)

    work = _work(cfg, cell, shape)
    if work is None:
        per_chip = None
        roof = {"model_flops": model_flops / chips}
    else:
        per_chip = {"flops": work.flops / chips, "bytes": work.hbm_bytes / chips,
                    "coll_bytes": None}
        roof = rl.Roofline(flops=per_chip["flops"], hbm_bytes=per_chip["bytes"],
                           coll_bytes=0.0, chips=1, model_flops=model_flops / chips,
                           ops_per_s=work.ops_per_s, route=work.route).as_dict()
        roof.update(coll_bytes=None, t_collective_s=None)
    arg_bytes_per_dev = _sharded_arg_bytes(cell.args, cell.in_specs, mesh)
    mem, mem_source = device_memory()
    t_specs = time.time() - t0

    rec.update(
        status="ok", kind=cell.kind, unrolled=unroll,
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        n_params=cell.n_params, n_params_active=cell.n_params_active,
        tokens_per_step=cell.tokens_per_step,
        lower_s=None, compile_s=None, specs_s=round(t_specs, 3),
        memory_analysis=None,
        arg_bytes_per_device=arg_bytes_per_dev,
        arg_bytes_global=cell.arg_bytes,
        fits=arg_bytes_per_dev <= mem, device_memory_bytes=mem,
        device_memory_source=mem_source,
        cost_analysis_raw=None,
        per_chip=per_chip,
        collectives=None,
        roofline=roof,
    )
    if verbose:
        work_s = ("work not reckoned" if per_chip is None else
                  f"flops={per_chip['flops']:.3e} bytes={per_chip['bytes']:.3e} "
                  f"bottleneck={roof['bottleneck']}")
        print(f"[dryrun] {arch} x {shape_name} mesh={rec['mesh']}: specs "
              f"{t_specs:.2f}s {work_s} args/dev={arg_bytes_per_dev / 2**30:.2f}GiB "
              f"fits={rec['fits']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--unroll", action="store_true",
                    help="recorded only: the analytic work is whole-step")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else list_archs()
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[dryrun] {tag}: cached")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               n_microbatches=args.microbatches,
                               unroll=args.unroll, chunk=args.chunk)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures += 1
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"[dryrun] done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
