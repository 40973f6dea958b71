"""Check the PyTorch/CUDA port on one GPU: every kernel bit for bit against
its plain version, every OMS path against ``fused``, the LM serve, training
and distribution paths against the CPU, the launchers and the examples.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --list           # the phases (needs no GPU)
    python3 chip_smoke.py --only tile_check,backends

The phases live in ``chip_smoke_phases/`` (each module's docstring says
what its phases hold); ``chip_smoke_phases.PHASES`` registers them in the
order below. ``--only`` runs the named phases after phase 1 (the build),
plus the data, the main path's ingest and the store they read. Any failure
exits nonzero; nothing is caught into a success. The timing-only runs
(LM prefill and decode, training steps, top-k sweep, serve q/s, ...) are
``scripts/chip_times.py``'s.

  1. env_build (oms_kernels): card, power limit, toolchain; the build.
  2. hdencode (oms_kernels): hdencode and the tile kernels at their edges.
  3. main_path (oms_paths): the Table I main path; fused_search on its
     blocks, on grouped runs and at the grouped design's edges.
  4. paths (oms_paths): kernels against the plain torch ops and the CPU;
     the device planner against the host's at the benchmark's sizes.
  5. times (oms_kernels): hdencode and fused_search timed, their bounds.
  6. tile_check (oms_kernels): the tile kernels on main-path blocks and the
     cascade's bucket; fused_search_mxu on main-path blocks.
  7. fused_mxu_batch (oms_kernels): fused_search_mxu == fused_search.
  8. backends (oms_paths): kernel_vpu, kernel_mxu, fused_mxu == fused.
  9. cascade (oms_paths): the dimension cascade, exact and margin mode.
 10. times_mxu (oms_kernels): the tile kernels and fused_search_mxu timed.
 11. topk_limits (oms_kernels): top_k 17..1024 and the widened limits.
 12. store (store_stream): the store and its resident load.
 13. streamed (store_stream): streamed search at three slab sizes.
 14. streamed_cascade (store_stream): the streamed exact cascade.
 15. narrow_cascade (store_stream): the narrow→open cascade.
 18. multi_device (multi): sharded and multi-device streamed search.
 16. launcher (launcher): ``python -m repro_torch.launch.oms`` end to end.
 17. tune_analyze (tune_analyze): the tuner and the contract analyzer.
 19. lm (lm): the LM serve path of every family.
 20. train (train): LM training.
 21. dist (dist): LM distribution.
 22. examples (examples): the port's examples.

Each phase prints its seconds; a ``[phases]`` line gives them all and the
total. All five kernels go into one ``kernels`` JSON line; ``launches`` is
the main path's count (the backend's own path for the tile and fused_mxu
kernels) and ``launches_by_path`` each path's, counts set to 0 just before
the path and read just after. Phase 19's results go into one ``lm`` JSON
line, phase 20's into ``train``, 21's into ``dist`` and 22's into
``examples`` before it. The last line is ``{"ok": true, "device": {...}}``.
The script imports neither jax nor the reference package, and it exits
nonzero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true", help="print the phases and exit")
    ap.add_argument("--only", default="",
                    help="comma-separated phase names: run these (and what they read)")
    args = ap.parse_args(argv)
    if not (HERE / "src" / "repro_torch").is_dir() or not (HERE / "chip_smoke_phases").is_dir():
        _fail(f"no src/repro_torch or chip_smoke_phases beside {Path(__file__).name}: run "
              "it from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import chip_smoke_phases as P
    if args.list:
        for p in P.PHASES:
            print(f"{p.number:>2} {p.name:<18} {p.module:<13} {p.summary}")
        return 0
    only = [n for n in args.only.split(",") if n]
    unknown = sorted(set(only) - set(P.NAMES))
    if unknown:
        _fail(f"no phase {', '.join(unknown)} (phases: {', '.join(P.NAMES)})")
    phases = [p for p in P.PHASES if not only or p.name in only or p.number == 1]

    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs a GPU")
    from chip_smoke_phases import common as C
    from chip_smoke_phases.context import Context
    from chip_smoke_phases.oms_kernels import OWN_PATH
    C.log(f"[phases] running {', '.join(p.name for p in phases)}")

    ctx = Context(torch)
    # A phase's side processes start with the phase named in start_with
    # where that one runs, else with the phase itself.
    names = [p.name for p in phases]
    starts = {}
    for p in phases:
        if p.background:
            starts.setdefault(p.start_with if p.start_with in names else p.name, []).append(p)
    # The resources each phase reads, released after the last that reads them.
    last_reader = {}
    for i, p in enumerate(phases):
        for r in p.needs:
            last_reader[r] = i
    seconds = {}
    t_all = time.perf_counter()
    try:
        for i, p in enumerate(phases):
            t0 = time.perf_counter()
            for q in starts.get(p.name, ()):
                ctx.background[q.name] = q.load(q.background)(ctx)
            p.load()(ctx)
            seconds[p.name] = time.perf_counter() - t0
            C.log(f"[phase] {p.number} {p.name} passed in {seconds[p.name]:.1f}s")
            for r in ("streamed", "store", "main"):
                if last_reader.get(r) == i:
                    ctx.release(r)
    finally:
        ctx.close()
    total = time.perf_counter() - t_all
    C.log(f"[phases] {json.dumps({**{k: round(v, 1) for k, v in seconds.items()}, 'total': round(total, 1)})}")

    kernels = []
    for name in OWN_PATH:
        if name in ctx.kernels:
            k = ctx.kernels[name]
            k["launches_by_path"] = ctx.by_path[name]
            k["launches"] = ctx.by_path[name].get(OWN_PATH[name])
            kernels.append(k)
    if not only:
        C.require([k["name"] for k in kernels] == list(OWN_PATH)
                  and all(k["launches"] for k in kernels),
                  f"the kernels line lacks a kernel or its launches: "
                  f"{[(k['name'], k['launches']) for k in kernels]}")
    C.log(f"[done] all phases passed in {total:.1f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key in ("lm", "train", "dist", "examples"):
        if key in ctx.lines:
            print(json.dumps({key: ctx.lines[key]}))
    print(json.dumps({"kernels": kernels}))
    print(ctx.env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
