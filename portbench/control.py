"""The control of the comparison that decides ``correct``: the program's
own approximate path in place of the timed search, which has to come out
as not correct.

The configurations state an exact top-k. The program's dimension cascade
with a margin (``prefix_words`` > 0, ``prefix_margin`` >= 0) is its own path
that gives that guarantee up: rows outside the seed pass's precursor window
(``prefix_seed_da``) are kept only when their first ``prefix_words`` words
alone reach the running threshold, the step a later change might take to
scan less. Here it runs with a quarter of the words, margin 0 and a seed
window of 0.01 Da, on the first ``RUNS`` runs of the cell's pool at its
own size, and the harness's check compares every answer.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed (``correct``, the numbers compared and their
limits) and exits 0 only where every seed came out not correct. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

SEED_DA = 0.01
# Runs of the window; the check keeps up to this many answers besides the
# first and the last, so it compares each.
RUNS = 4


def approximate_search(seed_da: float):
    """``pipe.search`` through the program's margin cascade."""
    def search(pipe, queries, top_k: int):
        if pipe.cfg.prefix_seed_da != seed_da:
            pipe.cfg = dataclasses.replace(pipe.cfg, prefix_seed_da=seed_da)
        return pipe.search(queries, top_k=top_k, prefix_words=pipe.cfg.n_words // 4,
                           prefix_margin=0)
    return search


def run_control(cell, seed: int, *, device, seed_da: float = SEED_DA) -> dict:
    """One seed of the control: ``RUNS`` runs of the pool answered.
    ``seed_da`` has to leave k seed rows in a query's window, or the cascade
    keeps every row there and is exact: 0.01 Da does at Table I's density
    (~10% of the rows are seeds), a library of a few thousand spectra needs
    about 1 Da."""
    from portbench import harness
    result, _ = harness.run(cell, seed, 0.0, False, device=device,
                            t_start=time.perf_counter(), search=approximate_search(seed_da),
                            min_runs=RUNS)
    return {"seed": seed, "correct": result["correct"], "attempted": result["attempted"],
            "checks": result["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    from portbench import harness
    harness.cache_dirs()
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_control(cell, seed, device="cuda:0")
        print(json.dumps({"workload": cell.name, **out}), flush=True)
        failed_all &= not out["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
