"""What the program's spans cost when a tracer is installed: alternating
windows of one benchmark cell, with a ``repro_torch.obs.trace.Tracer``
installed (no profiler) and without, in one process on one built pipeline.

    python3 scripts/trace_cost.py --workload <cell> --seed <n> --seconds 30 \\
        --order 0,1,1,0,0,1

Each window is the cell's driver loop (``portbench/drivers``) for
``--seconds``; a line per window gives ``spectra_per_s`` and ``run_p95_ms``
as the benchmark reads them, and per span name the spans a run and their
host milliseconds a run (the tracer's, whole durations). Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--order", default="0,1,1,0,0,1",
                    help="1 = tracer installed, 0 = none, one a window")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from repro_torch.obs import trace

    harness.cache_dirs()
    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    drv = harness.driver(cell.traffic["driver"])
    ctx = harness.Context(cell, args.seed, torch.device("cuda:0"), harness.default_search)
    drv.inputs(ctx)
    ctx.entry = drv.build(ctx)
    drv.warm(ctx)
    for traced in (int(x) for x in args.order.split(",")):
        ctx.runs = []
        tracer = trace.install(trace.Tracer(capacity=1 << 22)) if traced else None
        start = time.perf_counter_ns()
        try:
            drv.window(ctx, start + int(args.seconds * 1e9), 0)
        finally:
            trace.uninstall()
        rec = harness.Record(cell, 0.0, 0.0, ctx.runs, None)
        per_run = {}
        for ev in tracer.events() if tracer else ():
            c, ms = per_run.get(ev.name, (0, 0.0))
            per_run[ev.name] = (c + 1, ms + ev.dur_ns / 1e6)
        line = {"workload": cell.name, "seed": args.seed, "traced": traced,
                "runs": len(ctx.runs),
                "spectra_per_s": harness.reader("spectra_per_s")(rec),
                "run_p95_ms": harness.reader("run_p95_ms")(rec),
                "spans": tracer.n_recorded if tracer else 0, "card": card,
                "span_per_run": {k: [c / len(ctx.runs), ms / len(ctx.runs)]
                                 for k, (c, ms) in sorted(per_run.items())}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
