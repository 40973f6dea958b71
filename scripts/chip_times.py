"""Time the PyTorch/CUDA port's paths on one GPU: the figures that only
report a time, which ``chip_smoke.py`` leaves out.

    python3 scripts/chip_times.py

Sections, each from its phase module in ``chip_smoke_phases/`` (after the
build, which every run does):

  backends  the main path's warm ``fused`` search and the kernel backends'
            (host clock ended by a synchronize);
  topk      both fused kernels on the whole Table I batch at top_k 16..1024;
  wide      both fused kernels at W = 4,096 words on a seeded batch;
  streamed  a warm streamed search at each slab size, with per-slab times;
  multi     warm sharded searches, one shard's search and the merge, warm
            streamed searches over 2 and 4 device entries;
  serve     ``search`` alone; each serve mode alone (q/s, latencies), in
            process under torch.profiler (idle share, kernel device time a
            micro-batch), the resident trace's host spans, one micro-batch's
            kernel calls replayed;
  tune      the tuner's sweep at 20 timed calls a candidate, winners against
            the defaults;
  lm        each LM serve subprocess alone (tok/s); each family's full model:
            prefill median of 5, decode steps, MFU, HBM share, device
            profiles; the new families' layers alone;
  train     Llama-3.2-3B remat train steps (median of 5, MFU), a profiled
            step, gradients against AdamW;
  dist      the pipeline against the sequential loop; checkpoint save and
            sharded restore GB/s at 4 layers.

Each section prints its seconds, then a ``[sections]`` line, one ``times``
JSON line, the card's name and power limit, and ``{"ok": true, ...}`` last.
It exits nonzero without a GPU. Nothing here is held against a reference:
the checks are chip_smoke.py's.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SECTIONS = (
    ("backends", "oms_paths", "times_backends"),
    ("topk", "oms_kernels", "times_topk"),
    ("wide", "oms_kernels", "times_wide"),
    ("streamed", "store_stream", "times_streamed"),
    ("multi", "multi", "times_multi"),
    ("serve", "launcher", "times_serve"),
    ("tune", "tune_analyze", "times_tune"),
    ("lm", "lm", "times_lm"),
    ("train", "train", "times_train"),
    ("dist", "dist", "times_dist"),
)
LAST_OMS = "tune"        # the last section that reads the main path and the store


def main() -> int:
    import importlib
    from chip_smoke_phases import common as C
    import torch
    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is false: this script needs a GPU")
    from chip_smoke_phases.context import Context
    from chip_smoke_phases.oms_kernels import env_build

    ctx = Context(torch)
    seconds, out = {}, {}
    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        env_build(ctx)
        seconds["env_build"] = time.perf_counter() - t0
        for name, module, fn in SECTIONS:
            t0 = time.perf_counter()
            out[name] = getattr(importlib.import_module(f"chip_smoke_phases.{module}"), fn)(ctx)
            seconds[name] = time.perf_counter() - t0
            C.log(f"[section] {name} in {seconds[name]:.1f}s")
            if name == LAST_OMS:
                for r in ("streamed", "store", "main"):
                    ctx.release(r)
    finally:
        ctx.close()
    seconds["total"] = time.perf_counter() - t_all
    C.log(f"[sections] {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    print(json.dumps({"times": out, "seconds": seconds, "card": ctx.env["smi"]}))
    print(ctx.env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
