"""Phase 22: the port's examples as subprocesses.

22. ``examples/quickstart_torch.py`` on the card and with ``--device cpu``
    (the CPU run started with phase 21, on EXAMPLE_CPU_THREADS threads),
    their lines equal; ``oms_search_e2e_torch.py`` on the card, every
    ``[backend ...]`` line reporting the ``[serve]`` lines'
    identifications; ``serve_lm_torch.py``; ``train_lm_torch.py --steps 5``
    into a checkpoint directory under build/ (deleted after). The card's
    four run side by side. Each must exit 0; their times are printed.
"""
from __future__ import annotations

import re
import shutil
import sys
import time

from . import common as C
from .common import log, require

EXAMPLE_CKPT_DIR = C.BUILD / "smoke_example_ckpt"
EXAMPLE_TRAIN_STEPS = 5
EXAMPLE_CPU_THREADS = 4


def example(name: str, args=(), threads=C.SIDE_THREADS) -> C.Proc:
    """``python examples/<name>.py *args`` from the repository root, started."""
    return C.Proc([sys.executable, C.HERE / "examples" / f"{name}.py", *args],
                  f"example {' '.join([name, *map(str, args)])}", threads=threads)


def start_cpu_quickstart(ctx) -> C.Proc:
    """The quickstart on the CPU (the longest example), started early."""
    return example("quickstart_torch", ["--device", "cpu"], threads=EXAMPLE_CPU_THREADS)


def examples(ctx) -> None:
    """Phase 22: the four examples on the card side by side; the quickstart
    on the CPU, its lines equal to the card's. Sets the ``examples`` JSON
    line's object."""
    t_phase = time.perf_counter()
    cpu = ctx.background.pop("examples", None) or start_cpu_quickstart(ctx)
    shutil.rmtree(EXAMPLE_CKPT_DIR, ignore_errors=True)
    ctx.remove_later(EXAMPLE_CKPT_DIR)
    procs = {"quickstart": example("quickstart_torch"),
             "oms_search_e2e": example("oms_search_e2e_torch"),
             "serve_lm": example("serve_lm_torch"),
             "train_lm": example("train_lm_torch", ["--steps", EXAMPLE_TRAIN_STEPS,
                                                    "--ckpt-dir",
                                                    EXAMPLE_CKPT_DIR])}
    got, out = {}, {}
    for name, proc in (*procs.items(), ("quickstart_cpu", cpu)):
        got[name], _, out[f"{name}_s"] = proc.result()
        log(f"[examples] {proc.what[len('example '):]}: exited 0 in {out[f'{name}_s']:.1f}s")
    shutil.rmtree(EXAMPLE_CKPT_DIR, ignore_errors=True)
    qs, e2e, serve, train = (got[k] for k in ("quickstart", "oms_search_e2e", "serve_lm",
                                              "train_lm"))
    log("[examples] quickstart_torch on the card:\n" + qs.rstrip())
    require(len(qs.splitlines()) == 6 and qs == got["quickstart_cpu"],
            f"quickstart_torch: the card's lines differ from the CPU's:\n{qs}\n---\n"
            f"{got['quickstart_cpu']}")
    log("[examples] quickstart_torch --device cpu printed the same 6 lines")
    lines = e2e.splitlines()
    log("[examples] oms_search_e2e_torch on the card:\n" + e2e.rstrip())
    ids = {m.group(1) for x in lines if x.startswith(("[serve]", "[backend"))
           for m in [re.search(r"ids=(\d+)$", x)] if m}
    require(sum(x.startswith("[backend") for x in lines) == 7 and len(ids) == 1
            and sum(x.startswith("[serve]") for x in lines) == 3
            and lines[-1].startswith("[top-k] "),
            f"oms_search_e2e_torch: backends or batches disagree:\n{e2e}")
    require(serve.startswith("[serve] generated 64 tokens"), f"serve_lm_torch:\n{serve}")
    require(f"[train] done at step {EXAMPLE_TRAIN_STEPS};" in train, f"train_lm_torch:\n{train}")
    log(f"[examples] serve_lm_torch: {serve.strip()}")
    log(f"[examples] train_lm_torch: {train.strip().splitlines()[-1]}")
    out.update(card=ctx.env["smi"], quickstart_lines=qs.splitlines(), e2e_lines=lines,
               e2e_identifications=int(ids.pop()), phase_s=time.perf_counter() - t_phase)
    ctx.lines["examples"] = out
