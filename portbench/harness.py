"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the metrics, found by name.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose file is given in ``configs``, and a traffic mix,
``traffic/<name>.json``. The mix names its driver, ``drivers/<name>.py``,
which draws the inputs, builds the entry the window drives, warms it up,
runs the window and gives the check its reference (see
``drivers/closed_loop.py``). Each metric is read by ``metrics/<name>.py``'s
``read(record)``, which returns a number or ``None`` (nothing to read: the
metric is left out of the line). Nothing here names a cell, a
configuration, a mix, a driver or a metric.

The run: set-up is the driver's inputs, its build (timed as the ingest,
ended by a synchronise) and its warm-up; the window lasts ``seconds`` (the
request under way then finishes). Of the window's answers the first, the
last and ``SAMPLE`` drawn from the seed (reservoir sampling) are kept.
After the window the entry is freed and the reference answers the requests
they answer; each kept answer is compared with it entry by entry.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PORTBENCH = Path(__file__).resolve().parent
REPO = PORTBENCH.parent
BUILD = REPO / "build" / "portbench"
# Top-level module names that may not be loaded in the process that prints
# a result: JAX, its companions and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# Cells, found by name
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = REPO


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(bench: dict, workload: str, root: Path = REPO) -> Cell:
    """The cell ``workload`` with its configuration, mix and metrics, the
    files under ``root`` (a checkout)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {', '.join(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / PORTBENCH.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, root)


def _module(kind: str, name: str, root: Path):
    path = root / PORTBENCH.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = REPO):
    """``read`` of ``metrics/<metric>.py`` under ``root``."""
    return _module("metrics", metric, root).read


def driver(name: str, root: Path = REPO):
    """The module ``drivers/<name>.py`` under ``root``."""
    return _module("drivers", name, root)


# ---------------------------------------------------------------------------
# What a run records, for the metric readers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Record:
    cell: Cell
    setup_s: float
    ingest_s: float
    runs: list                    # (submit_ns, answer_ns, pool index, spectra)
    memory_peak_bytes: int | None
    spans: list = dataclasses.field(default_factory=list)     # (name, start_ns, end_ns)
    device_events: list = dataclasses.field(default_factory=list)  # (name, start_ns, end_ns)
    window_ns: tuple | None = None        # the traced window on the host clock
    busy_s: float | None = None
    gaps: dict = dataclasses.field(default_factory=dict)      # idle seconds by host span
    work: dict = dataclasses.field(default_factory=dict)      # pool index -> roofline bound
    card: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)  # the driver's, free-form

    def span_self_s(self, name: str) -> float | None:
        """Seconds inside spans ``name`` that no other span nested in them
        covers, summed over the window, or None when there are none."""
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        total, found = 0, False
        for n, a, b in spans:
            if n != name:
                continue
            found = True
            covered, end = 0, a
            for m, x, y in spans[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
                if m == name or y > b:
                    continue
                x = max(x, end)
                if y > x:
                    covered += y - x
                    end = y
            total += (b - a) - covered
        return total / 1e9 if found else None

    def kernel_s(self, names) -> float | None:
        """Device seconds of the events whose name holds any of ``names``,
        inside the window; None without a trace or with no such event."""
        if not self.device_events:
            return None
        t0, t1 = self.window_ns
        s = sum(min(b, t1) - max(a, t0) for n, a, b in self.device_events
                if any(k in n for k in names) and min(b, t1) > max(a, t0))
        return s / 1e9 if s > 0 else None


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def card_info(torch, device) -> dict:
    """SMs, maximum SM clock and power limit of the card."""
    info = {"n_sms": torch.cuda.get_device_properties(device).multi_processor_count}
    smi = shutil.which("nvidia-smi")
    if smi:
        q = subprocess.run([smi, "-i", str(torch.device(device).index or 0),
                            "--query-gpu=clocks.max.sm,power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60, check=True)
        clock, power = (float(x) for x in q.stdout.strip().splitlines()[0].split(","))
        info.update(max_sm_clock_hz=clock * 1e6, power_limit_w=power)
    return info


def default_search(entry, queries, top_k: int):
    return entry.search(queries, top_k=top_k)


# Answers of the window kept for the check besides its first and last.
SAMPLE = 4


@dataclasses.dataclass
class Context:
    """What a driver reads and fills: the cell, the seed, the device, the
    timed call ``search(entry, request, top_k)`` (tests and the control put
    another in its place); the driver's inputs (``library``, the window's
    ``pool`` of requests, the ``warm`` ones), the ``entry`` it builds, and
    ``counters``, free-form numbers it reads from the program for the
    metric readers. ``done`` records one request of the window."""
    cell: Cell
    seed: int
    device: object
    search: object
    library: object = None
    pool: list = dataclasses.field(default_factory=list)
    warm: list = dataclasses.field(default_factory=list)
    entry: object = None
    counters: dict = dataclasses.field(default_factory=dict)
    runs: list = dataclasses.field(default_factory=list)
    first: tuple | None = None
    last: tuple | None = None
    sample: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._choose = random.Random(self.seed)

    @property
    def top_k(self) -> int:
        return int(self.cell.traffic["top_k"])

    def done(self, submit_ns: int, answer_ns: int, j: int, spectra: int, answer) -> None:
        """Request ``j`` of the pool, submitted and answered at these host
        times, ``spectra`` query spectra, its host ``answer``."""
        i = len(self.runs)
        self.runs.append((submit_ns, answer_ns, j, spectra))
        if self.first is None:
            self.first = (j, answer)
        self.last = (j, answer)
        if i < SAMPLE:
            self.sample.append((j, answer))
        else:
            r = self._choose.randrange(i + 1)
            if r < SAMPLE:
                self.sample[r] = (j, answer)

    def kept(self) -> dict:
        """Pool index -> the kept answers to it, each once."""
        out: dict = {}
        for j, ans in [self.first, *self.sample, self.last]:
            if all(a is not ans for a in out.setdefault(j, [])):
                out[j].append(ans)
        return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device, t_start: float,
        search=default_search, min_runs: int = 0) -> tuple[dict, list[str]]:
    """One run; returns the result line's object and the check lines. The
    window lasts ``seconds`` and at least ``min_runs`` requests."""
    import torch

    from portbench import check, roofline
    from portbench.devtrace import (Profile, busy_intervals, idle_gaps, name_gaps,
                                    top_ops)
    from repro_torch.obs import trace as ptrace

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = cell.config
    drv = driver(cell.traffic["driver"], cell.root)
    ctx = Context(cell, int(seed), dev, search)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # -- set-up: inputs, build (the ingest), warm-up -------------------------
    t_data = time.perf_counter()
    drv.inputs(ctx)
    sync()
    data_s = time.perf_counter() - t_data
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ctx.entry = drv.build(ctx)
    sync()
    ingest_s = time.perf_counter() - t0
    t_warm = time.perf_counter()
    drv.warm(ctx)
    warm_s = time.perf_counter() - t_warm

    # -- the window ----------------------------------------------------------
    tracer = prof = None
    if trace:
        tracer = ptrace.install(ptrace.Tracer(capacity=1 << 22))
        if cuda:
            t_prof = time.perf_counter()
            prof = Profile(torch, dev, BUILD / "trace.json")
            prof.start()
            warm_s += time.perf_counter() - t_prof
    gc.collect()
    setup_s = time.perf_counter() - t_start
    start_ns = time.perf_counter_ns()
    drv.window(ctx, start_ns + int(seconds * 1e9), min_runs)
    end_ns = time.perf_counter_ns()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    runs = ctx.runs
    rec = Record(cell, setup_s, ingest_s, runs, memory_peak, counters=ctx.counters)
    if trace:
        ptrace.uninstall()
        rec.spans = [(e.name, e.t_start_ns, e.t_end_ns) for e in tracer.events()]
        rec.window_ns = (start_ns, end_ns)
        if prof is not None:
            prof.stop()
            rec.device_events = prof.events
            busy = busy_intervals(prof.events, start_ns, end_ns)
            rec.busy_s = sum(b - a for a, b in busy) / 1e9
            rec.gaps = name_gaps(idle_gaps(busy, start_ns, end_ns), rec.spans)

    # -- the check: free the entry, then the reference -----------------------
    got = ctx.kept()
    ctx.entry = ctx.first = ctx.last = ctx.sample = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    answer = drv.reference(ctx)
    answers = {j: answer(j) for j in sorted(got)}
    del answer
    diff = check.compare(got, answers)
    ref_s = time.perf_counter() - t_ref

    if trace:
        rec.card = card_info(torch, dev) if cuda else {}
        lib = roofline.Library(np.concatenate([ctx.library.pmz, ctx.library.pmz]),
                               np.concatenate([ctx.library.charge, ctx.library.charge]))
        for j in sorted({r[2] for r in runs}):
            q = ctx.pool[j]
            pairs, rows = lib.window_work(q.pmz, q.charge, cfg["oms"]["open_tol_da"])
            if "max_sm_clock_hz" in rec.card:
                rec.work[j] = roofline.bound(
                    pairs, rows, int(q.pmz.shape[0]), dim=cfg["oms"]["dim"],
                    top_k=ctx.top_k, n_sms=rec.card["n_sms"],
                    clock_hz=rec.card["max_sm_clock_hz"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    checks = {k: {"value": diff[k], "limit": lim} for k, lim in check.LIMITS.items()}
    correct = diff["answers"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": len(runs), "failed": diff["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": memory_peak}}
    if trace:
        result["device"].update(busy_s=rec.busy_s, window_s=(end_ns - start_ns) / 1e9)
        if rec.card:
            result["device"].update({k: rec.card[k] for k in ("max_sm_clock_hz", "power_limit_w")
                                     if k in rec.card})
        if prof is not None:
            result["breakdown"] = {
                "device_ops": top_ops(rec.device_events, start_ns, end_ns),
                "idle_gaps": [[k, v] for k, v in sorted(rec.gaps.items(),
                                                         key=lambda kv: -kv[1])[:10]]}
    result["checks"] = checks
    ms = np.array([(b - a) / 1e6 for a, b, _, _ in runs])
    half = len(ms) // 2
    lines = [f"window: {len(ms)} runs of {len({r[2] for r in runs})} distinct, run ms min "
             f"{ms.min():.3f} median {np.median(ms):.3f} p95 {np.percentile(ms, 95):.3f} max "
             f"{ms.max():.3f}; mean of first / second half "
             f"{ms[:half].mean() if half else ms.mean():.3f} / {ms[half:].mean():.3f}; "
             f"set-up {setup_s:.2f}s (data {data_s:.2f}s, ingest {ingest_s:.2f}s, "
             f"warm-up{' and profiler start' if prof else ''} {warm_s:.2f}s)"]
    lines += [f"checked {diff['answers']} answers of {len(got)} pool runs "
              f"({diff['entries']} winner entries) in {ref_s:.1f}s of reference"]
    lines += [f"{k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    return result, lines


def forbidden_loaded() -> list[str]:
    """Forbidden top-level module names present in ``sys.modules``."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN_MODULES))


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ.pop("REPRO_TUNE_CACHE", None)
