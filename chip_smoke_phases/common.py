"""What every phase shares: logging and failing, the seed and the dataset
constants, CUDA timing, and subprocesses that run beside the phase that
started them.

Nothing here imports torch or the port at import time, so the registry can
be listed on a machine without a GPU.
"""
from __future__ import annotations

import atexit
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SRC = HERE / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))
BUILD = HERE / "build"

SEED = 0
DEVICE = "cuda"
ENCODE_BATCH = 4096      # spectra per hdencode launch on the main path
CHUNK_ROWS = 1 << 16     # library rows per ingest chunk
TIMING_ITERS = 10
GRAPH_LAUNCHES = 20      # launches per captured CUDA graph (device times)
CLI_TIMEOUT_S = 300      # any one subprocess
# Torch intra-op threads of a subprocess that runs beside others (its work
# is on the card; this keeps the host's cores from being oversubscribed).
SIDE_THREADS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    # the process's own stderr: a phase may be running the launcher in
    # process with sys.stderr captured
    print(f"[chip_smoke] FAILED: {msg}", file=sys.__stderr__, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: bool = True) -> float:
    """Median milliseconds of ``fn()`` on the card over ``iters`` runs (after
    one warm-up run unless the caller has just run it), each bracketed by
    CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device milliseconds of one ``fn()``: ``launches`` calls captured in a
    CUDA graph, the graph's replay timed as cuda_ms times a call, divided
    by ``launches``. Around a single call, cuda_ms also counts the
    wrapper's host work whenever the kernel is shorter than it; a replay
    has none between its events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = cuda_ms(graph.replay) / launches
    del graph
    return ms


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def rel_err(a, ref) -> float:
    """max |a - ref| / max |ref|, in float32 on the host."""
    a, ref = a.float().cpu(), ref.float().cpu()
    return float((a - ref).abs().max() / ref.abs().max())


def counters():
    """The tile and fused kernels' launch counters by kernel name."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    return {"hamming_matrix": hops.matrix_launches, "hamming_mxu": mops.matrix_launches,
            "fused_search_mxu": mops.launches, "fused_search": hops.launches}


def counted(torch, fn):
    """Run ``fn`` with every tile/fused launch count set to 0 just before;
    returns (result, seconds to the device's end, counts read just after)."""
    cs = counters()
    for c in cs.values():
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    return out, t, {n: c.count for n, c in cs.items()}


# ---------------------------------------------------------------------------
# Subprocesses
# ---------------------------------------------------------------------------

_RUNNING: list["Proc"] = []


class Proc:
    """``cmd`` started now from the repository root, awaited by ``result()``.
    stdout and stderr go to files under build/ (a pipe would stall a
    process that writes more than its buffer before it is read); stdin
    comes from ``stdin`` (a path) or nowhere. A watcher thread notes the
    moment it exits, so ``seconds`` is its own run time however late it is
    read."""

    def __init__(self, cmd, what: str, *, stdin=None, stdout=None,
                 expect_failure: bool = False, threads: int | None = None,
                 timeout: float = CLI_TIMEOUT_S):
        env = {**os.environ, "PYTHONPATH": str(SRC)}
        if threads is not None:
            env["OMP_NUM_THREADS"] = str(threads)
        BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}_{len(_RUNNING)}_{time.monotonic_ns()}"
        self.out_path = Path(stdout) if stdout else BUILD / f"smoke_proc_{tag}.out"
        self.err_path = BUILD / f"smoke_proc_{tag}.err"
        self.keep_out = stdout is not None
        self.what, self.cmd = what, [str(c) for c in cmd]
        self.expect_failure, self.timeout = expect_failure, timeout
        fin = open(stdin) if stdin else subprocess.DEVNULL
        with open(self.out_path, "w") as fout, open(self.err_path, "w") as ferr:
            self.t0 = time.perf_counter()
            self.proc = subprocess.Popen(self.cmd, cwd=HERE, env=env, stdin=fin,
                                         stdout=fout, stderr=ferr, text=True)
        if fin is not subprocess.DEVNULL:
            fin.close()
        self.t_end = None
        self.watch = threading.Thread(target=self._wait, daemon=True)
        self.watch.start()
        _RUNNING.append(self)

    def _wait(self) -> None:
        self.proc.wait()
        self.t_end = time.perf_counter()

    def result(self) -> tuple[str, str, float]:
        """(stdout text, stderr text, seconds) once the process has exited
        0 (with ``expect_failure``, nonzero); fails the run if it outlives
        its timeout."""
        self.watch.join(max(0.0, self.t0 + self.timeout - time.perf_counter()))
        if self.watch.is_alive():
            self.stop()
            fail(f"{self.what}: `{' '.join(self.cmd[1:])}` ran past {self.timeout} s")
        _RUNNING.remove(self)
        out = self.out_path.read_text()
        err = self.err_path.read_text()
        self.err_path.unlink(missing_ok=True)
        if not self.keep_out:
            self.out_path.unlink(missing_ok=True)
        require((self.proc.returncode != 0) == self.expect_failure,
                f"{self.what}: `{' '.join(self.cmd[1:])}` exited "
                f"{self.proc.returncode}: {err[-3000:]}")
        return out, err, self.t_end - self.t0

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def stop_all() -> None:
    """Kill every subprocess still running (a failed phase leaves none)."""
    for p in list(_RUNNING):
        p.stop()
        for f in (p.err_path, None if p.keep_out else p.out_path):
            if f is not None:
                f.unlink(missing_ok=True)
        _RUNNING.remove(p)


atexit.register(stop_all)


def launch(args, what: str, *, module: str = "oms", **kw) -> Proc:
    """``python -m repro_torch.launch.<module> *args`` started now (see Proc)."""
    return Proc([sys.executable, "-m", f"repro_torch.launch.{module}", *args], what, **kw)


def cli(args, what: str, **kw) -> tuple[str, str, float]:
    """``launch(...)`` run to its end: (stdout text, stderr text, seconds)."""
    return launch(args, what, **kw).result()


# ---------------------------------------------------------------------------
# Device profiles (timing runs only)
# ---------------------------------------------------------------------------

PROFILE_TRACE = BUILD / "smoke_profile.json"
# Device activity in a torch.profiler (Kineto) trace, and the serve path's
# kernels by the names of their __global__ functions.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SERVE_KERNELS = {"hdencode": ("hdencode_kernel",),
                 "fused_search": ("fused_grouped_partial", "fused_search_merge")}


def device_profiler(torch):
    """A torch.profiler that records device activity only (CUPTI); the
    host work of the serve threads is not instrumented."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_profile(prof, wall_s: float, top: int = 0) -> dict:
    """The device's busy time (the union of kernel, copy and set
    intervals) over ``wall_s``, and each serve kernel's launches and
    device milliseconds, from ``prof``'s trace; with ``top``, also the
    ``top`` kernels by device time as [name, launches, ms]."""
    PROFILE_TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(PROFILE_TRACE))
    try:
        events = [e for e in json.loads(PROFILE_TRACE.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS]
    finally:
        PROFILE_TRACE.unlink(missing_ok=True)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernels = {k: [0, 0.0] for k in SERVE_KERNELS}
    for e in events:
        for k, names in SERVE_KERNELS.items():
            if e["cat"] == "kernel" and any(n in e["name"] for n in names):
                kernels[k][0] += 1
                kernels[k][1] += e["dur"] / 1e3
    by_name = {}
    for e in events:
        if e["cat"] == "kernel":
            n = by_name.setdefault(e["name"][:80], [0, 0.0])
            n[0] += 1
            n[1] += e["dur"] / 1e3
    out = {"wall_ms": wall_s * 1e3, "busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
           "copy_ms": sum(e["dur"] for e in events if e["cat"] == "gpu_memcpy") / 1e3,
           "n_events": len(events), "kernels": kernels}
    if top:
        out["top_kernels"] = [[k, *v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:top]]
    return out
