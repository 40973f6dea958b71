"""The device's activity over the measured window, from ``torch.profiler``.

The method of ``chip_smoke_phases/common.py::device_profile`` at commit
0d012dd: a profiler that records device activity only (CUPTI: kernels,
copies, sets), its Chrome trace read back, busy time = the union of the
activity intervals. Added here: the device clock is put on the host's
``perf_counter_ns`` by one marker kernel launched right after a
synchronise at the start of the window (the launch latency, some
microseconds, is the error), so that each idle gap can be named by the
host span it falls in.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """Start before the window, ``stop`` after it; then ``events`` holds
    ``(name, start_ns, end_ns)`` on the host clock, in start order."""

    def __init__(self, torch, device, trace_file: Path):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.device, self.trace_file = torch, device, trace_file
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: list[tuple[str, int, int]] = []

    def start(self) -> None:
        torch = self.torch
        self.marker = torch.zeros(1, device=self.device)
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.t_marker_ns = time.perf_counter_ns()
        self.marker.fill_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.trace_file.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.trace_file))
        try:
            raw = [e for e in json.loads(self.trace_file.read_text())["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        finally:
            self.trace_file.unlink(missing_ok=True)
        raw.sort(key=lambda e: e["ts"])
        if not raw:
            return
        # the first device event is the marker's fill
        offset_us = raw[0]["ts"] - self.t_marker_ns / 1e3
        self.events = [(e["name"], int((e["ts"] - offset_us) * 1e3),
                        int((e["ts"] + e["dur"] - offset_us) * 1e3)) for e in raw[1:]]


def busy_intervals(events, t0_ns: int, t1_ns: int) -> list[tuple[int, int]]:
    """The union of the events' intervals, clipped to ``[t0_ns, t1_ns]``."""
    out: list[list[int]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy, t0_ns: int, t1_ns: int) -> list[tuple[int, int]]:
    gaps, end = [], t0_ns
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1_ns > end:
        gaps.append((end, t1_ns))
    return gaps


def name_gaps(gaps, spans) -> dict[str, float]:
    """Idle seconds by the innermost host span holding each gap's middle
    (``"no span"`` outside every span). ``spans``: (name, start_ns, end_ns)."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    longest = max((s[2] - s[1] for s in spans), default=0)
    out: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            name, s0, s1 = spans[i]
            if s1 >= mid and (best is None or s1 - s0 < best[2] - best[1]):
                best = spans[i]
            if mid - s0 > longest:              # no earlier span reaches mid
                break
        out[best[0] if best else "no span"] += (b - a) / 1e9
    return dict(out)


def top_ops(events, t0_ns: int, t1_ns: int, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time in the window, by
    name: [name, seconds]."""
    by_name: dict[str, float] = defaultdict(float)
    for name, a, b in events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b > a:
            by_name[name] += (b - a) / 1e9
    return [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
