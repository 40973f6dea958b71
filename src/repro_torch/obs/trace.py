"""Structured tracing: spans, a thread-safe ring buffer, Perfetto export.

Counterpart of ``repro.obs.trace``, with the same span names, event schema
and export formats, so either package's trace report reads the other's
trace. The serve hot path is instrumented with :func:`span` context
managers at the real seams — query encode, window planning, per-slab
fetch/search/merge, micro-batch dispatch — all HOST-side. On the card a
span times the host: one that only enqueues kernel launches ends before
the device work does, and one that ends at a host synchronisation (a
``.cpu()`` copy, an event wait) includes the device work it waited for.
Tracing adds no synchronisation and changes no result byte.

Beyond the reference's names, the resident search path names its host
seams: ``scan.sort_pad`` (the query sort and padding plan), ``scan.pad_plan``
(the padding plan's build, only on a memo miss) and ``scan.launch`` (start
rows, the backend's wrapper, the kernel launch). A span named ``sync.<layer>.
<copy>`` wraps one copy between the host and the search's device, opened
only where a copy happens (an input already on the device opens none), so
the count of ``sync.*`` spans is the count of synchronising copies. On a CPU
pipeline the same sites open the same spans.

Zero-overhead-when-disabled is the design center: with no tracer
installed, ``span(...)`` is one module-global read plus returning a
shared no-op singleton — no object allocation, no clock read, no lock.
Installing a :class:`Tracer` turns the same call sites into real spans
that record ``(name, t_start_ns, t_end_ns, attrs)`` into a bounded ring
buffer (old events are evicted, never the serve loop blocked).

Export formats:

  * ``to_jsonl``  — one JSON object per line: ``{"name", "ts_us",
    "dur_us", "tid", ...attrs}`` (grep/jq-friendly);
  * ``to_chrome`` — Chrome ``trace_event`` JSON (``{"traceEvents":
    [...]}``, complete ``"ph": "X"`` events) that https://ui.perfetto.dev
    and ``chrome://tracing`` open directly.

This module is stdlib only: it is imported at module level from
``repro_torch.core.pipeline``, ``repro_torch.serve.engine`` and
``repro_torch.serve.scheduler``, both sides of the core<->serve boundary,
so importing anything of the package here would create a cycle.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Mapping, NamedTuple


class TraceEvent(NamedTuple):
    """One completed span. Times are ``time.perf_counter_ns`` values —
    monotonic and comparable within a process, not wall-clock epochs."""

    name: str
    t_start_ns: int
    t_end_ns: int
    tid: int                      # recording thread ident
    attrs: Mapping[str, Any]      # small JSON-able payload (rows, bytes, ...)

    @property
    def dur_ns(self) -> int:
        return self.t_end_ns - self.t_start_ns


class Tracer:
    """Thread-safe in-process span sink with a bounded ring buffer.

    ``capacity`` bounds memory: the buffer keeps the most recent events
    and counts evictions in :attr:`n_dropped` (a serve loop must never
    grow without bound or block on its own instrumentation).
    """

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._recorded = 0

    # ------------------------------------------------------------------
    def record(self, name: str, t_start_ns: int, t_end_ns: int,
               attrs: Mapping[str, Any] | None = None) -> None:
        ev = TraceEvent(name, int(t_start_ns), int(t_end_ns),
                        threading.get_ident(), attrs or {})
        with self._lock:
            self._buf.append(ev)
            self._recorded += 1

    def events(self) -> list[TraceEvent]:
        """Snapshot of the buffered events, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._recorded = 0

    @property
    def n_recorded(self) -> int:
        with self._lock:
            return self._recorded

    @property
    def n_dropped(self) -> int:
        with self._lock:
            return max(0, self._recorded - len(self._buf))

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------
    def to_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the number of events written."""
        events = self.events()
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(event_dict(ev), sort_keys=True,
                                   separators=(",", ":")) + "\n")
        return len(events)

    def to_chrome(self, path: str) -> int:
        """Chrome/Perfetto ``trace_event`` JSON; returns the event count."""
        events = self.events()
        pid = os.getpid()
        out = {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {"name": ev.name, "ph": "X", "pid": pid, "tid": ev.tid,
                 "ts": ev.t_start_ns / 1e3, "dur": ev.dur_ns / 1e3,
                 "args": dict(ev.attrs)}
                for ev in events
            ],
        }
        with open(path, "w") as f:
            json.dump(out, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        return len(events)


def event_dict(ev: TraceEvent) -> dict:
    """The JSON-lines schema of one event (also what the report loader
    reconstructs from either export format)."""
    d = {"name": ev.name, "ts_us": ev.t_start_ns / 1e3,
         "dur_us": ev.dur_ns / 1e3, "tid": ev.tid}
    d.update(ev.attrs)
    return d


# ---------------------------------------------------------------------------
# The span() fast path: module-global tracer, shared no-op singleton
# ---------------------------------------------------------------------------


class _Span:
    """A live span: clock read on enter, record on exit. ``add(**attrs)``
    attaches facts learned mid-span (bytes fetched, rows survived)."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def add(self, **attrs) -> None:
        self._attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.record(self._name, self._t0, time.perf_counter_ns(),
                            self._attrs)


class _NoopSpan:
    """The disabled fast path: a shared singleton whose enter/exit/add do
    nothing — ``with span(...)`` costs one global read when tracing is off."""

    __slots__ = ()

    def add(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_tracer: Tracer | None = None


def span(name: str, **attrs):
    """Context manager timing one named stage. With no tracer installed
    this returns the shared no-op singleton (the zero-overhead path)."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return _Span(t, name, attrs)


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide span sink; returns it."""
    global _tracer
    _tracer = tracer
    return tracer


def uninstall() -> None:
    global _tracer
    _tracer = None


def current() -> Tracer | None:
    return _tracer


def enabled() -> bool:
    return _tracer is not None
