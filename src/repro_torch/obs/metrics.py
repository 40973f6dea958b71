"""Serve metrics: counters, gauges, fixed-bucket latency histograms.

The histogram is deliberately NOT a reservoir sampler: observations land
in a fixed, sorted set of bucket upper bounds and quantiles are read back
as the smallest bound whose cumulative count covers the rank. Same
observations => same p50/p99, bit-for-bit, regardless of arrival order or
count — determinism is what lets CI gate on the serve summary and lets
two runs of the same workload be diffed.

All objects are thread-safe (the micro-batcher observes from its worker
thread while the serve loop reads snapshots) and ``snapshot()`` returns
plain JSON-able dicts — the serve loop's final metrics dump and the
heartbeat line are both just serialized snapshots.

Counterpart of ``repro.obs.metrics``: the same buckets and quantile rule,
so the same observations give the same percentiles in either package.
Stdlib only by design — imported from both sides of the core<->serve
boundary.
"""
from __future__ import annotations

import bisect
import math
import threading

# Default latency buckets (seconds): ~exponential 100us .. 60s. Chosen so
# micro-batch queue waits (sub-ms), slab scans (ms..s) and cold compiles
# (seconds) each land with a few buckets of resolution.
DEFAULT_LATENCY_BUCKETS = (
    100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    100e-3, 250e-3, 500e-3, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Default size buckets (counts): powers of two up to 4096 — batch sizes,
# queue depths, coalesce sizes.
DEFAULT_SIZE_BUCKETS = tuple(float(1 << i) for i in range(13))


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value plus the high-water mark since reset."""

    __slots__ = ("_lock", "_value", "_max")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            if self._value > self._max:
                self._max = self._value

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def snapshot(self):
        with self._lock:
            return {"value": self._value, "max": self._max}


class Histogram:
    """Fixed-bucket histogram with exact, deterministic quantile readback.

    ``bounds`` are sorted inclusive upper bounds; one implicit overflow
    bucket catches everything above the last bound. ``quantile(q)``
    returns the smallest bound whose cumulative count reaches
    ``ceil(q * count)`` — a value that (a) is always one of the static
    bounds, so two identical workloads report identical percentiles, and
    (b) upper-bounds the true quantile (conservative for latency SLOs).
    Observations in the overflow bucket report the last finite bound.
    """

    __slots__ = ("_lock", "bounds", "_counts", "_count", "_sum")

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS):
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(set(b)):
            raise ValueError("bounds must be non-empty, sorted, unique")
        if any(not math.isfinite(x) for x in b):
            raise ValueError("bounds must be finite (overflow is implicit)")
        self._lock = threading.Lock()
        self.bounds = b
        self._counts = [0] * (len(b) + 1)     # [+overflow]
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Deterministic upper-bound quantile from bucket counts;
        0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self._count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        out = {"count": count, "sum": total,
               "mean": (total / count) if count else 0.0,
               "buckets": {("inf" if i == len(self.bounds)
                            else repr(self.bounds[i])): c
                           for i, c in enumerate(counts) if c}}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            out[name] = self.quantile(q)
        return out


class Metrics:
    """A named registry of metrics with one-call ``snapshot()``.

    ``counter``/``gauge``/``histogram`` get-or-create by name (idempotent,
    thread-safe) so instrumentation sites don't coordinate construction.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        m = self._get(name, Counter)
        if not isinstance(m, Counter):
            raise TypeError(f"{name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._get(name, Gauge)
        if not isinstance(m, Gauge):
            raise TypeError(f"{name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def histogram(self, name: str,
                  bounds=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        m = self._get(name, lambda: Histogram(bounds))
        if not isinstance(m, Histogram):
            raise TypeError(f"{name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def snapshot(self) -> dict:
        """{name: plain JSON-able value} for every registered metric."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}
