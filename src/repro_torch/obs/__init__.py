"""Observability layer: structured tracing + serve metrics.

Counterpart of ``repro.obs``, stdlib only: zero-overhead-when-disabled
spans (``repro_torch.obs.trace``), deterministic counters/gauges/latency
histograms (``repro_torch.obs.metrics``), and the trace-report rollup
(``repro_torch.obs.report``). The hot-path seams — ``OMSPipeline``
stages, ``StreamingEngine`` slabs, ``MicroBatcher`` queueing — are
instrumented on the host; tracing changes no result byte and adds no
device synchronisation.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metrics,
                                     DEFAULT_LATENCY_BUCKETS,
                                     DEFAULT_SIZE_BUCKETS)
from repro_torch.obs.trace import (TraceEvent, Tracer, current, enabled,
                                   install, span, uninstall)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_SIZE_BUCKETS", "TraceEvent", "Tracer", "current", "enabled",
    "install", "span", "uninstall",
]
