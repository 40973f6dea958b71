"""Streaming serve (counterpart of ``repro.serve``): bounded-memory slab
scans over the near-storage LibraryStore plus an async micro-batching
query front with SLO-aware admission (deadlines, per-tenant fair dequeue)
and an HV-keyed result cache. Entry points:
``OMSPipeline.from_store(..., resident=False)`` and the
``repro_torch.launch.oms serve`` JSON-lines loop."""
from repro_torch.serve.engine import StreamingEngine, StreamStats, TotalStats
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import (DeadlineExceeded, MicroBatcher,
                                         QuerySpec, coalesce_queries)
from repro_torch.serve.slabs import (SlabPlan, StoreLayout, plan_slabs,
                                     slab_arrays, slabs_touched)

__all__ = ["StreamingEngine", "StreamStats", "TotalStats", "ResultCache",
           "DeadlineExceeded", "MicroBatcher", "QuerySpec", "coalesce_queries",
           "SlabPlan", "StoreLayout", "plan_slabs", "slab_arrays",
           "slabs_touched"]
