"""Streaming serve (counterpart of the engine half of ``repro.serve``):
bounded-memory slab scans over the near-storage LibraryStore. Entry point:
``OMSPipeline.from_store(..., resident=False)``. The micro-batching front
and the result cache are not ported yet (ROADMAP queue 1 item 4)."""
from repro_torch.serve.engine import StreamingEngine, StreamStats, TotalStats
from repro_torch.serve.slabs import (SlabPlan, StoreLayout, plan_slabs,
                                     slab_arrays, slabs_touched)

__all__ = ["StreamingEngine", "StreamStats", "TotalStats", "SlabPlan",
           "StoreLayout", "plan_slabs", "slab_arrays", "slabs_touched"]
