"""HV-keyed LRU result cache for the serve path.

Packed binary hypervectors make response caching exact: two spectra that
encode to the same (dim/32)-word HV with the same precursor (pmz, charge)
are THE SAME query to the search engine — bit-identical inputs produce
bit-identical results — so a cache keyed on the exact HV bytes plus the
precursor plus a token naming the search configuration (backend, windows,
top-k, cascade mode, ... and the store generation) can return the stored
response verbatim. No similarity thresholds, no approximate matching: a
hit is byte-identical to a recomputation by construction, which is what
lets CI compare a cached serve run against ``--no-result-cache``.

The cache stores the launcher's per-query response payloads (the exact
objects that get serialised to the JSON-lines output). It is LRU-bounded,
thread-safe, and counts hits/misses in the shared serve
:class:`~repro_torch.obs.metrics.Metrics` registry (``result_cache_hits`` /
``result_cache_misses`` in the ``--metrics`` snapshot). A hot-reload that
changes the library must :meth:`clear` it (the launcher does; cached
answers from the old generation are stale, not wrong-format).

Counterpart of ``repro.serve.result_cache``. The port's packed HVs are
int32 words holding the reference's uint32 bit patterns; :meth:`key`
hashes their bytes as uint32, so a key is byte-equal to the reference's
for the same HV.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.obs.metrics import Metrics


class ResultCache:
    """Bounded LRU map from exact-query keys to response payloads."""

    def __init__(self, capacity: int = 4096, *,
                 metrics: Metrics | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict[bytes, object] = OrderedDict()
        reg = metrics if metrics is not None else Metrics()
        self.hits = reg.counter("result_cache_hits")
        self.misses = reg.counter("result_cache_misses")

    @staticmethod
    def key(hv_words: np.ndarray, pmz: float, charge: int,
            params_token: str = "") -> bytes:
        """Exact-query key: the packed HV bytes + precursor + a caller
        token naming every setting that could change the answer (search
        params and store generation)."""
        hv = np.ascontiguousarray(hv_words)
        if hv.dtype == np.int32:        # the port's words: same bits
            hv = hv.view(np.uint32)
        hv = hv.astype(np.uint32, copy=False)
        return (hv.tobytes() + struct.pack("<fi", np.float32(pmz),
                                           int(charge))
                + params_token.encode())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: bytes):
        """Payload for ``key`` (refreshing its LRU position), else None."""
        with self._lock:
            try:
                val = self._entries[key]
            except KeyError:
                self.misses.inc()
                return None
            self._entries.move_to_end(key)
            self.hits.inc()
            return val

    def put(self, key: bytes, payload) -> None:
        with self._lock:
            self._entries[key] = payload
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        """Drop every entry (hot-reload: the library changed)."""
        with self._lock:
            self._entries.clear()
