"""Async micro-batching query frontend with SLO-aware admission.

Request queue -> coalesce (up to ``max_batch`` requests, or ``max_wait_s``
after the first arrival) -> ONE streamed scan serves the whole coalesced
batch. Per-query search results are batch-independent (the scan is
bit-identical under any batch composition), so coalescing never changes an
answer — it only amortises the slab stream and the kernel launches across
concurrent callers, which is where the throughput of a heavy-traffic serve
loop comes from. Counterpart of ``repro.serve.scheduler``, with the same
admission, shedding, round-robin and metrics.

On top of plain coalescing the batcher speaks SLOs:

  * **deadline** — ``submit(spec, deadline_s=...)`` attaches a per-request
    latency budget. Admission control sheds (fast-fails with
    :class:`DeadlineExceeded`) a request whose deadline the current queue
    depth cannot plausibly meet — the estimate is ``batches-ahead x
    e2e-p50`` read from the batcher's own deterministic latency histogram,
    so a cold batcher (no history) admits everything. An EMPTY queue also
    always admits (the half-open probe): shed requests are never observed
    into the histogram, so if everything shed on a stale/pessimistic
    estimate the estimator could never recover — the probe request runs in
    the very next batch and refreshes the history instead. A request that
    was admitted but whose deadline expired while it sat in the queue is
    fast-failed at dispatch instead of burning a scan on a dead answer.
    Shedding never changes an admitted request's answer (searches are
    batch-independent).
  * **tenant** — ``submit(spec, tenant=...)`` names the traffic source;
    requests queue per-tenant and batches are assembled round-robin across
    tenants, so one chatty tenant cannot starve the others (per-tenant
    FIFO order is preserved).

The scheduler is engine-agnostic: it coalesces raw peak lists into one
padded :class:`~repro_torch.data.spectra.SpectraSet` (host numpy) and hands it
to a ``run_batch`` callable (the launcher wires that to the pipeline's
encode and search), which must return one result payload per request.
``run_batch`` runs on the batcher's worker thread, so on the card every
kernel launch, copy stream and event of the search is issued from that
thread's current stream.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np

from repro_torch.data.spectra import SpectraSet
from repro_torch.obs.metrics import DEFAULT_SIZE_BUCKETS, Metrics
from repro_torch.obs.trace import span


@dataclasses.dataclass
class QuerySpec:
    """One query spectrum as raw (variable-length) peak arrays."""

    mz: np.ndarray         # (P,) f32 fragment m/z
    intensity: np.ndarray  # (P,) f32
    pmz: float             # neutral precursor mass (Da)
    charge: int


class DeadlineExceeded(RuntimeError):
    """A request was shed: its deadline cannot be (or was not) met."""


def coalesce_queries(specs: Sequence[QuerySpec]) -> SpectraSet:
    """Pad variable-length peak lists to one (B, P) batch. Zero-intensity
    padding is what the encoder already treats as "no peak", so padding is
    encode-neutral."""
    if not specs:
        raise ValueError("coalesce_queries: empty batch")
    P = max(1, max(len(s.mz) for s in specs))
    B = len(specs)
    mz = np.zeros((B, P), np.float32)
    inten = np.zeros((B, P), np.float32)
    pmz = np.empty((B,), np.float32)
    charge = np.empty((B,), np.int32)
    for i, s in enumerate(specs):
        n = len(s.mz)
        if n != len(s.intensity):
            raise ValueError(f"query {i}: mz/intensity length mismatch")
        mz[i, :n] = np.asarray(s.mz, np.float32)
        inten[i, :n] = np.asarray(s.intensity, np.float32)
        pmz[i] = np.float32(s.pmz)
        charge[i] = np.int32(s.charge)
    return SpectraSet(mz=mz, intensity=inten, pmz=pmz, charge=charge)


_CLOSE = object()


class _Request(NamedTuple):
    spec: QuerySpec
    fut: Future
    t_submit: float
    deadline_s: float | None
    tenant: str


class MicroBatcher:
    """Thread-safe micro-batching front of a batched search function.

    ``run_batch(spectra: SpectraSet) -> Sequence[payload]`` must return one
    payload per batch row; each :meth:`submit` future resolves to its row's
    payload (or to the batch's exception — for a shed request, a
    :class:`DeadlineExceeded`).

    Metrics (a :class:`repro_torch.obs.Metrics` registry, own or shared via the
    ``metrics`` argument):

      * ``queue_wait_s``   — histogram: submit -> batch-dispatch wait per
        request (how long coalescing held the query);
      * ``e2e_latency_s``  — histogram: submit -> future-resolution latency
        per request, observed exactly once per future — including futures
        the caller cancelled and batches that errored. Shed requests are
        NOT observed (they never ran), so the histogram keeps estimating
        the latency of requests that actually reach the engine;
      * ``batch_size``     — histogram: coalesced requests per dispatched
        batch (``close()`` flushes the final partial batch's observation);
      * ``queue_depth``    — gauge: requests enqueued but not yet pulled
        into a batch (``.max`` is the session high-water mark);
      * ``shed_admit``     — counter: requests rejected at submit because
        the deadline estimate said the queue cannot meet them;
      * ``shed_expired``   — counter: admitted requests fast-failed at
        dispatch because their deadline passed while queued.
    """

    def __init__(self, run_batch: Callable[[SpectraSet], Sequence[Any]], *,
                 max_batch: int = 64, max_wait_s: float = 0.005,
                 metrics: Metrics | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self._max_batch = max_batch
        self._max_wait = max(0.0, max_wait_s)
        # Per-tenant FIFO queues + a round-robin rotation of tenant names;
        # _cond guards both and wakes the worker on submit/close.
        self._cond = threading.Condition()
        self._queues: dict[str, deque] = {}
        self._rr: deque = deque()
        self._closing = False
        self._closed = False
        # Guards the closed-check + enqueue pair: without it a submit racing
        # close() could land behind the close flag and never resolve.
        self._submit_lock = threading.Lock()
        self.n_batches = 0
        self.n_queries = 0
        self.metrics = metrics if metrics is not None else Metrics()
        self.queue_wait = self.metrics.histogram("queue_wait_s")
        self.e2e_latency = self.metrics.histogram("e2e_latency_s")
        self.batch_sizes = self.metrics.histogram("batch_size",
                                                  DEFAULT_SIZE_BUCKETS)
        self.queue_depth = self.metrics.gauge("queue_depth")
        self.shed_admit = self.metrics.counter("shed_admit")
        self.shed_expired = self.metrics.counter("shed_expired")
        self._thread = threading.Thread(target=self._worker,
                                        name="oms-microbatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def estimate_latency_s(self) -> float:
        """Admission estimate for a request submitted NOW: the batches that
        must dispatch before it can resolve (everything queued ahead plus
        its own) times the observed e2e p50. Deterministic (fixed-bucket
        histogram) and deliberately cheap; 0.0 while there is no latency
        history yet, so a cold batcher never sheds."""
        p50 = self.e2e_latency.p50
        if p50 <= 0.0:
            return 0.0
        batches_ahead = 1 + int(self.queue_depth.value) // self._max_batch
        return batches_ahead * p50

    def submit(self, spec: QuerySpec, *, deadline_s: float | None = None,
               tenant: str = "default") -> Future:
        """Enqueue one query; returns a Future resolving to its payload.

        ``deadline_s`` is a latency budget measured from this call; a
        request the estimator predicts cannot meet it resolves immediately
        with :class:`DeadlineExceeded` (fast-fail — the caller finds out in
        microseconds, not after the deadline already blew)."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            # Empty queue => always admit (half-open probe): only admitted
            # requests feed the latency histogram, so shedding on stale
            # history with nothing queued would lock the estimator into
            # shedding forever after one slow (e.g. cold-compile) batch.
            if deadline_s is not None and int(self.queue_depth.value) > 0:
                est = self.estimate_latency_s()
                if est > deadline_s:
                    self.shed_admit.inc()
                    fut.set_exception(DeadlineExceeded(
                        f"shed at admission: estimated latency {est:.4f}s "
                        f"exceeds deadline {deadline_s:.4f}s"))
                    return fut
            self.queue_depth.inc()
            req = _Request(spec, fut, time.monotonic(), deadline_s, tenant)
            with self._cond:
                q = self._queues.get(tenant)
                if q is None:
                    q = self._queues[tenant] = deque()
                    self._rr.append(tenant)
                q.append(req)
                self._cond.notify()
        return fut

    def close(self) -> None:
        """Drain outstanding requests, stop the worker, join it."""
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                with self._cond:
                    self._closing = True
                    self._cond.notify()
        self._thread.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _pop(self, timeout: float | None = None):
        """Next request, round-robin across tenants (each pop advances the
        rotation, so tenant A's backlog cannot starve tenant B). Returns
        ``None`` on timeout, ``_CLOSE`` once closing AND fully drained."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                for _ in range(len(self._rr)):
                    t = self._rr[0]
                    self._rr.rotate(-1)
                    q = self._queues[t]
                    if q:
                        return q.popleft()
                if self._closing:
                    return _CLOSE
                if end is None:
                    self._cond.wait()
                else:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)

    def _worker(self) -> None:
        while True:
            first = self._pop()
            if first is _CLOSE:
                return
            self.queue_depth.dec()
            batch = [first]
            deadline = time.monotonic() + self._max_wait
            saw_close = False
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self._pop(timeout=remaining)
                if nxt is None:
                    break
                if nxt is _CLOSE:
                    saw_close = True
                    break
                self.queue_depth.dec()
                batch.append(nxt)
            self._dispatch(batch)
            if saw_close:
                return

    def _resolve(self, fut: Future, t_submit: float, *,
                 result=None, error=None) -> None:
        # The end-to-end latency observation happens HERE, exactly once per
        # future — before the set attempt, so a future the caller already
        # cancelled still records its latency (and losing that race must
        # not kill the worker thread: set_result on a cancelled future
        # raises InvalidStateError).
        self.e2e_latency.observe(time.monotonic() - t_submit)
        try:
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(result)
        except InvalidStateError:
            pass

    def _dispatch(self, batch) -> None:
        t0 = time.monotonic()
        # Fast-fail admitted requests whose deadline already passed while
        # they waited — scanning for them would only delay the live ones.
        # (Not observed in e2e_latency: see the metrics docstring.)
        live = []
        for req in batch:
            if (req.deadline_s is not None
                    and t0 - req.t_submit > req.deadline_s):
                self.shed_expired.inc()
                try:
                    req.fut.set_exception(DeadlineExceeded(
                        f"deadline {req.deadline_s:.4f}s expired after "
                        f"{t0 - req.t_submit:.4f}s in queue"))
                except InvalidStateError:
                    pass
            else:
                live.append(req)
        if not live:
            return
        self.batch_sizes.observe(len(live))
        for req in live:
            self.queue_wait.observe(t0 - req.t_submit)
        try:
            with span("serve.batch", n=len(live)):
                results = self._run_batch(
                    coalesce_queries([r.spec for r in live]))
            if len(results) != len(live):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for a "
                    f"{len(live)}-query batch")
        except BaseException as e:
            for req in live:
                self._resolve(req.fut, req.t_submit, error=e)
            return
        self.n_batches += 1
        self.n_queries += len(live)
        for req, res in zip(live, results):
            self._resolve(req.fut, req.t_submit, result=res)
