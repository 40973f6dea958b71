"""Streaming slab-search executor (counterpart of ``repro.serve.engine``).

Runs the blocked dual-window OMS scan over a library one fixed-size slab at
a time. Device memory holds the query batch, two slab buffers and the
(Q, top_k) running winners, never the library: servable library size is
decoupled from device memory, the paper's near-storage streaming with the
slab stream in the place of the SmartSSD-to-kernel DMA.

Bit-identity with the resident ``oms_search`` at any slab size:

  * queries go through the same ``sort_pad_plan`` layout;
  * every slab is a run of whole blocks of the same padded layout, searched
    by ``_search_sorted_padded`` with ``k_blocks`` capped to the slab, so a
    slab's scan covers a superset of its in-window candidates;
  * per-slab winners, offset into the global row space, fold into the
    running (Q, k) best with ``merge_topk`` in ascending slab order: on
    score ties the lower global row keeps winning;
  * slabs no query's open window touches are skipped.

Uploads (CUDA): slab ``j`` is gathered from the memory-mapped shards by a
one-worker thread straight into pinned host buffer ``j % 2``, copied on a
copy stream into device slab buffer ``j % 2`` and searched on the current
stream. An event marks each copy done: the search waits on it, and the
gather refills that pinned buffer only after it has completed. A second
event marks the searches done with a device buffer: the next copy into that
buffer waits on it. So the gather of slab ``j + 1`` and its copy overlap
the search of slab ``j``. On the CPU the slab arrays are used in place.

Spans (``repro_torch.obs``, the reference's names and attributes):
``serve.scan`` around a whole scan, per slab ``serve.slab.fetch`` (the wait
for the gather thread's pinned buffer), ``serve.slab.search`` and
``serve.slab.merge``, and ``serve.seed`` for the dimension cascade's seed
pass. They time the host: ``search`` and ``merge`` of the full-width scan
only enqueue launches; the prefix scan's ``search`` ends at the copy of its
survivor flags to the host.

Live growth: :meth:`StreamingEngine.reload` re-plans over a grown
(append-only) store and swaps (layout, plan) atomically; a search snapshots
them at entry and finishes on its snapshot (shard files are never
rewritten, so old memory maps stay valid).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.registry import contract, declare
from repro_torch.core.blocking import PAD_PMZ, ReferenceDB
from repro_torch.core.search import (SearchParams, SearchResult, _NEG_THRESHOLD,
                                     _host, _prefix_flags, _rescore_rows_padded,
                                     _search_sorted_padded, kth_thresholds,
                                     pad_candidate_rows, plan_seed_rows,
                                     row_bucket, sort_pad_plan,
                                     validate_prefix_words,
                                     validate_search_params)
from repro_torch.kernels.topk import merge_topk
from repro_torch.obs.trace import span
from repro_torch.serve.slabs import (SlabPlan, StoreLayout, plan_slabs,
                                     slab_arrays, slabs_touched)

_DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
              "block_max", "block_charge")


class StreamStats(NamedTuple):
    """Per-call scan accounting. ``scanned_rows`` counts row reads from the
    store shards (a survivor re-read at full width counts again);
    ``scanned_bytes`` the packed-HV bytes they pulled (prefix-stage rows
    count ``prefix_words * 4`` bytes)."""

    n_slabs: int            # slabs in the plan
    n_scanned: int          # slabs actually streamed for this batch
    slab_rows: int          # rows per slab (the device-memory bound)
    scanned_rows: int = 0   # store row-reads (seed + scan + rescore)
    scanned_bytes: int = 0  # packed-HV bytes those reads pulled


@dataclasses.dataclass
class TotalStats:
    """Cumulative scan accounting across ``search_encoded`` calls
    (``StreamingEngine.reset_stats`` zeroes it)."""

    n_scans: int = 0         # search_encoded calls that reached the slab loop
    slabs_scanned: int = 0   # slabs streamed, summed over calls
    scanned_rows: int = 0    # store row-reads, summed
    scanned_bytes: int = 0   # packed-HV bytes read, summed

    def add(self, st: StreamStats) -> None:
        self.n_scans += 1
        self.slabs_scanned += st.n_scanned
        self.scanned_rows += st.scanned_rows
        self.scanned_bytes += st.scanned_bytes


# The slab step — the capped _search_sorted_padded call plus the offset/
# merge fold below — is the streaming engine's entire device program. Its
# contract is the engine's reason to exist: device bytes are determined by
# the SLAB (q_block * slab_rows * W words of xor tensor at worst), never by
# the library. `oms.py analyze` records the step per search backend and
# checks these (see repro_torch.analysis.runner).
@contract("serve:slab_step", "peak_intermediate", "no_host_transfer",
          "dtype_stability",
          bound=lambda c: (max(c["q_block"], 32)
                           * c["slab_rows"] * c["n_words"] * 4),
          note="slab-determined cap: worst backend per slab — vpu's "
               "(Qb, slab_rows, W) xor tensor or mxu's 32-lane "
               "(slab_rows, W, 32) unpack; independent of library size")
def _offset_rows(std_b, std_row, open_b, open_row, offset: int):
    """Map slab-local winner rows into the global padded row space."""
    return (std_b, torch.where(std_row >= 0, std_row + offset, -1),
            open_b, torch.where(open_row >= 0, open_row + offset, -1))


def _merge_partials(run, part, k: int):
    """Fold one slab's winners into the running best. ``run`` holds earlier
    (lower-row) slabs, so it wins score ties — the merge_topk contract."""
    std_b, std_row = merge_topk(run[0], run[1], part[0], part[1], k)
    open_b, open_row = merge_topk(run[2], run[3], part[2], part[3], k)
    return std_b, std_row, open_b, open_row


# The serve loop's runtime contract: repeated same-shaped search_encoded
# calls build no kernel and, on the card, grow no allocator reservation
# (fixed slab shape + memoized padding plan + reused slab buffers). The
# analyzer runs real repeat calls under a RecompileGuard.
declare("serve:loop", "recompile_guard",
        note="steady-state serving must not build kernels or grow the "
             "allocator per call")

# Hot-reload keeps the same requested slab_rows, so a reload re-plans to
# the SAME fixed slab shapes and the slab buffers are reused.
declare("serve:loop", "recompile_guard",
        note="hot-reload swap preserves slab shapes, hence the buffers")

# The observability contract: the spans instrumenting this engine (and the
# pipeline stages above it) are host-side, strictly around the device work
# — installing a repro_torch.obs tracer must leave the recorded hot op
# sequence identical and change zero result bytes. The analyzer records
# and runs the real search with and without a tracer installed and diffs
# both.
declare("serve:obs", "trace_transparency",
        note="tracing must not alter the hot ops or result bytes")


class _Clock:
    """Stage marks of one scan: CUDA events on the card (read after the
    scan's final synchronisation), host clock readings on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self, stream=None):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class _SlabBuffers:
    """Two host slab buffers (pinned on CUDA) and, on CUDA, two device slab
    buffers, a copy stream and the copy-done / search-done events. Buffer
    ``i`` is allocated at its first use (a one-slab scan needs one)."""

    def __init__(self, device: torch.device, rows: int, blocks: int, W: int,
                 max_r: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.max_r = max_r
        self.shapes = dict(
            hvs=((rows, W), torch.int32), pmz=((rows,), torch.float32),
            charge=((rows,), torch.int32), is_decoy=((rows,), torch.bool),
            orig_idx=((rows,), torch.int32), block_min=((blocks,), torch.float32),
            block_max=((blocks,), torch.float32),
            block_charge=((blocks,), torch.int32))
        self.host_t = [None, None]      # ReferenceDB of (pinned) CPU tensors
        self.host = [None, None]        # the same memory as numpy arrays
        if self.cuda:
            self.dev = [None, None]
            self.copy_stream = torch.cuda.Stream(device)
            self.copy_done = [torch.cuda.Event() for _ in range(2)]
            self.search_done = [torch.cuda.Event() for _ in range(2)]

    def _alloc(self, dev, pin: bool) -> ReferenceDB:
        return ReferenceDB(**{f: torch.empty(s, dtype=dt, device=dev, pin_memory=pin)
                              for f, (s, dt) in self.shapes.items()}, max_r=self.max_r)

    def host_buffer(self, i: int) -> ReferenceDB:
        """Host buffer ``i`` as numpy arrays (allocated at first use)."""
        if self.host_t[i] is None:
            self.host_t[i] = self._alloc("cpu", self.cuda)
            self.host[i] = ReferenceDB(
                **{f: getattr(self.host_t[i], f).numpy() for f in _DB_FIELDS},
                max_r=self.max_r)
        return self.host[i]

    def wait_host_free(self, i: int) -> None:
        """Block until the last copy out of pinned buffer ``i`` is done."""
        if self.cuda:
            self.copy_done[i].synchronize()

    def upload(self, i: int, clock: _Clock | None):
        """Enqueue host buffer ``i`` -> device buffer ``i`` and make the
        current stream wait for it; returns (device slab, upload marks)."""
        if not self.cuda:
            return self.host_t[i], None
        if self.dev[i] is None:
            self.dev[i] = self._alloc(self.device, False)
        cs = self.copy_stream
        marks = None
        with torch.cuda.stream(cs):
            cs.wait_event(self.search_done[i])
            if clock is not None:
                marks = [clock.mark(cs)]
            for f in _DB_FIELDS:
                getattr(self.dev[i], f).copy_(getattr(self.host_t[i], f),
                                              non_blocking=True)
            if clock is not None:
                marks.append(clock.mark(cs))
            self.copy_done[i].record(cs)
        torch.cuda.current_stream(self.device).wait_event(self.copy_done[i])
        return self.dev[i], marks

    def release(self, i: int) -> None:
        """The searches of device buffer ``i`` are all enqueued."""
        if self.cuda:
            self.search_done[i].record(torch.cuda.current_stream(self.device))

    def settle(self) -> None:
        """Order every later use of the buffers after all enqueued work."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.copy_stream)
            for i in range(2):
                self.search_done[i].record(cur)


class StreamingEngine:
    """Executes OMS over a LibraryStore (or a prebuilt :class:`StoreLayout`)
    one bounded slab at a time, on ``device`` (``None`` -> CUDA)."""

    def __init__(self, store_or_layout, *, max_r: int, slab_rows: int = 1 << 18,
                 devices: Sequence | None = None, prefetch: bool = True,
                 device=None):
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                "StreamingEngine: streaming over several devices is not ported "
                "yet (ROADMAP queue 1 item 8, multi-GPU); pass one device")
        self.device = resolve_device(devices[0] if devices else device)
        self.max_r = max_r
        self._slab_rows_req = slab_rows
        self._prefetch = prefetch
        # _swap_lock makes the (layout, plan) pair swap atomically under
        # reload(); _stats_lock serialises the read-modify-write on the
        # cumulative totals when searches run concurrently; _buf_lock
        # guards the pool of slab buffers (one set per running scan).
        self._swap_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._buf_lock = threading.Lock()
        self._buffers: dict[tuple, list[_SlabBuffers]] = {}
        self.layout, self.plan = self._plan_for(store_or_layout)
        self.last_stats: StreamStats | None = None
        self.total_stats = TotalStats()

    def _plan_for(self, store_or_layout) -> tuple[StoreLayout, SlabPlan]:
        if isinstance(store_or_layout, StoreLayout):
            layout = store_or_layout
            if layout.max_r != self.max_r:
                raise ValueError(f"layout has max_r={layout.max_r}, "
                                 f"engine asked for {self.max_r}")
        else:
            layout = StoreLayout.from_store(store_or_layout, max_r=self.max_r)
        plan = plan_slabs(layout.n_blocks, max_r=self.max_r,
                          slab_rows=self._slab_rows_req)
        return layout, plan

    def reload(self, store_or_layout) -> None:
        """Re-plan over a grown store and swap (layout, plan) in atomically;
        in-flight searches finish on the snapshot they took at entry."""
        layout, plan = self._plan_for(store_or_layout)
        with self._swap_lock:
            self.layout = layout
            self.plan = plan

    def _snapshot(self) -> tuple[StoreLayout, SlabPlan]:
        with self._swap_lock:
            return self.layout, self.plan

    def _set_stats(self, st: StreamStats) -> None:
        with self._stats_lock:
            self.last_stats = st
            self.total_stats.add(st)

    def reset_stats(self) -> None:
        """Zero the cumulative totals and clear the per-call snapshot."""
        with self._stats_lock:
            self.last_stats = None
            self.total_stats = TotalStats()

    # ------------------------------------------------------------------
    def _take_buffers(self, plan: SlabPlan, W: int) -> _SlabBuffers:
        key = (plan.slab_rows, plan.slab_blocks, W)
        with self._buf_lock:
            free = self._buffers.setdefault(key, [])
            if free:
                return free.pop()
        return _SlabBuffers(self.device, plan.slab_rows, plan.slab_blocks, W,
                            plan.max_r)

    def _give_buffers(self, plan: SlabPlan, W: int, bufs: _SlabBuffers) -> None:
        with self._buf_lock:
            self._buffers[(plan.slab_rows, plan.slab_blocks, W)].append(bufs)

    @staticmethod
    def _slab_real_rows(layout: StoreLayout, plan: SlabPlan, s: int) -> int:
        """Non-padding layout rows slab ``s`` reads from the store shards."""
        b0 = s * plan.slab_blocks
        b1 = min(b0 + plan.slab_blocks, layout.n_blocks)
        return layout.real_rows(b0 * plan.max_r, b1 * plan.max_r)

    @staticmethod
    def _drain_prefetch(pool, nxt) -> None:
        """Tear down the prefetch without leaking the in-flight gather:
        cancel it if it has not started, else retrieve its outcome, so no
        mmap-reading thread outlives the scan. ``nxt`` is None on the clean
        path."""
        if pool is None:
            return
        if nxt is not None and not nxt.cancel():
            try:
                nxt.result()
            except BaseException:
                pass
        pool.shutdown(wait=False)

    def _stream(self, layout: StoreLayout, plan: SlabPlan, touched,
                n_words: int | None, timings: list | None):
        """Yield ``(s, device slab)`` for the touched slabs in ascending
        order, double-buffered (module docstring). Everything the caller
        enqueues for a slab before asking for the next one is ordered
        before that slab's device buffer is overwritten."""
        W = layout.n_words if n_words is None else n_words
        bufs = self._take_buffers(plan, W)
        clock = _Clock(self.device) if timings is not None else None
        pool = ThreadPoolExecutor(max_workers=1) if (
            self._prefetch and len(touched) > 1) else None

        def fetch(j: int) -> float:
            i = j % 2
            bufs.wait_host_free(i)
            t0 = time.perf_counter()
            slab_arrays(layout, touched[j], plan, n_words=W, out=bufs.host_buffer(i))
            return time.perf_counter() - t0

        nxt = None
        try:
            if pool:
                nxt = pool.submit(fetch, 0)
            for j, s in enumerate(touched):
                i = j % 2
                with span("serve.slab.fetch", slab=int(s)):
                    gather_s = nxt.result() if nxt else fetch(j)
                db, up = bufs.upload(i, clock)
                nxt = pool.submit(fetch, j + 1) if (
                    pool and j + 1 < len(touched)) else None
                if clock is not None:
                    rec = dict(slab=int(s), gather_s=gather_s, upload=up,
                               search=[clock.mark()])
                    timings.append(rec)
                yield int(s), db
                if clock is not None:
                    rec["search"].append(clock.mark())
                bufs.release(i)
        finally:
            self._drain_prefetch(pool, nxt)
            bufs.settle()
            self._give_buffers(plan, W, bufs)

    def search_encoded(self, q_hvs, q_pmz, q_charge, params: SearchParams, *,
                       dim: int, q_pmz_np: np.ndarray | None = None,
                       q_charge_np: np.ndarray | None = None,
                       stats: dict | None = None) -> SearchResult:
        """Streamed equivalent of ``oms_search``: same inputs (tensors on the
        engine's device), the same :class:`SearchResult`. With
        ``params.prefix_words > 0`` the slab scan runs as the dimension
        cascade (prefix-word slab reads + full-width survivor fetches).
        ``stats``, when given, receives per slab the host gather seconds and
        the upload and search (kernels and merge) milliseconds."""
        layout, plan = self._snapshot()
        validate_search_params(params, layout.n_rows)
        if params.prefix_words:
            validate_prefix_words(params, dim)
        Q, K = q_hvs.shape[0], params.top_k
        qp_np = _host(q_pmz) if q_pmz_np is None else np.asarray(q_pmz_np)
        qc_np = _host(q_charge) if q_charge_np is None else np.asarray(q_charge_np)

        if params.exhaustive:   # the HyperOMS baseline scans everything
            touched = list(range(plan.n_slabs))
        else:
            touched = np.flatnonzero(slabs_touched(
                layout, qp_np, qc_np, open_tol_da=params.open_tol_da,
                plan=plan)).tolist()

        gather, unpad = sort_pad_plan(q_pmz, q_charge, params.q_block,
                                      q_charge_np=qc_np)
        qh, qp, qc = q_hvs[gather], q_pmz[gather], q_charge[gather]
        timings = [] if stats is not None else None
        with span("serve.scan", queries=Q, slabs=len(touched),
                  mode="prefix" if params.prefix_words else "full") as sp:
            if params.prefix_words:
                run, st = self._scan_prefix(layout, plan, touched, qh, qp, qc,
                                            params, dim, qp_np, qc_np, timings)
            else:
                run, st = self._scan_full(layout, plan, touched, qh, qp, qc,
                                          params, dim, timings)
            self._set_stats(st)
            sp.add(rows=st.scanned_rows, bytes=st.scanned_bytes)

        if run is None:          # no slab intersects any query window
            z = torch.full((Q, K), -1, dtype=torch.int32, device=self.device)
            out = SearchResult(*(z,) * 6)
        else:
            # Drop padding queries, restore input order, finalize on the
            # host (orig_idx / is_decoy never go to the device).
            unpad_np = _host(unpad)
            std_b, std_row, open_b, open_row = (_host(x)[unpad_np] for x in run)
            std = self._finalize(layout, std_b, std_row, params.min_sim)
            opn = self._finalize(layout, open_b, open_row, params.min_sim)
            out = SearchResult(*(torch.from_numpy(a).to(self.device) for a in (
                std[0], std[1], opn[0], opn[1], std[2], opn[2])))
        if stats is not None:
            clock = _Clock(self.device)
            if clock.cuda:
                torch.cuda.synchronize(self.device)
            stats["slabs"] = [dict(
                slab=r["slab"], gather_s=r["gather_s"],
                upload_ms=clock.ms(*r["upload"]) if r["upload"] else 0.0,
                search_ms=clock.ms(*r["search"])) for r in timings]
        return out

    def _scan_full(self, layout: StoreLayout, plan: SlabPlan, touched,
                   qh, qp, qc, params: SearchParams, dim: int, timings):
        """Full-width slab loop."""
        K = params.top_k
        local = params._replace(k_blocks=min(params.k_blocks, plan.slab_blocks))
        W = layout.n_words
        rows_read = 0
        run = None
        with contextlib.closing(self._stream(layout, plan, touched, None,
                                             timings)) as slabs:
            for s, db in slabs:
                n_real = self._slab_real_rows(layout, plan, s)
                rows_read += n_real
                with span("serve.slab.search", slab=s, rows=n_real,
                          bytes=n_real * W * 4):
                    out = _search_sorted_padded(db, qh, qp, qc, params=local,
                                                dim=dim)
                with span("serve.slab.merge", slab=s):
                    part = _offset_rows(*out, s * plan.slab_rows)
                    run = part if run is None else _merge_partials(run, part, K)
        st = StreamStats(plan.n_slabs, len(touched), plan.slab_rows,
                         scanned_rows=rows_read,
                         scanned_bytes=rows_read * W * 4)
        return run, st

    def _scan_prefix(self, layout: StoreLayout, plan: SlabPlan, touched,
                     qh, qp, qc, params: SearchParams, dim: int, qp_np, qc_np,
                     timings):
        """Dimension-cascade slab loop: a seed pass for exact thresholds, a
        prefix-word read and scan per touched slab, a full-width fetch and
        exact rescore of its survivors, folded into the running winners."""
        p = params
        K, P, W = p.top_k, p.prefix_words, layout.n_words
        local = p._replace(k_blocks=min(p.k_blocks, plan.slab_blocks))
        dev = self.device
        rows_read = 0
        bytes_read = 0

        def rescore(rows_np: np.ndarray):
            """Exact dual-window top-k over global layout rows (full width).
            Only the real candidate rows are read from the store; the
            bucket padding is zeros (masked out by the PAD sidecars)."""
            n = rows_np.shape[0]
            bucket = row_bucket(n, device=self.device)
            rows_pad, valid = pad_candidate_rows(rows_np, bucket)
            hv = np.zeros((bucket, W), np.int32)
            hv[:n] = layout.gather_rows(rows_np)
            r_pmz = np.where(valid, layout.pmz[rows_pad], np.float32(PAD_PMZ))
            r_charge = np.where(valid, layout.charge[rows_pad], -1).astype(np.int32)
            r_rows = np.where(valid, rows_pad, -1).astype(np.int32)
            return _rescore_rows_padded(
                *(torch.from_numpy(a).to(dev) for a in (hv, r_rows, r_pmz, r_charge)),
                qh, qp, qc, params=p, dim=dim)

        Qp = qh.shape[0]
        neg = torch.full((Qp,), _NEG_THRESHOLD, dtype=torch.int32, device=dev)
        seed_rows = plan_seed_rows(layout.pmz, layout.charge, qp_np, qc_np,
                                   p.prefix_seed_da)
        if seed_rows.size:
            with span("serve.seed", rows=int(seed_rows.size),
                      bytes=int(seed_rows.size) * W * 4):
                thr_std, thr_open = kth_thresholds(rescore(seed_rows), K)
            rows_read += seed_rows.size
            bytes_read += seed_rows.size * W * 4
        else:
            thr_std, thr_open = neg, neg

        run = None
        q_prefix = qh[:, :P].contiguous()
        with contextlib.closing(self._stream(layout, plan, touched, P,
                                             timings)) as slabs:
            for s, db in slabs:
                n_real = self._slab_real_rows(layout, plan, s)
                rows_read += n_real
                bytes_read += n_real * P * 4
                with span("serve.slab.search", slab=s, rows=n_real,
                          bytes=n_real * P * 4):
                    if run is not None:
                        # Tighten with the running k-th: still a subset
                        # k-th, so the exact-mode guarantee holds.
                        rs, ro = kth_thresholds(run, K)
                        ts = torch.maximum(thr_std, rs)
                        to = torch.maximum(thr_open, ro)
                    else:
                        ts, to = thr_std, thr_open
                    # A prefix slab holds only the first P words: it is its
                    # own prefix_hvs.
                    flags = _prefix_flags(db, db.hvs, q_prefix, qp, qc, ts, to,
                                          params=local, dim=dim)
                    surv = np.flatnonzero(_host(flags))
                if surv.size == 0:
                    continue
                rows_read += surv.size
                bytes_read += surv.size * W * 4
                with span("serve.slab.merge", slab=s, rows=int(surv.size),
                          bytes=int(surv.size) * W * 4):
                    part = rescore(surv + s * plan.slab_rows)
                    run = part if run is None else _merge_partials(run, part, K)

        if p.prefix_margin >= 0 and seed_rows.size:
            # Margin mode may prune true winners; folding the seed-pass
            # winners back in makes it no worse than the seed pass. (Exact
            # mode re-finds every seed winner as a survivor, and merging
            # them here would let a seed winner beat an equal-sim lower row
            # of an earlier slab, so exact mode must not.)
            part = rescore(seed_rows)
            run = part if run is None else _merge_partials(run, part, K)
            rows_read += seed_rows.size
            bytes_read += seed_rows.size * W * 4

        st = StreamStats(plan.n_slabs, len(touched), plan.slab_rows,
                         scanned_rows=rows_read, scanned_bytes=bytes_read)
        return run, st

    @staticmethod
    def _finalize(layout: StoreLayout, best, row, min_sim):
        """Host mirror of ``oms_search``'s finalize: min-sim threshold, map
        padded rows to original library indices (padding rows carry -1)."""
        orig, n = layout.orig_idx, layout.n_rows
        ok = (best >= min_sim) & (row >= 0)
        idx = np.where(ok, orig[np.clip(row, 0, n - 1)], -1)
        ok = ok & (idx >= 0)
        return (np.where(ok, idx, -1).astype(np.int32),
                np.where(ok, best, -1).astype(np.int32),
                np.where(ok, row, -1).astype(np.int32))
