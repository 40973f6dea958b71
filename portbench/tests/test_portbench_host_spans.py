"""The readers of the program's host-seam spans (``sync.*``, ``pipeline.scan``,
``scan.*``) on hand-made records, and on the card the check that
``host_syncs_per_run`` counts what it says: every copy torch's sync debug
mode flags in one search lies inside a ``sync.*`` span, one span a copy."""
from __future__ import annotations

import time
import warnings

import pytest

from portbench import check, gen_spectra, harness
from portbench.tests._tiny import cells

MS = 1_000_000
NAMES = ("host_syncs_per_run", "host_sync_ms", "scan_host_ms", "pad_plan_ms",
         "pad_plan_miss_share")


def _record(spans, runs=20):
    cell = harness.resolve(harness.load_benchmark(), cells()[0])
    rows = [(i * 2 * MS, i * 2 * MS + MS, i % 2, 1000) for i in range(runs)]
    return harness.Record(cell, 1.0, 1.0, rows, None, spans=spans, window_ns=(0, 40 * MS))


def _read(rec):
    return {n: harness.reader(n)(rec) for n in NAMES}


# Two runs' host seams in the window and one copy after it: the first run's
# padding plan misses the memo, the second's hits.
SPANS = [("pipeline.encode", 0, 2 * MS), ("sync.encode.upload", MS, 3 * MS // 2),
         ("sync.query.sidecars", 3 * MS, 13 * MS // 4),
         ("pipeline.plan", 7 * MS // 2, 4 * MS),
         ("sync.plan.block_meta", 7 * MS // 2, 15 * MS // 4),
         ("pipeline.scan", 4 * MS, 7 * MS), ("scan.sort_pad", 4 * MS, 5 * MS),
         ("scan.pad_plan", 42 * MS // 10, 46 * MS // 10),
         ("sync.scan.pad_upload", 47 * MS // 10, 48 * MS // 10),
         ("pipeline.scan", 21 * MS, 23 * MS), ("scan.sort_pad", 21 * MS, 43 * MS // 2),
         ("sync.encode.upload", 45 * MS, 46 * MS)]


def test_host_span_readers_read_the_window():
    got = _read(_record(SPANS))
    assert got["host_syncs_per_run"] == pytest.approx(4 / 20)
    assert got["host_sync_ms"] == pytest.approx((0.5 + 0.25 + 0.25 + 0.1) / 20)
    assert got["scan_host_ms"] == pytest.approx((3 + 2) / 20)
    assert got["pad_plan_ms"] == pytest.approx(0.4 / 20)
    assert got["pad_plan_miss_share"] == pytest.approx(1 / 20)


def test_host_span_readers_read_a_memo_that_never_missed_as_zero():
    got = _read(_record([s for s in SPANS if s[0] != "scan.pad_plan"]))
    assert got["pad_plan_ms"] == 0.0 and got["pad_plan_miss_share"] == 0.0


def test_host_span_readers_with_nothing_to_read_return_nothing():
    assert _read(_record([])) == dict.fromkeys(NAMES)
    # A program without the host-seam spans (only its stage spans): the scan's
    # whole span is read, nothing of the seams.
    stages = [s for s in SPANS if s[0].startswith("pipeline.")]
    assert _read(_record(stages)) == {**dict.fromkeys(NAMES), "scan_host_ms": 0.25}


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_host_syncs_per_run_counts_the_copies_torch_flags(name, card):
    import torch

    from repro_torch.core import search
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.obs import trace

    cell = harness.resolve(harness.load_benchmark(), name)
    seed = 2**31 + 77
    library, pool, warm = gen_spectra.make_inputs(
        cell.config, {**cell.traffic, "pool_runs": 1, "warm_runs": 1}, seed, card)
    drv = harness.driver(cell.traffic["driver"])
    pipe = OMSPipeline(drv.oms_config(cell.config, seed), library, device=card)
    top_k = int(cell.traffic["top_k"])
    check.answer_of(pipe.search(warm[0], top_k=top_k))
    torch.cuda.synchronize(card)

    flagged = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            flagged.append((time.perf_counter_ns(), f"{filename}:{lineno}"))

    search._padding_plan.cache_clear()          # a run new to the memo, as in the pool
    tracer = trace.install(trace.Tracer())
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = pipe.search(pool[0], top_k=top_k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        trace.uninstall()
    check.answer_of(out)
    events = tracer.events()
    syncs = [e for e in events if e.name.startswith("sync.")]
    print(name, "syncs flagged", len(flagged), "sync spans", len(syncs),
          sorted({e.name for e in syncs}), sorted({at for _, at in flagged}))
    outside = [at for t, at in flagged
               if not any(e.t_start_ns <= t <= e.t_end_ns for e in syncs)]
    assert not outside, outside
    assert len(flagged) == len(syncs)
    assert sum(e.name == "scan.pad_plan" for e in events) == 1
