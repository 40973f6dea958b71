"""The port's observability layer against the reference's: the span fast
path and the tracer ring buffer; equal histogram quantiles and metric
snapshots for the same observations; equal rollups and tables for the same
events; each package's trace loader reads the other's JSON-lines and Chrome
exports and rejects the same malformed input; a traced port search
(resident, streamed, the streamed dimension cascade, the narrow→open
cascade) is byte-identical to the untraced one and records the same
multiset of span names and attributes as the reference's, times and thread
ids excluded."""
import pytest

torch = pytest.importorskip("torch")

import collections  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data.spectra import SpectraSet  # noqa: E402
from repro_torch.obs import (Counter, Gauge, Histogram, Metrics, Tracer,  # noqa: E402
                             enabled, install, span, uninstall)
from repro_torch.obs import metrics as port_metrics  # noqa: E402
from repro_torch.obs import report as port_report  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402

CFG = dict(dim=512, max_r=32, q_block=8, n_levels=16)
DS = dict(n_refs=300, n_queries=24, seed=7)


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test starts and ends with tracing disabled in both packages."""
    uninstall()
    ref_trace.uninstall()
    yield
    uninstall()
    ref_trace.uninstall()


# ---------------------------------------------------------------------------
# span() fast path + tracer
# ---------------------------------------------------------------------------


def test_span_disabled_is_shared_noop_singleton(monkeypatch):
    assert not enabled()
    s1, s2 = span("a", x=1), span("b")
    assert s1 is s2 is port_trace.NOOP_SPAN
    with s1 as s:
        s.add(ignored=True)
    assert port_trace.current() is None
    # A search through every site (the sync copies, the scan's prologue, the
    # padding plan on a memo miss) allocates no span object.
    from repro_torch.core import search as port_search

    def no_span(*a, **k):
        raise AssertionError("a span object was made with tracing off")

    monkeypatch.setattr(port_trace, "_Span", no_span)
    ds, queries = _data()
    pipe = pipeline.OMSPipeline(pipeline.OMSConfig(**CFG, backend="fused"),
                                SpectraSet(*(np.array(x) for x in ds.refs)),
                                device="cpu")
    port_search._padding_plan.cache_clear()
    pipe.search(queries)
    assert port_trace.current() is None


def test_span_records_name_attrs_and_midspan_add():
    t = install(Tracer())
    assert enabled() and port_trace.current() is t
    with span("stage", rows=7) as s:
        s.add(bytes=28)
    (ev,) = t.events()
    assert (ev.name, dict(ev.attrs)) == ("stage", {"rows": 7, "bytes": 28})
    assert ev.dur_ns == ev.t_end_ns - ev.t_start_ns >= 0
    assert ev.tid == threading.get_ident()
    uninstall()
    with span("after"):
        pass
    assert t.n_recorded == 1


@pytest.mark.parametrize("capacity,n", [(4, 10), (1, 3), (16, 5)])
def test_ring_buffer_matches_reference(capacity, n):
    got, want = Tracer(capacity=capacity), ref_trace.Tracer(capacity=capacity)
    for t in (got, want):
        for i in range(n):
            t.record(f"e{i}", i, i + 1)
    assert [e.name for e in got.events()] == [e.name for e in want.events()]
    assert (got.n_recorded, got.n_dropped) == (want.n_recorded, want.n_dropped)
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


OBS = {"spread": [10 ** (i % 7 - 5) * (1 + i % 3) for i in range(200)],
       "edges": [1e-4, 2.5e-4, 5e-4, 1.0, 60.0, 61.0, 0.0, 1e-9],
       "one": [0.003]}


@pytest.mark.parametrize("bounds", [None, (1.0, 2.0, 4.0),
                                    port_metrics.DEFAULT_SIZE_BUCKETS])
@pytest.mark.parametrize("obs", sorted(OBS))
def test_histogram_quantiles_equal_reference(bounds, obs):
    kw = {} if bounds is None else {"bounds": bounds}
    got, want = Histogram(**kw), ref_metrics.Histogram(**kw)
    for v in OBS[obs]:
        got.observe(v)
        want.observe(v)
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert got.snapshot() == want.snapshot()


def test_default_buckets_equal_reference():
    assert port_metrics.DEFAULT_LATENCY_BUCKETS == ref_metrics.DEFAULT_LATENCY_BUCKETS
    assert port_metrics.DEFAULT_SIZE_BUCKETS == ref_metrics.DEFAULT_SIZE_BUCKETS
    assert port_report._DUR_BUCKETS_US == ref_report._DUR_BUCKETS_US


def _exercise(m):
    m.counter("a").inc()
    m.counter("a").inc(4)
    g = m.gauge("g")
    g.inc(3)
    g.dec()
    g.set(0.5)
    h = m.histogram("h")
    for v in (1e-3, 2e-2, 0.7):
        h.observe(v)
    m.histogram("sizes", port_metrics.DEFAULT_SIZE_BUCKETS).observe(17)
    with pytest.raises(TypeError, match="already registered"):
        m.gauge("a")
    return m.snapshot()


def test_metrics_snapshot_equals_reference():
    assert _exercise(Metrics()) == _exercise(ref_metrics.Metrics())
    c, g = Counter(), Gauge()
    c.inc(2)
    g.inc(3)
    g.dec()
    assert (c.snapshot(), g.snapshot()) == (2, {"value": 2.0, "max": 3.0})
    for bad in ((), (2.0, 1.0), (1.0, 1.0), (1.0, float("inf"))):
        with pytest.raises(ValueError):
            Histogram(bounds=bad)


# ---------------------------------------------------------------------------
# Export formats, the loader, the rollup
# ---------------------------------------------------------------------------


def _record_sample(t):
    t.record("encode", 1_000_000, 3_000_000, {"rows": 5})
    t.record("scan", 3_000_000, 9_000_000, {"rows": 11, "bytes": 44})
    t.record("scan", 9_000_000, 10_000_000, {"rows": 1, "bytes": 4})
    t.record("merge", 10_000_000, 10_004_000, {"slab": 3})
    t.record("flag", 0, 7_000, {"rows": True})        # bools are not summed
    return t


def _plain(events):
    return [(e.name, e.t_start_ns, e.t_end_ns, e.tid, dict(e.attrs))
            for e in events]


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_loader_reads_the_other_export(tmp_path, fmt, writer):
    t = _record_sample(Tracer() if writer == "port" else ref_trace.Tracer())
    path = str(tmp_path / ("t.jsonl" if fmt == "jsonl" else "t.json"))
    assert (t.to_jsonl(path) if fmt == "jsonl" else t.to_chrome(path)) == 5
    got, want = port_report.load_trace(path), ref_report.load_trace(path)
    assert _plain(got) == _plain(want) and len(got) == 5
    assert got[1].attrs["rows"] == 11 and got[0].dur_ns == 2_000_000


def test_export_files_equal_reference(tmp_path):
    for fmt in ("jsonl", "chrome"):
        texts = []
        for t in (_record_sample(Tracer()), _record_sample(ref_trace.Tracer())):
            # one thread id for both: the files must then match byte for byte
            t._buf = type(t._buf)((e._replace(tid=1) for e in t._buf),
                                  maxlen=t._buf.maxlen)
            path = tmp_path / f"{len(texts)}.{fmt}"
            getattr(t, "to_jsonl" if fmt == "jsonl" else "to_chrome")(str(path))
            texts.append(path.read_text())
        assert texts[0] == texts[1]
    ev = _record_sample(Tracer()).events()[1]
    assert port_trace.event_dict(ev) == ref_trace.event_dict(
        ref_trace.TraceEvent(*ev))


@pytest.mark.parametrize("text,msg", [
    ('{"ts_us": 1, "dur_us": 2, "tid": 3}\n', "missing 'name'"),
    ('{"name": "x", "ts_us": 1, "tid": 3}\n', "missing 'dur_us'"),
    ('{"name": "x", "ts_us": 1, "dur_us": -2, "tid": 3}\n', "non-negative"),
    ('{"name": "", "ts_us": 1, "dur_us": 2, "tid": 3}\n', "non-empty"),
    ("not json\n", "invalid JSON"),
    ("", "empty"),
    (json.dumps({"traceEvents": [{"name": "x", "ph": "B", "ts": 0, "dur": 1,
                                  "pid": 1, "tid": 1}]}), "ph='X'"),
    (json.dumps({"traceEvents": {}}), "must be a list"),
])
def test_loader_rejects_what_the_reference_rejects(tmp_path, text, msg):
    path = tmp_path / "bad.trace"
    path.write_text(text)
    errors = []
    for mod in (port_report, ref_report):
        with pytest.raises(mod.TraceFormatError, match=msg) as e:
            mod.load_trace(str(path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_rollup_and_table_equal_reference():
    got_ev = _record_sample(Tracer()).events()
    want_ev = _record_sample(ref_trace.Tracer()).events()
    got, want = port_report.rollup(got_ev), ref_report.rollup(want_ev)
    assert got == want
    assert got["scan"]["count"] == 2 and got["scan"]["rows"] == 12
    assert got["flag"]["rows"] == 0
    assert port_report.format_table(got) == ref_report.format_table(want)
    assert port_report.format_table(got).splitlines()[2].startswith("scan")


# ---------------------------------------------------------------------------
# Traced searches: byte-identical results, the reference's spans
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _data():
    ds = make_dataset(LibraryConfig(**DS))
    return ds, SpectraSet(*(np.array(x) for x in ds.queries))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    ds, _ = _data()
    path = str(tmp_path_factory.mktemp("obs") / "store")
    ref_pipeline.OMSPipeline.ingest(ref_pipeline.OMSConfig(**CFG), ds.refs,
                                    path, chunk_rows=256)
    return path


# The port's spans at the search path's host seams, which the reference has
# not: one per synchronising host<->device copy, and the scan's prologue.
PORT_SPANS = {"sync.encode.upload", "sync.query.sidecars", "sync.plan.block_meta",
              "sync.plan.k_blocks", "sync.scan.pad_upload", "scan.sort_pad",
              "scan.pad_plan", "scan.launch"}


def _span_multiset(events):
    return collections.Counter(
        (e.name, tuple(sorted(e.attrs.items()))) for e in events)


def _results(out):
    res = getattr(out, "result", out)
    return {f: np.asarray(getattr(res, f)) if not isinstance(
        getattr(res, f), torch.Tensor) else getattr(res, f).numpy()
        for f in res._fields}


MODES = {
    "resident": (dict(resident=True), "search", {}),
    "streamed": (dict(resident=False, slab_rows=96), "search", {}),
    "streamed-prefix": (dict(resident=False, slab_rows=96), "search",
                        {"prefix_words": 4}),
    "cascade-resident": (dict(resident=True), "cascade", {}),
    "cascade-streamed": (dict(resident=False, slab_rows=160), "cascade", {}),
}


def _traced(tr_mod, pipe, queries, how, kw):
    def run():
        hvs, qp, qc = pipe.encode_queries(queries)
        if how == "cascade":
            return pipe.search_cascade_encoded(hvs, qp, qc, narrow_tol_da=1.0,
                                               stage1_per_query=True)
        return pipe.search_encoded(hvs, qp, qc, **kw)
    plain = run()
    t = tr_mod.install(tr_mod.Tracer())
    try:
        traced = run()
    finally:
        tr_mod.uninstall()
    return plain, traced, t.events()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_traced_search_byte_identical_with_reference_spans(store, mode):
    load, how, kw = MODES[mode]
    ds, queries = _data()
    ref = ref_pipeline.OMSPipeline.from_store(
        store, ref_pipeline.OMSConfig(**CFG), **load)
    port = pipeline.OMSPipeline.from_store(
        store, pipeline.OMSConfig(**CFG), device="cpu", **load)
    r_plain, r_traced, r_events = _traced(ref_trace, ref, ds.queries, how, kw)
    p_plain, p_traced, p_events = _traced(port_trace, port, queries, how, kw)
    p0, p1, r1 = _results(p_plain), _results(p_traced), _results(r_traced)
    for f in p0:
        assert p0[f].tobytes() == p1[f].tobytes(), f       # tracing is inert
        assert (p1[f] == r1[f]).all(), f                   # and the answer
    r_names = {e.name for e in r_events}
    assert _span_multiset([e for e in p_events if e.name in r_names]) == \
        _span_multiset(r_events)
    names = {e.name for e in p_events}
    assert names - r_names <= PORT_SPANS, names - r_names
    assert {"pipeline.encode"} <= names
    if how == "search":
        assert {"pipeline.plan", "pipeline.scan", "pipeline.fdr"} <= names
    else:
        assert "pipeline.stage" in names
    if not load["resident"]:
        assert {"serve.scan", "serve.slab.fetch", "serve.slab.search"} <= names
        n_search = sum(e.name == "serve.slab.search" for e in p_events)
        assert n_search == port.engine.total_stats.slabs_scanned // 2
    if kw.get("prefix_words"):
        assert "serve.seed" in names
    for e in p_events:
        json.dumps(port_trace.event_dict(e))               # exportable


def test_span_records_when_its_body_raises():
    """A failing stage still closes its span, as in the reference, and the
    error reaches the caller."""
    for mod in (port_trace, ref_trace):
        t = mod.install(mod.Tracer())
        try:
            with pytest.raises(RuntimeError, match="boom"):
                with mod.span("stage", rows=1):
                    raise RuntimeError("boom")
        finally:
            mod.uninstall()
        assert [(e.name, dict(e.attrs)) for e in t.events()] == [
            ("stage", {"rows": 1})]
