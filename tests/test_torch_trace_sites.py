"""The spans of ``OMSPipeline.search`` at its host seams: one ``sync.*``
span per copy between the host and the search's device, each inside the
stage that makes it, and the ``scan.*`` spans that split the scan's host
prologue; the padding plan's span only on a memo miss; a traced search
byte-identical to an untraced one. On a CPU pipeline the same sites open
the same spans as on the card, so the counts here are the card's."""
import pytest

torch = pytest.importorskip("torch")

import collections  # noqa: E402
import functools  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import encode_backends, pipeline, search  # noqa: E402
from repro_torch.data.spectra import LibraryConfig, SpectraSet, make_dataset  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

CFG = dict(dim=256, max_r=64, bin_size=0.2, encode_batch=64)
# (search backend, encode backend): the benchmark's pair and the default pair.
BACKENDS = [("fused", "pallas"), ("vpu", "word_tiled")]

# Spans of one resident search with host query arrays: the copies the
# search makes (the query charges for the padding plan, the planner's one
# scalar), and the scan's host prologue on a padding-plan memo miss.
SYNC_COUNTS = {"sync.encode.upload": 4, "sync.query.sidecars": 1,
               "sync.plan.k_blocks": 1, "sync.scan.pad_upload": 2}
SCAN_COUNTS = {"scan.sort_pad": 1, "scan.pad_plan": 1, "scan.launch": 1}
# The stage span each site lies in; the query sidecars lie between the
# encode and the plan, in none.
STAGE = {"sync.encode.upload": "pipeline.encode",
         "sync.plan.k_blocks": "pipeline.plan",
         "sync.scan.pad_upload": "scan.sort_pad",
         "scan.pad_plan": "scan.sort_pad",
         "scan.sort_pad": "pipeline.scan", "scan.launch": "pipeline.scan"}


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    trace.uninstall()
    yield
    trace.uninstall()


@functools.lru_cache(maxsize=None)
def _data():
    ds = make_dataset(LibraryConfig(n_refs=240, n_queries=40, seed=3))
    return ds.refs, ds.queries


@functools.lru_cache(maxsize=None)
def _pipeline(backend, encode_backend):
    refs, _ = _data()
    cfg = pipeline.OMSConfig(**CFG, backend=backend, encode_backend=encode_backend)
    return pipeline.OMSPipeline(cfg, refs, device="cpu")


def _traced_search(pipe, queries, *, miss=True):
    if miss:
        search._padding_plan.cache_clear()
    t = trace.install(trace.Tracer())
    try:
        out = pipe.search(queries)
    finally:
        trace.uninstall()
    return out, t.events()


def _inside(ev, outer):
    return outer.t_start_ns <= ev.t_start_ns and ev.t_end_ns <= outer.t_end_ns


def _results(out):
    arrays = [*out.result, *out.open_fdr, *out.std_fdr]
    return [a.numpy().tobytes() if isinstance(a, torch.Tensor) else repr(a)
            for a in arrays]


@pytest.mark.parametrize("backend,encode_backend", BACKENDS)
def test_sync_and_scan_spans_count_the_copies_and_the_prologue(backend, encode_backend):
    _, queries = _data()
    _, events = _traced_search(_pipeline(backend, encode_backend), queries)
    counts = collections.Counter(e.name for e in events)
    got = {n: c for n, c in counts.items() if n.startswith(("sync.", "scan."))}
    assert got == {**SYNC_COUNTS, **SCAN_COUNTS}
    assert sum(c for n, c in got.items() if n.startswith("sync.")) == 8
    for name in ("pipeline.encode", "pipeline.plan", "pipeline.scan", "pipeline.fdr"):
        assert counts[name] == 1


@pytest.mark.parametrize("backend,encode_backend", BACKENDS)
def test_each_span_lies_inside_the_stage_that_makes_it(backend, encode_backend):
    _, queries = _data()
    _, events = _traced_search(_pipeline(backend, encode_backend), queries)
    one = {e.name: e for e in events}
    for ev in events:
        if ev.name in STAGE:
            assert _inside(ev, one[STAGE[ev.name]]), ev.name
        if ev.name.startswith(("sync.scan.", "scan.")):
            assert _inside(ev, one["pipeline.scan"]), ev.name
    stages = [one[n] for n in ("pipeline.encode", "pipeline.plan",
                               "pipeline.scan", "pipeline.fdr")]
    for ev in events:
        if ev.name == "sync.query.sidecars":
            assert one["pipeline.encode"].t_end_ns <= ev.t_start_ns
            assert ev.t_end_ns <= one["pipeline.plan"].t_start_ns
            assert not any(_inside(ev, s) for s in stages)


@pytest.mark.parametrize("backend,encode_backend", BACKENDS)
def test_a_padding_plan_memo_hit_records_no_pad_plan(backend, encode_backend):
    _, queries = _data()
    pipe = _pipeline(backend, encode_backend)
    _, first = _traced_search(pipe, queries)
    # The same per-charge counts in another order: the memo answers.
    perm = np.random.default_rng(0).permutation(queries.pmz.shape[0])
    shuffled = SpectraSet(*(np.asarray(x)[perm] for x in queries))
    _, second = _traced_search(pipe, shuffled, miss=False)
    assert sum(e.name == "scan.pad_plan" for e in first) == 1
    names = collections.Counter(e.name for e in second)
    assert names["scan.pad_plan"] == 0 and names["scan.sort_pad"] == 1
    assert names["sync.scan.pad_upload"] == 2


@pytest.mark.parametrize("backend,encode_backend", BACKENDS)
def test_traced_search_is_byte_identical(backend, encode_backend):
    _, queries = _data()
    pipe = _pipeline(backend, encode_backend)
    search._padding_plan.cache_clear()
    plain = pipe.search(queries)
    traced, events = _traced_search(pipe, queries)
    assert events and _results(plain) == _results(traced)


def test_inputs_already_on_the_device_open_no_sync_span():
    _, queries = _data()
    pipe = _pipeline(*BACKENDS[0])
    cb, cfg = pipe.codebooks, pipe.cfg
    on_device = [torch.as_tensor(x) for x in queries]
    t = trace.install(trace.Tracer())
    try:
        encode_backends.preprocess_encode(*on_device, cb, cfg.preprocess_params,
                                          backend=cfg.encode_backend)
        search._host(np.zeros(3), "sync.test")
        host_meta = types.SimpleNamespace(n_blocks=pipe.db.n_blocks, **{
            f: getattr(pipe.db, f).numpy()
            for f in ("block_min", "block_max", "block_charge")})
        search.plan_search(host_meta, queries.pmz, queries.charge,
                           open_tol_da=cfg.open_tol_da, q_block=cfg.q_block)
    finally:
        trace.uninstall()
    assert [e.name for e in t.events()] == []
