"""The port's narrow→open cascade against a live run of the reference's, on
the same dataset: the merged SearchResult, both FDR results,
``identified_stage1``, each stage's query indices, result, FDR and scanned
rows must be identical, at top_k 1 and 2, with the stage-1 competition
pooled and per query; resident and streamed from a store (stage stream
stats equal to the reference's own). With stage 1 off the cascade equals
``search_encoded``."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipeline, search  # noqa: E402
from repro_torch.data.spectra import SpectraSet  # noqa: E402

# The reference's cascade tests' configuration and dataset (charges {2, 3},
# a charge boundary mid q-block).
CFG = dict(dim=512, max_r=32, q_block=8, n_levels=16)
DS = dict(n_refs=500, n_queries=40, seed=5)
NARROW = 1.0
CHUNK = 192


@functools.lru_cache(maxsize=None)
def _data():
    ds = make_dataset(LibraryConfig(**DS))
    return ds, tuple(SpectraSet(*(np.array(x) for x in s))
                     for s in (ds.refs, ds.queries))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One store written by the reference (its ingest runs the library
    encode once); both packages serve it, resident and streamed."""
    ds, _ = _data()
    path = str(tmp_path_factory.mktemp("cascade") / "store")
    ref_pipeline.OMSPipeline.ingest(ref_pipeline.OMSConfig(**CFG), ds.refs, path,
                                    chunk_rows=CHUNK)
    return path


@pytest.fixture(scope="module")
def ref(store):
    ds, _ = _data()
    pipe = ref_pipeline.OMSPipeline.from_store(store, ref_pipeline.OMSConfig(**CFG))
    return pipe, pipe.encode_queries(ds.queries)


@pytest.fixture(scope="module")
def port(store):
    _, (_, queries) = _data()
    pipe = pipeline.OMSPipeline.from_store(store, pipeline.OMSConfig(**CFG),
                                           device="cpu")
    return pipe, pipe.encode_queries(queries)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tuple_equal(want, got: dict, ctx):
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        assert w.shape == got[f].shape and (w == got[f]).all(), (ctx, f)


def _assert_cascade_equal(want, got):
    g = convert.cascade_output_to_numpy(got)
    _assert_tuple_equal(want.result, g["result"], "result")
    _assert_tuple_equal(want.open_fdr, g["open_fdr"], "open_fdr")
    _assert_tuple_equal(want.std_fdr, g["std_fdr"], "std_fdr")
    assert (want.identified_stage1 == g["identified_stage1"]).all()
    assert want.scanned_rows_total == g["scanned_rows_total"]
    assert want.scanned_bytes_total == g["scanned_bytes_total"]
    for name in ("stage1", "stage2"):
        w, gs = getattr(want, name), g[name]
        assert (w is None) == (gs is None), name
        if w is None:
            continue
        assert (np.asarray(w.query_idx) == gs["query_idx"]).all(), name
        _assert_tuple_equal(w.result, gs["result"], (name, "result"))
        _assert_tuple_equal(w.fdr, gs["fdr"], (name, "fdr"))
        assert w.scanned_rows == gs["scanned_rows"], name
        want_st = None if w.stream_stats is None else w.stream_stats._asdict()
        assert want_st == gs["stream_stats"], name


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("per_query", [False, True])
def test_cascade_matches_reference(ref, port, top_k, per_query):
    ref, (rh, rqp, rqc) = ref
    pipe, (hvs, qp, qc) = port
    kw = dict(narrow_tol_da=NARROW, top_k=top_k, stage1_per_query=per_query)
    want = ref.search_cascade_encoded(rh, rqp, rqc, **kw)
    got = pipe.search_cascade_encoded(hvs, qp, qc, **kw)
    assert want.identified_stage1.any() and (~want.identified_stage1).any()
    _assert_cascade_equal(want, got)
    # the identified queries carry their stage-1 rows, the rest stage 2's
    g = convert.cascade_output_to_numpy(got)
    idd = got.identified_stage1
    for f in got.result._fields:
        assert (g["result"][f][idd] == g["stage1"]["result"][f][idd]).all(), f
        assert (g["result"][f][~idd] == g["stage2"]["result"][f]).all(), f


@pytest.mark.parametrize("top_k", [1, 2])
def test_stage1_disabled_equals_search_encoded(ref, port, top_k):
    ref, (rh, rqp, rqc) = ref
    pipe, (hvs, qp, qc) = port
    got = pipe.search_cascade_encoded(hvs, qp, qc, run_stage1=False, top_k=top_k)
    plain = pipe.search_encoded(hvs, qp, qc, top_k=top_k)
    for f in plain.result._fields:
        assert torch.equal(getattr(plain.result, f), getattr(got.result, f)), f
    assert got.stage1 is None and not got.identified_stage1.any()
    assert (got.stage2.query_idx == np.arange(DS["n_queries"])).all()
    _assert_cascade_equal(ref.search_cascade_encoded(rh, rqp, rqc, run_stage1=False,
                                                     top_k=top_k), got)


def test_cascade_with_prefix_words_matches_reference(ref, port):
    """The dimension cascade composed into the open stage."""
    ref, (rh, rqp, rqc) = ref
    pipe, (hvs, qp, qc) = port
    kw = dict(narrow_tol_da=NARROW, top_k=2, prefix_words=3)
    _assert_cascade_equal(ref.search_cascade_encoded(rh, rqp, rqc, **kw),
                          pipe.search_cascade_encoded(hvs, qp, qc, **kw))


def test_narrow_params_and_scanned_rows_match_reference(ref, port):
    ref, (rh, rqp, rqc) = ref
    pipe, (hvs, qp, qc) = port
    base = search.SearchParams(q_block=CFG["q_block"], k_blocks=1)
    rbase = ref_search.SearchParams(q_block=CFG["q_block"], k_blocks=1)
    for tol in (0.5, NARROW, 10.0):
        got = search.narrow_search_params(pipe.db, _np(qp), _np(qc), base,
                                          narrow_tol_da=tol)
        want = ref_search.narrow_search_params(ref.db, rqp, rqc, rbase,
                                               narrow_tol_da=tol)
        assert got._asdict() == want._asdict(), tol
        assert search.scanned_rows(pipe.db, 40, got) == ref_search.scanned_rows(
            ref.db, 40, want)
    assert pipe.pure_open_scanned_rows(40, qp, qc) == ref.pure_open_scanned_rows(
        40, rqp, rqc)
    for bad in (0.0, 75.5):
        with pytest.raises(ValueError, match="narrow_tol_da"):
            search.narrow_search_params(pipe.db, _np(qp), _np(qc), base,
                                        narrow_tol_da=bad)
    with pytest.raises(ValueError, match="must be <"):
        pipe.search_cascade_encoded(hvs, qp, qc, narrow_tol_da=75.0)


def test_empty_batch(port):
    pipe, (hvs, qp, qc) = port
    out = pipe.search_cascade_encoded(hvs[:0], qp[:0], qc[:0], top_k=2)
    assert out.result.open_row.shape == (0, 2) and out.stage1 is None
    assert int(out.open_fdr.n_accepted) == 0 and out.scanned_rows_total == 0


@pytest.mark.parametrize("slab_rows", [64, 1 << 30])
def test_streamed_cascade_matches_reference(store, port, slab_rows):
    """The port serving the reference's store, streamed: the same cascade
    as the reference's streamed run, stage stream stats included, and the
    same as the port's resident run."""
    ds, (_, queries) = _data()
    ref = ref_pipeline.OMSPipeline.from_store(store, max_r=CFG["max_r"],
                                              resident=False, slab_rows=slab_rows)
    pipe = pipeline.OMSPipeline.from_store(store, max_r=CFG["max_r"],
                                           resident=False, slab_rows=slab_rows,
                                           device="cpu")
    want = ref.search_cascade(ds.queries, narrow_tol_da=NARROW, top_k=2)
    got = pipe.search_cascade(queries, narrow_tol_da=NARROW, top_k=2)
    _assert_cascade_equal(want, got)
    assert got.scanned_bytes_total > 0
    resident = port[0].search_cascade(queries, narrow_tol_da=NARROW, top_k=2)
    for f in got.result._fields:
        assert torch.equal(getattr(got.result, f), getattr(resident.result, f)), f
