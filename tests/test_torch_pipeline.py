"""The port's resident OMS pipeline against the reference's, end to end on
one dataset: the blocked DB, all six SearchResult arrays and both FDR
results must be identical, for every search backend (each paired with an
encode backend) at top_k 1 and 2, with and without the dimension cascade;
state carried across by repro_torch.convert searches alike."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fdr as ref_fdr  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import encode_backends, fdr, pipeline, search  # noqa: E402
from repro_torch.data.spectra import SpectraSet  # noqa: E402

DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")
CFG = dict(dim=256, max_r=64, bin_size=0.2, encode_batch=64)


@functools.lru_cache(maxsize=None)
def _dataset():
    ds = make_dataset(LibraryConfig(n_refs=240, n_queries=40, seed=1))
    return ds, tuple(SpectraSet(*(np.array(x) for x in s))
                     for s in (ds.refs, ds.queries))


@functools.lru_cache(maxsize=None)
def _ref_pipeline(backend, encode_backend):
    ds, _ = _dataset()
    return ref_pipeline.OMSPipeline(ref_pipeline.OMSConfig(
        **CFG, backend=backend, encode_backend=encode_backend), ds.refs)


@functools.lru_cache(maxsize=None)
def _ref_run(backend, encode_backend, top_k):
    ds, _ = _dataset()
    pipe = _ref_pipeline(backend, encode_backend)
    return pipe, pipe.search(ds.queries, top_k=top_k)


@functools.lru_cache(maxsize=None)
def _port_pipeline(backend, encode_backend):
    _, (refs, _) = _dataset()
    cfg = pipeline.OMSConfig(**CFG, backend=backend, encode_backend=encode_backend)
    return pipeline.OMSPipeline(cfg, refs, device="cpu")


def _assert_output_equal(want, got):
    res = convert.search_result_to_numpy(got.result)
    for f in want.result._fields:
        assert (np.asarray(getattr(want.result, f)) == res[f]).all(), f
    for name in ("open_fdr", "std_fdr"):
        w, g = getattr(want, name), convert.fdr_result_to_numpy(getattr(got, name))
        for f in w._fields:
            assert (np.asarray(getattr(w, f)) == g[f]).all(), (name, f)


BACKEND_PAIRS = [("vpu", "word_tiled"), ("fused", "pallas"),
                 ("mxu", "word_tiled"), ("kernel_vpu", "pallas"),
                 ("kernel_mxu", "word_tiled"), ("fused_mxu", "pallas")]


@pytest.mark.parametrize("backend,encode_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("top_k", [1, 2])
def test_pipeline_matches_reference(backend, encode_backend, top_k):
    _, (_, queries) = _dataset()
    ref_pipe, want = _ref_run(backend, encode_backend, top_k)
    pipe = _port_pipeline(backend, encode_backend)
    for f in DB_FIELDS:
        w, g = np.asarray(getattr(ref_pipe.db, f)), getattr(pipe.db, f).numpy()
        if f == "hvs":
            g = g.view(np.uint32)
        assert w.shape == g.shape and (w == g).all(), f
    for f in ("id_hvs", "level_hvs", "tiebreak"):
        assert (convert.packed_to_numpy(getattr(pipe.codebooks, f))
                == np.asarray(getattr(ref_pipe.codebooks, f))).all(), f
    got = pipe.search(queries, top_k=top_k)
    _assert_output_equal(want, got)
    assert pipe.identifications(got) == ref_pipe.identifications(want)


@pytest.mark.parametrize("backend,encode_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("top_k", [1, 2])
def test_pipeline_prefix_words_matches_reference(backend, encode_backend, top_k):
    """OMSConfig(prefix_words=P) runs the dimension cascade: the same
    answer as the reference's cascade and as the port's full-width scan."""
    ds, (_, queries) = _dataset()
    want = _ref_pipeline(backend, encode_backend).search(
        ds.queries, top_k=top_k, prefix_words=3)
    pipe = _port_pipeline(backend, encode_backend)
    stats = {}
    hvs, qp, qc = pipe.encode_queries(queries)
    got = pipe.search_encoded(hvs, qp, qc, top_k=top_k, prefix_words=3,
                              stats=stats)
    _assert_output_equal(want, got)
    _assert_output_equal(_ref_run(backend, encode_backend, top_k)[1], got)
    assert stats["seed_rows"] > 0 and 3 in pipe._prefix_hvs
    assert pipe.prefix_hvs(3).is_contiguous()


def test_state_carried_by_convert_searches_identically():
    """Codebooks and DB built by the reference, carried across as numpy,
    drive the port's query encode + search to the reference's answer."""
    ds, (_, queries) = _dataset()
    ref_pipe, want = _ref_run("vpu", "word_tiled", 2)
    cb = convert.codebooks_from_reference(ref_pipe.codebooks.id_hvs,
                                          ref_pipe.codebooks.level_hvs,
                                          ref_pipe.codebooks.tiebreak, CFG["dim"])
    db = convert.reference_db_from_numpy(
        *(np.asarray(getattr(ref_pipe.db, f)) for f in DB_FIELDS),
        max_r=ref_pipe.db.max_r)
    cfg = pipeline.OMSConfig(**CFG, top_k=2)
    hvs, qp, qc = encode_backends.preprocess_encode(
        queries.mz, queries.intensity, queries.pmz, queries.charge, cb,
        cfg.preprocess_params, backend="pallas", batch=16)
    k = search.plan_search(db, qp, qc, open_tol_da=75.0, q_block=16)
    res = search.oms_search(db, hvs, qp, qc, search.SearchParams(
        k_blocks=k, top_k=2, backend="fused"), dim=CFG["dim"])
    got = convert.search_result_to_numpy(res)
    for f in want.result._fields:
        assert (np.asarray(getattr(want.result, f)) == got[f]).all(), f


@pytest.mark.parametrize("shape", [(50,), (20, 3)])
def test_fdr_filter_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    scores = rng.integers(100, 110, shape).astype(np.float32)   # heavy ties
    decoy = rng.random(shape) < 0.3
    valid = rng.random(shape) < 0.8
    for thr in (0.01, 0.3):
        want = ref_fdr.fdr_filter(jnp.asarray(scores), jnp.asarray(decoy),
                                  jnp.asarray(valid), threshold=thr)
        got = convert.fdr_result_to_numpy(fdr.fdr_filter(
            torch.from_numpy(scores), torch.from_numpy(decoy),
            torch.from_numpy(valid), threshold=thr))
        for f in want._fields:
            assert (np.asarray(getattr(want, f)) == got[f]).all(), f
    with pytest.raises(ValueError):
        fdr.fdr_filter(torch.from_numpy(scores), torch.from_numpy(decoy),
                       torch.from_numpy(valid), threshold=0.0)


def test_config_defaults_match_reference():
    assert pipeline.OMSConfig() == pipeline.OMSConfig(**vars(ref_pipeline.OMSConfig()))
    assert vars(pipeline.OMSConfig()) == vars(ref_pipeline.OMSConfig())
