"""The port's baselines and block statistics against the reference's:
``candidate_block_stats`` equal on a resident DB and on the streaming
layout; ``bin_spectra_dense`` with the same bins and sqrt-scaled values,
normalised within float32 rounding; ``spectrast_dot`` and
``shifted_cosine`` with equal argmax rows (including queries with nothing
in a window) and scores within float32 rounding; ``exhaustive_params``.

Tolerances: the L2 norm and the dot products are float32 sums whose order
differs between XLA and PyTorch, so each result may be a rounding step or
two away: vectors within 2 ulp (rtol 2**-22), scores (cosines of unit
vectors, |s| <= 1) within 1e-6 absolute."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import baselines as ref_bl  # noqa: E402
from repro.core import blocking as ref_blocking  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core.search import SearchParams as RefParams  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro_torch.core import baselines as port_bl  # noqa: E402
from repro_torch.core import blocking, pipeline  # noqa: E402
from repro_torch.core.search import SearchParams  # noqa: E402
from repro_torch.serve import StoreLayout  # noqa: E402
from repro_torch.store import LibraryStore  # noqa: E402

BIN = dict(bin_size=0.05, mz_min=200.0, mz_max=2000.0)
SCORE_ATOL = 1e-6
VEC_RTOL = 2.0 ** -22


@functools.lru_cache(maxsize=None)
def _data(seed=3):
    ds = make_dataset(LibraryConfig(n_refs=200, n_queries=30, seed=seed))
    q = [np.array(x) for x in ds.queries]
    q[3][:2] = 4            # charge 4 on queries 0, 1: windows empty
    return ds, [np.array(x) for x in ds.refs], q


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("which", ["refs", "queries"])
def test_bin_spectra_dense_matches_reference(which):
    _, refs, queries = _data()
    s = refs if which == "refs" else queries
    want = np.asarray(ref_bl.bin_spectra_dense(s[0], s[1], **BIN))
    got = port_bl.bin_spectra_dense(_t(s[0]), _t(s[1]), **BIN,
                                    device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (
        s[0].shape[0], 36000)
    assert ((got != 0) == (want != 0)).all()          # the same bins
    np.testing.assert_allclose(got, want, rtol=VEC_RTOL, atol=0)
    # numpy input gives the same tensor, on the device asked for
    again = port_bl.bin_spectra_dense(s[0], s[1], **BIN, device="cpu")
    assert again.device.type == "cpu" and (again.numpy() == got).all()


@pytest.mark.parametrize("fn", ["spectrast_dot", "shifted_cosine"])
@pytest.mark.parametrize("windows", [dict(), dict(ppm_tol=50.0, open_tol_da=20.0)],
                         ids=["default", "narrow"])
def test_dense_scores_match_reference(fn, windows):
    _, refs, queries = _data()
    rv_ref = ref_bl.bin_spectra_dense(refs[0], refs[1], **BIN)
    qv_ref = ref_bl.bin_spectra_dense(queries[0], queries[1], **BIN)
    kw = dict(windows, **({"bin_size": BIN["bin_size"]}
                          if fn == "shifted_cosine" else {}))
    want = getattr(ref_bl, fn)(qv_ref, rv_ref, queries[2], refs[2],
                               queries[3], refs[3], **kw)
    # the port scores the reference's vectors: only the scoring differs
    got = getattr(port_bl, fn)(_t(qv_ref), _t(rv_ref), _t(queries[2]),
                               _t(refs[2]), _t(queries[3]), _t(refs[3]), **kw)
    for f in ("std_idx", "open_idx"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == np.int32 and (g == w).all(), f
    for f in ("std_score", "open_score"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_ATOL)
    # queries 0 and 1 carry charge 4: nothing in either window
    assert (got.std_idx.numpy()[:2] == -1).all()
    assert (got.open_idx.numpy()[:2] == -1).all()
    assert (got.open_score.numpy()[:2] == -2.0).all()
    assert (got.open_idx.numpy() >= 0).sum() > 20     # real matches too


def test_dense_pipeline_on_port_vectors_finds_the_same_rows():
    """End to end on the port's own vectors: the argmax rows equal the
    reference's."""
    _, refs, queries = _data()
    want = ref_bl.shifted_cosine(
        ref_bl.bin_spectra_dense(queries[0], queries[1], **BIN),
        ref_bl.bin_spectra_dense(refs[0], refs[1], **BIN),
        queries[2], refs[2], queries[3], refs[3], bin_size=BIN["bin_size"])
    got = port_bl.shifted_cosine(
        port_bl.bin_spectra_dense(queries[0], queries[1], **BIN, device="cpu"),
        port_bl.bin_spectra_dense(refs[0], refs[1], **BIN, device="cpu"),
        _t(queries[2]), _t(refs[2]), _t(queries[3]), _t(refs[3]),
        bin_size=BIN["bin_size"])
    for f in ("std_idx", "open_idx"):
        assert (getattr(got, f).numpy() == np.asarray(getattr(want, f))).all()


def test_exhaustive_params_matches_reference():
    assert tuple(port_bl.exhaustive_params()) == tuple(ref_bl.exhaustive_params())
    base = SearchParams(top_k=3, backend="fused")
    got = port_bl.exhaustive_params(base)
    assert got.exhaustive and got._replace(exhaustive=False) == base
    assert tuple(got) == tuple(ref_bl.exhaustive_params(
        RefParams(top_k=3, backend="fused")))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    ds, _, _ = _data()
    cfg = dict(dim=256, max_r=32, n_levels=8)
    path = str(tmp_path_factory.mktemp("bl") / "store")
    ref_pipeline.OMSPipeline.ingest(ref_pipeline.OMSConfig(**cfg), ds.refs,
                                    path, chunk_rows=512)
    return path, cfg


@pytest.mark.parametrize("tol", [0.5, 20.0, 75.0, 1000.0])
def test_candidate_block_stats_equal_reference(store, tol):
    path, cfg = store
    _, _, queries = _data()
    ref = ref_pipeline.OMSPipeline.from_store(path, ref_pipeline.OMSConfig(**cfg))
    port = pipeline.OMSPipeline.from_store(path, pipeline.OMSConfig(**cfg),
                                           device="cpu")
    want = ref_blocking.candidate_block_stats(ref.db, queries[2], queries[3], tol)
    assert blocking.candidate_block_stats(port.db, _t(queries[2]),
                                          _t(queries[3]), tol) == want
    layout = StoreLayout.from_store(LibraryStore.open(path), max_r=cfg["max_r"])
    assert blocking.candidate_block_stats(layout, queries[2], queries[3],
                                          tol) == want
    assert want["scanned_rows"] > 0 or tol < 1.0
