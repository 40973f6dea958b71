"""The resident dimension cascade (prefix_words > 0) of repro_torch against
the reference, bit-exact: its helpers, and oms_search with a prefix-word
prune and an exact rescore for the backends whose prefix and rescore
stages take different tiles (vpu; kernel_vpu; fused_mxu -> kernel_mxu),
in exact mode and with a margin, on a zero-seed batch and a tie-heavy
library; and the port's cascade against its own full-width search."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import blocking as ref_blocking  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro_torch.convert import (packed_to_torch, reference_db_from_numpy,  # noqa: E402
                                 search_result_to_numpy)
from repro_torch.core import search  # noqa: E402

W = 8
DIM = 32 * W
DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")


@functools.lru_cache(maxsize=None)
def _case(distinct: int, seed: int):
    """A blocked library (reference and port) and a query batch whose
    blocks straddle charges; ``distinct`` HV rows make similarities tie."""
    rng = np.random.default_rng(seed)
    n = 200
    pool = rng.integers(0, 2 ** 32, (distinct, W), dtype=np.uint64).astype(np.uint32)
    hvs = pool[rng.integers(0, distinct, n)]
    pmz = rng.uniform(400.0, 1800.0, n).astype(np.float32)
    charge = np.asarray([2, 3], np.int32)[rng.integers(0, 2, n)]
    decoy = rng.random(n) < 0.5
    src = rng.integers(0, n, 37)
    q = hvs[src].copy()
    flip = rng.integers(0, 2 ** 32, (37, W), dtype=np.uint64).astype(np.uint32)
    q ^= flip & np.uint32(0x01010101)
    qp = (pmz[src] + rng.uniform(-50, 50, 37) * (rng.random(37) < 0.5)).astype(np.float32)
    qc = charge[src]
    ref_db = ref_blocking.build_reference_db(
        jnp.asarray(hvs), jnp.asarray(pmz), jnp.asarray(charge),
        jnp.asarray(decoy), max_r=32)
    db = reference_db_from_numpy(*(np.asarray(getattr(ref_db, f)) for f in DB_FIELDS),
                                 max_r=32)
    kb = ref_search.plan_search(ref_db, qp, qc, open_tol_da=75.0, q_block=16)
    return ref_db, db, q, qp, qc, kb


def _run_both(case, **kw):
    ref_db, db, q, qp, qc, kb = case
    params = ref_search.SearchParams(q_block=16, k_blocks=kb, **kw)
    want = ref_search.oms_search(ref_db, jnp.asarray(q), jnp.asarray(qp),
                                 jnp.asarray(qc), params, dim=DIM)
    stats = {}
    got = search.oms_search(db, packed_to_torch(q), torch.from_numpy(qp),
                            torch.from_numpy(qc), search.SearchParams(*params),
                            dim=DIM, stats=stats)
    got = search_result_to_numpy(got)
    for f in ref_search.SearchResult._fields:
        assert (np.asarray(getattr(want, f)) == got[f]).all(), f
    return got, stats


def _full_width(case, **kw):
    _, db, q, qp, qc, kb = case
    res = search.oms_search(db, packed_to_torch(q), torch.from_numpy(qp),
                            torch.from_numpy(qc),
                            search.SearchParams(q_block=16, k_blocks=kb, **kw),
                            dim=DIM)
    return search_result_to_numpy(res)


@pytest.mark.parametrize("backend", ["vpu", "kernel_vpu", "fused_mxu"])
@pytest.mark.parametrize("prefix_words", [1, 4, 7])
@pytest.mark.parametrize("top_k", [1, 2])
def test_prefix_search_matches_reference(backend, prefix_words, top_k):
    case = _case(30, top_k)
    got, stats = _run_both(case, backend=backend, top_k=top_k,
                           prefix_words=prefix_words)
    full = _full_width(case, backend="vpu", top_k=top_k)
    for f, v in full.items():
        assert (v == got[f]).all(), f                  # exact mode == full scan
    assert 0 < stats["seed_rows"] <= stats["seed_bucket"]
    assert stats["survivors"] <= stats["survivor_bucket"]
    assert min(stats["seed_s"], stats["prefix_s"], stats["rescore_s"]) >= 0


@pytest.mark.parametrize("margin", ["zero", "rest"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_prefix_margin_matches_reference(margin, top_k):
    prefix_words = 4
    m = 0 if margin == "zero" else DIM - 32 * prefix_words
    case = _case(30, 10 + top_k)
    got, stats = _run_both(case, backend="kernel_vpu", top_k=top_k,
                           prefix_words=prefix_words, prefix_margin=m)
    if margin == "rest":          # the exact bound, spelled out
        full = _full_width(case, backend="vpu", top_k=top_k)
        for f, v in full.items():
            assert (v == got[f]).all(), f
    else:                         # seed rows are folded back in
        assert stats["survivors"] >= stats["seed_rows"]


def test_zero_seed_batch_matches_reference():
    """No library row lies within the seed window of any query: every
    threshold stays unknown and stage A keeps each in-window row."""
    ref_db, db, q, qp, qc, kb = _case(30, 5)
    far = (qp + np.float32(0.37)).astype(np.float32)      # between rows
    row_pmz = np.asarray(ref_db.pmz)
    assert search.plan_seed_rows(row_pmz, np.asarray(ref_db.charge), far, qc,
                                 1e-4).size == 0
    case = (ref_db, db, q, far, qc, kb)
    got, stats = _run_both(case, backend="fused_mxu", top_k=2, prefix_words=2,
                           prefix_seed_da=1e-4)
    assert stats["seed_rows"] == 0 and stats["survivors"] > 0
    full = _full_width(case, backend="fused", top_k=2)
    for f, v in full.items():
        assert (v == got[f]).all(), f


@pytest.mark.parametrize("backend", ["vpu", "fused_mxu"])
def test_tie_heavy_library_matches_reference(backend):
    """Three distinct HVs: every rank is a tie broken by the lowest row."""
    case = _case(3, 7)
    got, _ = _run_both(case, backend=backend, top_k=2, prefix_words=3)
    full = _full_width(case, backend="fused", top_k=2)
    for f, v in full.items():
        assert (v == got[f]).all(), f


@pytest.mark.parametrize("backend", ["mxu", "kernel_mxu", "fused", "fused_xla"])
def test_prefix_search_matches_own_full_width(backend):
    """The port's cascade against the port's full-width scan, for the
    backends the reference comparison above leaves out."""
    case = _case(30, 9)
    _, db, q, qp, qc, kb = case
    res = search.oms_search(db, packed_to_torch(q), torch.from_numpy(qp),
                            torch.from_numpy(qc),
                            search.SearchParams(q_block=16, k_blocks=kb,
                                                backend=backend, top_k=2,
                                                prefix_words=5),
                            dim=DIM)
    got = search_result_to_numpy(res)
    full = _full_width(case, backend=backend, top_k=2)
    for f, v in full.items():
        assert (v == got[f]).all(), f


def test_helpers_match_reference():
    ref_db, db, q, qp, qc, kb = _case(30, 1)
    for pw, pm in ((1, -1), (4, 0), (4, 40), (7, 10 ** 6)):
        p = ref_search.SearchParams(prefix_words=pw, prefix_margin=pm)
        assert search.prefix_margin_bits(search.SearchParams(*p), DIM) == \
            ref_search.prefix_margin_bits(p, DIM)
    rng = np.random.default_rng(3)
    sims = rng.integers(-1, 50, (20, 3)).astype(np.int32)
    rows = np.where(sims >= 0, rng.integers(0, 100, (20, 3)), -1).astype(np.int32)
    run = (sims, rows, sims[::-1].copy(), rows[::-1].copy())
    for k in (1, 3):
        want = ref_search.kth_thresholds(tuple(jnp.asarray(x) for x in run), k)
        got = search.kth_thresholds(tuple(torch.from_numpy(x) for x in run), k)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32 and (np.asarray(w) == g.numpy()).all()
    row_pmz, row_charge = np.asarray(ref_db.pmz), np.asarray(ref_db.charge)
    for tol in (1e-3, 1.0, 30.0):
        want = ref_search.plan_seed_rows(row_pmz, row_charge, qp, qc, tol)
        got = search.plan_seed_rows(row_pmz, row_charge, qp, qc, tol)
        assert got.dtype == want.dtype and (got == want).all()
    for n in (0, 1, 63, 64, 65, 1000, 4096, 4097):
        assert search.row_bucket(n) == ref_search.row_bucket(n, lo=64)
        assert search.row_bucket(n, lo=8) == ref_search.row_bucket(n, lo=8)
    surv = np.asarray([3, 5, 40, 41], np.int64)
    for (wr, wv), (gr, gv) in ((ref_search.pad_candidate_rows(surv, 64),
                                search.pad_candidate_rows(surv, 64)),):
        assert (wr == gr).all() and (wv == gv).all()


def test_cascade_tile_routing():
    """Matrix backends use their own tile; ``fused`` and ``fused_mxu`` use
    their kernel siblings (the eager plain tile of ``fused``'s reference
    route would materialise (Qb, S, W)); ``fused_xla`` keeps the plain one."""
    from repro_torch.core import backends
    want = {"vpu": "vpu", "mxu": "mxu", "kernel_vpu": "kernel_vpu",
            "kernel_mxu": "kernel_mxu", "fused": "kernel_vpu",
            "fused_mxu": "kernel_mxu", "fused_xla": "vpu"}
    assert set(backends.names()) == set(want)
    for name, tile in want.items():
        assert backends.hamming_tile_fn(name) is backends.get(tile).fn, name
