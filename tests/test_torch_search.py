"""Top-k selection, the blocked DB layout, the fused_search plain version
and oms_search of repro_torch against the reference, bit-exact."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import blocking as ref_blocking  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.kernels import topk as ref_topk  # noqa: E402
from repro.kernels.hamming import ops as ref_hops  # noqa: E402
from repro_torch.convert import (packed_to_torch, reference_db_from_numpy,  # noqa: E402
                                 search_result_to_numpy)
from repro_torch.core import backends, blocking, search  # noqa: E402
from repro_torch.kernels import topk  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.kernels.hamming import ref as href  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_select_and_merge_topk_match_reference(k):
    rng = np.random.default_rng(k)
    s = rng.integers(-1, 4, (7, 11)).astype(np.int32)   # many ties and -1s
    s[0] = -1
    want = ref_topk.select_topk(jnp.asarray(s), k)
    got = topk.select_topk(_t(s), k)
    for w, g in zip(want, got):
        assert (np.asarray(w) == g.numpy()).all()
    a_s, a_i = (np.asarray(x) for x in ref_topk.select_topk(jnp.asarray(s[:, :5]), k))
    b_s, b_i = (np.asarray(x) for x in ref_topk.select_topk(jnp.asarray(s[:, 5:]), k))
    b_i = np.where(b_i >= 0, b_i + 5, -1).astype(np.int32)
    want = ref_topk.merge_topk(*(jnp.asarray(x) for x in (a_s, a_i, b_s, b_i)), k)
    got = topk.merge_topk(_t(a_s), _t(a_i), _t(b_s), _t(b_i), k)
    for w, g in zip(want, got):
        assert (np.asarray(w) == g.numpy()).all()


def _library(rng, n, W, *, distinct=None, charges=(2, 3)):
    """Random packed HVs (optionally only ``distinct`` different rows, so
    similarities tie), pmz and charges."""
    if distinct:
        pool = rng.integers(0, 2 ** 32, (distinct, W), dtype=np.uint64).astype(np.uint32)
        hvs = pool[rng.integers(0, distinct, n)]
    else:
        hvs = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint64).astype(np.uint32)
    pmz = rng.uniform(400.0, 1800.0, n).astype(np.float32)
    charge = np.asarray(charges, np.int32)[rng.integers(0, len(charges), n)]
    return hvs, pmz, charge


DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")


def _assert_db_equal(want, got):
    for f in DB_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "hvs":
            g = g.view(np.uint32)
        assert w.shape == g.shape and (w == g).all(), f
    assert want.max_r == got.max_r


def test_blocking_layout_matches_reference():
    rng = np.random.default_rng(0)
    hvs, pmz, charge = _library(rng, 150, 4, charges=(1, 2, 3))
    pmz[:10] = pmz[10]                       # equal pmz: tie order matters
    decoy = rng.random(150) < 0.5
    want = ref_blocking.build_reference_db(jnp.asarray(hvs), jnp.asarray(pmz),
                                           jnp.asarray(charge), jnp.asarray(decoy),
                                           max_r=16)
    got = blocking.build_reference_db(hvs, pmz, charge, decoy, max_r=16)
    _assert_db_equal(want, got)

    runs, ref_runs = [], []
    for s in range(0, 150, 40):
        sl = slice(s, s + 40)
        order = np.lexsort((pmz[sl], charge[sl]))
        arrs = (hvs[sl][order], pmz[sl][order], charge[sl][order],
                decoy[sl][order], (s + order).astype(np.int32))
        runs.append(blocking.LibraryRun(*arrs))
        ref_runs.append(ref_blocking.LibraryRun(*arrs))
    want = ref_blocking.build_reference_db_from_runs(ref_runs, max_r=16)
    _assert_db_equal(want, blocking.build_reference_db_from_runs(runs, max_r=16))
    _assert_db_equal(want, got)

    sel, bc = blocking.padded_partition_plan(np.sort(charge), 16)
    wsel, wbc = ref_blocking.padded_partition_plan(np.sort(charge), 16)
    assert (sel == wsel).all() and (bc == wbc).all()


def _ref_fused_blocks(q, r, qp, rp, qc, rc, starts, *, q_block, rk, dim, k):
    """The reference kernel (interpret mode), once per query block as the
    reference's lax.map does, rows made global."""
    outs = []
    for b, s in enumerate(starts):
        qs, rs = slice(b * q_block, (b + 1) * q_block), slice(s, s + rk)
        ss, si, os_, oi = (np.asarray(x) for x in ref_hops.fused_search(
            *(jnp.asarray(x) for x in (q[qs], r[rs], qp[qs], rp[rs], qc[qs], rc[rs])),
            dim=dim, k=k, interpret=True))
        outs.append((ss, np.where(si >= 0, si + s, -1), os_, np.where(oi >= 0, oi + s, -1)))
    return [np.concatenate(c) for c in zip(*outs)]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fused_search_plain_matches_reference_kernel(k):
    rng = np.random.default_rng(10 + k)
    W, q_block, rk = 8, 16, 96
    r, rp, rc = _library(rng, 300, W, distinct=5)          # tie-heavy rows
    rp[250:] = np.float32(np.finfo(np.float32).max)        # padding rows
    rc[250:] = -1
    qsrc = rng.integers(0, 300, 48)
    q = r[qsrc].copy()
    qp = (rp[qsrc] % 1800 + rng.uniform(-60, 60, 48)).astype(np.float32)
    qp[::5] = rp[qsrc][::5]                               # std-window hits
    qc = np.where(rc[qsrc] < 0, 2, rc[qsrc]).astype(np.int32)
    starts = [0, 100, 204]
    want = _ref_fused_blocks(q, r, qp, rp, qc, rc, starts, q_block=q_block,
                             rk=rk, dim=32 * W, k=k)
    args = (packed_to_torch(q), _t(qp), _t(qc), packed_to_torch(r), _t(rp), _t(rc),
            torch.tensor(starts, dtype=torch.int32))
    kw = dict(q_block=q_block, rk=rk, dim=32 * W, k=k)
    plain = href.fused_search(*args, **kw)
    before = hops.launches.count
    wrapped = hops.fused_search(*args, **kw)
    assert hops.launches.count == before       # CPU tensors: plain version
    for w, p, g in zip(want, plain, wrapped):
        assert (w == p.numpy()).all()
        assert (w == g.numpy()).all()


def _search_case(seed):
    rng = np.random.default_rng(seed)
    W = 8
    hvs, pmz, charge = _library(rng, 200, W, distinct=30)
    decoy = rng.random(200) < 0.5
    src = rng.integers(0, 200, 37)                 # 37: blocks straddle charges
    q = hvs[src].copy()
    flip = rng.integers(0, 2 ** 32, (37, W), dtype=np.uint64).astype(np.uint32)
    q ^= flip & np.uint32(0x01010101)
    qp = (pmz[src] + rng.uniform(-50, 50, 37) * (rng.random(37) < 0.5)).astype(np.float32)
    qc = charge[src]
    return hvs, pmz, charge, decoy, q, qp, qc


@pytest.mark.parametrize("backend", ["vpu", "mxu", "kernel_vpu", "kernel_mxu",
                                     "fused", "fused_mxu"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("exhaustive", [False, True])
def test_oms_search_matches_reference(backend, top_k, exhaustive):
    hvs, pmz, charge, decoy, q, qp, qc = _search_case(top_k)
    ref_db = ref_blocking.build_reference_db(jnp.asarray(hvs), jnp.asarray(pmz),
                                             jnp.asarray(charge), jnp.asarray(decoy),
                                             max_r=32)
    db = reference_db_from_numpy(*(np.asarray(getattr(ref_db, f)) for f in DB_FIELDS),
                                 max_r=32)
    kb = ref_search.plan_search(ref_db, qp, qc, open_tol_da=75.0, q_block=16)
    assert search.plan_search(db, qp, qc, open_tol_da=75.0, q_block=16) == kb
    params = ref_search.SearchParams(q_block=16, k_blocks=kb, backend=backend,
                                     top_k=top_k, exhaustive=exhaustive)
    want = ref_search.oms_search(ref_db, jnp.asarray(q), jnp.asarray(qp),
                                 jnp.asarray(qc), params, dim=256)
    got = search.oms_search(db, packed_to_torch(q), _t(qp), _t(qc),
                            search.SearchParams(*params), dim=256)
    got = search_result_to_numpy(got)
    for f in ref_search.SearchResult._fields:
        assert (np.asarray(getattr(want, f)) == got[f]).all(), f
    assert search.scanned_rows(db, 37, search.SearchParams(*params)) == \
        ref_search.scanned_rows(ref_db, 37, params)


def test_sort_pad_plan_matches_reference():
    rng = np.random.default_rng(4)
    qp = rng.uniform(400, 1800, 45).astype(np.float32)
    qp[:6] = qp[6]                                # equal keys keep input order
    qc = rng.integers(1, 4, 45).astype(np.int32)
    for q_block in (4, 16):
        wg, wu = ref_search.sort_pad_plan(jnp.asarray(qp), jnp.asarray(qc), q_block)
        g, u = search.sort_pad_plan(_t(qp), _t(qc), q_block)
        assert (np.asarray(wg) == g.numpy()).all()
        assert (np.asarray(wu) == u.numpy()).all()


def test_unported_options_raise():
    names = "vpu, mxu, kernel_vpu, kernel_mxu, fused, fused_mxu, fused_xla"
    with pytest.raises(ValueError, match=f"registered: {names}"):
        backends.get("fused_tpu")
    assert backends.names() == tuple(names.split(", "))
    with pytest.raises(ValueError, match="prefix_words must be >= 0"):
        search.validate_search_params(search.SearchParams(prefix_words=-1))
    with pytest.raises(ValueError, match="prefix_seed_da must be > 0"):
        search.validate_search_params(search.SearchParams(prefix_words=2,
                                                          prefix_seed_da=0.0))
    search.validate_search_params(search.SearchParams(prefix_words=2))
    with pytest.raises(ValueError, match="must be < n_words=8"):
        search.validate_prefix_words(search.SearchParams(prefix_words=8), 256)
    search.validate_prefix_words(search.SearchParams(prefix_words=7), 256)
    with pytest.raises(ValueError, match="top_k"):
        search.validate_search_params(search.SearchParams(top_k=0))
