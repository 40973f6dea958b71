"""The port's streaming serve engine against the reference's, on a store the
reference wrote: the host layout and slab plans are equal; a streamed
search equals the resident one (and the reference's) at slab sizes of one
block, a prime number of blocks and the whole store, at full width and with
``prefix_words``, at top_k 1 and 2; StreamStats and TotalStats equal the
reference engine's; the cross-slab merge keeps the (sim desc, row asc) tie
order across a slab boundary; ``reload_store`` equals a cold start on the
grown store."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.core.blocking import LibraryRun as RefRun  # noqa: E402
from repro.core.blocking import build_reference_db_from_runs as ref_build  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import slabs as ref_slabs  # noqa: E402
from repro.store import LibraryStore as RefStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipeline, search  # noqa: E402
from repro_torch.core.blocking import LibraryRun, build_reference_db_from_runs  # noqa: E402
from repro_torch.data.spectra import SpectraSet  # noqa: E402
from repro_torch.serve import (StoreLayout, StreamingEngine, plan_slabs,  # noqa: E402
                               slab_arrays, slabs_touched)
from repro_torch.serve.slabs import PAD_BLOCK_CHARGE  # noqa: E402
from repro_torch.store import LibraryStore  # noqa: E402

# The reference's serve tests' configuration and dataset.
CFG = dict(dim=512, max_r=32, q_block=8, n_levels=16)
DS = dict(n_refs=500, n_queries=40, seed=5)
CHUNK = 192
LAYOUT_FIELDS = ("pmz", "charge", "is_decoy", "orig_idx", "block_min",
                 "block_max", "block_charge", "src_run", "src_row")
# slab sizes in rows: one block, a prime number of blocks (5), whole store
SLAB_ROWS = (CFG["max_r"], 5 * CFG["max_r"], 1 << 30)


@functools.lru_cache(maxsize=None)
def _data():
    ds = make_dataset(LibraryConfig(**DS))
    return ds, tuple(SpectraSet(*(np.array(x) for x in s))
                     for s in (ds.refs, ds.queries))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ds, (_, queries) = _data()
    path = str(tmp_path_factory.mktemp("serve") / "store")
    ref_pipeline.OMSPipeline.ingest(ref_pipeline.OMSConfig(**CFG), ds.refs, path,
                                    chunk_rows=CHUNK)
    ref = ref_pipeline.OMSPipeline.from_store(path, ref_pipeline.OMSConfig(**CFG))
    port = pipeline.OMSPipeline.from_store(path, pipeline.OMSConfig(**CFG),
                                           device="cpu")
    return path, ref, ref.encode_queries(ds.queries), port, port.encode_queries(queries)


def _params(pipe, qp, qc, **kw):
    return pipe.search_params(np.asarray(qp) if not isinstance(qp, torch.Tensor)
                              else qp.numpy(),
                              np.asarray(qc) if not isinstance(qc, torch.Tensor)
                              else qc.numpy(), **kw)


def _assert_result_equal(want, got, ctx=""):
    g = convert.search_result_to_numpy(got)
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        assert w.shape == g[f].shape and (w == g[f]).all(), (ctx, f)


def test_layout_matches_reference(setup):
    path = setup[0]
    want = ref_slabs.StoreLayout.from_store(RefStore.open(path), max_r=CFG["max_r"])
    got = StoreLayout.from_store(LibraryStore.open(path), max_r=CFG["max_r"])
    for f in LAYOUT_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and (w == g).all(), f
    assert (got.n_rows, got.n_blocks, got.n_words, got.sidecar_nbytes()) == (
        want.n_rows, want.n_blocks, want.n_words, want.sidecar_nbytes())
    for lo, hi, nw in ((0, got.n_rows, None), (65, 131, None), (3, 200, 4)):
        g = got.read_hv_rows(lo, hi, n_words=nw)
        assert g.dtype == np.int32
        assert (g.view(np.uint32) == want.read_hv_rows(lo, hi, n_words=nw)).all()
        assert got.real_rows(lo, hi) == want.real_rows(lo, hi)
    rows = np.array([0, 5, 31, 32, 400, got.n_rows - 1])
    assert (got.gather_rows(rows, 3).view(np.uint32) == want.gather_rows(rows, 3)).all()
    # the layout is the resident DB's, row for row
    port = setup[3]
    assert (got.read_hv_rows(0, got.n_rows) == port.db.hvs.numpy()).all()


def test_slab_plans_and_arrays_match_reference(setup):
    path, ref = setup[0], setup[1]
    want_l = ref_slabs.StoreLayout.from_store(RefStore.open(path), max_r=CFG["max_r"])
    got_l = StoreLayout.from_store(LibraryStore.open(path), max_r=CFG["max_r"])
    ds, _ = _data()
    for rows in (1, 32, 97, 160, 1 << 30):
        plan = plan_slabs(got_l.n_blocks, max_r=CFG["max_r"], slab_rows=rows)
        rplan = ref_slabs.plan_slabs(want_l.n_blocks, max_r=CFG["max_r"], slab_rows=rows)
        assert tuple(plan) == tuple(rplan) and plan.slab_rows == rplan.slab_rows
        for tol in (0.5, 75.0):
            assert (slabs_touched(got_l, ds.queries.pmz, ds.queries.charge,
                                  open_tol_da=tol, plan=plan)
                    == ref_slabs.slabs_touched(want_l, ds.queries.pmz, ds.queries.charge,
                                               open_tol_da=tol, plan=rplan)).all()
        last = plan.n_slabs - 1
        for s in {0, last}:
            for nw in (None, 2):
                g = slab_arrays(got_l, s, plan, n_words=nw)
                w = ref_slabs.slab_arrays(want_l, s, rplan, n_words=nw)
                for f in ("hvs", "pmz", "charge", "is_decoy", "orig_idx",
                          "block_min", "block_max", "block_charge"):
                    gf, wf = getattr(g, f), getattr(w, f)
                    gf = gf.view(np.uint32) if f == "hvs" else gf
                    assert gf.shape == wf.shape and (gf == wf).all(), (rows, s, f)
    plan = plan_slabs(got_l.n_blocks, max_r=CFG["max_r"], slab_rows=7 * CFG["max_r"])
    tail = slab_arrays(got_l, plan.n_slabs - 1, plan)
    n_tail = got_l.n_blocks - (plan.n_slabs - 1) * plan.slab_blocks
    assert n_tail < plan.slab_blocks and (tail.block_charge[n_tail:] == PAD_BLOCK_CHARGE).all()
    with pytest.raises(ValueError, match="out of range"):
        slab_arrays(got_l, plan.n_slabs, plan)


@pytest.mark.parametrize("slab_rows", SLAB_ROWS)
@pytest.mark.parametrize("prefix_words", [0, 3])
@pytest.mark.parametrize("top_k", [1, 2])
def test_streamed_equals_resident_and_reference(setup, slab_rows, prefix_words, top_k):
    path, ref, (rh, rqp, rqc), port, (hvs, qp, qc) = setup
    params = _params(port, qp, qc, top_k=top_k, prefix_words=prefix_words)
    rparams = ref.search_params(rqp, rqc, top_k=top_k, prefix_words=prefix_words)
    assert params._asdict() == rparams._asdict()
    resident = search.oms_search(port.db, hvs, qp, qc, params, dim=CFG["dim"])
    want = ref_search.oms_search(ref.db, rh, rqp, rqc, rparams, dim=CFG["dim"])
    _assert_result_equal(want, resident)
    eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"],
                          slab_rows=slab_rows, device="cpu")
    got = eng.search_encoded(hvs, qp, qc, params, dim=CFG["dim"])
    _assert_result_equal(want, got, (slab_rows, prefix_words, top_k))
    reng = ref_engine.StreamingEngine(RefStore.open(path), max_r=CFG["max_r"],
                                      slab_rows=slab_rows)
    reng.search_encoded(rh, rqp, rqc, rparams, dim=CFG["dim"])
    assert convert.stream_stats_to_numpy(eng.last_stats) == reng.last_stats._asdict()
    assert eng.last_stats.n_scanned >= (3 if slab_rows == CFG["max_r"] else 1)
    if slab_rows > 1 << 20:
        assert eng.plan.n_slabs == 1


def test_streamed_fused_backend_and_pipeline_fdr(setup):
    """The port's ``fused`` backend (its plain version on the CPU) streamed
    through the pipeline: the reference's resident vpu search and both FDR
    results."""
    path, ref, _, _, _ = setup
    ds, (_, queries) = _data()
    stream = pipeline.OMSPipeline.from_store(path, pipeline.OMSConfig(**CFG),
                                             device="cpu", resident=False,
                                             slab_rows=3 * CFG["max_r"],
                                             backend="fused")
    assert stream.db is None and stream.engine is not None
    want = ref.search(ds.queries, top_k=2)
    stats = {}
    hvs, qp, qc = stream.encode_queries(queries)
    got = stream.search_encoded(hvs, qp, qc, top_k=2, stats=stats)
    _assert_result_equal(want.result, got.result)
    for name in ("open_fdr", "std_fdr"):
        w, g = getattr(want, name), convert.fdr_result_to_numpy(getattr(got, name))
        for f in w._fields:
            assert (np.asarray(getattr(w, f)) == g[f]).all(), (name, f)
    assert [r["slab"] for r in stats["slabs"]] == sorted(r["slab"] for r in stats["slabs"])
    assert len(stats["slabs"]) == stream.engine.last_stats.n_scanned
    assert all(r["gather_s"] >= 0 and r["search_ms"] >= 0 for r in stats["slabs"])
    # the engine holds two slab-sized buffers, never a library-sized one
    (bufs,) = [b for v in stream.engine._buffers.values() for b in v]
    assert all(h.hvs.shape[0] == stream.engine.plan.slab_rows for h in bufs.host_t
               if h is not None)
    assert stream.engine.plan.slab_rows < stream.engine.layout.n_rows


def _tie_runs(n=40, w=16):
    """Every HV identical: all in-window candidates tie at sim == dim."""
    rng = np.random.default_rng(0)
    hv = rng.integers(0, 2 ** 32, size=(1, w), dtype=np.uint32)
    arrays = (np.repeat(hv, n, axis=0), np.linspace(1000.0, 1010.0, n).astype(np.float32),
              np.full((n,), 2, np.int32), np.zeros((n,), bool),
              np.arange(n, dtype=np.int32))
    q = (hv.view(np.int32), np.asarray([1005.0], np.float32), np.asarray([2], np.int32))
    return arrays, q


def test_exact_ties_straddling_a_slab_boundary():
    """top_k 6 with 4-row slabs: the winners are rows 0..5, across the slab
    0 / slab 1 boundary, in global row order (the reference's result)."""
    arrays, (qh, qp, qc) = _tie_runs()
    run = LibraryRun(arrays[0].view(np.int32), *arrays[1:])
    params = search.SearchParams(q_block=4, k_blocks=10, top_k=6)
    want = ref_search.oms_search(
        ref_build([RefRun(*arrays)], max_r=4), jnp.asarray(qh.view(np.uint32)),
        jnp.asarray(qp), jnp.asarray(qc),
        ref_search.SearchParams(q_block=4, k_blocks=10, top_k=6), dim=512)
    eng = StreamingEngine(StoreLayout.from_runs([run], max_r=4), max_r=4,
                          slab_rows=4, device="cpu")
    got = eng.search_encoded(*map(torch.from_numpy, (qh, qp, qc)), params, dim=512)
    _assert_result_equal(want, got)
    assert got.open_row[0].tolist() == [0, 1, 2, 3, 4, 5]
    assert (got.open_sim[0] == 512).all()
    resident = search.oms_search(build_reference_db_from_runs([run], max_r=4),
                                 *map(torch.from_numpy, (qh, qp, qc)), params, dim=512)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(resident, f)), f


def test_k_larger_than_any_single_slabs_matches():
    """No 4-row slab can fill top_k 6: the merge accumulates across slabs."""
    arrays, (qh, qp, qc) = _tie_runs()
    run = LibraryRun(arrays[0].view(np.int32), *arrays[1:])
    eng = StreamingEngine(StoreLayout.from_runs([run], max_r=4), max_r=4,
                          slab_rows=4, device="cpu")
    assert eng.plan.slab_rows < 6
    params = search.SearchParams(q_block=4, k_blocks=10, top_k=6, ppm_tol=1e5)
    got = eng.search_encoded(*map(torch.from_numpy, (qh, qp, qc)), params, dim=512)
    assert (got.open_idx[0] >= 0).all() and (got.std_idx[0] >= 0).all()


def test_query_touching_zero_slabs(setup):
    path, ref, _, port, _ = setup
    qh = torch.zeros((1, CFG["dim"] // 32), dtype=torch.int32)
    qp, qc = torch.tensor([900.0]), torch.tensor([9], dtype=torch.int32)
    params = _params(port, qp, qc, top_k=2)
    eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"], slab_rows=64,
                          device="cpu")
    got = eng.search_encoded(qh, qp, qc, params, dim=CFG["dim"])
    want = search.oms_search(port.db, qh, qp, qc, params, dim=CFG["dim"])
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.open_idx == -1).all() and eng.last_stats.n_scanned == 0


def test_total_stats_and_reset_match_reference(setup):
    path, ref, (rh, rqp, rqc), port, (hvs, qp, qc) = setup
    eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"], slab_rows=96,
                          device="cpu")
    reng = ref_engine.StreamingEngine(RefStore.open(path), max_r=CFG["max_r"],
                                      slab_rows=96)
    for kw in (dict(), dict(exhaustive=True), dict(open_tol_da=0.5)):
        eng.search_encoded(hvs, qp, qc, _params(port, qp, qc, **kw), dim=CFG["dim"])
        reng.search_encoded(rh, rqp, rqc, ref.search_params(rqp, rqc, **kw),
                            dim=CFG["dim"])
        assert convert.stream_stats_to_numpy(eng.last_stats) == reng.last_stats._asdict()
    assert convert.stream_stats_to_numpy(eng.total_stats) == vars(reng.total_stats)
    assert eng.total_stats.n_scans == 3
    eng.reset_stats()
    assert eng.last_stats is None and eng.total_stats.n_scans == 0


def test_reload_store_equals_cold_start(setup, tmp_path):
    _, _, _, _, _ = setup
    _, (refs, queries) = _data()
    cfg = pipeline.OMSConfig(**CFG)
    grown = str(tmp_path / "grown")
    pipeline.OMSPipeline.ingest(cfg, SpectraSet(*(x[:300] for x in refs)), grown,
                                chunk_rows=CHUNK, device="cpu")
    stream = pipeline.OMSPipeline.from_store(grown, cfg, device="cpu",
                                             resident=False, slab_rows=64)
    small = stream.search(queries, top_k=2)
    pipeline.OMSPipeline.ingest(cfg, SpectraSet(*(x[300:] for x in refs)), grown,
                                chunk_rows=CHUNK, device="cpu", append=True)
    stream.reload_store(grown)
    assert stream.n_targets == DS["n_refs"]
    got = stream.search(queries, top_k=2)
    cold = pipeline.OMSPipeline.from_store(grown, cfg, device="cpu",
                                           resident=False, slab_rows=64)
    want = cold.search(queries, top_k=2)
    for a, b in ((got.result, want.result), (got.open_fdr, want.open_fdr),
                 (got.std_fdr, want.std_fdr)):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(small.result.open_row, got.result.open_row)
    resident = pipeline.OMSPipeline.from_store(grown, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="streaming path"):
        resident.reload_store(grown)


def test_several_devices_raise_and_name_the_roadmap_item(setup):
    path = setup[0]
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"],
                        devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        pipeline.OMSPipeline.from_store(path, pipeline.OMSConfig(**CFG), device="cpu",
                                        resident=False, stream_devices=["cpu", "cpu"])
    eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"], devices=["cpu"])
    assert eng.device == torch.device("cpu")


def test_concurrent_searches_share_one_engine(setup):
    """Searches from more threads than cores on one engine: every result
    equals the serial one and the cumulative totals lose no update (the
    stats and buffer-pool locks)."""
    import os
    import sys
    import threading

    path, _, _, port, (hvs, qp, qc) = setup
    eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"],
                          slab_rows=3 * CFG["max_r"], device="cpu")
    params = _params(port, qp, qc, top_k=2)
    want = eng.search_encoded(hvs, qp, qc, params, dim=CFG["dim"])
    eng.reset_stats()
    n_threads, per_thread = (os.cpu_count() or 2) + 1, 1
    results, errors = [], []

    def work():
        try:
            for _ in range(per_thread):
                results.append(eng.search_encoded(hvs, qp, qc, params, dim=CFG["dim"]))
        except BaseException as e:      # re-raised below, in the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == n_threads * per_thread
    for got in results:
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert eng.total_stats.n_scans == n_threads * per_thread
    assert eng.total_stats.slabs_scanned == n_threads * per_thread * eng.last_stats.n_scanned
