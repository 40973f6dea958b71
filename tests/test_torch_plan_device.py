"""The planner on the device: ``search.plan_search`` given query tensors on
the device of a resident ReferenceDB's block sidecars returns the integer
the port's host planner and the reference's ``plan_search`` return on the
same inputs, reading back one scalar; and a resident ``OMSPipeline``
search planned that way equals the host-planned search."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402
import types  # noqa: E402
import zlib  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import search as ref_search  # noqa: E402
from repro_torch.core import blocking, pipeline, search  # noqa: E402
from repro_torch.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro_torch.kernels.plan import ops as plan_ops  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

F32 = np.float32


def _library(rng, n, charges, *, max_r, lo=300.0, hi=1800.0, ties=False):
    pmz = rng.uniform(lo, hi, n).astype(F32)
    if ties:
        pmz = np.round(pmz / 25.0).astype(F32) * F32(25.0)
    charge = rng.choice(np.asarray(charges, np.int32), n)
    hvs = np.zeros((n, 1), np.int32)
    return blocking.build_reference_db(hvs, pmz, charge, np.zeros(n, bool),
                                       max_r=max_r, device="cpu")


def _queries(rng, n, charges, *, lo=300.0, hi=1800.0, ties=False):
    qp = rng.uniform(lo, hi, n).astype(F32)
    if ties:
        qp = np.round(qp / 40.0).astype(F32) * F32(40.0)
    return qp, rng.choice(np.asarray(charges, np.int32), n)


def _boundary_case():
    """Charge-4 queries whose pmz pair (a, b), one float32 ulp apart, falls
    on a q-block boundary: the float32 ``_CHARGE_KEY`` key cannot tell a
    from b and keeps b (given first) ahead of a; the exact order ends the
    first q-block at a. A library block whose min pmz is b + tol lies in
    reach of b's block, not of a's."""
    tol = 75.0
    a = F32(600.0)
    b = np.nextafter(a, F32(1e9))
    below = np.linspace(420.0, 590.0, 15).astype(F32)
    above = np.linspace(600.1, 601.0, 14).astype(F32)
    qp = np.concatenate([below, [b, a], above]).astype(F32)
    qc = np.full(qp.shape, 4, np.int32)
    lib_pmz = np.concatenate([
        np.linspace(400.0, 674.0, 24), np.full(8, b + F32(tol)),
        np.linspace(680.0, 800.0, 24)]).astype(F32)
    n = lib_pmz.size
    db = blocking.build_reference_db(np.zeros((n, 1), np.int32), lib_pmz,
                                     np.full(n, 4, np.int32), np.zeros(n, bool),
                                     max_r=8, device="cpu")
    return db, qp, qc, tol, 16


def _case(name, q_block):
    """(db, qp, qc, open_tol_da) of one named case."""
    rng = np.random.default_rng(zlib.crc32(f"{name} {q_block}".encode()))
    if name.startswith("random"):
        nq = int(name.split("-")[1])
        db = _library(rng, 700, (2, 3), max_r=16)
        return (db, *_queries(rng, nq, (2, 3)), 75.0)
    if name == "absent-charges":
        db = _library(rng, 500, (2, 3), max_r=16)
        return (db, *_queries(rng, 123, (1, 2, 3, 4, 5)), 75.0)
    if name == "equal-pmz":
        db = _library(rng, 600, (2, 3), max_r=8, ties=True)
        return (db, *_queries(rng, 211, (2, 3), ties=True), 20.0)
    if name == "padding-blocks":
        db = blocking.shard_reference_db(_library(rng, 300, (2, 3), max_r=16), 8)
        assert int((db.block_charge == -1).sum()) > 0
        return (db, *_queries(rng, 77, (-1, 2, 3)), 75.0)
    if name == "cap":
        db = _library(rng, 400, (2,), max_r=16)
        return (db, *_queries(rng, 90, (2,)), 5000.0)
    raise KeyError(name)


CASES = ["random-0", "random-5", "random-37", "random-100", "random-1000",
         "absent-charges", "equal-pmz", "padding-blocks", "cap"]


def _host_meta(db):
    return types.SimpleNamespace(n_blocks=db.n_blocks, **{
        f: getattr(db, f).numpy() for f in ("block_min", "block_max", "block_charge")})


def _three_plans(db, qp, qc, tol, q_block):
    """(device plan, port host plan, reference plan) and the device plan's
    span names."""
    kw = dict(open_tol_da=tol, q_block=q_block)
    t = trace.install(trace.Tracer())
    try:
        on_device = search.plan_search(db, torch.from_numpy(qp),
                                       torch.from_numpy(qc), **kw)
    finally:
        trace.uninstall()
    host = search.plan_search(db, qp, qc, **kw)
    ref = ref_search.plan_search(_host_meta(db), qp, qc, **kw)
    return (on_device, host, ref), [e.name for e in t.events()]


@pytest.mark.parametrize("q_block", [16, 8])
@pytest.mark.parametrize("name", CASES)
def test_device_plan_equals_host_and_reference_plans(name, q_block):
    db, qp, qc, tol = _case(name, q_block)
    (dev, host, ref), names = _three_plans(db, qp, qc, tol, q_block)
    assert dev == host == ref
    assert names == ([] if qp.size == 0 else ["sync.plan.k_blocks"])
    if name == "cap":
        assert dev == db.n_blocks
    keys = search.plan_block_keys(db)
    assert search.plan_search_device(
        db, torch.from_numpy(qp), torch.from_numpy(qc), open_tol_da=tol,
        q_block=q_block, block_keys=keys) == dev


def test_device_plan_at_a_q_block_boundary_within_one_ulp():
    db, qp, qc, tol, q_block = _boundary_case()
    key = (np.clip(qp, 0.0, search._CHARGE_KEY - 1.0).astype(F32)
           + qc.astype(F32) * F32(search._CHARGE_KEY)).astype(F32)
    f32_order = np.argsort(key, kind="stable")
    exact_order = np.lexsort((qp, qc))
    # The case holds what it claims: the float32 key ends the first q-block
    # at b, the exact order at a, and the plans on each order differ.
    assert qp[f32_order[q_block - 1]] > qp[exact_order[q_block - 1]]
    plans, _ = _three_plans(db, qp, qc, tol, q_block)
    shuffled = search.plan_search(db, qp[f32_order], qc[f32_order], open_tol_da=tol,
                                  q_block=q_block)
    assert plans[0] == plans[1] == plans[2] == shuffled
    wrong = _plan_in_given_order(db, qp[f32_order], qc[f32_order], tol, q_block)
    assert wrong == plans[0] + 1


def _plan_in_given_order(db, qp, qc, tol, q_block, safety_blocks=2):
    """The host plan's segments taken in the given order, not re-sorted:
    what a planner keyed on the float32 key would return."""
    bmin, bmax = db.block_min.numpy(), db.block_max.numpy()
    worst = 1
    for s in range(0, qp.size, q_block):
        lo, hi = qp[s] - F32(tol), qp[min(s + q_block, qp.size) - 1] + F32(tol)
        first = np.searchsorted(bmax, lo, side="left")
        last = np.searchsorted(bmin, hi, side="right") - 1
        worst = max(worst, int(last - first + 1))
    return min(worst + safety_blocks, db.n_blocks)


@functools.lru_cache(maxsize=None)
def _pipeline_and_queries():
    ds = make_dataset(LibraryConfig(n_refs=240, n_queries=40, seed=5))
    cfg = pipeline.OMSConfig(dim=256, max_r=32, bin_size=0.2, encode_batch=64,
                             backend="fused", encode_backend="pallas")
    return pipeline.OMSPipeline(cfg, ds.refs, device="cpu"), ds.queries


def test_resident_search_planned_on_the_device_equals_the_host_planned_search():
    pipe, queries = _pipeline_and_queries()
    seen = []
    run_search = pipe._run_search

    def recording(hvs, q_pmz, q_charge, params, *rest):
        seen.append(params)
        return run_search(hvs, q_pmz, q_charge, params, *rest)

    pipe._run_search = recording
    try:
        out = pipe.search(queries)
    finally:
        del pipe._run_search
    hvs, q_pmz, q_charge = pipe.encode_queries(queries)
    host_params = pipe.search_params(q_pmz.numpy(), q_charge.numpy())
    assert [p.k_blocks for p in seen] == [host_params.k_blocks]
    assert pipe.search_params(q_pmz, q_charge) == host_params == seen[0]
    want = search.oms_search(pipe.db, hvs, q_pmz, q_charge, host_params,
                             dim=pipe.cfg.dim)
    for f, got, exp in zip(want._fields, out.result, want):
        assert torch.equal(got, exp), f


def test_plan_reach_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA gets no plain fallback."""
    meta = dict(device="meta")
    args = (torch.empty(4, dtype=torch.float32, **meta),
            torch.empty(4, dtype=torch.int32, **meta),
            torch.empty(2, dtype=torch.int64, **meta),
            torch.empty(2, dtype=torch.int64, **meta))
    before = plan_ops.launches.count
    with pytest.raises(ValueError, match="unsupported device meta"):
        plan_ops.plan_reach(*args, q_block=16, open_tol_da=75.0)
    assert plan_ops.launches.count == before
