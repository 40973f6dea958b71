"""The port's contract analyzer (repro_torch.analysis) on the CPU: each
restated checker catches its synthetic violation and names the offending
op, a clean function passes, a kernel wrapper call is one op, the
declared (target, contract) pairs are the reference's, the port's import
graph is cycle-free with clean leaves, and the full contract matrix holds
at the reference's smoke shapes with the reference runner's combination
keys."""
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro_torch.analysis import contracts as C  # noqa: E402
from repro_torch.analysis import imports, op_walk, registry  # noqa: E402
from repro_torch.analysis.registry import ContractDecl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
QB, RK, W = 8, 96, 16


def _inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-2 ** 31, 2 ** 31 - 1, (QB, W), generator=g, dtype=torch.int32)
    r = torch.randint(-2 ** 31, 2 ** 31 - 1, (RK, W), generator=g, dtype=torch.int32)
    return q, r


def _clean(q, r):
    """A per-row reduction that never builds a (Qb, Rk) tile."""
    return (q.sum(dim=1, dtype=torch.int32)[:, None] + r[:4].sum(dim=1, dtype=torch.int32)
            .sum(dtype=torch.int32))


def _ops(fn):
    return op_walk.record_ops(fn, *_inputs())[1]


def _all_checks(ops, bound=1 << 20):
    return [C.check_no_materialize(ops, q_block=QB, r_rows=RK),
            C.check_peak_intermediate(ops, bound_bytes=bound),
            C.check_no_host_transfer(ops),
            C.check_dtype_stability(ops, hv_words=W, q_block=QB, r_rows=RK)]


def test_a_clean_function_passes():
    ops = _ops(_clean)
    assert ops and all(r.passed for r in _all_checks(ops))


def test_score_matrix_is_caught_and_named():
    res = C.check_no_materialize(_ops(lambda q, r: q[:, None, :] ^ r[None]),
                                 q_block=QB, r_rows=RK, target="t")
    assert not res.passed and "Qb=8" in res.detail
    assert res.eqn.startswith("aten.bitwise_xor") and f"[{QB}, {RK}, {W}]" in res.eqn
    assert "test_torch_analysis.py:" in res.eqn       # the user source line


@pytest.mark.parametrize("make,what", [
    (lambda q, r: q.to(torch.int64) + 1, "int64"),
    (lambda q, r: r.to(torch.float64).sum(), "float64"),
    (lambda q, r: q.to(torch.uint8), "carrier"),
    (lambda q, r: (q[:, :1].to(torch.int64) * r[:, 0].to(torch.int64)), "(Qb, Rk)"),
], ids=["int64-W-carrier", "float64", "uint8-W-carrier", "int64-score"])
def test_dtype_violations_are_caught(make, what):
    res = C.check_dtype_stability(_ops(make), hv_words=W, q_block=QB, r_rows=RK)
    assert not res.passed and res.eqn
    assert what.split("-")[0] in res.detail or what in res.detail


def test_int64_indices_are_allowed():
    ops = _ops(lambda q, r: r[torch.argsort(r[:, 0])][:, :4])
    assert C.check_dtype_stability(ops, hv_words=W, q_block=QB, r_rows=RK).passed


@pytest.mark.parametrize("make,name", [
    (lambda q, r: q[0, 0].item(), "aten._local_scalar_dense"),
    (lambda q, r: bool((q > 0).any()), "aten._local_scalar_dense"),
    (lambda q, r: r[:, 0].tolist(), "host:tolist"),
    (lambda q, r: r[r[:, 0] > 0], "aten.index"),
    (lambda q, r: torch.nonzero(q), "aten.nonzero"),
], ids=["item", "bool", "tolist", "bool-mask", "nonzero"])
def test_host_transfers_are_caught(make, name):
    res = C.check_no_host_transfer(_ops(make), target="t")
    assert not res.passed and res.eqn.startswith(name)


def test_sync_debug_error_fails_the_check():
    res = C.check_no_host_transfer(_ops(_clean), sync_error="CUDA sync\nmore")
    assert not res.passed and "set_sync_debug_mode" in res.detail


def test_bound_overrun_is_caught():
    ops = _ops(lambda q, r: q[:, None, :] ^ r[None])
    ok = C.check_peak_intermediate(ops, bound_bytes=QB * RK * W * 4)
    over = C.check_peak_intermediate(ops, bound_bytes=QB * RK * W * 4 - 1,
                                     allocator_bytes=123)
    assert ok.passed and not over.passed
    assert over.eqn.startswith("aten.bitwise_xor") and "allocator rise 123" in over.detail
    assert over.as_dict()["allocator_bytes"] == 123


def test_rebuild_and_repeat_allocation_are_caught(monkeypatch):
    reserved = [0]
    guard = C.RecompileGuard(["x"], reserved=lambda: reserved[0])
    guard.arm()
    assert guard.check().passed
    monkeypatch.setattr(_build, "builds", _build.builds + 1)
    res = guard.check(target="serve:loop")
    assert not res.passed and "kernel builds(+1)" in res.detail
    guard.arm()
    reserved[0] += 2 << 20
    res = guard.check()
    assert not res.passed and res.eqn == "grew: reserved bytes"


def test_checker_that_raises_is_a_failed_check():
    decl = ContractDecl("search:x", "peak_intermediate", bound=lambda c: c["missing"])
    res = C.evaluate(decl, _ops(_clean), {"q_block": QB, "rk": RK})
    assert not res.passed and "checker raised KeyError" in res.detail


def test_expectation_folds_like_the_reference():
    decl = ContractDecl("search:x", "no_materialize", expect=False, note="why")
    caught = C.evaluate(decl, _ops(lambda q, r: q[:, None] ^ r[None]),
                        {"q_block": QB, "rk": RK})
    stale = C.evaluate(decl, _ops(_clean), {"q_block": QB, "rk": RK})
    assert caught.passed and "documented exemption (why)" in caught.detail
    assert not stale.passed and "stale exemption" in stale.detail


def test_a_kernel_wrapper_call_is_one_op():
    """On the CPU the wrapper runs its plain version, whose (16, rk, W) tile
    stays inside the one recorded op."""
    q, r = _inputs()
    starts = torch.zeros((1,), dtype=torch.int32)
    pmz = torch.full((QB,), 500.0)
    rp = torch.full((RK,), 500.0)
    ch, rch = torch.full((QB,), 2, dtype=torch.int32), torch.full((RK,), 2, dtype=torch.int32)
    out, ops = op_walk.record_ops(hops.fused_search, q, pmz, ch, r, rp, rch, starts,
                                  q_block=QB, rk=RK, dim=32 * W, k=2)
    assert [op.name for op in ops] == ["kernel:fused_search"]
    assert [s for s, _, _ in ops[0].outputs] == [(QB, 2)] * 4
    assert C.check_no_materialize(ops, q_block=QB, r_rows=RK).passed
    assert _build.region_hook is None and torch.Tensor.tolist.__name__ == "tolist"
    # outside a recorder the wrapper is the plain call
    assert all(torch.equal(a, b) for a, b in zip(out, hops.fused_search(
        q, pmz, ch, r, rp, rch, starts, q_block=QB, rk=RK, dim=32 * W, k=2)))


def test_declarations_equal_the_reference():
    import repro.core.backends  # noqa: F401
    import repro.core.encode_backends  # noqa: F401
    import repro.serve.engine  # noqa: F401
    import repro_torch.core.backends  # noqa: F401
    import repro_torch.core.encode_backends  # noqa: F401
    import repro_torch.serve.engine  # noqa: F401
    from repro.analysis import registry as ref_registry

    def pairs(reg):
        return {(d.target, d.contract, d.expect) for d in reg.declarations()}
    assert pairs(registry) == pairs(ref_registry)
    assert registry.CONTRACT_NAMES == ref_registry.CONTRACT_NAMES
    assert registry.targets("search") == ref_registry.targets("search")


def test_import_graph_is_cycle_free_with_clean_leaves():
    rep = imports.check_imports(SRC, "repro_torch")
    assert rep["ok"], rep
    assert rep["modules"] > 40 and not rep["cycles"] and not rep["leaf_violations"]
    graph = imports.build_import_graph(SRC, "repro_torch")
    for leaf in imports.LEAF_MODULES:
        assert leaf in graph and graph[leaf] == []
    assert "repro_torch.analysis.registry" in graph["repro_torch.core.backends"]
    # nothing of the port imports the reference package
    assert not any(e == "repro" or e.startswith("repro.")
                   for deps in graph.values() for e in deps)


def test_contract_matrix_holds_with_the_reference_combinations():
    from repro.analysis import runner as ref_runner
    from repro_torch.analysis import runner

    rep = runner.run(device="cpu")
    assert rep["ok"], runner.summarize(rep)
    ref = ref_runner.run(with_recompile=False)
    assert set(rep) == set(ref)
    assert rep["smoke"] == ref["smoke"]

    def keys(r):
        return sorted((c["encode"], c["search"], c["path"], c["cascade"],
                       c["prefix"]) for c in r["combos"])

    def checks(r):
        return sorted((c["encode"], c["search"], c["path"], c["cascade"], c["prefix"],
                       x["target"], x["contract"])
                      for c in r["combos"] for x in c["contracts"]
                      if x["contract"] != "recompile_guard")
    assert keys(rep) == keys(ref) and rep["n_combinations"] == 169
    assert checks(rep) == checks(ref)
    assert any(x["contract"] == "recompile_guard" and x["passed"]
               for c in rep["combos"] for x in c["contracts"])
    assert runner.summarize(rep).endswith("ALL CONTRACTS HOLD")
