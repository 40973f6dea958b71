"""The port's autotuner (repro_torch.tune) against the reference's
(repro.tune) on the CPU: the cache's bucketing, nearest-entry rule and file
format (a file either package writes loads in the other, byte for byte on
re-save), the sweep's candidate order, winner tie-break and layering
(defaults < PROMOTED < cache) under injected timings, every candidate held
bit for bit against the defaults, a shared "cpu"-keyed cache giving both
packages the same row_bucket floor and the same prefix-cascade result,
and a reference-written entry changing no port launch parameter."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import tune as ref_tune  # noqa: E402
from repro.core import blocking as ref_blocking  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.tune import cache as ref_cache  # noqa: E402
from repro.tune import sweep as ref_sweep  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.convert import (packed_to_torch, reference_db_from_numpy,  # noqa: E402
                                 search_result_to_numpy)
from repro_torch.core import search  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.tune import cache as cache_mod  # noqa: E402
from repro_torch.tune import promoted  # noqa: E402
from repro_torch.tune import sweep  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_tune_runtime():
    tune.reset_runtime()
    ref_tune.reset_runtime()
    yield
    tune.reset_runtime()
    ref_tune.reset_runtime()


def _entries():
    """A few entries over every key field, with evidence."""
    out = []
    for dk, be, dim, k, bucket, tiles in (
            ("cpu", "fused", 512, 2, "q16xr1024", {"waves": 2, "min_split_rows": 256}),
            ("cpu", "fused", 512, 2, "q16xr4096", {"waves": 8}),
            ("cpu", "kernel_vpu", 4096, 0, "q16xr262144", {"ctas_per_sm": 2}),
            ("NVIDIA H100 80GB HBM3", "rescore", 0, 0, "q1xr1", {"row_bucket": 128}),
            ("cpu", "fused_mxu", 512, 2, "q16xr1024",
             {"q_tile": 32, "r_tile": 256, "word_tile": 8})):
        out.append(dict(device_kind=dk, backend=be, dim=dim, k=k,
                        shape_bucket=bucket, tiles=tiles, median_us=12.5,
                        roofline_frac=0.25, git_rev="abc"))
    return out


# ---------------------------------------------------------------------------
# The cache: bucketing, nearest entry, one file format for both packages
# ---------------------------------------------------------------------------


def test_shape_bucket_and_lookup_nearest_agree():
    for q, r in ((0, 0), (1, 1), (16, 300), (17, 1024), (16, 1025), (8, 143360)):
        assert cache_mod.shape_bucket(q, r) == ref_cache.shape_bucket(q, r)
    port, ref = cache_mod.TuneCache(), ref_cache.TuneCache()
    for bucket, rt in (("q16xr256", 111), ("q16xr1024", 222), ("q64xr256", 333)):
        for c in (port, ref):
            c.put(device_kind="cpu", backend="fused", dim=512, k=2,
                  shape_bucket=bucket, tiles={"waves": rt})
    for q, r in ((16, 200), (16, 512), (16, 3000), (32, 256), (128, 40), (1, 1)):
        assert (port.lookup_nearest("cpu", "fused", 512, 2, q, r)
                == ref.lookup_nearest("cpu", "fused", 512, 2, q, r)), (q, r)
    # the equidistant tie breaks on the bucket string in both
    assert port.lookup_nearest("cpu", "fused", 512, 2, 16, 512) == {"waves": 222}
    assert port.lookup_nearest("cpu", "fused", 1024, 2, 16, 512) is None


def test_cache_files_load_in_both_packages_byte_identical(tmp_path):
    port, ref = cache_mod.TuneCache(), ref_cache.TuneCache()
    for e in _entries():
        port.put(**e)
        ref.put(**e)
    port.save(tmp_path / "port.json")
    ref.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert ref_cache.TuneCache.load(tmp_path / "port.json").entries == port.entries
    assert cache_mod.TuneCache.load(tmp_path / "ref.json").entries == ref.entries
    # a re-save of what the other package wrote is byte-identical too
    cache_mod.TuneCache.load(tmp_path / "ref.json").save(tmp_path / "again.json")
    assert (tmp_path / "again.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert cache_mod.SCHEMA == ref_cache.SCHEMA
    assert cache_mod.ENV_VAR == ref_cache.ENV_VAR == "REPRO_TUNE_CACHE"


def test_cache_tolerates_corruption_and_schema_mismatch(tmp_path):
    p = tmp_path / "c.json"
    p.write_text("{definitely not json")
    assert cache_mod.TuneCache.load(p).entries == {}
    good = {"device_kind": "cpu", "backend": "fused", "dim": 256, "k": 1,
            "shape_bucket": "q8xr64", "tiles": {"waves": 2}}
    p.write_text(json.dumps({"schema": 999, "entries": [good]}))
    assert cache_mod.TuneCache.load(p).entries == {}
    p.write_text(json.dumps({"schema": cache_mod.SCHEMA, "entries": [
        good, {"backend": "fused"}, {**good, "tiles": {}}, "not-a-dict"]}))
    assert list(cache_mod.TuneCache.load(p).entries.values()) == [good]


# ---------------------------------------------------------------------------
# The sweep: candidate order, tie-break, timer, bit-identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", ["default", "tiny"])
def test_rescore_candidates_in_the_reference_order(grid):
    assert (sweep.grid_candidates("rescore", grid)
            == ref_sweep.grid_candidates("rescore", grid))
    names = {"fused": ["min_split_rows", "waves"], "kernel_vpu": ["ctas_per_sm"]}
    for be, want in names.items():
        cands = sweep.grid_candidates(be, grid)
        assert all(sorted(c) == want for c in cands)
        assert cands == sorted(cands, key=lambda c: [c[n] for n in want])


def test_grids():
    d, t = sweep.GRIDS["default"], sweep.GRIDS["tiny"]
    assert d["fused"] == {"waves": (1, 2, 4, 8), "min_split_rows": (256, 1024, 4096)}
    assert d["kernel"] == {"ctas_per_sm": (0, 1, 2, 4)}
    assert d["rescore"] == {"row_bucket": (32, 64, 128, 256)}
    for kind in ("fused", "kernel", "rescore"):
        assert all(len(v) == 2 for v in t[kind].values())
    assert len(sweep.grid_candidates("fused")) == 12


@pytest.mark.parametrize("backend", ["fused", "fused_mxu", "kernel_vpu",
                                     "kernel_mxu", "rescore"])
def test_winner_tie_breaks_to_smallest_parameters(backend):
    rows = sweep.sweep_backend(backend, dim=128, k=1, q_rows=8, r_rows=48,
                               grid="tiny", timer=lambda fn, a, t: 1e-3,
                               model=False, device=CPU)
    want = min(sweep.grid_candidates(backend, "tiny"),
               key=lambda c: tuple(sorted(c.items())))
    assert rows[0].tiles == want
    assert [r.sort_key() for r in rows] == sorted(r.sort_key() for r in rows)


def test_winner_follows_injected_timings_and_repeats():
    def timer(fn, args, tiles):
        return 1e-6 if tiles["waves"] == 4 and tiles["min_split_rows"] == 1024 else 1e-3

    a, b = (sweep.sweep_backend("fused", dim=128, k=1, q_rows=8, r_rows=32,
                                grid="tiny", timer=timer, device=CPU)
            for _ in range(2))
    assert a[0].tiles == {"waves": 4, "min_split_rows": 1024}
    assert [(r.tiles, r.median_us) for r in a] == [(r.tiles, r.median_us) for r in b]
    # the roofline terms come from utils.roofline
    assert a[0].t_bound_us > 0 and a[0].model_bytes > 0 and a[0].model_flops > 0
    table = sweep.format_table({"fused": a}, winners_only=True)
    assert table.splitlines()[0] == ref_sweep.format_table({}).splitlines()[0]
    assert "min_split_rows=1024 waves=4" in table and table.endswith("%*")


def test_a_candidate_that_changes_the_output_fails_the_sweep(monkeypatch):
    real = sweep.make_case

    def broken(backend, **kw):
        case = real(backend, **kw)

        def tiles_case(tiles):
            fn, args = case(tiles)
            if tiles["ctas_per_sm"] == 2:
                return (lambda a, b: fn(a, b) + 1), args
            return fn, args
        return tiles_case
    monkeypatch.setattr(sweep, "make_case", broken)
    with pytest.raises(RuntimeError, match="changed the output"):
        sweep.sweep_backend("kernel_vpu", dim=128, k=0, q_rows=8, r_rows=32,
                            grid="tiny", timer=lambda *a: 1e-3, device=CPU)


def test_sweep_saves_winners_under_the_reference_keys(tmp_path):
    res = sweep.run_sweeps(["kernel_vpu", "fused", "rescore"], dim=128, k=2,
                           q_rows=16, r_rows=300, grid="tiny",
                           timer=lambda fn, a, t: 1e-3, model=False, device=CPU)
    p = tmp_path / "w.json"
    sweep.save_winners(p, res, dim=128, k=2, q_rows=16, r_rows=300,
                       git_rev="x", device=CPU)
    ref = ref_cache.TuneCache.load(p)
    for be in ("kernel_vpu", "fused", "rescore"):
        key = ref_sweep.cache_key_for(be, dim=128, k=2, q_rows=16, r_rows=300)
        assert sweep.cache_key_for(be, dim=128, k=2, q_rows=16, r_rows=300) == key
        e = ref.entries[("cpu", be, key["dim"], key["k"], key["shape_bucket"])]
        assert e["tiles"] == res[be][0].tiles


# ---------------------------------------------------------------------------
# Dispatch layering: defaults < PROMOTED < cache, with hit/miss stats
# ---------------------------------------------------------------------------


def _cache_with(tmp_path, tiles, *, backend="fused", dim=512, k=2,
                bucket=None, writer=cache_mod):
    p = tmp_path / "tune_cache.json"
    c = writer.TuneCache()
    c.put(device_kind="cpu", backend=backend, dim=dim, k=k,
          shape_bucket=bucket or cache_mod.shape_bucket(16, 300), tiles=tiles,
          median_us=1.0)
    c.save(p)
    return p


def test_layering_and_stats(tmp_path, monkeypatch):
    defaults = tune.kernel_defaults("fused")
    assert defaults == {"waves": hops.FUSED_WAVES, "min_split_rows": hops.MIN_SPLIT_ROWS}
    assert promoted.PROMOTED == {}        # reference winners come from other hardware
    kw = dict(dim=512, k=2, q_rows=16, r_rows=300, device=CPU)
    # no cache, nothing promoted: the defaults, without any lookup
    assert tune.tiles_for("fused", **kw) == defaults
    assert tune.cache_stats() == {"path": None, "hits": 0, "misses": 0, "entries": 0}
    # PROMOTED overlays the defaults ...
    monkeypatch.setitem(promoted.PROMOTED, ("cpu", "fused"), {"waves": 2})
    assert tune.tiles_for("fused", **kw) == {**defaults, "waves": 2}
    # ... and the cache overlays PROMOTED; untouched keys survive
    tune.set_cache_path(_cache_with(tmp_path, {"waves": 8}))
    assert tune.tiles_for("fused", **kw) == {**defaults, "waves": 8}
    st = tune.cache_stats()
    assert st["hits"] == 1 and st["misses"] == 0 and st["entries"] == 1
    # an unrelated backend is a miss and keeps its defaults
    assert tune.tiles_for("kernel_vpu", dim=512, k=0, q_rows=16, r_rows=300,
                          device=CPU) == {"ctas_per_sm": 0}
    assert tune.cache_stats()["misses"] == 1
    # the reference's layering reads the same way at the same keys
    ref_tune.set_cache_path(_cache_with(tmp_path, {"q_tile": 32}, writer=ref_cache))
    assert ref_tune.tiles_for("fused", dim=512, k=2, q_rows=16,
                              r_rows=300)["q_tile"] == 32


def test_bad_cached_value_raises(tmp_path):
    tune.set_cache_path(_cache_with(tmp_path, {"waves": 0}))
    with pytest.raises(ValueError, match="waves=0"):
        tune.tiles_for("fused", dim=512, k=2, q_rows=16, r_rows=300, device=CPU)


def test_reference_entry_changes_no_port_launch(tmp_path):
    """The reference's keys (q_tile / r_tile / word_tile) mean nothing to
    the port's kernels: the launch parameters stay the defaults, and so
    does the split count the fused wrapper derives from them."""
    tune.set_cache_path(_cache_with(
        tmp_path, {"q_tile": 64, "r_tile": 512, "word_tile": 8}, writer=ref_cache))
    for be in ("fused", "fused_mxu", "kernel_vpu", "kernel_mxu"):
        got = tune.tiles_for(be, dim=512, k=2 if be.startswith("fused") else 0,
                             q_rows=16, r_rows=300, device=CPU)
        assert got == tune.kernel_defaults(be)
    assert tune.cache_stats()["hits"] == 1
    assert (hops.n_splits_for(40, 300, 132, **tune.kernel_defaults("fused"))
            == hops.n_splits_for(40, 300, 132))


# ---------------------------------------------------------------------------
# One "cpu"-keyed cache, both packages: row_bucket and the prefix cascade
# ---------------------------------------------------------------------------

W = 8
DIM = 32 * W
DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")


def _case():
    rng = np.random.default_rng(5)
    n = 200
    hvs = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint64).astype(np.uint32)
    pmz = rng.uniform(400.0, 1800.0, n).astype(np.float32)
    charge = np.asarray([2, 3], np.int32)[rng.integers(0, 2, n)]
    decoy = rng.random(n) < 0.5
    src = rng.integers(0, n, 37)
    q = hvs[src] ^ (rng.integers(0, 2 ** 32, (37, W), dtype=np.uint64)
                    .astype(np.uint32) & np.uint32(0x01010101))
    qp = (pmz[src] + rng.uniform(-50, 50, 37)).astype(np.float32)
    ref_db = ref_blocking.build_reference_db(
        jnp.asarray(hvs), jnp.asarray(pmz), jnp.asarray(charge),
        jnp.asarray(decoy), max_r=32)
    db = reference_db_from_numpy(*(np.asarray(getattr(ref_db, f)) for f in DB_FIELDS),
                                 max_r=32)
    kb = ref_search.plan_search(ref_db, qp, charge[src], open_tol_da=75.0, q_block=16)
    return ref_db, db, q, qp, charge[src], kb


@pytest.mark.parametrize("floor", [32, 128])
def test_shared_cpu_cache_row_bucket_and_prefix_cascade(tmp_path, floor):
    p = _cache_with(tmp_path, {"row_bucket": floor}, backend="rescore", dim=0,
                    k=0, bucket=cache_mod.shape_bucket(0, 0))
    tune.set_cache_path(p)
    ref_tune.set_cache_path(p)
    jax.clear_caches()
    assert tune.row_bucket_lo(CPU) == ref_tune.row_bucket_lo() == floor
    for n in (0, 1, 31, 33, 64, 65, 129, 1000):
        assert (search.row_bucket(n, device=CPU) == ref_search.row_bucket(n)
                == ref_search.row_bucket(n, lo=floor))
    ref_db, db, q, qp, qc, kb = _case()
    params = ref_search.SearchParams(q_block=16, k_blocks=kb, backend="vpu",
                                     top_k=2, prefix_words=2)
    want = ref_search.oms_search(ref_db, jnp.asarray(q), jnp.asarray(qp),
                                 jnp.asarray(qc), params, dim=DIM)
    stats = {}
    got = search_result_to_numpy(search.oms_search(
        db, packed_to_torch(q), torch.from_numpy(qp), torch.from_numpy(qc),
        search.SearchParams(*params), dim=DIM, stats=stats))
    for f in ref_search.SearchResult._fields:
        assert (np.asarray(getattr(want, f)) == got[f]).all(), f
    assert stats["seed_bucket"] == ref_search.row_bucket(stats["seed_rows"], lo=floor)
    assert stats["survivor_bucket"] == ref_search.row_bucket(stats["survivors"], lo=floor)
    assert tune.cache_stats()["hits"] > 0 and ref_tune.cache_stats()["hits"] > 0
