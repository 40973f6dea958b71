"""The port's multi-device OMS against the reference's: ``shard_reference_db``
field for field; ``sharded_search`` on a (2, 4) mesh of CPU devices with
backends vpu and fused at top_k 1 and 3, bit for bit against the
reference's ``sharded_search`` (global rows included) and the port's own
resident search, also where equal HVs lie in two shards; the store-to-mesh
loader; and the streaming engine over several devices (and the mesh's),
at slab sizes of one block, a prime number of blocks and the whole store,
full width and with ``prefix_words``, against the one-device engine and
the reference's ``oms_search``.

The reference runs once for the whole module, in one subprocess with 8
forced host devices (as ``tests/test_distributed.py`` runs it), and hands
its outputs back as an ``.npz``."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.blocking import ReferenceDB, shard_reference_db  # noqa: E402
from repro_torch.core.search import SearchParams, _search_sorted_padded  # noqa: E402
from repro_torch.distributed import (Mesh, ShardedDB, make_mesh,  # noqa: E402
                                     place_shards, sharded_db_from_store,
                                     sharded_search, streaming_engine_for_mesh)
from repro_torch.distributed.collectives import _merge_best  # noqa: E402
from repro_torch.serve import StreamingEngine  # noqa: E402
from repro_torch.store import LibraryStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The reference's sharded-search test configuration and dataset.
CFG = dict(dim=512, max_r=64, q_block=8, n_levels=16)
DS = dict(n_refs=1024, n_queries=64, seed=4)
TIE_SHIFT_DA = 40.0
DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")
OUTS = ("std_sim", "std_row", "open_sim", "open_row")
SHARD_COUNTS = (1, 2, 3, 4, 5)
SEARCH_CASES = [(b, k) for b in ("vpu", "fused") for k in (1, 3)]
TIE_BACKENDS = ("fused",)
TIE_TOP_K = 3
ENGINE_TOP_K = 2
PREFIX_WORDS = 4
# slab sizes in rows: one block, a prime number of blocks (5), the whole store
SLAB_ROWS = (CFG["max_r"], 5 * CFG["max_r"], 1 << 30)
STORE_MESH_SHARDS = 4

_REFERENCE = r"""
import json, sys
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from repro.core import OMSConfig, OMSPipeline
from repro.core.blocking import shard_reference_db
from repro.core.search import oms_search, sort_pad_plan
from repro.data.spectra import LibraryConfig, SpectraSet, make_dataset
from repro.distributed.collectives import (sharded_db_from_store, sharded_search,
                                           streaming_engine_for_mesh)
from repro.store import LibraryStore

out_path, store_path = sys.argv[1], sys.argv[2]
p = json.loads(sys.argv[3])
cfg = OMSConfig(**p["cfg"])
ds = make_dataset(LibraryConfig(**p["ds"]))
mesh = jax.make_mesh((2, 4), ("data", "model"))
res = {}
# Independent parts run in threads: most of the time is XLA compiling one
# sharded program per case, which runs outside the interpreter lock.
pool = ThreadPoolExecutor(8)

def save_db(tag, db):
    for f in p["db_fields"]:
        res[f"{tag}/{f}"] = np.asarray(getattr(db, f))

def search_case(tag, refs, cases):
    pipe = OMSPipeline(cfg, refs)
    save_db(f"{tag}/db", pipe.db)
    hvs, qp, qc = pipe.encode_queries(ds.queries)
    gather, _ = sort_pad_plan(qp, qc, cfg.q_block)
    qh, qps, qcs = hvs[gather], qp[gather], qc[gather]
    res[f"{tag}/q_hvs"] = np.asarray(qh)
    res[f"{tag}/q_pmz"] = np.asarray(qps)
    res[f"{tag}/q_charge"] = np.asarray(qcs)

    def one(case):
        backend, top_k = case
        params = pipe.search_params(qp, qc, backend=backend, top_k=top_k)
        key = f"{tag}/{backend}/{top_k}"
        res[f"{key}/params"] = np.array(json.dumps(params._asdict()))
        outs, padded = sharded_search(pipe.db, qh, qps, qcs, params,
                                      dim=cfg.dim, mesh=mesh)
        for f, x in zip(p["outs"], outs):
            res[f"{key}/{f}"] = np.asarray(x)
        res[f"{key}/n_rows"] = np.array(padded.n_rows)
    return pipe, [pool.submit(one, c) for c in cases]

def main_case():
    pipe, futs = search_case("main", ds.refs, p["search_cases"])
    for s in p["shard_counts"]:
        save_db(f"shard{s}", shard_reference_db(pipe.db, s))
    return futs

def tie_case():
    # Copies of the queries' source spectra, peaks unchanged, precursor
    # moved: equal HVs whose rows lie in other shards inside one open window.
    src = np.asarray(ds.query_source)
    r = ds.refs
    refs2 = SpectraSet(mz=jnp.concatenate([r.mz, r.mz[src]]),
                       intensity=jnp.concatenate([r.intensity, r.intensity[src]]),
                       pmz=jnp.concatenate([r.pmz, r.pmz[src] + p["tie_shift"]]),
                       charge=jnp.concatenate([r.charge, r.charge[src]]))
    return search_case("tie", refs2, [(b, p["tie_top_k"]) for b in p["tie_backends"]])[1]

def store_case():
    OMSPipeline.ingest(cfg, ds.refs, store_path, chunk_rows=384)
    store = LibraryStore.open(store_path)
    save_db("store_sharded", sharded_db_from_store(store, mesh, max_r=cfg.max_r))
    spipe = OMSPipeline.from_store(store, cfg)
    hvs, qp, qc = spipe.encode_queries(ds.queries)
    res["engine/q_hvs"] = np.asarray(hvs)
    res["engine/q_pmz"] = np.asarray(qp)
    res["engine/q_charge"] = np.asarray(qc)
    for P in (0, p["prefix_words"]):
        params = spipe.search_params(qp, qc, top_k=p["engine_top_k"], prefix_words=P)
        res[f"engine/{P}/params"] = np.array(json.dumps(params._asdict()))
        want = oms_search(spipe.db, hvs, qp, qc, params, dim=cfg.dim)
        for f in want._fields:
            res[f"engine/{P}/{f}"] = np.asarray(getattr(want, f))
        for rows in p["slab_rows"]:
            eng = streaming_engine_for_mesh(store, mesh, max_r=cfg.max_r,
                                            slab_rows=rows)
            eng.search_encoded(hvs, qp, qc, params, dim=cfg.dim)
            res[f"engine/{P}/{rows}/stats"] = np.array(list(eng.last_stats))
    return []

for part in [pool.submit(f) for f in (main_case, tie_case, store_case)]:
    for fut in part.result():
        fut.result()
pool.shutdown()
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs (one subprocess for the module) and the path
    of the store it wrote."""
    tmp = tmp_path_factory.mktemp("distributed")
    out, store = tmp / "ref.npz", tmp / "store"
    args = dict(cfg=CFG, ds=DS, db_fields=DB_FIELDS, outs=OUTS,
                search_cases=SEARCH_CASES, shard_counts=SHARD_COUNTS,
                tie_shift=TIE_SHIFT_DA, tie_top_k=TIE_TOP_K,
                tie_backends=TIE_BACKENDS, prefix_words=PREFIX_WORDS,
                engine_top_k=ENGINE_TOP_K, slab_rows=SLAB_ROWS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
                        str(store), json.dumps(args)], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}, str(store)


def _db(res, tag) -> ReferenceDB:
    return convert.reference_db_from_numpy(
        *(res[f"{tag}/{f}"] for f in DB_FIELDS), max_r=CFG["max_r"])


def _queries(res, tag):
    return (convert.packed_to_torch(res[f"{tag}/q_hvs"]),
            torch.from_numpy(res[f"{tag}/q_pmz"].copy()),
            torch.from_numpy(res[f"{tag}/q_charge"].copy()))


def _params(res, key) -> SearchParams:
    return SearchParams(**json.loads(str(res[f"{key}/params"])))


def _cpu_mesh() -> Mesh:
    return make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


def _db_numpy(db: ReferenceDB) -> dict[str, np.ndarray]:
    out = {f: getattr(db, f).numpy() for f in DB_FIELDS}
    out["hvs"] = out["hvs"].view(np.uint32)
    return out


def _concat(sdb: ShardedDB) -> dict[str, np.ndarray]:
    out = {f: np.concatenate([getattr(sh, f).numpy() for sh in sdb.shards])
           for f in DB_FIELDS}
    out["hvs"] = out["hvs"].view(np.uint32)
    return out


def _assert_fields_equal(want: dict, got: dict, ctx=""):
    for f in DB_FIELDS:
        w, g = want[f], got[f]
        assert w.dtype == g.dtype and w.shape == g.shape, (ctx, f, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), (ctx, f)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_reference_db_matches_reference(ref, n_shards):
    res = ref[0]
    db = _db(res, "main/db")
    got = shard_reference_db(db, n_shards)
    want = {f: res[f"shard{n_shards}/{f}"] for f in DB_FIELDS}
    _assert_fields_equal(want, _db_numpy(got), n_shards)
    assert got.n_blocks % n_shards == 0 and got.max_r == db.max_r
    if db.n_blocks % n_shards == 0:
        assert got is db
    else:                             # the real rows keep their numbers
        assert (got.hvs[:db.n_rows] == db.hvs).all()


@pytest.mark.parametrize("backend,top_k", SEARCH_CASES)
def test_sharded_search_matches_reference_and_resident(ref, backend, top_k):
    res = ref[0]
    key = f"main/{backend}/{top_k}"
    db, (qh, qp, qc), params = _db(res, "main/db"), _queries(res, "main"), _params(res, key)
    assert params.backend == backend and params.top_k == top_k
    outs, sdb = sharded_search(db, qh, qp, qc, params, dim=CFG["dim"],
                               mesh=_cpu_mesh())
    assert sdb.n_shards == 4 and sdb.n_rows == int(res[f"{key}/n_rows"])
    resident = _search_sorted_padded(db, qh, qp, qc, params=params, dim=CFG["dim"])
    for f, g, r in zip(OUTS, outs, resident):
        assert g.dtype == torch.int32 and g.shape == (qh.shape[0], top_k), f
        assert (g.numpy() == res[f"{key}/{f}"]).all(), f
        assert (g == r).all(), f
    # a ShardedDB is taken as it is: the same outputs
    again, same = sharded_search(sdb, qh, qp, qc, params, dim=CFG["dim"],
                                 mesh=_cpu_mesh())
    assert same is sdb and all((a == b).all() for a, b in zip(again, outs))


@pytest.mark.parametrize("backend", TIE_BACKENDS)
def test_sharded_search_breaks_cross_shard_ties_by_row(ref, backend):
    """Copies of the queries' source spectra with their precursor moved by
    +40 Da: equal HVs in two shards of one open window. At least one
    winner list holds equal sims from two shards, the lower global row
    first, as in the reference."""
    res = ref[0]
    key = f"tie/{backend}/{TIE_TOP_K}"
    db, (qh, qp, qc), params = _db(res, "tie/db"), _queries(res, "tie"), _params(res, key)
    outs, sdb = sharded_search(db, qh, qp, qc, params, dim=CFG["dim"],
                               mesh=_cpu_mesh())
    resident = _search_sorted_padded(db, qh, qp, qc, params=params, dim=CFG["dim"])
    for f, g, r in zip(OUTS, outs, resident):
        assert (g.numpy() == res[f"{key}/{f}"]).all(), f
        assert (g == r).all(), f
    sims, rows = outs[2].numpy(), outs[3].numpy()
    shard = rows // sdb.rows_per_shard
    # consecutive ranks of one list with equal sims, both real rows
    tie = (sims[:, :-1] == sims[:, 1:]) & (rows[:, :-1] >= 0) & (rows[:, 1:] >= 0)
    cross = tie & (shard[:, :-1] != shard[:, 1:])
    assert cross.any(), "no winner list holds a tie across shards"
    assert (rows[:, :-1][tie] < rows[:, 1:][tie]).all()


def test_merge_best_keeps_shard_order_on_ties():
    """Hand-made per-shard lists: equal sims resolve to the earlier shard
    (the lower global row), -1 columns stay empty ranks."""
    t = functools.partial(torch.tensor, dtype=torch.int32)
    sims = [t([[9, 5, 4], [3, -1, -1]]), t([[9, 7, -1], [-1, -1, -1]]),
            t([[5, 5, 4], [3, -1, -1]])]
    rows = [t([[1, 2, 3], [4, -1, -1]]), t([[10, 11, -1], [-1, -1, -1]]),
            t([[20, 21, 22], [23, -1, -1]])]
    best, row = _merge_best(sims, rows, 3, "cpu")
    assert best.tolist() == [[9, 9, 7], [3, 3, -1]]
    assert row.tolist() == [[1, 10, 11], [4, 23, -1]]


def test_sharded_db_from_store_matches_reference(ref):
    res, path = ref
    mesh = _cpu_mesh()
    store = LibraryStore.open(path)
    sdb = sharded_db_from_store(store, mesh, max_r=CFG["max_r"])
    assert sdb.n_shards == STORE_MESH_SHARDS
    assert [sh.device for sh in sdb.shards] == [torch.device("cpu")] * STORE_MESH_SHARDS
    got = _concat(sdb)
    _assert_fields_equal({f: res[f"store_sharded/{f}"] for f in DB_FIELDS}, got)
    loaded = shard_reference_db(store.load_reference_db(max_r=CFG["max_r"], device="cpu"),
                                STORE_MESH_SHARDS)
    _assert_fields_equal(_db_numpy(loaded), got, "port")
    assert sdb.n_rows == loaded.n_rows and sdb.n_blocks == loaded.n_blocks


def test_mesh_layout_and_errors(monkeypatch):
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = make_mesh((2, 4), ("data", "model"), devices=devs)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.axis_names == ("data", "model")
    assert mesh.axis_devices("model") == [torch.device(d) for d in devs[:4]]
    assert mesh.axis_devices("data") == [torch.device(devs[0]), torch.device(devs[4])]
    t = Mesh(np.array(devs, dtype=object).reshape(4, 2), ("model", "data"))
    assert t.axis_devices("model") == [torch.device(d) for d in devs[::2]]
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("pipe")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(devs, dtype=object), ("data", "model"))
    with pytest.raises(ValueError, match="do not split"):
        place_shards(shard_reference_db(_tiny_db(), 1), ["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1,), ("model",))


def _tiny_db() -> ReferenceDB:
    return ReferenceDB(hvs=torch.zeros((12, 2), dtype=torch.int32),
                       pmz=torch.zeros(12), charge=torch.zeros(12, dtype=torch.int32),
                       is_decoy=torch.zeros(12, dtype=torch.bool),
                       orig_idx=torch.arange(12, dtype=torch.int32),
                       block_min=torch.zeros(3), block_max=torch.zeros(3),
                       block_charge=torch.zeros(3, dtype=torch.int32), max_r=4)


@pytest.fixture(scope="module")
def one_device(ref):
    """The one-device engine's (result, StreamStats) per (slab_rows,
    prefix_words), computed at first use."""
    res, path = ref

    @functools.lru_cache(maxsize=None)
    def run(slab_rows: int, prefix_words: int):
        eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"],
                              slab_rows=slab_rows, device="cpu")
        got = eng.search_encoded(*_queries(res, "engine"),
                                 _params(res, f"engine/{prefix_words}"), dim=CFG["dim"])
        return convert.search_result_to_numpy(got), tuple(eng.last_stats)
    return run


@pytest.mark.parametrize("prefix_words", (0, PREFIX_WORDS))
@pytest.mark.parametrize("slab_rows", SLAB_ROWS)
@pytest.mark.parametrize("devices", ("cpu2", "cpu3", "mesh"))
def test_multi_device_engine_matches_one_device_and_reference(ref, one_device, devices,
                                                              slab_rows, prefix_words):
    res, path = ref
    store = LibraryStore.open(path)
    if devices == "mesh":
        eng = streaming_engine_for_mesh(store, _cpu_mesh(), max_r=CFG["max_r"],
                                        slab_rows=slab_rows)
        assert eng.devices == [torch.device("cpu")] * 4
    else:
        eng = StreamingEngine(store, max_r=CFG["max_r"], slab_rows=slab_rows,
                              devices=["cpu"] * int(devices[-1]))
    assert eng.device == torch.device("cpu")
    key = f"engine/{prefix_words}"
    params = _params(res, key)
    got = convert.search_result_to_numpy(eng.search_encoded(
        *_queries(res, "engine"), params, dim=CFG["dim"]))
    one, one_stats = one_device(slab_rows, prefix_words)
    for f in got:
        assert (got[f] == one[f]).all(), f
        assert (got[f] == res[f"{key}/{f}"]).all(), f
    assert tuple(eng.last_stats) == one_stats
    assert list(eng.last_stats) == res[f"{key}/{slab_rows}/stats"].tolist()
    assert eng.last_stats.n_scanned > (1 if slab_rows < (1 << 30) else 0)


@pytest.mark.parametrize("devices", (["cpu:0"], ["cpu:0", "cpu"]))
def test_engine_takes_devices_named_with_an_index(ref, one_device, devices):
    """A device named with an index ("cpu:0", as "cuda" and "cuda:0") is
    not equal to the device its tensors report: the engine still finds its
    query copies for every slab."""
    res, path = ref
    eng = StreamingEngine(LibraryStore.open(path), max_r=CFG["max_r"],
                          slab_rows=SLAB_ROWS[1], devices=devices)
    got = convert.search_result_to_numpy(eng.search_encoded(
        *_queries(res, "engine"), _params(res, "engine/0"), dim=CFG["dim"]))
    one, one_stats = one_device(SLAB_ROWS[1], 0)
    assert all((got[f] == one[f]).all() for f in got)
    assert tuple(eng.last_stats) == one_stats


def test_kernel_launches_run_under_the_device_guard():
    """Every ctypes launch of the kernel wrappers (each call that passes
    ``_build.stream_ptr``) sits inside ``with _build.on_device(dev)``, so
    the launcher's SM count and shared-memory opt-in are those of the
    tensors' device."""
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    found = 0
    for path in sorted(kernels.rglob("*.py")):
        tree = ast.parse(path.read_text())
        parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "stream_ptr") or path.name == "_build.py":
                continue
            found += 1
            up = node
            while up in parents and not _guarded(up):
                up = parents[up]
            assert _guarded(up), f"{path.name}:{node.lineno} launches unguarded"
    assert found >= 3


def _guarded(node) -> bool:
    return isinstance(node, ast.With) and any(
        isinstance(i.context_expr, ast.Call)
        and isinstance(i.context_expr.func, ast.Attribute)
        and i.context_expr.func.attr == "on_device" for i in node.items)
