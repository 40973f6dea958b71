"""The port's LibraryStore and its pipeline entry points against the
reference's: a store the port ingests is byte-identical to the reference's
(every shard file and the manifest, also when grown by append); the port
serves a store the reference wrote with the reference's DB and search
results; an append-grown store equals a one-shot build; the config is
rebuilt from the manifest as the reference does; malformed stores and
mismatched configs are refused."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import filecmp  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro.store import LibraryStore as RefStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data.spectra import SpectraSet  # noqa: E402
from repro_torch.store import (FORMAT_VERSION, LibraryStore, StoreConfigError,  # noqa: E402
                               StoreError)
from repro_torch.store import format as store_format  # noqa: E402

# The reference's store tests' configuration and dataset.
CFG = dict(dim=512, max_r=64, q_block=8, n_levels=16)
DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")
CHUNK = 256
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ds = make_dataset(LibraryConfig(n_refs=600, n_queries=48, seed=7))
    refs, queries = (SpectraSet(*(np.array(x) for x in s))
                     for s in (ds.refs, ds.queries))
    root = tmp_path_factory.mktemp("store")
    ref_path, port_path = str(root / "ref"), str(root / "port")
    ref_pipeline.OMSPipeline.ingest(ref_pipeline.OMSConfig(**CFG), ds.refs,
                                    ref_path, chunk_rows=CHUNK)
    pipeline.OMSPipeline.ingest(pipeline.OMSConfig(**CFG), refs, port_path,
                                chunk_rows=CHUNK, device="cpu")
    ref = ref_pipeline.OMSPipeline.from_store(ref_path, ref_pipeline.OMSConfig(**CFG))
    return ds, refs, queries, ref_path, port_path, ref


def _assert_same_files(a: str, b: str):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "manifest.json" in names and len(names) > 1
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


def _assert_db_equal(want, got):
    for f in DB_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "hvs":
            g = g.view(np.uint32)
        assert w.shape == g.shape and (w == g).all(), f


def _assert_output_equal(want, got):
    res = convert.search_result_to_numpy(got.result)
    for f in want.result._fields:
        assert (np.asarray(getattr(want.result, f)) == res[f]).all(), f
    for name in ("open_fdr", "std_fdr"):
        w, g = getattr(want, name), convert.fdr_result_to_numpy(getattr(got, name))
        for f in w._fields:
            assert (np.asarray(getattr(w, f)) == g[f]).all(), (name, f)


def test_port_store_is_byte_identical_to_reference(setup):
    _, _, _, ref_path, port_path, _ = setup
    _assert_same_files(ref_path, port_path)
    with open(os.path.join(port_path, "manifest.json")) as f:
        man = json.load(f)
    assert man["format_version"] == FORMAT_VERSION == 2
    assert [s["kind"] for s in man["shards"]] == ["target"] * 3 + ["decoy"] * 3
    st = LibraryStore.open(port_path)
    assert (st.n_targets, st.n_rows, st.nbytes()) == (
        600, 1200, RefStore.open(ref_path).nbytes())


@pytest.mark.parametrize("backend", ["vpu", "fused"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_port_serves_reference_store(setup, backend, top_k):
    """The port's resident cold start from the reference's store: the DB in
    all eight fields, and the search (port backend against the reference's
    vpu; every backend is bit-identical) with both FDR results."""
    ds, _, queries, ref_path, _, ref = setup
    pipe = pipeline.OMSPipeline.from_store(ref_path, pipeline.OMSConfig(**CFG),
                                           device="cpu", backend=backend)
    _assert_db_equal(ref.db, pipe.db)
    _assert_output_equal(ref.search(ds.queries, top_k=top_k),
                         pipe.search(queries, top_k=top_k))


def test_reference_serves_port_store(setup):
    ds, _, _, ref_path, port_path, ref = setup
    other = ref_pipeline.OMSPipeline.from_store(port_path, ref_pipeline.OMSConfig(**CFG))
    for f in DB_FIELDS:
        assert (np.asarray(getattr(ref.db, f)) == np.asarray(getattr(other.db, f))).all(), f


def test_append_grown_store_equals_oneshot_and_reference(setup, tmp_path):
    """Grown by append with other chunk boundaries: byte-identical to the
    reference's store grown the same way, and searching like the one-shot
    build."""
    ds, refs, queries, _, port_path, _ = setup
    n1 = 410   # not a multiple of the chunk
    grown, ref_grown = str(tmp_path / "grown"), str(tmp_path / "ref_grown")
    pcfg, rcfg = pipeline.OMSConfig(**CFG), ref_pipeline.OMSConfig(**CFG)
    pipeline.OMSPipeline.ingest(pcfg, SpectraSet(*(x[:n1] for x in refs)), grown,
                                chunk_rows=128, device="cpu")
    pipeline.OMSPipeline.ingest(pcfg, SpectraSet(*(x[n1:] for x in refs)), grown,
                                chunk_rows=128, device="cpu", append=True)
    ref_pipeline.OMSPipeline.ingest(rcfg, type(ds.refs)(*(x[:n1] for x in ds.refs)),
                                    ref_grown, chunk_rows=128)
    ref_pipeline.OMSPipeline.ingest(rcfg, type(ds.refs)(*(x[n1:] for x in ds.refs)),
                                    ref_grown, chunk_rows=128, append=True)
    _assert_same_files(ref_grown, grown)
    assert LibraryStore.open(grown).n_targets == 600
    a = pipeline.OMSPipeline.from_store(grown, pcfg, device="cpu")
    b = pipeline.OMSPipeline.from_store(port_path, pcfg, device="cpu")
    for f in DB_FIELDS:
        assert torch.equal(getattr(a.db, f), getattr(b.db, f)), f
    out_a, out_b = a.search(queries, top_k=2), b.search(queries, top_k=2)
    for f in out_a.result._fields:
        assert torch.equal(getattr(out_a.result, f), getattr(out_b.result, f)), f


def test_append_never_rewrites_existing_shards(setup, tmp_path):
    _, refs, _, _, _, _ = setup
    p = str(tmp_path / "s")
    cfg = pipeline.OMSConfig(**CFG)
    pipeline.OMSPipeline.ingest(cfg, SpectraSet(*(x[:256] for x in refs)), p,
                                chunk_rows=256, device="cpu")
    before = {f: os.path.getmtime(os.path.join(p, f))
              for f in os.listdir(p) if f.endswith(".npy")}
    token = LibraryStore.manifest_token(p)
    pipeline.OMSPipeline.ingest(cfg, SpectraSet(*(x[256:512] for x in refs)), p,
                                chunk_rows=256, device="cpu", append=True)
    assert before == {f: os.path.getmtime(os.path.join(p, f)) for f in before}
    assert LibraryStore.manifest_token(p) != token


def test_config_rebuilt_from_manifest_as_the_reference_does(setup):
    _, _, _, ref_path, _, _ = setup
    kw = dict(backend="fused_xla", top_k=3, max_r=128)
    want = ref_pipeline.OMSPipeline.from_store(ref_path, **kw).cfg
    got = pipeline.OMSPipeline.from_store(ref_path, device="cpu", **kw).cfg
    assert vars(got) == vars(want)
    assert got.top_k == 3 and got.max_r == 128 and got.dim == CFG["dim"]
    assert store_format.CONFIG_KEYS == ("dim", "n_levels", "bin_size", "mz_min",
                                        "mz_max", "seed", "add_decoys")
    assert store_format.SIDECARS == ("hvs", "pmz", "charge", "decoy", "orig")


def test_config_mismatch_rejected(setup):
    _, _, _, _, port_path, _ = setup
    cfg = pipeline.OMSConfig(**CFG)
    for bad in (dict(dim=1024), dict(n_levels=32), dict(bin_size=0.04),
                dict(seed=1), dict(add_decoys=False)):
        with pytest.raises(StoreConfigError):
            pipeline.OMSPipeline.from_store(port_path, dataclasses.replace(cfg, **bad),
                                            device="cpu")
    pipe = pipeline.OMSPipeline.from_store(port_path, cfg, device="cpu",
                                           backend="fused_xla", top_k=3, max_r=128)
    assert pipe.cfg.top_k == 3 and pipe.cfg.max_r == 128


def test_iter_runs_yields_int32_views_of_the_memory_map(setup):
    _, _, _, _, port_path, _ = setup
    st = LibraryStore.open(port_path)
    runs = list(st.iter_runs())
    assert len(runs) == 6 and all(r.hvs.dtype == np.int32 for r in runs)
    for r in runs:
        assert isinstance(r.hvs, np.memmap) and not r.hvs.flags.owndata
    on_disk = np.load(os.path.join(port_path, "shard_00000.hvs.npy"))
    assert on_disk.dtype == np.uint32 and (runs[0].hvs.view(np.uint32) == on_disk).all()
    # decoy runs index the concatenated layout: n_targets + target index
    assert runs[3].orig_idx.min() >= st.n_targets


def test_malformed_store_rejected(setup, tmp_path):
    _, _, _, _, port_path, _ = setup
    with pytest.raises(StoreError, match="missing manifest"):
        LibraryStore.open(str(tmp_path / "nowhere"))
    bad = tmp_path / "badver"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({"format_version": 99, "shards": []}))
    with pytest.raises(StoreError, match="format_version"):
        LibraryStore.open(str(bad))
    gone = str(tmp_path / "gone")
    shutil.copytree(port_path, gone)
    os.unlink(os.path.join(gone, "shard_00002.orig.npy"))
    with pytest.raises(StoreError, match="missing"):
        LibraryStore.open(gone)


@pytest.mark.parametrize("part", ["hvs", "pmz", "charge", "decoy", "orig"])
def test_truncated_sidecar_rejected_every_part(setup, tmp_path, part):
    _, _, _, _, port_path, _ = setup
    broken = str(tmp_path / f"broken_{part}")
    shutil.copytree(port_path, broken)
    f = os.path.join(broken, f"shard_00000.{part}.npy")
    np.save(f, np.load(f)[:3])
    with pytest.raises(StoreError, match=part):
        LibraryStore.open(broken)


def test_hv_width_mismatch_rejected(setup, tmp_path):
    _, _, _, _, port_path, _ = setup
    broken = str(tmp_path / "broken_width")
    shutil.copytree(port_path, broken)
    s0 = LibraryStore.open(port_path).shards[0]
    np.save(os.path.join(broken, f"{s0.name}.hvs.npy"),
            np.zeros((s0.rows, CFG["dim"] // 32 - 1), np.uint32))
    with pytest.raises(StoreError, match="width"):
        LibraryStore.open(broken)


def _empty_store(path):
    return LibraryStore.create(path, dim=512, n_levels=16, bin_size=0.05,
                               mz_min=200.0, mz_max=2000.0, seed=0, add_decoys=True)


def test_append_shard_validates_rows_and_views_int32_words(tmp_path):
    st = _empty_store(str(tmp_path / "v"))
    charge = np.full(4, 2, np.int32)
    orig = np.arange(4, dtype=np.int32)
    hvs = np.array([[-1] * 16, [0] * 16, [1] * 16, [-(2 ** 31)] * 16], np.int32)
    with pytest.raises(StoreError, match="sorted"):
        st.append_shard("target", hvs, np.array([5., 1., 2., 3.], np.float32),
                        charge, orig)
    with pytest.raises(StoreError, match="width"):
        st.append_shard("target", np.zeros((4, 8), np.int32),
                        np.arange(4, dtype=np.float32), charge, orig)
    with pytest.raises(StoreError, match="kind"):
        st.append_shard("junk", hvs, np.arange(4, dtype=np.float32), charge, orig)
    with pytest.raises(StoreError, match="int32 or uint32"):
        st.append_shard("target", hvs.astype(np.int64),
                        np.arange(4, dtype=np.float32), charge, orig)
    st.append_shard("target", hvs, np.arange(4, dtype=np.float32), charge, orig)
    saved = np.load(os.path.join(str(tmp_path / "v"), "shard_00000.hvs.npy"))
    assert saved.dtype == np.uint32 and (saved.view(np.int32) == hvs).all()


def test_ingest_commits_manifest_once(setup, tmp_path):
    """Staged shards without a commit leave the store as it was; a first
    ingest over the leftovers works; a committed store is never re-created."""
    _, refs, _, _, _, _ = setup
    p = str(tmp_path / "staged")
    st = _empty_store(p)
    st.append_shard("target", np.zeros((2, 16), np.int32),
                    np.array([1., 2.], np.float32), np.full(2, 2, np.int32),
                    np.arange(2, dtype=np.int32), commit=False)
    assert LibraryStore.open(p).n_rows == 0
    st2 = pipeline.OMSPipeline.ingest(pipeline.OMSConfig(**CFG),
                                      SpectraSet(*(x[:128] for x in refs)), p,
                                      chunk_rows=128, device="cpu")
    assert LibraryStore.open(p).n_rows == st2.n_rows == 256
    with pytest.raises(StoreError, match="already exists"):
        _empty_store(p)


def test_empty_store_raises_store_error(tmp_path):
    p = str(tmp_path / "empty")
    _empty_store(p)
    with pytest.raises(StoreError, match="no shards"):
        pipeline.OMSPipeline.from_store(p, pipeline.OMSConfig(**CFG), device="cpu")


def test_store_package_imports_first_and_without_jax():
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "from repro_torch.store import LibraryStore, TARGET\n"
            "from repro_torch.core.pipeline import OMSPipeline\nprint('IMPORT_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr
    assert "IMPORT_OK" in r.stdout
