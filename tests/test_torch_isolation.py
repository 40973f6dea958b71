"""The port stands alone: no module of repro_torch (nor chip_smoke.py, its
phase modules chip_smoke_phases/, scripts/chip_times.py, nor the port's
examples ``examples/*_torch.py``) imports jax or the
reference package, every module imports with jax
absent, and entry points refuse to fall back to the CPU silently."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import pkgutil  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data.spectra import LibraryConfig, make_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|\.|,|$)|from\s+repro(\.|\s))",
    re.MULTILINE)


EXAMPLES = ("quickstart_torch.py", "oms_search_e2e_torch.py", "serve_lm_torch.py",
            "train_lm_torch.py")


def _port_files():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "chip_smoke_phases").glob("*.py"))
            + [ROOT / "scripts" / "chip_times.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def test_static_scan_finds_no_jax_or_reference_import():
    assert (ROOT / "chip_smoke.py").exists()
    assert {p.name for p in _port_files() if p.parent.name == "chip_smoke_phases"} >= {
        "__init__.py", "common.py", "oms_kernels.py", "launcher.py", "lm.py"}
    assert ROOT / "scripts" / "chip_times.py" in _port_files()
    assert {p.name for p in _port_files() if p.parent.name == "examples"} == set(EXAMPLES)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in _port_files() for m in FORBIDDEN.finditer(p.read_text())]
    assert hits == []
    # the pattern itself must not flag the port's own name
    assert not FORBIDDEN.search("from repro_torch.core import search\n"
                                "import repro_torch\n")
    assert FORBIDDEN.search("from repro.core import search\n")
    assert FORBIDDEN.search("import jax.numpy as jnp\n")


def test_every_module_imports_without_jax():
    mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch.")]
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(mods) > 15


def test_store_serve_and_cascade_modules_are_covered():
    """The static scan and the jax-free import reach the store, the serve
    engine and the cascade."""
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    assert {"store/format.py", "store/library_store.py", "serve/slabs.py",
            "serve/engine.py", "core/cascade.py"} <= files
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  prefix="repro_torch.")}
    assert {"repro_torch.store.library_store", "repro_torch.serve.engine",
            "repro_torch.serve.slabs", "repro_torch.core.cascade"} <= mods


def test_launcher_obs_and_serve_front_modules_are_covered():
    """The static scan and the jax-free import reach the launcher, the
    observability layer, the serve front and the baselines."""
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    assert {"launch/oms.py", "obs/trace.py", "obs/metrics.py", "obs/report.py",
            "serve/scheduler.py", "serve/result_cache.py",
            "core/baselines.py"} <= files
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  prefix="repro_torch.")}
    assert {"repro_torch.launch.oms", "repro_torch.obs.trace",
            "repro_torch.obs.report", "repro_torch.serve.scheduler",
            "repro_torch.serve.result_cache",
            "repro_torch.core.baselines"} <= mods


def test_distributed_modules_are_covered():
    """The static scan and the jax-free import reach the multi-device
    modules (the mesh, the sharded search and its store loader)."""
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    assert {"distributed/__init__.py", "distributed/mesh.py",
            "distributed/collectives.py"} <= files
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  prefix="repro_torch.")}
    assert {"repro_torch.distributed", "repro_torch.distributed.mesh",
            "repro_torch.distributed.collectives"} <= mods


def test_lm_modules_are_covered():
    """The static scan and the jax-free import reach the LM serve path: the
    configs (all ten archs), the layers, the MoE FFN, the RG-LRU and xLSTM
    blocks, Whisper, the transformer, the Model and ``launch/serve.py``;
    every reference module under ``models/`` has its counterpart."""
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    models = {"models/__init__.py", "models/layers.py", "models/moe.py",
              "models/rglru.py", "models/xlstm.py", "models/whisper.py",
              "models/transformer.py", "models/model.py"}
    assert {"configs/__init__.py", "configs/base.py", "configs/registry.py",
            "configs/shapes.py", "configs/llama3_2_3b.py", "configs/qwen2_vl_7b.py",
            "launch/serve.py"} | models <= files
    assert len([f for f in files if f.startswith("configs/")]) == 14
    ref_models = {f"models/{p.name}" for p in (ROOT / "src" / "repro" / "models").glob("*.py")}
    assert ref_models == models
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  prefix="repro_torch.")}
    assert {"repro_torch.configs", "repro_torch.configs.registry",
            "repro_torch.models.layers", "repro_torch.models.moe",
            "repro_torch.models.rglru", "repro_torch.models.xlstm",
            "repro_torch.models.whisper", "repro_torch.models.transformer",
            "repro_torch.models.model", "repro_torch.launch.serve"} <= mods


def test_training_modules_are_covered():
    """The static scan and the jax-free import reach the training path:
    the tree helpers, the optimizer, the schedule, gradient compression,
    the train step and loop, checkpoints, the token pipeline and
    ``launch/train.py``; every reference module under ``optim/``,
    ``train/`` and ``checkpoint/`` has its counterpart."""
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    training = {"utils/treeutil.py", "optim/__init__.py", "optim/adamw.py",
                "optim/schedule.py", "optim/compression.py", "train/__init__.py",
                "train/step.py", "train/loop.py", "checkpoint/__init__.py",
                "checkpoint/ckpt.py", "data/tokens.py", "launch/train.py"}
    assert training <= files
    for pkg in ("optim", "train", "checkpoint"):
        ref = {f"{pkg}/{p.name}" for p in (ROOT / "src" / "repro" / pkg).glob("*.py")}
        assert ref == {f for f in files if f.startswith(pkg + "/")}
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  prefix="repro_torch.")}
    assert {"repro_torch." + f.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
            for f in training} <= mods


def test_lm_distribution_and_launch_modules_are_covered():
    """The static scan and the jax-free import reach the LM distribution
    (sharding rules, pipeline, elastic remesh), the mesh constructors, the cell
    specs and the restated dry run."""
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    lm_dist = {"launch/mesh.py", "launch/specs.py", "launch/dryrun.py",
               "distributed/sharding.py", "distributed/pipeline.py",
               "distributed/elastic.py"}
    assert lm_dist <= files
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  prefix="repro_torch.")}
    assert {"repro_torch." + f.removesuffix(".py").replace("/", ".")
            for f in lm_dist} <= mods
    from repro_torch import distributed
    assert {"param_pspecs", "opt_state_pspecs", "batch_pspecs",
            "cache_pspecs"} <= set(distributed.__all__)


# reference modules with no counterpart file in the port, and why
NO_COUNTERPART = {
    "kernels/hamming/hamming.py": "Pallas kernels, ported as CUDA under kernels/hamming/csrc/",
    "kernels/hdencode/hdencode.py": "Pallas kernel, ported as CUDA under kernels/hdencode/csrc/",
    "kernels/hamming_mxu/hamming_mxu.py": "Pallas kernels, ported as CUDA under "
                                          "kernels/hamming_mxu/csrc/",
    "analysis/jaxpr_walk.py": "walks jaxprs; the port's counterpart is analysis/op_walk.py",
    "utils/hlo.py": "parses XLA HLO text, which PyTorch does not produce",
    "utils/hlo_cost.py": "prices XLA HLO; the port's cost model is utils/roofline.py",
    "utils/unrollctl.py": "controls scan unrolling; the port's loops are Python loops",
}


def test_every_reference_module_has_a_counterpart():
    """Every module of the reference package has a file of the same path
    in the port, apart from the named ones, each for its reason."""
    ref = {p.relative_to(ROOT / "src" / "repro").as_posix()
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert ref - port == set(NO_COUNTERPART)
    assert (PKG / "analysis" / "op_walk.py").exists()


def test_launcher_runs_with_jax_absent(tmp_path):
    """``python -m repro_torch.launch.oms`` with jax and the reference
    package made unimportable: ``queries`` runs, ``build`` without
    ``--device`` refuses the CPU-only host."""
    pre = ("import sys, runpy\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['repro'] = None\n"
           "sys.argv = ['oms'] + sys.argv[1:]\n"
           "runpy.run_module('repro_torch.launch.oms', run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", pre, "queries", "--refs", "64",
                          "--queries", "3"], capture_output=True, text=True,
                         timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 3
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "-c", pre, "build", "--store",
                              "s", "--refs", "64"], capture_output=True,
                             text=True, timeout=120, env=env, cwd=tmp_path)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr
        assert not (tmp_path / "s").exists()


def test_store_entry_points_without_device_raise_when_cuda_is_missing(
        monkeypatch, tmp_path):
    from repro_torch.serve import StoreLayout, StreamingEngine
    from repro_torch.core.blocking import LibraryRun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset(LibraryConfig(n_refs=8, n_queries=2))
    cfg = pipeline.OMSConfig(dim=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.OMSPipeline.ingest(cfg, ds.refs, str(tmp_path / "s"))
    store = pipeline.OMSPipeline.ingest(cfg, ds.refs, str(tmp_path / "s"),
                                        device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.OMSPipeline.from_store(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.OMSPipeline.from_store(store, resident=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store.load_reference_db(max_r=64)
    run = LibraryRun(np.zeros((2, 2), np.int32), np.array([1.0, 2.0], np.float32),
                     np.full(2, 2, np.int32), np.zeros(2, bool),
                     np.arange(2, dtype=np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEngine(StoreLayout.from_runs([run], max_r=4), max_r=4)


def test_pipeline_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset(LibraryConfig(n_refs=8, n_queries=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.OMSPipeline(pipeline.OMSConfig(dim=64), ds.refs)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_dense_baseline_without_device_raises_when_cuda_is_missing(
        monkeypatch):
    """Numpy peaks binned without ``device`` go to the card, not the host."""
    from repro_torch.core.baselines import bin_spectra_dense
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset(LibraryConfig(n_refs=8, n_queries=2))
    kw = dict(bin_size=0.05, mz_min=200.0, mz_max=2000.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bin_spectra_dense(ds.refs.mz, ds.refs.intensity, **kw)
    assert bin_spectra_dense(ds.refs.mz, ds.refs.intensity, **kw,
                             device="cpu").device.type == "cpu"


def test_port_dataset_is_seeded_and_shaped():
    cfg = LibraryConfig(n_refs=64, n_queries=16, seed=3)
    a, b = make_dataset(cfg), make_dataset(cfg)
    assert (a.refs.mz == b.refs.mz).all() and (a.queries.pmz == b.queries.pmz).all()
    assert a.refs.mz.shape == (64, 64) and a.refs.mz.dtype == np.float32
    assert a.queries.charge.dtype == np.int32 and set(a.refs.charge) <= {2, 3}
    assert ((a.refs.intensity > 0).sum(axis=1) >= cfg.min_peaks).all()
