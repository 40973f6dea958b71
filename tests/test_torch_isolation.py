"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports jax or the reference package, every module imports with jax
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


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_static_scan_finds_no_jax_or_reference_import():
    assert (ROOT / "chip_smoke.py").exists()
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


def test_port_dataset_is_seeded_and_shaped():
    cfg = LibraryConfig(n_refs=64, n_queries=16, seed=3)
    a, b = make_dataset(cfg), make_dataset(cfg)
    assert (a.refs.mz == b.refs.mz).all() and (a.queries.pmz == b.queries.pmz).all()
    assert a.refs.mz.shape == (64, 64) and a.refs.mz.dtype == np.float32
    assert a.queries.charge.dtype == np.int32 and set(a.refs.charge) <= {2, 3}
    assert ((a.refs.intensity > 0).sum(axis=1) >= cfg.min_peaks).all()
