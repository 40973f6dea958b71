"""The on-card check's entry point and phase registry, on the CPU: every phase of
chip_smoke.py is registered in order, the entry point refuses to run without a
GPU or with an unknown phase, the kernels line names the Pallas kernels it
replaces, and no phase catches a failure into a success."""
import pytest

pytest.importorskip("torch")

import ast  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke_phases as P  # noqa: E402
from chip_smoke_phases import oms_kernels  # noqa: E402

PHASE_FILES = sorted((ROOT / "chip_smoke_phases").glob("*.py"))
# The phases in the order the run takes them: 18 before 16, as before the
# split, since 16's subprocesses come last among the OMS paths.
ORDER = [*range(1, 16), 18, 16, 17, 19, 20, 21, 22]


def _run(*args, cwd=ROOT, script=ROOT / "chip_smoke.py"):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_registry_holds_every_phase_in_order():
    assert [p.number for p in P.PHASES] == ORDER
    assert len(set(P.NAMES)) == len(P.NAMES) == 22
    doc = importlib.import_module("chip_smoke").__doc__
    listed = re.findall(r"^\s*(\d+)\. (\w+) \((\w+)\):", doc, re.M)
    assert [(int(n), name, mod) for n, name, mod in listed] == [
        (p.number, p.name, p.module) for p in P.PHASES]
    for i, p in enumerate(P.PHASES):
        assert callable(p.load()), p.name
        assert set(p.needs) <= {"main", "store", "streamed"}, p.name
        if p.background:
            assert callable(p.load(p.background)), p.name
            start = p.start_with or p.name
            assert P.NAMES.index(start) <= i, p.name
        # the phase's own number heads its entry in its module's docstring
        doc = importlib.import_module(f"chip_smoke_phases.{p.module}").__doc__
        assert re.search(rf"^\s*{p.number}\. ", doc, re.M), (p.name, p.module)


def test_chip_times_sections_reuse_the_phase_modules():
    sys.path.insert(0, str(ROOT / "scripts"))
    chip_times = importlib.import_module("chip_times")
    names = [s[0] for s in chip_times.SECTIONS]
    assert len(set(names)) == len(names)
    assert chip_times.LAST_OMS in names
    for _, module, fn in chip_times.SECTIONS:
        assert fn.startswith("times_")
        assert callable(getattr(importlib.import_module(f"chip_smoke_phases.{module}"), fn))


def test_list_runs_without_a_gpu():
    r = _run("--list")
    assert r.returncode == 0, r.stderr
    rows = [line.split() for line in r.stdout.splitlines()]
    assert [(int(x[0]), x[1]) for x in rows] == [(p.number, p.name) for p in P.PHASES]


@pytest.mark.parametrize("args", [(), ("--only", "nosuch"), ("--only", "tile_check")])
def test_refuses_without_a_gpu_or_with_an_unknown_phase(args):
    r = _run(*args)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "FAILED" in r.stderr
    if args[1:] == ("nosuch",):
        assert "no phase nosuch" in r.stderr


def test_chip_times_refuses_without_a_gpu():
    r = _run(script=ROOT / "scripts" / "chip_times.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(cwd=tmp_path, script=tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _pallas_kernels(path: Path) -> set:
    """Names read in the functions that call ``pl.pallas_call``."""
    tree = ast.parse(path.read_text())
    names = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "pallas_call" for n in ast.walk(fn)):
            names |= {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    return names


@pytest.mark.parametrize("name", list(oms_kernels.KERNEL_SOURCES))
def test_kernel_entries_name_the_pallas_kernels_they_replace(name):
    entry = oms_kernels.kernel_entry(name)
    assert entry["route"] == "cuda" and (ROOT / entry["source"]).is_file()
    path, line = entry["replaces"].split(":")
    lines = (ROOT / path).read_text().splitlines()
    assert lines[int(line) - 1].startswith(f"def {entry['tpu_kernel']}(")
    assert entry["tpu_kernel"] in _pallas_kernels(ROOT / path)
    assert name in oms_kernels.OWN_PATH


def _handlers():
    """(file, enclosing function, exception text, handler) of every except."""
    out = []
    for path in [*PHASE_FILES, ROOT / "chip_smoke.py", ROOT / "scripts" / "chip_times.py"]:
        tree = ast.parse(path.read_text())
        found = {}      # handler -> its innermost function (walked after the outer)
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    if isinstance(node, ast.ExceptHandler):
                        found[node] = fn.name
        handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
        assert set(handlers) == set(found), f"{path.name}: a handler outside a function"
        out += [(path.name, found[h], ast.unparse(h.type), h) for h in handlers]
    return out


def _calls(node, name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == name
               for n in ast.walk(node))


def test_no_handler_catches_a_failure_into_a_success():
    """Only these: the nvcc probe that fails the run, the triton version
    probe, a subprocess timeout that fails the run, and the training
    phase's out-of-memory batch cut, which re-raises past its one cut."""
    seen = set()
    for file, fn, exc, h in _handlers():
        key = (file, fn, exc)
        if exc == "(OSError, IndexError)":
            assert (file, fn) == ("oms_kernels.py", "environment") and _calls(h, "fail")
        elif exc == "ImportError":
            assert (file, fn) == ("oms_kernels.py", "environment")
            assert [ast.unparse(x) for x in h.body] == ["triton_v = None"]
        elif exc.endswith("TimeoutExpired"):
            assert _calls(h, "fail"), key
        elif exc == "torch.cuda.OutOfMemoryError":
            assert (file, fn) == ("train.py", "with_batch_fallback")
            assert any(isinstance(n, ast.Raise) for n in ast.walk(h))
        else:
            raise AssertionError(f"unexpected handler {key}")
        seen.add(key)
    assert ("oms_kernels.py", "environment", "(OSError, IndexError)") in seen
    assert ("train.py", "with_batch_fallback", "torch.cuda.OutOfMemoryError") in seen
