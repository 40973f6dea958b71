"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import harness

FILES = sorted(harness.PORTBENCH.rglob("*.py"))


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.PORTBENCH)))
def test_no_jax_and_no_jax_package(path):
    found = _top_level_imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((harness.PORTBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _top_level_imports(path)


def test_the_run_time_check_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("repro_torchlike"))
    monkeypatch.setitem(sys.modules, "jaxlike.sub", types.ModuleType("jaxlike.sub"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_loaded() == ["repro"]
