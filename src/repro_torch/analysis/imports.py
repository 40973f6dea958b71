"""Static import-graph analysis for the ``repro_torch`` package.

Counterpart of ``repro.analysis.imports``. ``repro_torch.core.pipeline``
(ingest writer) and ``repro_torch.store.library_store`` (reader) share
constants through the dependency-free ``repro_torch.store.format`` — the
module whose emptiness of package imports is what keeps the core<->store
relationship acyclic at module granularity. The same pattern protects
``repro_torch.analysis.registry`` (imported at module level by
``repro_torch.core.backends``). This module is the ``analyze --imports``
check.

Semantics:

  * edges are MODULE-LEVEL imports only — imports inside function bodies
    (the repo's lazy-import idiom) and under ``if TYPE_CHECKING:`` do not
    execute at import time and are excluded;
  * ``from repro_torch.x import y`` resolves to module ``repro_torch.x.y``
    when that is a module on disk, else to ``repro_torch.x``;
  * only edges into the checked package's namespace are kept
    (stdlib/torch/numpy are irrelevant to its layering);
  * cycles are strongly connected components of size > 1 (plus self
    loops), found with Tarjan's algorithm — deterministic order, no
    recursion limits.

Beyond "no cycles anywhere", a few named modules must stay import-free of
the package entirely, because other modules import them at module level
from both sides of a package boundary: ``repro_torch.store.format``,
``repro_torch.analysis.registry``, and the observability primitives
``repro_torch.obs.trace`` / ``repro_torch.obs.metrics`` (imported by both
``repro_torch.core`` and ``repro_torch.serve``).
"""
from __future__ import annotations

import ast
import os
from typing import Iterable

LEAF_MODULES = ("repro_torch.store.format", "repro_torch.analysis.registry",
                "repro_torch.obs.trace", "repro_torch.obs.metrics")


def _module_name(root: str, path: str) -> str:
    rel = os.path.relpath(path, os.path.dirname(root))
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace(os.sep, ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _is_type_checking_guard(node: ast.If) -> bool:
    t = node.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
        isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING")


def _module_level_imports(tree: ast.Module) -> Iterable[ast.stmt]:
    """Import statements that execute at import time: module body plus
    module-level ``if``/``try`` blocks — but not ``if TYPE_CHECKING:`` and
    not anything inside a def/class body."""
    def walk(body):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                yield node
            elif isinstance(node, ast.If):
                if not _is_type_checking_guard(node):
                    yield from walk(node.body)
                yield from walk(node.orelse)
            elif isinstance(node, ast.Try):
                for blk in (node.body, node.orelse, node.finalbody):
                    yield from walk(blk)
                for h in node.handlers:
                    yield from walk(h.body)
    yield from walk(tree.body)


def build_import_graph(src_root: str, package: str = "repro_torch"
                       ) -> dict[str, list[str]]:
    """{module: sorted imported package modules} from static AST analysis.

    ``src_root`` is the directory CONTAINING the package (e.g. ``src`` for
    ``src/repro_torch``).
    """
    pkg_root = os.path.join(src_root, package)
    modules: dict[str, str] = {}
    packages: set[str] = set()
    for path in _iter_py_files(pkg_root):
        mod = _module_name(pkg_root, path)
        modules[mod] = path
        if os.path.basename(path) == "__init__.py":
            packages.add(mod)
    known = set(modules)

    def resolve(name: str) -> str | None:
        """Longest known-module prefix of a dotted import target."""
        parts = name.split(".")
        for i in range(len(parts), 0, -1):
            cand = ".".join(parts[:i])
            if cand in known:
                return cand
        return None

    graph: dict[str, list[str]] = {}
    for mod, path in modules.items():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        edges: set[str] = set()
        for node in _module_level_imports(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                base = node.module or ""
                if node.level:      # relative import -> absolute
                    # level 1 = the containing package (the module itself
                    # if it IS a package __init__); each extra level strips
                    # one more component.
                    anchor = mod.split(".")
                    if mod not in packages:
                        anchor = anchor[:-1]
                    if node.level > 1:
                        anchor = anchor[:len(anchor) - (node.level - 1)]
                    base = ".".join(anchor + ([base] if base else []))
                names = [f"{base}.{a.name}" if base else a.name
                         for a in node.names]
            for name in names:
                tgt = resolve(name)
                if tgt is not None and tgt != mod:
                    edges.add(tgt)
        graph[mod] = sorted(edges)
    return graph


def find_cycles(graph: dict[str, list[str]]) -> list[list[str]]:
    """Cycles as sorted SCCs of size > 1 (plus self-loops), via iterative
    Tarjan."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    for root in sorted(graph):
        if root in index:
            continue
        work = [(root, iter(graph.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in graph:
                    continue
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(graph.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1 or v in graph.get(v, ()):
                    sccs.append(sorted(scc))
    return sorted(sccs)


def check_imports(src_root: str, package: str = "repro_torch") -> dict:
    """The ``analyze --imports`` report: cycles + leaf-module violations."""
    graph = build_import_graph(src_root, package)
    cycles = find_cycles(graph)
    leaf_violations = {
        leaf: graph[leaf] for leaf in LEAF_MODULES
        if leaf in graph and graph[leaf]
    }
    return {
        "modules": len(graph),
        "edges": sum(len(v) for v in graph.values()),
        "cycles": cycles,
        "leaf_violations": leaf_violations,
        "ok": not cycles and not leaf_violations,
    }
