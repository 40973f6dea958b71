"""The port's launcher against the reference's, in process, on one small
store: ``queries`` output and ``build`` shards byte-equal; ``serve`` stdout
byte-identical, resident and streamed, with the result cache on and off,
with ``--cascade``, with malformed lines and a past-deadline request; the
non-timing lines of ``search`` and the one-shot form equal; ``--device``
unset raises without a GPU; ``tune --grid tiny`` writes a cache the
reference loads, ``analyze --imports`` exits 0, and ``search`` / ``serve``
answer the same with ``--tune-cache`` (or ``REPRO_TUNE_CACHE``) as
without it, reading the cache at dispatch.

The port's synthetic data comes from numpy draws, the reference's from
``jax.random``, so both launchers are given the reference's dataset (its
``make_dataset`` patched into the port's launcher); every other input is
the same file or store."""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from repro.data import spectra as ref_spectra  # noqa: E402
from repro.launch import oms as ref_oms  # noqa: E402
from repro_torch.data import spectra as port_spectra  # noqa: E402
from repro_torch.launch import oms as port_oms  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402

REFS, QUERIES = 300, 24
COMMON = ["--refs", str(REFS), "--seed", "3"]
ENC = ["--dim", "512", "--n-levels", "16"]
SERVE = ["--max-r", "64", "--q-block", "8"]
CPU = ["--device", "cpu"]


@functools.lru_cache(maxsize=None)
def _ref_dataset(cfg):
    return ref_spectra.make_dataset(cfg)


def _port_make_dataset(cfg: port_spectra.LibraryConfig):
    """The reference's dataset for the same config, as the port's numpy
    types."""
    ds = _ref_dataset(ref_spectra.LibraryConfig(**dataclasses.asdict(cfg)))

    def s(x):
        return port_spectra.SpectraSet(*(np.array(a) for a in x))
    return port_spectra.SyntheticDataset(
        refs=s(ds.refs), queries=s(ds.queries),
        query_source=np.array(ds.query_source),
        query_modified=np.array(ds.query_modified),
        query_shift=np.array(ds.query_shift))


@pytest.fixture(autouse=True)
def _reference_data(monkeypatch):
    monkeypatch.setattr(port_oms, "make_dataset", _port_make_dataset)


def _run(mod, argv, stdin: str | None = None) -> tuple[str, str]:
    """``mod.main(argv)`` in process; returns (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            mod.main(argv)
    finally:
        sys.stdin = old_stdin
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The reference's build of the small library, and the port's."""
    root = tmp_path_factory.mktemp("launch")
    ref_path, port_path = str(root / "ref"), str(root / "port")
    argv = ["build", "--chunk-rows", "512", *COMMON, *ENC]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_oms, "make_dataset", _port_make_dataset)
        ref_out = _run(ref_oms, [*argv, "--store", ref_path])[0]
        port_out = _run(port_oms, [*argv, "--store", port_path, *CPU])[0]
    return ref_path, port_path, ref_out, port_out


@pytest.fixture(scope="module")
def requests():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_oms, "make_dataset", _port_make_dataset)
        argv = ["queries", "--queries", str(QUERIES), *COMMON]
        return _run(ref_oms, argv)[0], _run(port_oms, argv)[0]


def _strip_time(line: str) -> str:
    return re.sub(r" in \d+\.\d+s", " in <t>s", line)


def test_build_shards_byte_equal(store):
    ref_path, port_path, ref_out, port_out = store
    assert (_strip_time(ref_out).replace(ref_path, "<store>")
            == _strip_time(port_out).replace(port_path, "<store>"))
    names = sorted(os.listdir(ref_path))
    assert names == sorted(os.listdir(port_path)) and len(names) > 5
    for name in names:
        if name == "manifest.json":
            continue
        with open(os.path.join(ref_path, name), "rb") as a, \
                open(os.path.join(port_path, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(ref_path, "manifest.json")) as a, \
            open(os.path.join(port_path, "manifest.json")) as b:
        assert json.load(a) == json.load(b)


def test_queries_stdout_byte_equal(requests):
    ref, port = requests
    assert ref == port and len(ref.splitlines()) == QUERIES


# Extra lines: a malformed JSON line, a request missing its peaks and one
# whose deadline passes before any batch can run. A shed response's text
# carries the seconds it waited (or the latency estimate that shed it),
# which differ between any two runs, so that text is masked; the error
# type is compared.
EXTRA = ['not json', '{"id": "no-peaks", "pmz": 500.0, "charge": 2}']


def _with_extras(reqs: str) -> str:
    lines = reqs.splitlines()
    late = json.loads(lines[0])
    late.update(id="late", deadline_ms=1e-6)
    return "\n".join(lines[:5] + EXTRA + [json.dumps(late)] + lines[5:]) + "\n"


def _mask_wait(out: str) -> str:
    return re.sub(r'"DeadlineExceeded: [^"]*"', '"DeadlineExceeded: <t>"', out)


SERVE_CASES = {
    "resident": ["--resident", "--no-result-cache"],
    "resident-cache": ["--resident"],
    "streamed": ["--slab-rows", "128", "--no-result-cache"],
    "streamed-cache-topk2": ["--slab-rows", "64", "--top-k", "2"],
    "cascade": ["--resident", "--cascade", "--no-result-cache"],
    "cascade-streamed-cache": ["--cascade", "--slab-rows", "128"],
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_stdout_byte_identical(store, requests, case, tmp_path):
    ref_path, port_path = store[:2]
    reqs = _with_extras(requests[0])
    batch = "64"
    if "cache" in case:     # every request twice, in later batches: hits
        reqs, batch = reqs + reqs, "16"
    argv = ["serve", *SERVE, "--max-batch", batch, "--max-wait-ms", "50",
            *SERVE_CASES[case]]
    ref_out, _ = _run(ref_oms, [*argv, "--store", ref_path], reqs)
    trace = str(tmp_path / "serve.trace.jsonl")
    port_out, port_err = _run(port_oms, [*argv, "--store", port_path, *CPU,
                                         "--trace", trace, "--metrics", "-"],
                              reqs)
    assert _mask_wait(port_out) == _mask_wait(ref_out)
    lines = [json.loads(x) for x in port_out.splitlines()]
    assert len(lines) == len(reqs.splitlines())
    errors = [x for x in lines if "error" in x]
    assert [x["id"] for x in errors][:3] == [None, "no-peaks", "late"]
    assert errors[0]["error"].startswith("JSONDecodeError")
    assert errors[1]["error"] == "KeyError: 'mz'"
    assert "DeadlineExceeded" in errors[2]["error"]
    assert port_trace.current() is None           # uninstalled on exit
    assert "micro-batches" in port_err and "metrics {" in port_err
    if "cache" in case:
        masked = _mask_wait(port_out).splitlines()
        n = len(masked) // 2
        assert masked[:n] == masked[n:]
        assert re.search(r"cache (\d+)/", port_err).group(1) != "0"
    # the port's cached run equals its own uncached one
    if case == "resident-cache":
        plain, _ = _run(port_oms, [*argv, "--no-result-cache",
                                   "--store", port_path, *CPU], reqs)
        assert _mask_wait(plain) == _mask_wait(port_out)


def _result_lines(out: str) -> list[str]:
    keep = ("reduction", "cascade:", "recall", "identifications")
    return [_strip_time(x) for x in out.splitlines()
            if any(k in x for k in keep)]


@pytest.mark.parametrize("extra", [[], ["--cascade", "--top-k", "2"]],
                         ids=["plain", "cascade-top2"])
def test_search_result_lines_equal(store, extra):
    argv = ["search", "--queries", str(QUERIES), *SERVE, *extra]
    ref = _run(ref_oms, [*argv, "--store", store[0], *COMMON])[0]
    port = _run(port_oms, [*argv, "--store", store[1], *COMMON, *CPU])[0]
    assert _result_lines(port) == _result_lines(ref)
    assert len(_result_lines(port)) >= (4 if not extra else 6)


def test_oneshot_result_lines_equal():
    argv = [*COMMON, *ENC, *SERVE, "--queries", str(QUERIES),
            "--backend", "fused"]
    ref = _run(ref_oms, argv)[0]
    port = _run(port_oms, [*argv, *CPU])[0]
    assert _result_lines(port) == _result_lines(ref)
    ingest = [re.sub(r" in .*", "", x.splitlines()[0]) for x in (ref, port)]
    assert ingest[0] == ingest[1]


@pytest.mark.parametrize("cmd", [["build", "--store", "unused", "--refs", "8"],
                                 ["search", "--store", "unused"],
                                 ["serve", "--store", "unused"],
                                 ["--refs", "8"]],
                         ids=["build", "search", "serve", "oneshot"])
def test_device_unset_raises_without_gpu(monkeypatch, cmd, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(port_oms, cmd)
    assert not os.listdir(tmp_path)           # nothing was written


def _tune_cache(path) -> str:
    """A "cpu"-keyed cache: split parameters for the fused backend at the
    tests' shapes and a rescore bucket floor of 128 (the default is 64)."""
    from repro_torch.tune import cache as tune_cache
    c = tune_cache.TuneCache()
    c.put(device_kind="cpu", backend="fused", dim=512, k=1,
          shape_bucket=tune_cache.shape_bucket(8, 1024),
          tiles={"waves": 1, "min_split_rows": 256})
    c.put(device_kind="cpu", backend="rescore", dim=0, k=0,
          shape_bucket=tune_cache.shape_bucket(0, 0), tiles={"row_bucket": 128})
    c.save(path)
    return str(path)


@pytest.fixture
def _tune_runtime():
    from repro_torch import tune
    tune.reset_runtime()
    yield tune
    tune.reset_runtime()


def test_tune_writes_a_winner_cache(tmp_path, _tune_runtime):
    cache, table = tmp_path / "tune.json", tmp_path / "table.txt"
    out, err = _run(port_oms, ["tune", "--grid", "tiny", "--dim", "256",
                               "--rows", "200", "--iters", "1", "--cache",
                               str(cache), "--table", str(table), *CPU])
    from repro.tune import cache as ref_cache
    entries = ref_cache.TuneCache.load(cache).entries
    assert {k[1] for k in entries} == set(_tune_runtime.SWEPT_BACKENDS)
    assert all(k[0] == "cpu" for k in entries)
    assert table.read_text().strip() == out.strip()
    assert len(out.splitlines()) == 1 + len(_tune_runtime.SWEPT_BACKENDS)
    assert "device=cpu" in err and "14 candidates over 5 backends" in err


def test_analyze_imports_exits_zero(tmp_path):
    report = tmp_path / "analyze.json"
    out, _ = _run(port_oms, ["analyze", "--imports", "--no-recompile",
                             "--json", str(report), *CPU])
    assert "imports:" in out and "— OK" in out and "ALL CONTRACTS HOLD" in out
    rep = json.loads(report.read_text())
    assert rep["imports"]["ok"] and rep["contracts"]["ok"]
    assert rep["contracts"]["n_combinations"] == 169


@pytest.mark.parametrize("cmd", ["search", "serve"])
def test_tune_cache_changes_no_output_and_hits(store, requests, cmd, tmp_path,
                                               _tune_runtime):
    """Tuned launch parameters and a tuned bucket floor give the same bytes;
    the stats line shows the cache was read at dispatch."""
    port_path = store[1]
    extra = ["--backend", "fused", "--prefix-words", "4"]
    if cmd == "search":
        argv = ["search", "--queries", str(QUERIES), *SERVE, *extra,
                "--store", port_path, *COMMON, *CPU]
        stdin = None
    else:
        argv = ["serve", *SERVE, *extra, "--store", port_path, *CPU,
                "--resident", "--no-result-cache"]
        stdin = requests[0]
    plain, plain_err = _run(port_oms, argv, stdin)
    tuned, tuned_err = _run(port_oms, [*argv, "--tune-cache",
                                       _tune_cache(tmp_path / "t.json")], stdin)
    if cmd == "search":
        plain, tuned = _result_lines(plain), _result_lines(tuned)
        assert len(plain) >= 4
    assert tuned == plain
    assert "tune-cache" not in plain_err
    hits = re.search(rf"\[oms {cmd}\] tune-cache .*: 2 entries, (\d+) hits / "
                     rf"(\d+) misses at dispatch", tuned_err)
    assert hits and int(hits.group(1)) > 0


def test_tune_cache_environment_is_honoured(store, monkeypatch, tmp_path,
                                            _tune_runtime):
    monkeypatch.setenv("REPRO_TUNE_CACHE", _tune_cache(tmp_path / "env.json"))
    _, err = _run(port_oms, ["search", "--queries", str(QUERIES), *SERVE,
                             "--backend", "fused", "--prefix-words", "4",
                             "--store", store[1], *COMMON, *CPU])
    assert re.search(r"\[oms search\] tune-cache .*env\.json: 2 entries, "
                     r"[1-9]\d* hits", err)


def test_trace_report_reads_the_serve_trace(store, requests, tmp_path):
    reqs = requests[0]
    trace = str(tmp_path / "t.trace.json")
    _, err = _run(port_oms, ["serve", *SERVE, "--store", store[1], *CPU,
                             "--slab-rows", "128", "--no-result-cache",
                             "--trace", trace], reqs)
    n_batches = int(re.search(r"(\d+) micro-batches", err).group(1))
    n_slabs = int(re.search(r"scans over (\d+) slabs", err).group(1))
    for mod in (port_oms, ref_oms):
        out, _ = _run(mod, ["trace-report", "--json", trace])
        roll = json.loads(out)
        assert roll["serve.batch"]["count"] == n_batches
        assert roll["serve.slab.search"]["count"] == n_slabs
        assert {"pipeline.encode", "pipeline.plan", "pipeline.scan",
                "pipeline.fdr", "serve.scan", "serve.slab.fetch",
                "serve.slab.merge"} <= set(roll)
    table, _ = _run(port_oms, ["trace-report", trace])
    assert table.splitlines()[0].startswith("span")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "x"}\n')
    with pytest.raises(SystemExit) as e:
        _run(port_oms, ["trace-report", str(bad)])
    assert e.value.code == 1
