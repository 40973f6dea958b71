"""The benchmark finds every cell's files by name, a cell added as new
files needs no code edit, and ``BENCHMARK.json`` keeps to its contract."""
from __future__ import annotations

import json
import re
import shutil

import numpy as np
import pytest

from portbench import harness
from portbench.tests._tiny import cells, shrink

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER = ("inputs", "build", "warm", "window", "reference")


@pytest.mark.parametrize("name", cells())
def test_every_cell_resolves_to_its_files(name):
    bench = harness.load_benchmark()
    cell = harness.resolve(bench, name)
    config = {w["name"]: w["config"] for w in bench["workloads"]}[name]
    assert cell.config["name"] == config and cell.config["oms"]["dim"] > 0
    assert cell.traffic["top_k"] >= 1 and cell.traffic["pool_runs"] >= 1
    drv = harness.driver(cell.traffic["driver"])
    assert all(callable(getattr(drv, f)) for f in DRIVER)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_benchmark_keeps_to_its_contract():
    root = harness.REPO
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    assert all((root / p).is_dir() for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert json.loads((root / c["file"]).read_text())["reduced"] == c["reduced"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200 for w in bench["workloads"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_added_as_files_is_found_without_a_code_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PORTBENCH, root / "portbench")
    bench = harness.load_benchmark()
    cfg = json.loads((harness.REPO / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "newlib"
    (root / "portbench/configs/newlib.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/new_mix.json").write_text(json.dumps(
        {"name": "new_mix", "driver": "closed_loop", "top_k": 3, "pool_runs": 2,
         "warm_runs": 1}))
    (root / "portbench/metrics/runs_done.py").write_text(
        "def read(rec):\n    return len(rec.runs)\n")
    bench["configs"].append({"name": "newlib", "source": "x", "file":
                             "portbench/configs/newlib.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "newlib.new_mix", "config": "newlib",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "runs_done", "unit": "runs", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "spectra_per_s",
                               "workloads": ["newlib.new_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve(harness.load_benchmark(root), "newlib.new_mix", root)
    assert cell.config["name"] == "newlib" and cell.traffic["top_k"] == 3
    assert [m["name"] for m in cell.per_layer] == ["runs_done"]
    rec = harness.Record(cell, 1.0, 0.5, [(0, 1, 0, 10)] * 7, None)
    assert harness.reader("runs_done", root)(rec) == 7


def test_a_driver_and_its_counter_added_as_files_need_no_code_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PORTBENCH, root / "portbench")
    (root / "portbench/drivers/counted_loop.py").write_text(
        "from portbench import harness\n"
        "_base = harness.driver('closed_loop')\n"
        "inputs, build, warm, reference = _base.inputs, _base.build, _base.warm, _base.reference\n"
        "\n\n"
        "def window(ctx, deadline_ns, min_runs):\n"
        "    _base.window(ctx, deadline_ns, min_runs)\n"
        "    ctx.counters['requests'] = len(ctx.runs)\n")
    (root / "portbench/metrics/requests_seen.py").write_text(
        "def read(rec):\n    return rec.counters.get('requests')\n")
    bench = harness.load_benchmark()
    w = bench["workloads"][0]
    mix = json.loads((harness.PORTBENCH / "traffic" / f"{w['traffic']}.json").read_text())
    (root / "portbench/traffic/counted.json").write_text(json.dumps(
        {**mix, "name": "counted", "driver": "counted_loop"}))
    bench["workloads"].append({**w, "name": "counted_cell", "traffic": "counted"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "runs", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "spectra_per_s", "workloads": ["counted_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = shrink(harness.resolve(harness.load_benchmark(root), "counted_cell", root))
    assert [m["name"] for m in cell.per_layer] == ["requests_seen"]
    result, lines = harness.run(cell, 77, 0.0, True, device="cpu", t_start=0.0, min_runs=3)
    assert result["correct"], lines
    assert result["metrics"] == {"requests_seen": {"value": 3.0, "unit": "runs"}}


def test_the_window_sends_distinct_runs_with_distinct_charge_counts():
    from portbench import gen_spectra
    cell = shrink(harness.resolve(harness.load_benchmark(), cells()[0]), pool_runs=12)
    _, pool, warm = gen_spectra.make_inputs(cell.config, cell.traffic, 5, "cpu")
    counts = [tuple(np.unique(r.charge, return_counts=True)[1]) for r in pool + warm]
    assert len(pool) == 12 and len(warm) == 2
    assert len(set(counts)) == len(counts)
    assert all(r.pmz.shape == (cell.config["queries_per_run"],) for r in pool + warm)
    assert len({r.mz.tobytes() for r in pool}) == len(pool)


@pytest.mark.parametrize("name", cells())
def test_each_cell_cycles_more_runs_than_the_program_memoizes(name):
    from repro_torch.core import search
    memo = getattr(search, "_padding_plan", None)
    if not hasattr(memo, "cache_info"):
        pytest.skip("the program memoizes no padding plan")
    cell = harness.resolve(harness.load_benchmark(), name)
    assert cell.traffic["pool_runs"] > memo.cache_info().maxsize


def _record(**kw):
    cell = harness.resolve(harness.load_benchmark(), cells()[0])
    ms = 1_000_000
    runs = [(i * 20 * ms, i * 20 * ms + (10 + i) * ms, i % 2, 1000) for i in range(20)]
    rec = harness.Record(cell, 12.5, 4.0, runs, 3 * 2**30, **kw)
    return rec, runs


def test_end_to_end_readers_read_the_window():
    rec, runs = _record()
    rd = harness.reader
    span_s = (runs[-1][1] - runs[0][0]) / 1e9
    assert rd("spectra_per_s")(rec) == pytest.approx(20 * 1000 / span_s)
    assert rd("run_p95_ms")(rec) == pytest.approx(np.percentile(np.arange(10, 30), 95))
    assert rd("device_peak_gib")(rec) == 3.0
    assert rd("setup_s")(rec) == 12.5 and rd("ingest_s")(rec) == 4.0


def test_per_layer_readers_read_spans_and_the_device_trace():
    ms = 1_000_000
    spans = [("bench.search", 0, 10 * ms), ("pipeline.encode", 1 * ms, 3 * ms),
             ("pipeline.plan", 3 * ms, 4 * ms), ("pipeline.fdr", 8 * ms, 9 * ms),
             ("pipeline.encode", 21 * ms, 24 * ms)]
    events = [("void fused_grouped_partial<x>", 4 * ms, 7 * ms),
              ("fused_search_merge", 7 * ms, 8 * ms), ("hdencode_kernel", 2 * ms, 3 * ms)]
    rec, runs = _record(spans=spans, device_events=events, window_ns=(0, 40 * ms),
                        busy_s=0.010, work={0: {"bound_s": 0.0005}, 1: {"bound_s": 0.0005}})
    rd = harness.reader
    n = len(runs)
    assert rd("encode_ms")(rec) == pytest.approx(5.0 / n)
    assert rd("plan_ms")(rec) == pytest.approx(1.0 / n)
    assert rd("fdr_ms")(rec) == pytest.approx(1.0 / n)
    assert rd("fused_search_device_ms")(rec) == pytest.approx(4.0 / n)
    assert rd("fused_search_roofline")(rec) == pytest.approx(100 * n * 0.0005 / 0.004)
    assert rd("device_idle_share")(rec) == pytest.approx(0.75)
    assert rec.span_self_s("bench.search") == pytest.approx(0.006)


def test_readers_with_nothing_to_read_return_nothing():
    rec, _ = _record()
    for name in ("encode_ms", "fused_search_device_ms", "fused_search_roofline",
                 "device_idle_share"):
        assert harness.reader(name)(rec) is None
