"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can hold: a
few thousand library spectra, runs of some dozens, 512-bit hypervectors,
0.5 Da bins, blocks of 256 rows and a pool of 3 runs; every other setting
as the cell's."""
from __future__ import annotations

import copy

from portbench import harness


def tiny_cell(name: str, **kw):
    return shrink(harness.resolve(harness.load_benchmark(), name), **kw)


def shrink(cell, *, n_refs: int = 2000, queries: int = 48, pool_runs: int = 3):
    cfg = copy.deepcopy(cell.config)
    cfg["library"]["n_refs"] = n_refs
    cfg["queries_per_run"] = queries
    cfg["oms"].update(dim=512, bin_size=0.5, max_r=256, encode_batch=64)
    cell.config = cfg
    cell.traffic = {**cell.traffic, "pool_runs": pool_runs, "warm_runs": 2}
    return cell


def cells() -> list[str]:
    return [w["name"] for w in harness.load_benchmark()["workloads"]]
