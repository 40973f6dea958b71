"""The comparison fails what it should: the control (the program's own
approximate cascade) and faults planted under the timed path, driven
through the rest of a run with the look for a card skipped. A cell on one
chip has no exchange between chips to leave out."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import control, harness
from portbench.tests._tiny import cells, tiny_cell


def _run(cell, seed, **kw):
    return harness.run(cell, seed, 0.2, False, device="cpu", t_start=time.perf_counter(),
                       **kw)[0]


@pytest.mark.parametrize("seed", [101, 2**31 + 7, 3_000_000_019])
@pytest.mark.parametrize("name", cells())
def test_the_control_is_not_correct(name, seed):
    out = control.run_control(tiny_cell(name), seed, device="cpu", seed_da=1.0)
    assert not out["correct"]
    assert out["checks"]["winners_off"]["value"] > 0


def _half_batch(oms_search):
    """Half the queries left out: the search runs on the first half and the
    rest get no winners."""
    def search(db, q_hvs, q_pmz, q_charge, params, **kw):
        h = q_hvs.shape[0] // 2
        kw.update(q_pmz_np=None, q_charge_np=None)
        r = oms_search(db, q_hvs[:h], q_pmz[:h], q_charge[:h], params, **kw)
        pad = lambda t: torch.cat([t, torch.full((q_hvs.shape[0] - h, *t.shape[1:]), -1,  # noqa: E731
                                                 dtype=t.dtype)])
        return type(r)(*(pad(t) for t in r))
    return search


def _altered(fn):
    """One answer altered where it is produced: the scan kernel's best open
    similarity of one query raised by one."""
    def fused(*args, **kw):
        std_sim, std_row, open_sim, open_row = fn(*args, **kw)
        open_sim = open_sim.clone()
        open_sim[5, 0] += 1
        return std_sim, std_row, open_sim, open_row
    return fused


def _stale(search_encoded):
    """The previous run's answer returned again."""
    last = {}

    def search(self, *args, **kw):
        out = last.get("out") or search_encoded(self, *args, **kw)
        last["out"] = search_encoded(self, *args, **kw)
        return out
    return search


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer", "stale_answer"])
@pytest.mark.parametrize("name", cells())
def test_planted_faults_are_not_correct(name, fault, monkeypatch):
    from repro_torch.core import backends, pipeline
    if fault == "half_batch":
        monkeypatch.setattr(pipeline, "oms_search", _half_batch(pipeline.oms_search))
    elif fault == "altered_answer":
        be = backends.get("fused")
        monkeypatch.setitem(backends._REGISTRY, "fused",
                            backends.Backend(be.name, be.kind, _altered(be.fn), be.tile_name))
    else:
        monkeypatch.setattr(pipeline.OMSPipeline, "search_encoded",
                            _stale(pipeline.OMSPipeline.search_encoded))
    result = _run(tiny_cell(name), 4242)
    assert not result["correct"]
    assert result["checks"]["winners_off"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_the_control_is_not_correct_at_the_cells_size(name, card):
    cell = harness.resolve(harness.load_benchmark(), name)
    for seed in (11, 2**31 + 13, 3_000_000_023):
        out = control.run_control(cell, seed, device=card)
        print(name, out)
        assert not out["correct"]
