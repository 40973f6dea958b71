"""The plain reference agrees with the port on the CPU at a tiny size, part
by part (codebooks, decoys, encoder, FDR) and whole (every cell's runs), and
its blocked search agrees with an exhaustive one."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import gen_spectra, harness
from portbench.reference import encode as enc
from portbench.reference.fdr import fdr_filter
from portbench.reference.oms import ReferenceOMS
from portbench.tests._tiny import cells, tiny_cell

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell(cells()[0])
    refs, runs, _ = gen_spectra.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    return cell.config, refs, runs


def test_codebooks_and_decoys_equal_the_ports(tiny):
    from repro_torch.core import decoys
    from repro_torch.core.pipeline import _codebooks, _derive_keys
    cfg, refs, _ = tiny
    oms = cfg["oms"]
    e = enc.Encoder(oms, SEED, "cpu")
    cb = _codebooks(SEED, e.n_bins, oms["n_levels"], oms["dim"], torch.device("cpu"))
    assert torch.equal(e.id_hvs, cb.id_hvs) and torch.equal(e.level_hvs, cb.level_hvs)
    assert torch.equal(e.tiebreak, cb.tiebreak)
    mz, inten = torch.as_tensor(refs.mz[:300]), torch.as_tensor(refs.intensity[:300])
    k_port = _derive_keys(harness.driver("closed_loop").oms_config(cfg, SEED), "cpu")[1]
    want = decoys.make_decoy_peaks(k_port, mz, inten, oms["mz_min"], oms["mz_max"],
                                   row_offset=700)
    got = enc.make_decoy_peaks(enc.decoy_key(SEED, "cpu"), mz, inten, oms["mz_min"],
                               oms["mz_max"], row_offset=700)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_encoder_equals_the_ports(tiny):
    from repro_torch.core import encode_backends
    from repro_torch.core.pipeline import _codebooks
    cfg, refs, runs = tiny
    oms = cfg["oms"]
    e = enc.Encoder(oms, SEED, "cpu")
    cb = _codebooks(SEED, e.n_bins, oms["n_levels"], oms["dim"], torch.device("cpu"))
    pp = harness.driver("closed_loop").oms_config(cfg, SEED).preprocess_params
    for s in (refs, runs[0]):
        want, _, _ = encode_backends.preprocess_encode(s.mz, s.intensity, s.pmz, s.charge,
                                                       cb, pp, backend="oracle")
        got = e(torch.as_tensor(s.mz), torch.as_tensor(s.intensity), chunk=333)
        assert torch.equal(want, got)


def test_fdr_equals_the_ports():
    from repro_torch.core.fdr import fdr_filter as port_fdr
    g = torch.Generator().manual_seed(5)
    sims = torch.randint(2000, 2100, (400, 3), generator=g).float()
    isd = torch.rand((400, 3), generator=g) < 0.3
    valid = torch.rand((400, 3), generator=g) < 0.9
    want = port_fdr(sims, isd & valid, valid, threshold=0.05)
    accept, q = fdr_filter(sims, isd & valid, valid, 0.05)
    assert torch.equal(want.accept, accept) and torch.equal(want.q_values, q)


def test_blocked_search_equals_an_exhaustive_one(tiny):
    cfg, refs, runs = tiny
    oms = cfg["oms"]
    ref = ReferenceOMS(cfg, refs, SEED, "cpu", chunk_rows=500)
    k = 4
    got = ref.answer(runs[0], k, q_block=7, max_pairs=300)
    q_hvs = ref.encoder(torch.as_tensor(runs[0].mz), torch.as_tensor(runs[0].intensity))
    bits = lambda w: enc.unpack_bits(w).reshape(w.shape[0], -1).numpy()  # noqa: E731
    qb, rb = bits(q_hvs), bits(ref.hvs)
    sim = (qb[:, None, :] == rb[None, :, :]).sum(-1)
    qp = np.asarray(runs[0].pmz, np.float32)
    rp = ref.pmz.numpy()
    d = np.abs(qp[:, None] - rp[None, :])
    same = np.asarray(runs[0].charge)[:, None] == ref.charge.numpy()[None, :]
    windows = {"std": same & (d <= qp[:, None] * np.float32(oms["ppm_tol"] * 1e-6)),
               "open": same & (d <= np.float32(oms["open_tol_da"]))}
    for w, inside in windows.items():
        for i in range(len(qp)):
            cand = sorted(((-sim[i, r], r) for r in np.flatnonzero(inside[i])))[:k]
            want_idx = [int(ref.idx[r]) for _, r in cand] + [-1] * (k - len(cand))
            want_sim = [-s for s, _ in cand] + [-1] * (k - len(cand))
            assert got[f"{w}_idx"][i].tolist() == want_idx
            assert got[f"{w}_sim"][i].tolist() == want_sim


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_every_cell_is_correct_at_a_tiny_size(name, trace):
    result, lines = harness.run(tiny_cell(name), SEED + trace, 0.2, bool(trace),
                                device="cpu", t_start=time.perf_counter())
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 for c in result["checks"].values())
    want = {"encode_ms", "plan_ms", "fdr_ms", "ingest_s"} if trace else {
        "spectra_per_s", "run_p95_ms", "setup_s"}
    assert want <= set(result["metrics"])
