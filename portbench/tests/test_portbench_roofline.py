"""The roofline counts the pairs and rows the inputs need, whatever scans
them: held against a brute-force count."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline


def _brute(lib_pmz, lib_charge, q_pmz, q_charge, tol):
    d = np.abs(q_pmz[:, None].astype(np.float64) - lib_pmz[None, :].astype(np.float64))
    inside = (d <= tol) & (q_charge[:, None] == lib_charge[None, :])
    return int(inside.sum()), int(inside.any(axis=0).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_work_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    lib_pmz = rng.uniform(400, 1800, n).astype(np.float32)
    lib_pmz[:50] = lib_pmz[50:100]                  # ties, as decoys bring
    lib_charge = rng.integers(2, 4, n).astype(np.int32)
    q_pmz = (lib_pmz[rng.integers(0, n, 300)] + rng.uniform(-80, 80, 300)).astype(np.float32)
    q_pmz[:5] = lib_pmz[:5] + np.float32(75.0)      # on the window's edge
    q_charge = rng.integers(2, 5, 300).astype(np.int32)   # charge 4: no rows
    lib = roofline.Library(lib_pmz, lib_charge)
    assert lib.window_work(q_pmz, q_charge, 75.0) == _brute(
        lib_pmz, lib_charge, q_pmz, q_charge, 75.0)


def test_bound_takes_the_larger_of_operations_and_bytes():
    b = roofline.bound(2_000_000_000, 2_322_432, 16_000, dim=4096, top_k=1,
                       n_sms=132, clock_hz=1.98e9)
    mma_per_s = roofline.BMMA_PER_CLK_SM * 132 * 1.98e9
    assert b["ops_s"] == pytest.approx(2e9 * 4096 / (16 * 8 * 256) / mma_per_s)
    nbytes = (2_322_432 + 16_000) * (128 * 4 + 8) + 4 * 16_000 * 4
    assert b["bytes_s"] == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert b["by"] == "operations" and b["bound_s"] == b["ops_s"]
    few = roofline.bound(1000, 2_322_432, 16_000, dim=4096, top_k=1, n_sms=132,
                         clock_hz=1.98e9)
    assert few["by"] == "bytes" and few["bound_s"] == few["bytes_s"]
