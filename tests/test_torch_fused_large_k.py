"""The fused kernels' design past top_k = 64, where each (query, window)
list lives in device memory and every split of a group inserts into it:
the numpy mirror of csrc/fused_grouped.cuh (tests/test_torch_fused_designs.py)
and the plain versions held bit for bit against the reference's Pallas
kernels in interpret mode, for both routes, at k = 65 on one tile and at
k = 65 past the rows a tile scans (ranks padded with -1). The resident
pipeline at top_k = 100 is checked in tests/test_torch_fused_designs.py."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from test_torch_fused_designs import check_design_against_reference  # noqa: E402

# (W, starts, n_rows, rk, n_splits): one tile scanning 256 rows, and one
# whose scan is cut at the last row to 30 rows, 6 of them padding.
LARGE_K_CASES = {"one tile": (8, [0], 300, 256, 2),
                 "k past the rows scanned": (8, [270], 300, 64, 2)}


@pytest.mark.parametrize("route", ["binary", "pm1"])
@pytest.mark.parametrize("case", list(LARGE_K_CASES))
def test_device_lists_at_k_65_match_reference_kernel(route, case):
    k = 65
    assert hops.fused_plan(8, k).lists == "global"
    want = check_design_against_reference(route, *LARGE_K_CASES[case], k, 65,
                                          lists="global")
    std_row, open_row = want[1], want[3]
    if case == "one tile":
        assert (open_row[:, k - 1] >= 0).any()             # some list is full
    else:
        # at most the 24 real rows scanned: every rank past them is -1/-1
        assert (open_row[:, 24:] == -1).all() and (want[2][:, 24:] == -1).all()
        assert (std_row[:, 24:] == -1).all()
