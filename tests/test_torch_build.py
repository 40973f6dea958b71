"""The kernel build of repro_torch without nvcc: the build key covers every
source and header under csrc/, and the CUDA wrappers refuse tensors on a
device that is neither the CPU nor CUDA instead of falling back."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.kernels.hamming_mxu import ops as mops  # noqa: E402


def test_build_key_covers_headers(tmp_path, monkeypatch):
    (tmp_path / "a" / "csrc").mkdir(parents=True)
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "a" / "csrc" / "k.cu"
    cuh = tmp_path / "csrc" / "shared.cuh"
    h = tmp_path / "csrc" / "consts.h"
    src.write_text('#include "../../csrc/shared.cuh"\n')
    cuh.write_text("// v1\n")
    h.write_text("#define N 1\n")
    (tmp_path / "a" / "notes.py").write_text("x = 1\n")
    monkeypatch.setattr(_build, "_KERNELS_DIR", tmp_path)
    assert _build.sources() == [src]
    assert _build.headers() == sorted([cuh, h])
    key = _build._digest()
    assert _build._digest() == key
    (tmp_path / "a" / "notes.py").write_text("x = 2\n")
    assert _build._digest() == key                 # not a kernel file
    cuh.write_text("// v2\n")
    key2 = _build._digest()
    assert key2 != key                             # a header alone rebuilds
    h.write_text("#define N 2\n")
    assert _build._digest() not in (key, key2)
    src.write_text('#include "../../csrc/shared.cuh"\n// edit\n')
    assert _build._digest() not in (key, key2)


def test_repository_kernels_and_headers_are_found():
    names = {p.name for p in _build.sources()}
    assert {"fused_search.cu", "hamming_matrix.cu", "hdencode.cu",
            "hamming_mxu.cu", "fused_search_mxu.cu", "errors.cu"} <= names
    assert {p.name for p in _build.headers()} >= {"winners.cuh", "pm1_mma.cuh",
                                                   "fused_grouped.cuh", "bmma.cuh"}
    assert len(_build._digest()) == 16
    assert set(_build._SIGNATURES) >= {
        "hamming_matrix_launch", "hamming_mxu_launch", "fused_search_launch",
        "fused_search_mxu_launch"}


@pytest.mark.parametrize("kernel", ["hamming_matrix", "hamming_mxu",
                                    "fused_search", "fused_search_mxu"])
def test_wrappers_refuse_other_devices(kernel):
    """A tensor that is on neither the CPU nor CUDA gets no plain fallback."""
    meta = dict(device="meta")
    q = torch.empty((16, 4), dtype=torch.int32, **meta)
    before = (hops.launches.count, hops.matrix_launches.count,
              mops.launches.count, mops.matrix_launches.count)
    with pytest.raises(ValueError, match="unsupported device meta"):
        if kernel == "hamming_matrix":
            hops.hamming_matrix(q, q)
        elif kernel == "hamming_mxu":
            mops.hamming_matrix(q, q, 128)
        else:
            pmz = torch.empty((16,), dtype=torch.float32, **meta)
            ch = torch.empty((16,), dtype=torch.int32, **meta)
            start = torch.empty((1,), dtype=torch.int32, **meta)
            fn = hops.fused_search if kernel == "fused_search" else mops.fused_search
            fn(q, pmz, ch, q, pmz, ch, start, q_block=16, rk=16, dim=128, k=1)
    assert before == (hops.launches.count, hops.matrix_launches.count,
                      mops.launches.count, mops.matrix_launches.count)


# (kernel, top_k, W in words) -> (query tiles per CTA, lists, staged query
# words) of fused_plan, which mirrors csrc/fused_grouped.cuh's
# launch_grouped: shared lists where k <= 64 and one tile's queries, lists,
# rings and scratch fit in 225,280 bytes (64 * ceil16(W) + 256 * k +
# 65,536, + 4,096 for fused_search_mxu's A slice; G = 8 where 8 tiles fit),
# else lists in device memory with G = 8 and the queries staged whole or in
# 32-word multiples (288 words a chunk, 224 with the A slices).
FUSED_PLANS = [("fused_search", 16, 128, (8, "shared", 128)),
               ("fused_search", 64, 2240, (1, "shared", 2240)),
               ("fused_search", 65, 128, (8, "global", 128)),
               ("fused_search", 1, 2496, (8, "global", 288)),
               ("fused_search_mxu", 1, 2416, (1, "shared", 2416)),
               ("fused_search_mxu", 1024, 4096, (8, "global", 224))]


@pytest.mark.parametrize("kernel,k,W,plan", FUSED_PLANS)
def test_fused_plan(kernel, k, W, plan):
    """The path the fused wrappers take at each (kernel, k, W); a shared
    plan at the edge of its bound goes to device lists one step past it."""
    scratch = mops.FUSED_SCRATCH_PER_TILE if kernel == "fused_search_mxu" else 0
    assert hops.fused_plan(W, k, scratch) == plan
    if plan[1] == "shared" and plan[0] == 1:
        assert hops.fused_smem_bytes(1, W, k, scratch) <= hops.FUSED_SMEM_BUDGET
        assert hops.fused_plan(W + 16, k, scratch).lists == "global"
    if plan[1] == "shared":
        assert hops.fused_plan(W, hops.K_SHARED + 1, scratch).lists == "global"


@pytest.mark.parametrize("scratch", [0, 8 * 32 * 16])
def test_main_path_keeps_eight_tiles_per_cta_up_to_k16(scratch):
    """At the main path's 128 words the grouped launch keeps G = 8 tiles per
    CTA for every k <= 16, as before the top_k cap was lifted."""
    for k in (1, 4, 16):
        assert hops.fused_smem_bytes(hops.GROUP, 128, k, scratch) <= hops.FUSED_SMEM_BUDGET
    assert hops.fused_smem_bytes(hops.GROUP, 128, 64, scratch) > hops.FUSED_SMEM_BUDGET


@pytest.mark.parametrize("k", [17, 32, 64])
def test_fused_wrappers_take_top_k_above_16_on_the_cpu(k):
    g = torch.Generator().manual_seed(k)
    r = torch.randint(-2 ** 31, 2 ** 31 - 1, (96, 4), generator=g, dtype=torch.int32)
    q = r[:16].clone()
    pmz = torch.linspace(500.0, 501.0, 96)
    ch = torch.full((96,), 2, dtype=torch.int32)
    start = torch.zeros((1,), dtype=torch.int32)
    args = (q, pmz[:16], ch[:16], r, pmz, ch, start)
    kw = dict(q_block=16, rk=96, dim=128, k=k)
    a, b = hops.fused_search(*args, **kw), mops.fused_search(*args, **kw)
    for x, y in zip(a, b):
        assert x.shape == (16, k) and torch.equal(x, y)
    assert (a[3] >= 0).sum() == 16 * k        # every rank filled (96 >= k rows)
