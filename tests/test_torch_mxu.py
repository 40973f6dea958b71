"""The MXU formulation and the Hamming tile kernels of repro_torch against
the reference, bit-exact: bits_to_pm1 / packed_to_pm1 / hamming_matrix_mxu,
the plain all-pairs tile behind kernel_vpu against the reference's Pallas
tile kernel, and the plain kernel_mxu tile and fused_mxu search against the
reference's Pallas MXU kernels (interpret mode)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as ref_packing  # noqa: E402
from repro.kernels.hamming import ops as ref_hops  # noqa: E402
from repro.kernels.hamming_mxu import ops as ref_mops  # noqa: E402
from repro_torch.convert import packed_to_torch  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.kernels.hamming import ref as href  # noqa: E402
from repro_torch.kernels.hamming_mxu import ops as mops  # noqa: E402
from repro_torch.kernels.hamming_mxu import ref as mref  # noqa: E402


def _words(rng, *shape, distinct=None):
    """Random packed words; with ``distinct``, rows repeat (tie-heavy)."""
    if distinct:
        pool = rng.integers(0, 2 ** 32, (distinct, shape[1]),
                            dtype=np.uint64).astype(np.uint32)
        return pool[rng.integers(0, distinct, shape[0])]
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    edge = np.asarray([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)
    w.reshape(-1)[:4] = edge[:w.size]
    return w


@pytest.mark.parametrize("dtype", ["int8", "int32", "float32"])
def test_bits_and_packed_to_pm1_match_reference(dtype):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, 5, 64)).astype(np.uint8)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_packing.bits_to_pm1(jnp.asarray(bits), dtype=jdt))
    got = packing.bits_to_pm1(torch.from_numpy(bits), dtype=tdt)
    assert got.dtype == tdt and (got.numpy() == want).all()
    assert set(np.unique(want)) == {-1, 1}
    w = _words(rng, 4, 3)
    want = np.asarray(ref_packing.packed_to_pm1(jnp.asarray(w), dtype=jdt))
    got = packing.packed_to_pm1(packed_to_torch(w), dtype=tdt)
    assert got.shape == (4, 96) and (got.numpy() == want).all()


@pytest.mark.parametrize("W,dim", [(4, 128), (4, 100), (7, 224), (130, 4160)])
def test_hamming_matrix_mxu_matches_reference(W, dim):
    """dim 100 cuts into a word; W = 130 sums past int8 and int16's range
    of partial sums, where an int8 matmul would wrap."""
    rng = np.random.default_rng(W + dim)
    q, r = _words(rng, 5, W), _words(rng, 9, W)
    want = np.asarray(ref_packing.hamming_matrix_mxu(jnp.asarray(q),
                                                     jnp.asarray(r), dim))
    got = packing.hamming_matrix_mxu(packed_to_torch(q), packed_to_torch(r), dim)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    if dim == 32 * W:
        assert (want == np.asarray(ref_packing.hamming_matrix_packed(
            jnp.asarray(q), jnp.asarray(r)))).all()


@pytest.mark.parametrize("Q,R,W", [(16, 256, 8), (5, 37, 7), (17, 300, 4),
                                   (3, 11, 1)])
def test_hamming_matrix_plain_matches_reference_kernel(Q, R, W):
    """The kernel_vpu tile: shapes that are not tile multiples included."""
    rng = np.random.default_rng(Q * R * W)
    q, r = _words(rng, Q, W), _words(rng, R, W, distinct=6)
    want = np.asarray(ref_hops.hamming_matrix(jnp.asarray(q), jnp.asarray(r),
                                              interpret=True))
    before = hops.matrix_launches.count
    got = hops.hamming_matrix(packed_to_torch(q), packed_to_torch(r))
    assert hops.matrix_launches.count == before      # CPU: plain version
    assert got.dtype == torch.int32 and got.shape == (Q, R)
    assert (got.numpy() == want).all()
    assert (href.hamming_matrix(packed_to_torch(q), packed_to_torch(r)).numpy()
            == want).all()


@pytest.mark.parametrize("Q,R,W", [(16, 256, 4), (5, 37, 7), (33, 300, 2)])
def test_hamming_mxu_plain_matches_reference_kernel(Q, R, W):
    rng = np.random.default_rng(Q + R + W)
    q, r = _words(rng, Q, W), _words(rng, R, W, distinct=6)
    want = np.asarray(ref_mops.hamming_matrix(jnp.asarray(q), jnp.asarray(r),
                                              32 * W, interpret=True))
    before = mops.matrix_launches.count
    got = mops.hamming_matrix(packed_to_torch(q), packed_to_torch(r), 32 * W)
    assert mops.matrix_launches.count == before
    assert (got.numpy() == want).all()
    assert (mref.hamming_matrix(packed_to_torch(q), packed_to_torch(r),
                                32 * W).numpy() == want).all()


def _tie_heavy_case(rng, W, n_rows=300, n_q=48):
    r = _words(rng, n_rows, W, distinct=5)
    rp = rng.uniform(400.0, 1800.0, n_rows).astype(np.float32)
    rc = np.asarray([2, 3], np.int32)[rng.integers(0, 2, n_rows)]
    rp[250:] = np.float32(np.finfo(np.float32).max)        # padding rows
    rc[250:] = -1
    src = rng.integers(0, 250, n_q)
    q = r[src].copy()
    qp = (rp[src] + rng.uniform(-60, 60, n_q)).astype(np.float32)
    qp[::5] = rp[src][::5]                                 # std-window hits
    return q, r, qp, rp, rc[src].copy(), rc


@pytest.mark.parametrize("k", [1, 2])
def test_fused_mxu_plain_matches_reference_kernel(k):
    rng = np.random.default_rng(20 + k)
    W, q_block, rk = 4, 16, 96
    q, r, qp, rp, qc, rc = _tie_heavy_case(rng, W)
    starts = [0, 100, 204]
    want = []
    for b, s in enumerate(starts):
        qs, rs = slice(b * q_block, (b + 1) * q_block), slice(s, s + rk)
        ss, si, os_, oi = (np.asarray(x) for x in ref_mops.fused_search(
            *(jnp.asarray(x) for x in (q[qs], r[rs], qp[qs], rp[rs], qc[qs], rc[rs])),
            dim=32 * W, k=k, interpret=True))
        want.append((ss, np.where(si >= 0, si + s, -1), os_,
                     np.where(oi >= 0, oi + s, -1)))
    want = [np.concatenate(c) for c in zip(*want)]
    args = (packed_to_torch(q), torch.from_numpy(qp), torch.from_numpy(qc),
            packed_to_torch(r), torch.from_numpy(rp), torch.from_numpy(rc),
            torch.tensor(starts, dtype=torch.int32))
    kw = dict(q_block=q_block, rk=rk, dim=32 * W, k=k)
    before = mops.launches.count
    got = mops.fused_search(*args, **kw)
    assert mops.launches.count == before
    popc = hops.fused_search(*args, **kw)
    assert int((want[3] >= 0).sum()) > 0 and (want[0][:, 0] >= 0).any()
    for w, g, p in zip(want, got, popc):
        assert (w == g.numpy()).all()
        assert (w == p.numpy()).all()             # fused_mxu == fused


def test_mxu_wrappers_require_dim_of_whole_words():
    q = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dim == 32"):
        mops.hamming_matrix(q, q, 100)
    z = torch.zeros((16,), dtype=torch.float32)
    with pytest.raises(ValueError, match="dim == 32"):
        mops.fused_search(torch.zeros((16, 4), dtype=torch.int32), z,
                          z.to(torch.int32), q, z[:2], z[:2].to(torch.int32),
                          torch.zeros((1,), dtype=torch.int32), q_block=16,
                          rk=2, dim=96, k=1)
    with pytest.raises(ValueError, match="dim == 32"):
        ref_mops.hamming_matrix(jnp.zeros((2, 4), jnp.uint32),
                                jnp.zeros((2, 4), jnp.uint32), 100)
