"""repro_torch.core.rng against the installed jax.random (threefry2x32,
partitionable): every draw the pipeline makes must be bit-exact, so the
port regenerates the reference's codebooks and decoys from the seed."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import decoys as ref_decoys  # noqa: E402
from repro.core import encoding as ref_encoding  # noqa: E402
from repro_torch.convert import packed_to_numpy  # noqa: E402
from repro_torch.core import decoys, encoding, rng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 32 - 1, 2 ** 33 + 5]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    assert (_np(k) == kt.numpy()).all()
    for n in (2, 3, 4):
        assert (_np(jax.random.split(k, n)) == rng.split(kt, n).numpy()).all()
    for d in (0, 7, 2 ** 31 + 3, 2 ** 32 - 1):
        assert (_np(jax.random.fold_in(k, d)) == rng.fold_in(kt, d).numpy()).all()
    rows = np.arange(5, dtype=np.uint32) + np.uint32(1000)
    want = jax.vmap(lambda r: jax.random.fold_in(k, r))(rows)
    assert (_np(want) == rng.fold_in(kt, torch.from_numpy(rows.astype(np.int64))).numpy()).all()


@pytest.mark.parametrize("shape", [(7,), (3, 5), (4, 64)])
def test_bits(shape):
    k = jax.random.PRNGKey(3)
    want = _np(jax.random.bits(k, shape, dtype=jnp.uint32))
    assert (want == rng.bits(rng.PRNGKey(3), shape).numpy()).all()


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (200.0, 2000.0), (-75.0, 75.0)])
def test_uniform_bit_exact(minval, maxval):
    k = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    want = np.asarray(jax.random.uniform(k, (20000,), minval=minval, maxval=maxval))
    got = rng.uniform(rng.fold_in(rng.PRNGKey(0), 7), (20000,), minval, maxval)
    assert got.dtype == torch.float32
    assert (got.numpy() == want).all()


def test_bernoulli():
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bernoulli(k, 0.5, (64, 256)))
    assert (rng.bernoulli(rng.PRNGKey(11), 0.5, (64, 256)).numpy() == want).all()
    want = np.asarray(jax.random.bernoulli(k, 0.8, (300,)))
    assert (rng.bernoulli(rng.PRNGKey(11), 0.8, (300,)).numpy() == want).all()


@pytest.mark.parametrize("chunk", [1000, 1 << 20])
def test_cpu_draws_in_chunks_are_the_whole_draw(monkeypatch, chunk):
    """On the CPU one key's draws are hashed in flat runs of ``_CPU_CHUNK``
    counts: at a run of 1,000 (a ragged last run of 37 x 101 = 3,737) and
    at the default past one run (1,100 x 1,024 draws), bits, uniform and
    bernoulli equal jax.random's."""
    monkeypatch.setattr(rng, "_CPU_CHUNK", chunk)
    shape = (37, 101) if chunk == 1000 else (1100, 1024)
    k = jax.random.fold_in(jax.random.PRNGKey(9), 2)
    kt = rng.fold_in(rng.PRNGKey(9), 2)
    assert (_np(jax.random.bits(k, shape, dtype=jnp.uint32)) == rng.bits(kt, shape).numpy()).all()
    want = np.asarray(jax.random.uniform(k, shape, minval=200.0, maxval=2000.0))
    assert (rng.uniform(kt, shape, 200.0, 2000.0).numpy() == want).all()
    want = np.asarray(jax.random.bernoulli(k, 0.5, shape))
    got = rng.bernoulli(kt, 0.5, shape)
    assert got.shape == shape and (got.numpy() == want).all()


@pytest.mark.parametrize("n", [1, 7, 256, 4096])
def test_permutation(n):
    k = jax.random.PRNGKey(n)
    want = np.asarray(jax.random.permutation(k, n))
    assert (rng.permutation(rng.PRNGKey(n), n).numpy() == want).all()


@pytest.mark.parametrize("n_bins,n_levels,dim", [(300, 32, 512), (17, 1, 64)])
def test_make_codebooks_matches_reference(n_bins, n_levels, dim):
    want = ref_encoding.make_codebooks(jax.random.PRNGKey(5), n_bins=n_bins,
                                       n_levels=n_levels, dim=dim)
    got = encoding.make_codebooks(rng.PRNGKey(5), n_bins=n_bins,
                                  n_levels=n_levels, dim=dim)
    assert got.dim == want.dim
    for f in ("id_hvs", "level_hvs", "tiebreak"):
        assert (packed_to_numpy(getattr(got, f)) == np.asarray(getattr(want, f))).all(), f


@pytest.mark.parametrize("row_offset", [0, 4096, 2 ** 32 - 3])
def test_make_decoy_peaks_matches_reference(row_offset):
    r = np.random.default_rng(row_offset % 97)
    mz = r.uniform(200, 2000, (9, 13)).astype(np.float32)
    inten = r.exponential(1.0, (9, 13)).astype(np.float32)
    inten[:, 10:] = 0.0
    k = jax.random.PRNGKey(2)
    want_mz, want_i = ref_decoys.make_decoy_peaks(
        k, jnp.asarray(mz), jnp.asarray(inten), 200.0, 2000.0, row_offset=row_offset)
    got_mz, got_i = decoys.make_decoy_peaks(
        rng.PRNGKey(2), torch.from_numpy(mz), torch.from_numpy(inten), 200.0,
        2000.0, row_offset=row_offset)
    assert (got_mz.numpy() == np.asarray(want_mz)).all()
    assert (got_i.numpy() == np.asarray(want_i)).all()
