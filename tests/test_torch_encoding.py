"""Preprocessing, every encode backend and the hdencode plain version of
repro_torch against the reference, bit-exact (bins, levels, masks, HVs)."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import encode_backends as ref_backends  # noqa: E402
from repro.core import encoding as ref_encoding  # noqa: E402
from repro.kernels.hdencode import ops as ref_hd  # noqa: E402
from repro_torch.convert import codebooks_from_reference, packed_to_numpy  # noqa: E402
from repro_torch.core import encode_backends, encoding  # noqa: E402
from repro_torch.kernels.hdencode import ops as hd_ops  # noqa: E402
from repro_torch.kernels.hdencode import ref as hd_ref  # noqa: E402

PP = encoding.PreprocessParams(bin_size=1.0, mz_min=200.0, mz_max=2000.0, n_levels=8)
REF_PP = ref_encoding.PreprocessParams(*PP)


@functools.lru_cache(maxsize=None)
def _codebooks(dim, n_levels=8, n_bins=1800, seed=0):
    cb = ref_encoding.make_codebooks(jax.random.PRNGKey(seed), n_bins=n_bins,
                                     n_levels=n_levels, dim=dim)
    return cb, codebooks_from_reference(cb.id_hvs, cb.level_hvs, cb.tiebreak, dim)


def _raw(rng, B, P):
    mz = rng.uniform(PP.mz_min, PP.mz_max, (B, P)).astype(np.float32)
    inten = rng.gamma(2.0, 1.0, (B, P)).astype(np.float32)
    inten[:, P - 2:] = 0.0                  # padded peak slots
    inten[0, :] = 0.0                       # one all-masked spectrum
    pmz = rng.uniform(400.0, 1800.0, (B,)).astype(np.float32)
    charge = rng.integers(2, 4, (B,)).astype(np.int32)
    return mz, inten, pmz, charge


def _boundary_raw():
    """Peaks exactly on the 0.05 Da bin grid and intensities whose level
    sits on a rounding edge."""
    rng = np.random.default_rng(3)
    B, P = 11, 13
    k = rng.integers(0, 36000, (B, P))
    mz = (200.0 + k * 0.05).astype(np.float32)
    inten = rng.gamma(2.0, 1.0, (B, P)).astype(np.float32)
    inten[:, 0] = 1.0
    inten[:, 1] = np.float32((2.5 / 31) ** 2)
    pmz = rng.uniform(400.0, 1800.0, (B,)).astype(np.float32)
    charge = rng.integers(2, 4, (B,)).astype(np.int32)
    return mz, inten, pmz, charge


def _level_edge_raw(n_levels, B=512, P=64):
    """Many spectra whose peaks sit on level rounding edges: intensity
    ratios ((m - 0.5) / (n_levels - 1))^2 to a random base peak, so each
    level decision rests on the last bit of a correctly rounded sqrt (and
    the batch is large enough for torch's vectorised CPU kernels)."""
    rng = np.random.default_rng(7)
    mz = rng.uniform(PP.mz_min, PP.mz_max, (B, P)).astype(np.float32)
    base = rng.uniform(1.0, 1000.0, (B, 1)).astype(np.float32)
    m = rng.integers(1, n_levels, (B, P))
    inten = (base * ((m - 0.5) / (n_levels - 1)) ** 2).astype(np.float32)
    inten[:, 0] = base[:, 0]
    pmz = rng.uniform(400.0, 1800.0, (B,)).astype(np.float32)
    charge = rng.integers(2, 4, (B,)).astype(np.int32)
    return mz, inten, pmz, charge


@pytest.mark.parametrize("n_levels", [8, 32])
@pytest.mark.parametrize("boundary", [False, True, "level_edges"])
def test_preprocess_matches_reference(boundary, n_levels):
    raw = (_level_edge_raw(n_levels) if boundary == "level_edges" else
           _boundary_raw() if boundary else _raw(np.random.default_rng(1), 17, 29))
    kw = dict(bin_size=0.05, mz_min=200.0, mz_max=2000.0, n_levels=n_levels)
    want = ref_encoding.preprocess_spectra(*(jnp.asarray(x) for x in raw), **kw)
    got = encoding.preprocess_spectra(*(torch.from_numpy(x) for x in raw), **kw)
    for f in ("bins", "levels", "mask", "pmz", "charge"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and (w == g).all(), f


@pytest.mark.parametrize("backend", encode_backends.names())
@pytest.mark.parametrize("B,P,W,batch", [(23, 17, 7, 8), (16, 33, 8, 16), (3, 5, 2, 512)])
def test_backend_matches_reference_oracle(backend, B, P, W, batch):
    ref_cb, cb = _codebooks(W * 32)
    raw = _raw(np.random.default_rng(B * P), B, P)
    want = ref_backends.preprocess_encode(*(jnp.asarray(x) for x in raw), ref_cb,
                                          REF_PP, backend="oracle", batch=batch)
    got = encode_backends.preprocess_encode(*(torch.from_numpy(x) for x in raw), cb,
                                            PP, backend=backend, batch=batch)
    assert (packed_to_numpy(got[0]) == np.asarray(want[0])).all()
    assert (got[1].numpy() == np.asarray(want[1])).all()
    assert (got[2].numpy() == np.asarray(want[2])).all()


@pytest.mark.parametrize("backend", encode_backends.names())
def test_backend_on_bin_boundary_peaks(backend):
    pp = encoding.PreprocessParams(bin_size=0.05, mz_min=200.0, mz_max=2000.0,
                                   n_levels=32)
    ref_cb, cb = _codebooks(128, n_levels=32, n_bins=36000, seed=3)
    raw = _boundary_raw()
    want = ref_backends.preprocess_encode(
        *(jnp.asarray(x) for x in raw), ref_cb,
        ref_encoding.PreprocessParams(*pp), backend="oracle", batch=4)
    got = encode_backends.preprocess_encode(*(torch.from_numpy(x) for x in raw),
                                            cb, pp, backend=backend, batch=4)
    assert (packed_to_numpy(got[0]) == np.asarray(want[0])).all()


def _tie_spectra(rng, B, P, F, L):
    """Spectra with even peak counts (two distinct peaks tie wherever their
    bound HVs differ), odd counts, and an all-masked row."""
    bins = rng.integers(0, F, (B, P)).astype(np.int32)
    levels = rng.integers(0, L, (B, P)).astype(np.int32)
    mask = rng.random((B, P)) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, :2] = True
    mask[2] = False
    mask[2, :4] = True
    return bins, levels, mask


@pytest.mark.parametrize("B,P,F,L,W", [(20, 9, 50, 8, 7), (16, 64, 300, 32, 16)])
def test_hdencode_plain_matches_reference_kernel(B, P, F, L, W):
    ref_cb, cb = _codebooks(W * 32, n_levels=L, n_bins=F, seed=B)
    bins, levels, mask = _tie_spectra(np.random.default_rng(B * P), B, P, F, L)
    want = np.asarray(ref_hd.hdencode(jnp.asarray(bins), jnp.asarray(levels),
                                      jnp.asarray(mask), ref_cb.id_hvs,
                                      ref_cb.level_hvs, ref_cb.tiebreak,
                                      interpret=True))
    args = (torch.from_numpy(bins), torch.from_numpy(levels),
            torch.from_numpy(mask), cb.id_hvs, cb.level_hvs, cb.tiebreak)
    plain = hd_ref.hdencode(*args)
    assert (packed_to_numpy(plain) == want).all()
    # On CPU tensors the wrapper runs the plain version and counts nothing.
    before = hd_ops.launches.count
    assert (packed_to_numpy(hd_ops.hdencode(*args)) == want).all()
    assert hd_ops.launches.count == before
    assert (packed_to_numpy(plain[0]) == np.asarray(ref_cb.tiebreak)).all()


def test_encode_spectra_batched_pads_and_slices():
    ref_cb, cb = _codebooks(96)
    bins, levels, mask = _tie_spectra(np.random.default_rng(9), 13, 6, 1800, 8)
    sp = encoding.PreprocessedSpectra(torch.from_numpy(bins), torch.from_numpy(levels),
                                      torch.from_numpy(mask), None, None)
    want = np.asarray(jax.jit(ref_encoding.encode_spectra)(
        ref_encoding.PreprocessedSpectra(jnp.asarray(bins), jnp.asarray(levels),
                                         jnp.asarray(mask), None, None), ref_cb))
    for backend in encode_backends.names(encode_backends.ENCODE):
        got = encoding.encode_spectra_batched(sp, cb, batch=5, backend=backend)
        assert (packed_to_numpy(got) == want).all(), backend
    with pytest.raises(ValueError, match="fused"):
        encoding.encode_spectra_batched(sp, cb, backend="fused")
    with pytest.raises(ValueError, match="registered"):
        encode_backends.get("nope")
