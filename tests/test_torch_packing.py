"""repro_torch.core.packing against repro.core.packing: pack/unpack,
popcount and Hamming, bit-exact, high-bit words included."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as ref  # noqa: E402
from repro_torch.convert import packed_to_numpy, packed_to_torch  # noqa: E402
from repro_torch.core import packing  # noqa: E402


def _words(rng, *shape):
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    return w


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 96), (1, 32)])
def test_pack_unpack_match_reference(shape):
    bits = np.random.default_rng(len(shape)).integers(0, 2, shape).astype(np.uint8)
    bits[..., 31] = 1                       # every word has its high bit set
    want = np.asarray(ref.pack_bits(jnp.asarray(bits)))
    got = packing.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert (packed_to_numpy(got) == want).all()
    back = packing.unpack_bits(got)
    assert (back.numpy() == np.asarray(ref.unpack_bits(jnp.asarray(want)))).all()
    assert (back.numpy() == bits).all()
    cut = packing.unpack_bits(got, dim=shape[-1] - 7).numpy()
    assert (cut == bits[..., :shape[-1] - 7]).all()


def test_popcount_matches_reference():
    w = _words(np.random.default_rng(0), 4, 257)
    want = np.asarray(ref.popcount(jnp.asarray(w)))
    got = packing.popcount(packed_to_torch(w))
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


def test_hamming_matches_reference():
    rng = np.random.default_rng(1)
    q, r = _words(rng, 5, 8), _words(rng, 9, 8)
    want = np.asarray(ref.hamming_matrix_packed(jnp.asarray(q), jnp.asarray(r)))
    got = packing.hamming_matrix_packed(packed_to_torch(q), packed_to_torch(r))
    assert (got.numpy() == want).all()
    pair = packing.hamming_packed(packed_to_torch(q[:, None]), packed_to_torch(r[None]))
    assert (pair.numpy() == want).all()
    want_pairs = np.asarray(ref.hamming_packed(jnp.asarray(q), jnp.asarray(r[:5])))
    got_pairs = packing.hamming_packed(packed_to_torch(q), packed_to_torch(r[:5]))
    assert (got_pairs.numpy() == want_pairs).all()


def test_n_words_rejects_ragged_dim():
    assert packing.n_words(4096) == 128
    with pytest.raises(ValueError):
        packing.n_words(100)
