"""The port's FDR variants against the reference's: pooled, per-query (one
competition per query's own top-k list) and shift-grouped (separate
competitions for the standard and the open population), on the same seeded
numpy inputs, with heavy score ties and all-invalid rows; q-values, accept
flags and counts must be identical."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fdr as ref_fdr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fdr  # noqa: E402


def _inputs(shape, seed, *, invalid_rows=()):
    rng = np.random.default_rng(seed)
    scores = rng.integers(100, 106, shape).astype(np.float32)    # heavy ties
    decoy = rng.random(shape) < 0.3
    valid = rng.random(shape) < 0.85
    in_narrow = rng.random(shape) < 0.5
    for r in invalid_rows:
        valid[r] = False
    return scores, decoy, valid, in_narrow


def _assert_fdr_equal(want, got):
    got = convert.fdr_result_to_numpy(got)
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        assert w.shape == got[f].shape and (w == got[f]).all(), f


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("shape,invalid_rows", [((40, 3), (0, 7)), ((64, 1), (5,)),
                                                ((7, 16), ()), ((1, 5), (0,))])
@pytest.mark.parametrize("threshold", [0.01, 0.25, 1.0])
def test_per_query_matches_reference(shape, invalid_rows, threshold):
    scores, decoy, valid, _ = _inputs(shape, sum(shape), invalid_rows=invalid_rows)
    want = ref_fdr.fdr_filter_per_query(jnp.asarray(scores), jnp.asarray(decoy),
                                        jnp.asarray(valid), threshold=threshold)
    got = fdr.fdr_filter_per_query(*_t(scores, decoy, valid), threshold=threshold)
    _assert_fdr_equal(want, got)
    for r in invalid_rows:      # an all-invalid row reports 1.0 and accepts nothing
        assert (got.q_values[r] == 1.0).all() and not got.accept[r].any()


@pytest.mark.parametrize("shape", [(50,), (40, 3), (9, 16)])
@pytest.mark.parametrize("threshold", [0.01, 0.25])
def test_grouped_matches_reference(shape, threshold):
    scores, decoy, valid, in_narrow = _inputs(shape, 3 + len(shape))
    args = (scores, decoy, valid, in_narrow)
    want = ref_fdr.fdr_filter_grouped(*map(jnp.asarray, args), threshold=threshold)
    got = fdr.fdr_filter_grouped(*_t(*args), threshold=threshold)
    _assert_fdr_equal(want, got)
    q_want = ref_fdr.compute_q_values_grouped(*map(jnp.asarray, args))
    assert (np.asarray(q_want) == fdr.compute_q_values_grouped(*_t(*args)).numpy()).all()


@pytest.mark.parametrize("narrow_share", [0.0, 1.0])
def test_grouped_with_one_empty_population(narrow_share):
    """All matches in one subgroup: the grouped q-values are the pooled
    ones, as in the reference."""
    scores, decoy, valid, _ = _inputs((30, 2), 11)
    in_narrow = np.full((30, 2), narrow_share > 0.5)
    args = (scores, decoy, valid, in_narrow)
    want = ref_fdr.fdr_filter_grouped(*map(jnp.asarray, args))
    got = fdr.fdr_filter_grouped(*_t(*args))
    _assert_fdr_equal(want, got)
    pooled = fdr.fdr_filter(*_t(scores, decoy, valid))
    assert (got.q_values == pooled.q_values).all()


def test_pooled_still_matches_reference_after_the_row_refactor():
    scores, decoy, valid, _ = _inputs((33, 4), 21, invalid_rows=(2,))
    want = ref_fdr.fdr_filter(*map(jnp.asarray, (scores, decoy, valid)))
    _assert_fdr_equal(want, fdr.fdr_filter(*_t(scores, decoy, valid)))


def test_per_query_is_independent_of_batchmates():
    """A query's per-query decision depends only on its own list."""
    scores, decoy, valid, _ = _inputs((24, 4), 5)
    full = fdr.fdr_filter_per_query(*_t(scores, decoy, valid), threshold=0.3)
    alone = fdr.fdr_filter_per_query(*_t(scores[3:4], decoy[3:4], valid[3:4]),
                                     threshold=0.3)
    assert (full.q_values[3] == alone.q_values[0]).all()
    assert (full.accept[3] == alone.accept[0]).all()


def test_validation_matches_reference():
    scores, decoy, valid, in_narrow = _inputs((6,), 1)
    with pytest.raises(ValueError, match=r"\(Q, k\)"):
        fdr.fdr_filter_per_query(*_t(scores, decoy, valid))
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="threshold"):
            fdr.fdr_filter_grouped(*_t(scores, decoy, valid, in_narrow), threshold=bad)
        with pytest.raises(ValueError, match="threshold"):
            fdr.fdr_filter_per_query(*_t(scores[None], decoy[None], valid[None]),
                                     threshold=bad)
