"""The port's RG-LRU block (``repro_torch.models.rglru``) and
recurrentgemma-9b against the reference's, on the CPU in float32, on the
reference's own init: within max |Δ| / max |ref| < 1e-4
(``_torch_lm.TOL``), token ids equal.

Covered: the causal conv with and without its history, ``rglru_scan``
(the log-depth scan) against ``rglru_step`` run S times and both against
the reference, ``rec_block_apply`` prefill and decode with their caches,
recurrentgemma forward, loss, prefill cache, decode, ``generate`` and
decode against the full forward, and the reference's
``test_subquadratic_state_is_bounded`` for both sub-quadratic archs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import rglru as RG  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.models import rglru as PG  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from _torch_lm import (B, TOL, check_generate, check_model,  # noqa: E402
                       decode_matches_full_forward, rel_err, smoke_cfgs)

W, D = 24, 16


def _params(seed=0):
    p = jax.tree_util.tree_map(np.asarray, RG.rglru_init(
        jax.random.PRNGKey(seed), D, W, 4, jnp.float32))
    rng = np.random.default_rng(seed)     # non-zero biases exercise the gates
    for k in ("b_a", "b_x", "conv_b"):
        p[k] = rng.standard_normal(W).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 7, W)).astype(np.float32)
    w = rng.standard_normal((4, W)).astype(np.float32)
    b = rng.standard_normal(W).astype(np.float32)
    st = rng.standard_normal((B, 3, W)).astype(np.float32) if with_state else None
    ref, ref_st = RG._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  None if st is None else jnp.asarray(st))
    out, new_st = PG.causal_conv(_t(x), _t(w), _t(b), None if st is None else _t(st))
    assert rel_err(out, ref) < TOL and rel_err(new_st, ref_st) < TOL


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_rglru_scan_against_steps_and_reference(S):
    rp, pp = _params()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    for h in (None, h0):
        y_r, hl_r = RG.rglru_scan(rp, jnp.asarray(x), None if h is None else jnp.asarray(h))
        y, hl = PG.rglru_scan(pp, _t(x), None if h is None else _t(h))
        assert hl.dtype == torch.float32
        assert rel_err(y, y_r) < TOL and rel_err(hl, hl_r) < TOL
        # the same recurrence one step at a time
        hs, ys = torch.zeros(B, W) if h is None else _t(h), []
        for t in range(S):
            yt, hs = PG.rglru_step(pp, _t(x[:, t:t + 1]), hs)
            ys.append(yt)
        assert rel_err(torch.cat(ys, 1), y_r) < TOL and rel_err(hs, hl_r) < TOL
    y1_r, h1_r = RG.rglru_step(rp, jnp.asarray(x[:, :1]), jnp.asarray(h0))
    y1, h1 = PG.rglru_step(pp, _t(x[:, :1]), _t(h0))
    assert rel_err(y1, y1_r) < TOL and rel_err(h1, h1_r) < TOL


@pytest.mark.parametrize("mode", ["no cache", "prefill", "decode"])
def test_rec_block_apply(mode):
    rp, pp = _params()
    rng = np.random.default_rng(3)
    S = 1 if mode == "decode" else 11
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cache = None
    if mode != "no cache":
        cache = {"h": rng.standard_normal((B, W)).astype(np.float32),
                 "conv": rng.standard_normal((B, 3, W)).astype(np.float32)}
    decode = mode == "decode"
    out_r, c_r = RG.rec_block_apply(rp, jnp.asarray(x), decode=decode, cache=None if cache is None
                                    else {k: jnp.asarray(v) for k, v in cache.items()})
    out, c = PG.rec_block_apply(pp, _t(x), decode=decode, cache=None if cache is None
                                else {k: _t(v) for k, v in cache.items()})
    assert rel_err(out, out_r) < TOL
    assert (c is None) == (c_r is None)
    if c is not None:
        assert c.keys() == c_r.keys()
        for k in c:
            assert c[k].dtype == getattr(torch, str(c_r[k].dtype))
            assert rel_err(c[k], c_r[k]) < TOL, k


def test_recurrentgemma_matches_reference():
    check_model(*smoke_cfgs("recurrentgemma-9b"))


def test_recurrentgemma_generate_matches_reference():
    check_generate(*smoke_cfgs("recurrentgemma-9b"), P=20, gen=6)


def test_recurrentgemma_decode_matches_full_forward():
    decode_matches_full_forward(smoke_cfgs("recurrentgemma-9b")[1])


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_subquadratic_state_is_bounded(name):
    """long_500k applicability: the decode state does not grow with the
    history (the local window is clamped, the recurrent state fixed), and
    its bytes equal the reference's."""
    ref_cfg, cfg = smoke_cfgs(name)

    def nbytes(c):
        return sum(t.numel() * t.element_size() for d in c.values() for t in d.values())

    c1, c2 = PT.init_cache(cfg, B, 64, "cpu"), PT.init_cache(cfg, B, 32, "cpu")
    assert nbytes(c1) <= nbytes(c2) * 3
    for S, c in ((64, c1), (32, c2)):
        ref = RT.init_cache(ref_cfg, B, S)
        assert nbytes(c) == sum(a.nbytes for a in jax.tree_util.tree_leaves(ref))
