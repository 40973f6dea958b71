"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and xlstm-1.3b
against the reference's, on the CPU in float32, on the reference's own
init: within max |Δ| / max |ref| < 1e-4 (``_torch_lm.TOL``), token ids
equal.

Covered: ``mlstm_parallel`` in both formulations (whole and ragged last
chunks), ``mlstm_step``, ``_mlstm_state_from_sequence`` against S steps,
``mlstm_block_apply`` and ``slstm_block_apply`` with and without caches
and in decode, and xlstm forward, loss, prefill cache, decode,
``generate`` and decode against the full forward."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import xlstm as RX  # noqa: E402
from repro_torch.models import xlstm as PX  # noqa: E402
from _torch_lm import (B, TOL, check_generate, check_model,  # noqa: E402
                       decode_matches_full_forward, rel_err, smoke_cfgs)

NH, DH, D = 2, 8, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv_gates(S, seed):
    """q/k/v (B,NH,S,DH) and pre-activation gates (B,NH,S) spread wide
    enough that the stabilisers matter."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, NH, S, DH)).astype(np.float32) for _ in range(3))
    ig = (rng.standard_normal((B, NH, S)) * 3).astype(np.float32)
    fg = (rng.standard_normal((B, NH, S)) * 2 + 2).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("S,chunk", [(16, 4), (13, 4), (9, 32), (40, 16)])
@pytest.mark.parametrize("separable", [True, False])
def test_mlstm_parallel(S, chunk, separable):
    args = _qkv_gates(S, S)
    ref = RX.mlstm_parallel(*map(jnp.asarray, args), chunk=chunk, separable=separable)
    out = PX.mlstm_parallel(*map(_t, args), chunk=chunk, separable=separable)
    assert rel_err(out, ref) < TOL
    other = PX.mlstm_parallel(*map(_t, args), chunk=chunk, separable=not separable)
    assert rel_err(other, ref) < TOL


def _state(rng):
    return {"C": rng.standard_normal((B, NH, DH, DH)).astype(np.float32),
            "n": rng.standard_normal((B, NH, DH)).astype(np.float32),
            "m": rng.standard_normal((B, NH)).astype(np.float32)}


def test_mlstm_step():
    q, k, v, ig, fg = _qkv_gates(1, 3)
    st = _state(np.random.default_rng(4))
    args = (q[:, :, 0], k[:, :, 0], v[:, :, 0], ig[..., 0], fg[..., 0])
    h_r, st_r = RX.mlstm_step(*map(jnp.asarray, args), {k_: jnp.asarray(a) for k_, a in st.items()})
    h, st_p = PX.mlstm_step(*map(_t, args), {k_: _t(a) for k_, a in st.items()})
    assert rel_err(h, h_r) < TOL
    for n in ("C", "n", "m"):
        assert rel_err(st_p[n], st_r[n]) < TOL, n


@pytest.mark.parametrize("S", [1, 12])
def test_state_from_sequence_against_steps(S):
    q, k, v, ig, fg = _qkv_gates(S, 5)
    closed = PX._mlstm_state_from_sequence(*map(_t, (q, k, v, ig, fg)))
    ref = RX._mlstm_state_from_sequence(*map(jnp.asarray, (q, k, v, ig, fg)))
    st = {"C": torch.zeros(B, NH, DH, DH), "n": torch.zeros(B, NH, DH),
          "m": torch.full((B, NH), -1e30)}
    for t in range(S):
        _, st = PX.mlstm_step(*(_t(a[:, :, t]) for a in (q, k, v)), _t(ig[..., t]),
                              _t(fg[..., t]), st)
    # the step recurrence keeps m as the running max, the closed form as the
    # final max: the same state up to the common factor exp(m_step - m_closed)
    scale = torch.exp(st["m"] - closed["m"])
    assert rel_err(closed["m"], ref["m"]) < TOL
    for n in ("C", "n"):
        assert rel_err(closed[n], ref[n]) < TOL, n
        s = scale[..., None, None] if n == "C" else scale[..., None]
        assert rel_err(st[n] * s, closed[n]) < TOL, n


def _cell_params(kind, seed=0):
    init = (RX.mlstm_init(jax.random.PRNGKey(seed), D, NH, 4, jnp.float32) if kind == "mlstm"
            else RX.slstm_init(jax.random.PRNGKey(seed), D, NH, jnp.float32))
    p = jax.tree_util.tree_map(np.asarray, init)
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}


def _cache(kind, rng):
    if kind == "mlstm":
        dh = 2 * D // NH
        return {"C": rng.standard_normal((B, NH, dh, dh)).astype(np.float32),
                "n": rng.standard_normal((B, NH, dh)).astype(np.float32),
                "m": rng.standard_normal((B, NH)).astype(np.float32),
                "conv": rng.standard_normal((B, 3, 2 * D)).astype(np.float32)}
    return {"c": rng.standard_normal((B, D)).astype(np.float32),
            "n": (np.abs(rng.standard_normal((B, D))) + 0.5).astype(np.float32),
            "h": rng.standard_normal((B, D)).astype(np.float32),
            "m": rng.standard_normal((B, D)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["no cache", "prefill", "prefill shorter than the conv",
                                  "decode"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply(kind, mode):
    rp, pp = _cell_params(kind)
    rng = np.random.default_rng(6)
    S = {"decode": 1, "prefill shorter than the conv": 2}.get(mode, 13)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cache = None if mode == "no cache" else _cache(kind, rng)
    rc = None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()}
    pc = None if cache is None else {k: _t(v) for k, v in cache.items()}
    decode = mode == "decode"
    if kind == "mlstm":
        out_r, c_r = RX.mlstm_block_apply(rp, jnp.asarray(x), NH, cache=rc, decode=decode,
                                          chunk=4)
        out, c = PX.mlstm_block_apply(pp, _t(x), NH, cache=pc, decode=decode, chunk=4)
    else:
        out_r, c_r = RX.slstm_block_apply(rp, jnp.asarray(x), NH, cache=rc, decode=decode)
        out, c = PX.slstm_block_apply(pp, _t(x), NH, cache=pc, decode=decode)
    assert rel_err(out, out_r) < TOL
    assert (c is None) == (c_r is None)
    if c is not None:
        assert c.keys() == c_r.keys()
        for k in c:
            assert rel_err(c[k], c_r[k]) < TOL, k


def test_xlstm_matches_reference():
    check_model(*smoke_cfgs("xlstm-1.3b"))


def test_xlstm_generate_matches_reference():
    check_generate(*smoke_cfgs("xlstm-1.3b"), P=12, gen=6)


def test_xlstm_decode_matches_full_forward():
    decode_matches_full_forward(smoke_cfgs("xlstm-1.3b")[1])
