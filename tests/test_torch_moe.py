"""The port's MoE FFN (``repro_torch.models.moe``) and the two MoE archs
against the reference's, on the CPU in float32, on the reference's own
``moe_init`` / ``init_params`` weights: within max |Δ| / max |ref| < 1e-4
(``_torch_lm.TOL``), token ids equal.

Covered: ``moe_apply`` at capacity factors 0.5, 1.25 and E (the dropped
copies against a plain loop over the capacity rule, outputs and aux loss
against the reference), a zero router (every probability ties: both
packages take the lowest K experts), shared experts, the four behaviours
of ``tests/test_moe.py``, and olmoe-1b-7b / deepseek-v2-lite-16b forward,
aux, loss, prefill cache, decode and ``generate``, with capacity drops."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as RM  # noqa: E402
from repro.models.layers import ffn_apply as ref_ffn_apply  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models.layers import ffn_apply  # noqa: E402
from _torch_lm import (TOL, check_generate, check_model,  # noqa: E402
                       decode_matches_full_forward, rel_err, smoke_cfgs,
                       with_capacity)

MOE = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]


def _setup(name="olmoe-1b-7b", capacity_factor=1.25, seed=0, shape=(2, 16)):
    """Both configs, the reference's ``moe_init`` params (numpy) and x."""
    ref_cfg, cfg = with_capacity(smoke_cfgs(name), capacity_factor)
    p = jax.tree_util.tree_map(np.asarray, RM.moe_init(jax.random.PRNGKey(seed),
                                                       ref_cfg, jnp.float32))
    x = np.random.default_rng(seed + 1).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, x


def _both(p):
    def conv(d, f):
        return {k: conv(v, f) if isinstance(v, dict) else f(v) for k, v in d.items()}
    return conv(p, jnp.asarray), conv(p, lambda a: torch.from_numpy(np.array(a)))


def _run(ref_cfg, cfg, p, x):
    rp, pp = _both(p)
    out_r, aux_r = RM.moe_apply(rp, jnp.asarray(x), ref_cfg)
    out, aux = PM.moe_apply(pp, torch.from_numpy(x), cfg)
    return (out, float(aux)), (np.asarray(out_r), float(aux_r))


def _kept_by_loop(idx_k, n_experts, C):
    """The capacity rule as a loop: copies ranked by (expert, token, k);
    each expert keeps its first C."""
    seen = np.zeros(n_experts, int)
    keep = np.zeros(idx_k.shape, bool)
    for e in range(n_experts):
        for t, k in zip(*np.nonzero(idx_k == e)):
            keep[t, k] = seen[e] < C
            seen[e] += 1
    return keep


@pytest.mark.parametrize("cf", [0.5, 1.25, "E"])
def test_moe_apply_drops_the_same_copies(cf):
    ref_cfg, cfg, p, x = _setup(capacity_factor=cf if cf != "E" else 4.0)
    (out, aux), (out_r, aux_r) = _run(ref_cfg, cfg, p, x)
    assert rel_err(out, out_r) < TOL and abs(aux - aux_r) <= TOL * abs(aux_r)
    T = x.shape[0] * x.shape[1]
    C = PM.capacity(T, cfg)
    assert C == max(int(np.ceil(T * 2 / 4 * cfg.moe.capacity_factor)), 1)
    _, _, idx_k = PM.route({"router": torch.from_numpy(np.array(p["router"]))},
                           torch.from_numpy(x.reshape(T, -1)), cfg)
    _, slot_valid, _, keep, _ = PM.dispatch(idx_k, 4, C)
    expect = _kept_by_loop(idx_k.numpy(), 4, C)
    assert np.array_equal(keep.numpy(), expect)
    assert int(slot_valid.sum()) == int(expect.sum())
    if cf == 0.5:
        assert not expect.all()
    if cf == "E":
        assert expect.all()


def test_zero_router_takes_the_lowest_experts():
    """Every probability ties at 1/E: both packages route each token to
    experts 0..K-1, in that order, so the capacity drops land alike."""
    ref_cfg, cfg, p, x = _setup(capacity_factor=1.25)
    p["router"] = np.zeros_like(p["router"])
    (out, aux), (out_r, aux_r) = _run(ref_cfg, cfg, p, x)
    assert rel_err(out, out_r) < TOL and abs(aux - aux_r) <= TOL * abs(aux_r)
    T = x.shape[0] * x.shape[1]
    _, gate, idx_k = PM.route({"router": torch.from_numpy(np.array(p["router"]))},
                              torch.from_numpy(x.reshape(T, -1)), cfg)
    assert idx_k.tolist() == [[0, 1]] * T
    ref_gate, ref_idx = jax.lax.top_k(jnp.full((T, 4), 0.25), 2)
    assert np.array_equal(np.asarray(ref_idx), idx_k.numpy())
    assert torch.equal(gate, torch.full((T, 2), 0.5))
    _, _, _, keep, _ = PM.dispatch(idx_k, 4, PM.capacity(T, cfg))
    assert int(keep.sum()) == 2 * PM.capacity(T, cfg)     # experts 2, 3 idle


def test_shared_experts_match_reference():
    ref_cfg, cfg, p, x = _setup("deepseek-v2-lite-16b", capacity_factor=1.25)
    assert cfg.moe.n_shared == 1 and "shared" in p
    (out, aux), (out_r, aux_r) = _run(ref_cfg, cfg, p, x)
    assert rel_err(out, out_r) < TOL and abs(aux - aux_r) <= TOL * abs(aux_r)


# -- the behaviours of tests/test_moe.py, on the port, same inputs ----------

def _dense(p, x, cfg):
    """All experts on every token, no capacity: the port's counterpart of
    tests/test_moe.py's ``_dense_reference``."""
    p = {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict)
         else {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
         for k, v in p.items()}
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, gate, idx = PM.route(p, xt, cfg)
    g = torch.einsum("td,edf->tef", xt, p["w_gate"])
    u = torch.einsum("td,edf->tef", xt, p["w_up"])
    eo = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u, p["w_down"])
    out = (gate[..., None] * torch.gather(eo, 1, idx[..., None].expand(-1, -1, eo.shape[-1]))
           ).sum(1)
    if cfg.moe.n_shared:
        out = out + ffn_apply(p["shared"], torch.from_numpy(x), "swiglu").reshape(out.shape)
    return out.reshape(x.shape)


@pytest.mark.parametrize("behaviour", ["dispatch matches dense", "drops reduce mass",
                                       "shared always on", "aux balanced vs collapsed"])
def test_reference_moe_behaviours(behaviour):
    if behaviour == "dispatch matches dense":
        ref_cfg, cfg, p, x = _setup(capacity_factor=64.0)
        (out, aux), (out_r, _) = _run(ref_cfg, cfg, p, x)
        np.testing.assert_allclose(out.numpy(), _dense(p, x, cfg).numpy(), rtol=2e-4, atol=2e-5)
        assert rel_err(out, out_r) < TOL and np.isfinite(aux)
    elif behaviour == "drops reduce mass":
        ref_cfg, cfg, p, x = _setup(capacity_factor=64.0)
        small = with_capacity((ref_cfg, cfg), 0.25)
        (full, _), _ = _run(ref_cfg, cfg, p, x)
        (dropped, _), (dropped_r, _) = _run(*small, p, x)
        assert float(dropped.norm()) < float(full.norm())
        assert rel_err(dropped, dropped_r) < TOL
    elif behaviour == "shared always on":
        ref_cfg, cfg, p, x = _setup("deepseek-v2-lite-16b", shape=(1, 8))
        p["w_down"] = np.zeros_like(p["w_down"])            # kill routed outputs
        (out, _), (out_r, _) = _run(ref_cfg, cfg, p, x)
        _, pp = _both(p)
        shared = ffn_apply(pp["shared"], torch.from_numpy(x), "swiglu")
        np.testing.assert_allclose(out.numpy(), shared.numpy(), rtol=2e-4, atol=2e-5)
        assert rel_err(out, out_r) < TOL
        rp, _ = _both(p)
        assert rel_err(shared, ref_ffn_apply(rp["shared"], jnp.asarray(x), "swiglu")) < TOL
    else:
        ref_cfg, cfg, p, x = _setup(capacity_factor=8.0)
        x = np.abs(x)    # a positive column-0 router then collapses onto expert 0
        uniform = {**p, "router": np.zeros_like(p["router"])}
        collapse = {**p, "router": np.zeros_like(p["router"])}
        collapse["router"][:, 0] = 10.0
        (_, aux_u), (_, aux_ur) = _run(ref_cfg, cfg, uniform, x)
        (_, aux_c), (_, aux_cr) = _run(ref_cfg, cfg, collapse, x)
        assert aux_c > aux_u
        assert abs(aux_u - aux_ur) <= TOL * aux_ur and abs(aux_c - aux_cr) <= TOL * aux_cr


# -- the MoE archs ------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_moe_model_matches_reference(name):
    """Default capacity factor: the 2 x 32 full pass and the 2 x 16
    prefill drop copies in their first layer (C = 40 and 20; the decode
    step's C = 2 holds its 4 copies); both packages drop the same ones.
    The aux loss is summed over layers in float32."""
    aux, aux_r = check_model(*smoke_cfgs(name))
    assert aux > 0 and aux_r > 0


@pytest.mark.parametrize("name", MOE)
def test_moe_generate_matches_reference(name):
    check_generate(*smoke_cfgs(name))


@pytest.mark.parametrize("name", MOE)
def test_moe_decode_matches_full_forward(name):
    """At capacity_factor = E nothing drops, so the prefill + decode and the
    full forward route alike (as tests/test_models_smoke.py runs it)."""
    _, cfg = smoke_cfgs(name)
    decode_matches_full_forward(cfg.scaled(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts))))
