"""The optimizer against the reference on the CPU: ``adamw_update`` over
several steps on random trees with float32 and bfloat16 leaves (params,
``m``, ``v`` and ``grad_norm`` within 1e-6 of max |ref| in float32, bf16
params within one bf16 ulp), ``cosine_schedule`` over every step from 0
to total + 5, and ``compress_with_feedback`` / ``decompress`` (``q`` bit
for bit, ``scale`` and the residual within 1e-7). The update is in place."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro.optim.schedule import cosine_schedule as ref_cosine  # noqa: E402
from repro.utils.treeutil import global_norm as ref_global_norm  # noqa: E402
from repro_torch.convert import _leaf_to_torch  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim import compression as PC  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.utils import treeutil as TU  # noqa: E402

TOL = 1e-6


def _tree(rng, scale=1.0):
    """A nested dict of float32 and bfloat16 leaves (as numpy; bf16 via
    ml_dtypes), with keys out of sorted order."""
    def f32(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": f32(16, 8), "b": f32(8),
            "block": {"z": f32(3, 4, 5), "a": f32(2, 2).astype(jnp.bfloat16)},
            "emb": f32(32, 4).astype(jnp.bfloat16)}


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict) else _leaf_to_torch(v, "cpu")
            for k, v in t.items()}


def _np(t) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(port, ref, what):
    p = dict(jax.tree_util.tree_leaves_with_path(port))
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        a = np.asarray(a)
        b = _np(p[path])
        if a.dtype == jnp.bfloat16:
            # one bf16 ulp at the element's magnitude (8 bits of mantissa)
            af = a.astype(np.float32)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(af), 1e-30))) - 7)
            assert (np.abs(b - af) <= ulp).all(), (what, path)
        else:
            assert np.abs(b - a).max() <= TOL * np.abs(a).max(), (what, path)


def test_tree_leaves_follow_the_reference_order():
    t = _tree(np.random.default_rng(0))
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    port = TU.tree_leaves(_torch_tree(t))
    assert [tuple(x.shape) for x in port] == [x.shape for x in ref]
    assert TU.tree_count(_torch_tree(t)) == sum(x.size for x in ref)
    assert TU.tree_bytes(_torch_tree(t)) == sum(x.nbytes for x in ref)
    gn = TU.global_norm(_torch_tree(t))
    assert gn.dtype == torch.float32 and gn.dim() == 0
    assert abs(float(gn) - float(ref_global_norm(t))) <= TOL * float(ref_global_norm(t))


@pytest.mark.parametrize("lr_scale", [1.0, "schedule"])
@pytest.mark.parametrize("grad_scale", [0.1, 30.0])      # clip inactive / active
def test_adamw_matches_reference(grad_scale, lr_scale):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg = PA.AdamWConfig(lr=1e-2)
    ref_cfg = RA.AdamWConfig(lr=1e-2)
    rp, rs = jax.tree_util.tree_map(jnp.asarray, params), RA.adamw_init(params)
    pp = _torch_tree(params)
    ps = PA.adamw_init(pp)
    assert ps["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in TU.tree_leaves(ps["m"]))
    update = jax.jit(lambda p, g, s, k: RA.adamw_update(p, g, s, ref_cfg, lr_scale=k))
    for step in range(4):
        grads = _tree(rng, grad_scale)
        k_ref = 1.0 if lr_scale == 1.0 else ref_cosine(jnp.int32(step), warmup=2, total=6)
        k = 1.0 if lr_scale == 1.0 else cosine_schedule(
            torch.tensor(step, dtype=torch.int32), warmup=2, total=6)
        rp, rs, rm = update(rp, grads, rs, k_ref)
        leaves_before = TU.tree_leaves(pp)
        out_p, out_s, met = PA.adamw_update(pp, _torch_tree(grads), ps, cfg, lr_scale=k)
        # in place: the same tensors come back, updated
        assert out_p is pp and out_s is ps
        assert all(a is b for a, b in zip(TU.tree_leaves(pp), leaves_before))
        assert met["grad_norm"].dtype == met["lr"].dtype == torch.float32
        assert abs(float(met["grad_norm"]) - float(rm["grad_norm"])) <= \
            TOL * float(rm["grad_norm"])
        assert abs(float(met["lr"]) - float(rm["lr"])) <= TOL * float(rm["lr"])
        _close(pp, rp, f"params step {step}")
        _close(ps["m"], rs["m"], f"m step {step}")
        _close(ps["v"], rs["v"], f"v step {step}")
        assert int(ps["step"]) == int(rs["step"]) == step + 1


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5), (10, 40)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = np.arange(total + 6, dtype=np.int32)
    ref = np.asarray(jax.vmap(lambda s: ref_cosine(s, warmup=warmup, total=total))(steps))
    port = cosine_schedule(torch.from_numpy(steps), warmup=warmup, total=total)
    assert port.dtype == torch.float32
    assert np.abs(port.numpy() - ref).max() <= TOL * np.abs(ref).max()
    one = cosine_schedule(torch.tensor(3, dtype=torch.int32), warmup=warmup, total=total)
    assert one.dim() == 0 and float(one) == float(port[3])


def test_compression_matches_reference():
    rng = np.random.default_rng(2)
    grads = _tree(rng)
    grads["tie"] = np.array([0.5, -1.5, 2.5, 127.0, -127.0, 63.5], np.float32)  # halves
    err = jax.tree_util.tree_map(
        lambda g: (rng.standard_normal(g.shape) * 1e-3).astype(np.float32), grads)
    err["tie"][:] = 0          # scale 1: exact halves, rounded half to even
    comp_r, err_r = RC.compress_with_feedback(grads, err)
    assert np.asarray(comp_r["tie"].q).tolist() == [0, -2, 2, 127, -127, 64]
    comp, err_p = PC.compress_with_feedback(_torch_tree(grads), _torch_tree(err))
    for (path, c_r), c in zip(jax.tree_util.tree_leaves_with_path(
            comp_r, is_leaf=lambda x: isinstance(x, RC.Compressed)),
            TU.tree_leaves(comp, is_leaf=lambda x: isinstance(x, PC.Compressed))):
        assert c.q.dtype == torch.int8 and c.scale.dtype == torch.float32
        assert np.array_equal(c.q.numpy(), np.asarray(c_r.q)), path
        assert abs(float(c.scale) - float(c_r.scale)) <= 1e-7 * float(c_r.scale)
    _close(err_p, err_r, "residual")
    for path, d in jax.tree_util.tree_leaves_with_path(RC.decompress(comp_r)):
        got = dict(jax.tree_util.tree_leaves_with_path(PC.decompress(comp)))[path]
        assert np.abs(got.numpy() - np.asarray(d)).max() <= 1e-7 * np.abs(np.asarray(d)).max()
    zeros = PC.init_error(_torch_tree(grads))
    assert all(float(z.abs().max()) == 0.0 and z.dtype == torch.float32
               for z in TU.tree_leaves(zeros))
