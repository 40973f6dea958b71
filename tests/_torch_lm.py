"""Shared pieces of the LM tests that hold the port (``repro_torch.models``)
against the reference (``repro.models``) on the CPU in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_for_smoke as ref_reduced
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.models import model as RM
from repro.models import transformer as RT
from repro.models import whisper as RW
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced_for_smoke
from repro_torch.convert import lm_cache_to_numpy, lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as PT
from repro_torch.models import whisper as PW

# max |Δ| / max |ref| for hidden states, logits, caches and layer outputs:
# float32 on both sides, which differ only in the order of float32 sums
TOL = 1e-4
DENSE = ["llama3.2-3b", "deepseek-7b", "mistral-nemo-12b", "starcoder2-15b",
         "qwen2-vl-7b"]
B, S, S0 = 2, 32, 16      # tests/test_models_smoke.py's batch and lengths


def rel_err(port, ref) -> float:
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref)) / (np.max(np.abs(ref)) + 1e-30))


def smoke_cfgs(name, **kw):
    """(reference config, port config): the smoke config in float32."""
    return (ref_reduced(ref_get_config(name)).scaled(dtype="float32", **kw),
            reduced_for_smoke(get_config(name)).scaled(dtype="float32", **kw))


def with_capacity(cfgs, capacity_factor):
    """Both configs with the MoE capacity factor set."""
    return tuple(c.scaled(moe=dataclasses.replace(c.moe, capacity_factor=capacity_factor))
                 for c in cfgs)


def ref_params(ref_cfg, seed=0, **model_kw):
    """The reference's own init, as nested dicts of numpy arrays."""
    params = jax.jit(ref_build_model(ref_cfg, **model_kw).init_params)(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def caches_close(port_cache, ref_cache):
    port_np = dict(jax.tree_util.tree_leaves_with_path(lm_cache_to_numpy(port_cache)))
    ref_np = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, ref_cache)))
    assert port_np.keys() == ref_np.keys()
    for path, a in ref_np.items():
        assert rel_err(port_np[path], a) < TOL, jax.tree_util.keystr(path)


def lm_batch(cfg, rng, S):
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1
                                 ).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = (rng.standard_normal((B, 4, cfg.d_model)) * 0.1
                                  ).astype(np.float32)
        ar = np.arange(S)
        batch["positions3"] = np.broadcast_to(
            np.stack([ar, ar // 2, ar % 3])[:, None, :], (3, B, S)).astype(np.int32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _full_pass(ref_cfg, cfg, rparams, params, batch):
    """Both packages' hidden states over the whole batch, and the MoE aux
    loss (0 for the audio family)."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        enc_r = RW.encode(rparams, ref_cfg, jnp.asarray(batch["frame_embeds"]), chunk=8)
        enc = PW.encode(params, cfg, torch.from_numpy(batch["frame_embeds"]), chunk=8)
        assert rel_err(enc, enc_r) < TOL
        hid_r, _ = RW.decode(rparams, ref_cfg, jnp.asarray(tokens), enc_out=enc_r, chunk=8)
        hid, _ = PW.decode(params, cfg, torch.from_numpy(tokens), enc_out=enc, chunk=8)
        return (hid, 0.0), (hid_r, 0.0)
    kw_r = {k: jnp.asarray(batch[k]) for k in ("vision_embeds", "positions3") if k in batch}
    kw_p = {k: torch.from_numpy(np.array(batch[k])) for k in kw_r}
    hid_r, _, aux_r = RT.forward(rparams, ref_cfg, jnp.asarray(tokens), chunk=8, **kw_r)
    hid, _, aux = PT.forward(params, cfg, torch.from_numpy(tokens), chunk=8, **kw_p)
    return (hid, float(aux)), (hid_r, float(aux_r))


def _head(cfg, params, hidden):
    return (PW.lm_head(params, hidden) if cfg.family == "audio"
            else PT.lm_head(params, cfg, hidden))


def _ref_head(ref_cfg, rparams, hidden):
    return (RW.lm_head(rparams, hidden) if ref_cfg.family == "audio"
            else RT.lm_head(rparams, ref_cfg, hidden))


def check_model(ref_cfg, cfg):
    """The full pass + lm_head (and the MoE aux loss), the loss, prefill
    (logits, whole cache) and a decode step of both packages on the
    reference's weights; returns the aux losses (port, reference)."""
    rng = np.random.default_rng(5)
    rm, pm = ref_build_model(ref_cfg, max_seq=48, chunk=8), build_model(cfg, max_seq=48, chunk=8)
    tree = ref_params(ref_cfg, max_seq=48)
    params = lm_params_from_reference(tree, cfg, "cpu")
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = lm_batch(cfg, rng, S)

    with torch.no_grad():
        (hid, aux), (hid_r, aux_r) = _full_pass(ref_cfg, cfg, rparams, params, batch)
        assert rel_err(hid, hid_r) < TOL
        assert rel_err(_head(cfg, params, hid), _ref_head(ref_cfg, rparams, hid_r)) < TOL
        assert abs(aux - aux_r) <= TOL * abs(aux_r)
        # the reference's Model.loss_fn from the pieces just computed (its
        # own call would compile the whole forward once more)
        rb = ref_batch(batch)
        loss_r = float(RM._ce_loss_whisper(rparams, hid_r, rb) if cfg.family == "audio" else
                       RT.lm_loss(rparams, ref_cfg, hid_r, rb["targets"], rb["mask"]) + aux_r)
        loss = float(pm.loss_fn(params, port_batch(batch)))
        assert abs(loss - loss_r) / abs(loss_r) < TOL

    pre = {k: v[:, :S0] if k != "positions3" else v[:, :, :S0]
           for k, v in batch.items() if k not in ("targets", "mask")}
    logits_r, cache_r = rm.prefill(rparams, ref_batch(pre), rm.init_cache(B, 32, enc_seq=S0))
    logits, cache = pm.prefill(params, port_batch(pre),
                               pm.init_cache(B, 32, enc_seq=S0, device="cpu"))
    assert rel_err(logits, logits_r) < TOL
    caches_close(cache, cache_r)

    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    db = {"token": nxt, "index": S0}
    if cfg.family == "vlm":
        db["positions3"] = np.full((3, B, 1), S0, np.int32)
    ref_db = {k: jnp.asarray(v) for k, v in db.items()}
    ref_db["index"] = jnp.int32(S0)
    logits_dr, cache_r = rm.decode_step(rparams, cache_r, ref_db)
    logits_d, cache = pm.decode_step(params, cache, {
        k: (torch.from_numpy(v) if k != "index" else v) for k, v in db.items()})
    assert rel_err(logits_d, logits_dr) < TOL
    caches_close(cache, cache_r)
    return aux, aux_r


def check_generate(ref_cfg, cfg, P=16, gen=8):
    """``generate`` of both packages on the reference's weights and one
    prompt (the audio family on ``P`` zero frames) gives equal token ids."""
    tree = ref_params(ref_cfg, max_seq=P + gen)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    ref = ref_serve.generate(ref_build_model(ref_cfg, max_seq=P + gen, chunk=P),
                             jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(prompt), gen=gen, enc_seq=P)
    out = serve.generate(build_model(cfg, max_seq=P + gen, chunk=P),
                         lm_params_from_reference(tree, cfg, "cpu"),
                         torch.from_numpy(prompt), gen=gen, enc_seq=P)
    assert out.dtype == torch.int32 and out.shape == (B, gen)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def decode_matches_full_forward(cfg):
    """The port alone, as tests/test_models_smoke.py holds the reference:
    prefill of S0 tokens + one decode step against a full forward over
    S0 + 1, at the reference's 5e-3."""
    m = build_model(cfg, max_seq=32, chunk=8)
    params = m.init_params(torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(6)
    batch = port_batch({k: v for k, v in lm_batch(cfg, rng, S0).items()
                        if k not in ("targets", "mask")})
    _, cache = m.prefill(params, batch, m.init_cache(B, 32, enc_seq=S0, device="cpu"))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
    db = {"token": nxt, "index": S0}
    kw = {}
    if cfg.family == "vlm":
        db["positions3"] = torch.full((3, B, 1), S0, dtype=torch.int32)
        kw = dict(vision_embeds=batch["vision_embeds"],
                  positions3=torch.cat([batch["positions3"], db["positions3"]], 2))
    logits_d, _ = m.decode_step(params, cache, db)
    toks = torch.cat([batch["tokens"], nxt], 1)
    with torch.no_grad():
        if cfg.family == "audio":
            enc = PW.encode(params, cfg, batch["frame_embeds"], chunk=8)
            hid, _ = PW.decode(params, cfg, toks, enc_out=enc, chunk=8)
        else:
            hid, _, _ = PT.forward(params, cfg, toks, chunk=8, **kw)
        ref = _head(cfg, params, hid[:, -1:])
    assert rel_err(logits_d, ref) < 5e-3


# ---------------------------------------------------------------------------
# training: one reference init, both packages' train steps
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module runs (restored after): the test
    models are tiny, and with the suite's workers each spinning a thread
    per core, a smoke-sized step took ~190x longer (0.38 s alone, 72 s
    beside five busy processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# float32 on both sides: the loss within 1e-5 relative; each gradient leaf
# within 1e-4 of its max |ref|; params, m and v after the steps within 1e-4
LOSS_TOL, TRAIN_TOL = 1e-5, 1e-4
# xLSTM's gradient is ill-conditioned in float32: the reference's own moves
# by 1.2e-4 (3.7e-4) of max |grad| in its mLSTM leaves when its params are
# perturbed by a relative 1e-7 (3e-7), about one ulp; so it is held at 1e-3
GRAD_TOL = {"xlstm-1.3b": 1e-3}
# The attention key biases' gradient is zero in exact arithmetic (softmax
# is invariant to a shift every key shares), so both packages' are rounding
# noise: held to TRAIN_TOL of the largest gradient of any leaf
ZERO_GRAD_LEAVES = ("['bk']",)


def ref_train_state(ref_cfg, *, seed=0, use_compression=False, **model_kw):
    """The reference's ``init_train_state`` (jitted) as nested dicts of
    numpy, the form ``convert.train_state_from_reference`` reads."""
    from repro.train.step import init_train_state as ref_init
    st = jax.jit(lambda k: ref_init(ref_build_model(ref_cfg, **model_kw), k,
                                    use_compression=use_compression))(
        jax.random.PRNGKey(seed))
    return ref_state_to_numpy(st)


def ref_state_to_numpy(st) -> dict:
    def arrays(t):
        return jax.tree_util.tree_map(np.asarray, t)

    return {"params": arrays(st.params), "opt": arrays(st.opt),
            "step": np.asarray(st.step),
            "grad_err": None if st.grad_err is None else arrays(st.grad_err)}


def ref_state_from_numpy(d):
    from repro.train.step import TrainState as RefTrainState

    def arrays(t):
        return None if t is None else jax.tree_util.tree_map(jnp.asarray, t)

    return RefTrainState(params=arrays(d["params"]), opt=arrays(d["opt"]),
                         step=jnp.asarray(d["step"]), grad_err=arrays(d["grad_err"]))


def grads_to_reference(params, grads) -> dict:
    """The port's gradient list (``tree_leaves(params)`` order) in the
    reference's stacked layout, as numpy."""
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.utils.treeutil import tree_unflatten_like
    return lm_cache_to_numpy(lm_params_to_reference(tree_unflatten_like(params, grads)))


def _zero_grad(path) -> bool:
    return jax.tree_util.keystr(path).endswith(ZERO_GRAD_LEAVES)


def trees_close(port, ref, tol, what):
    """Every leaf of two nested dicts of arrays (the same paths) within
    ``tol`` of its max |ref|; for gradients and AdamW's ``m`` / ``v``, a
    leaf whose exact gradient is zero within ``tol`` of the largest |ref|
    of any leaf."""
    p = dict(jax.tree_util.tree_leaves_with_path(port))
    r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert p.keys() == r.keys(), what
    top = max(float(np.abs(a).max()) for a in r.values())
    for path, a in r.items():
        if what in ("grads", "m", "v") and _zero_grad(path):
            err = max(np.abs(np.asarray(x, np.float32)).max() for x in (p[path], a)) / top
        else:
            err = rel_err(np.asarray(p[path], np.float32), a)
        assert err < tol, (what, jax.tree_util.keystr(path), err)


def params_close(port, ref, ref_v, *, lr, steps, grad_tol):
    """The params after ``steps`` AdamW steps. Adam divides each gradient
    element by its RMS, so the error of an element's update is the lr
    times its gradient's relative error, up to 4 lr a step (the update's
    bound) where the gradient lies at the rounding level. Each element is
    held to TRAIN_TOL of its leaf's max |ref| plus that propagated error:
    4 lr ``steps`` min(1, grad_tol max(rms) / rms), with ``rms`` the
    reference's RMS gradient ``sqrt(v)`` and ``grad_tol`` the accuracy the
    gradient check holds (1 for every element of a zero-gradient leaf)."""
    p = dict(jax.tree_util.tree_leaves_with_path(port))
    r = dict(jax.tree_util.tree_leaves_with_path(ref))
    v = dict(jax.tree_util.tree_leaves_with_path(ref_v))
    assert p.keys() == r.keys() == v.keys()
    for path, a in r.items():
        a = np.asarray(a, np.float32)
        d = np.abs(np.asarray(p[path], np.float32) - a)
        rms = np.sqrt(np.asarray(v[path], np.float64))
        rel = np.minimum(1.0, grad_tol * rms.max() / np.maximum(rms, 1e-300))
        if _zero_grad(path):
            rel = np.ones_like(rel)
        bound = TRAIN_TOL * np.abs(a).max() + 4 * lr * steps * rel
        worst = np.unravel_index(np.argmax(d - bound), d.shape)
        assert (d <= bound).all(), (jax.tree_util.keystr(path), d[worst], bound[worst])


def train_batch(cfg, rng, B=4, S=S):
    """A training batch (targets the next tokens, a random mask) of the
    smoke tests' shapes; vlm with 4 vision embeddings and three position
    streams."""
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1
                                 ).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = (rng.standard_normal((B, 4, cfg.d_model)) * 0.1
                                  ).astype(np.float32)
        ar = np.arange(S)
        batch["positions3"] = (np.stack([ar, ar // 2, ar % 3])[:, None, :]
                               + np.arange(B)[None, :, None]).astype(np.int32)
    return batch


def check_train_steps(ref_cfg, cfg, *, remat=False, n_micro=1, steps=2, seed=0,
                      lr=1e-3):
    """From one reference init: the gradients of the first batch (each leaf
    against the reference's, read back from its first AdamW step: from
    zero state ``m = (1 - b1) clip g``, exact to a few ulp, which spares a
    second trace of its backward pass), then ``steps`` train steps of both
    packages (warmup 1: the first step's lr is 0, the second moves the
    params), each loss within LOSS_TOL and ``grad_norm`` within TRAIN_TOL,
    ``m`` and ``v`` after them within TRAIN_TOL (GRAD_TOL for xLSTM) and
    the params as ``params_close`` holds them. Returns the port's losses."""
    from repro.optim.adamw import AdamWConfig as RefAdamW
    from repro.train.step import make_train_step as ref_make_step
    from repro_torch.convert import train_state_from_reference, train_state_to_reference
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import make_train_step, value_and_grad

    kw = dict(max_seq=S, chunk=8, remat=remat)
    rm, pm = ref_build_model(ref_cfg, **kw), build_model(cfg, **kw)
    init = ref_train_state(ref_cfg, seed=seed, **kw)
    step_kw = dict(n_microbatches=n_micro, warmup=1, total_steps=10)
    ref_cfg_opt = RefAdamW(lr=lr)
    ref_step = jax.jit(ref_make_step(rm, ref_cfg_opt, **step_kw))
    port_step = make_train_step(pm, AdamWConfig(lr=lr), **step_kw)
    rst = ref_state_from_numpy(init)
    pst = train_state_from_reference(init, cfg, "cpu")
    rng = np.random.default_rng(seed + 11)
    losses = []
    for i in range(steps):
        batch = train_batch(cfg, rng)
        rst, met_r = ref_step(rst, ref_batch(batch))
        if i == 0:
            loss0, grads = value_and_grad(pm, pst.params, port_batch(batch), n_micro)
            assert abs(float(loss0) - float(met_r["loss"])) <= \
                LOSS_TOL * abs(float(met_r["loss"]))
            gnorm = np.float32(met_r["grad_norm"])
            clip = min(np.float32(1.0), np.float32(ref_cfg_opt.grad_clip) / (gnorm + np.float32(1e-9)))
            grads_r = jax.tree_util.tree_map(
                lambda m: np.asarray(m) / (np.float32(1 - ref_cfg_opt.b1) * clip), rst.opt["m"])
            trees_close(grads_to_reference(pst.params, grads), grads_r,
                        GRAD_TOL.get(cfg.name, TRAIN_TOL), "grads")
        pst, met = port_step(pst, port_batch(batch))
        assert abs(float(met["loss"]) - float(met_r["loss"])) <= \
            LOSS_TOL * abs(float(met_r["loss"])), (i, float(met["loss"]), float(met_r["loss"]))
        assert abs(float(met["grad_norm"]) - float(met_r["grad_norm"])) <= \
            TRAIN_TOL * float(met_r["grad_norm"])
        losses.append(float(met["loss"]))
    port, ref = train_state_to_reference(pst), ref_state_to_numpy(rst)
    assert int(port["step"]) == int(ref["step"]) == steps
    assert int(port["opt"]["step"]) == int(ref["opt"]["step"]) == steps
    for what in ("m", "v"):
        trees_close(port["opt"][what], ref["opt"][what], GRAD_TOL.get(cfg.name, TRAIN_TOL), what)
    params_close(port["params"], ref["params"], ref["opt"]["v"], lr=lr, steps=steps,
                 grad_tol=GRAD_TOL.get(cfg.name, TRAIN_TOL))
    return losses
