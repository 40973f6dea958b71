"""Shared pieces of the LM tests that hold the port (``repro_torch.models``)
against the reference (``repro.models``) on the CPU in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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
