"""The port's transformer and Model against the reference's on the
reference's own ``init_params`` weights (carried across by
``lm_params_from_reference``), on the CPU in float32: ``forward`` +
``lm_head``, ``loss_fn``, ``prefill`` (logits and the whole cache) and a
``decode_step`` at the smoke shapes of ``tests/test_models_smoke.py`` for
the five dense-path archs and for small configs with padded heads, within
max |Δ| / max |ref| < 1e-4; and the port's decode against its full
forward at the reference's 5e-3."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from _torch_lm import (B, DENSE, S, S0, TOL, caches_close, lm_batch,  # noqa: E402
                       port_batch, ref_batch, ref_params, rel_err, smoke_cfgs)


def _check_model(ref_cfg, cfg):
    """forward + lm_head, the loss, prefill (logits, whole cache) and a
    decode step of both packages on the reference's weights."""
    rng = np.random.default_rng(5)
    rm, pm = ref_build_model(ref_cfg, max_seq=48, chunk=8), build_model(cfg, max_seq=48, chunk=8)
    tree = ref_params(ref_cfg)
    params = lm_params_from_reference(tree, cfg, "cpu")
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = lm_batch(cfg, rng, S)
    kw_r = {k: jnp.asarray(batch[k]) for k in ("vision_embeds", "positions3") if k in batch}
    kw_p = {k: torch.from_numpy(np.array(batch[k])) for k in kw_r}

    with torch.no_grad():
        hid_r, _, _ = RT.forward(rparams, ref_cfg, jnp.asarray(batch["tokens"]), chunk=8, **kw_r)
        hid, _ = PT.forward(params, cfg, torch.from_numpy(batch["tokens"]), chunk=8, **kw_p)
        assert rel_err(hid, hid_r) < TOL
        assert rel_err(PT.lm_head(params, cfg, hid), RT.lm_head(rparams, ref_cfg, hid_r)) < TOL
        loss_r = float(rm.loss_fn(rparams, ref_batch(batch)))
        loss = float(pm.loss_fn(params, port_batch(batch)))
        assert abs(loss - loss_r) / abs(loss_r) < TOL

    pre = {k: v[:, :S0] if k != "positions3" else v[:, :, :S0]
           for k, v in batch.items() if k not in ("targets", "mask")}
    logits_r, cache_r = rm.prefill(rparams, ref_batch(pre), rm.init_cache(B, 32))
    logits, cache = pm.prefill(params, port_batch(pre), pm.init_cache(B, 32, device="cpu"))
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


@pytest.mark.parametrize("name", DENSE)
def test_model_matches_reference(name):
    _check_model(*smoke_cfgs(name))


def test_padded_heads_model_matches_reference():
    """6 heads in 2 KV groups padded to 8 (``reduced_for_smoke`` turns the
    padding off; Llama and Qwen2-VL on the card use it)."""
    kw = dict(n_heads=6, n_kv_heads=2, tp_pad_heads_to=8)
    ref_cfg, cfg = smoke_cfgs("llama3.2-3b", **kw)
    assert PT._attn_dims(cfg) == PL.AttnDims(64, 8, 2, 16, n_real_heads=6)
    _check_model(ref_cfg, cfg)
    _check_model(*smoke_cfgs("qwen2-vl-7b", **kw))


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_full_forward(name):
    """The port alone, as tests/test_models_smoke.py holds the reference:
    prefill of 16 tokens + one decode step against a full forward over
    17, at the reference's 5e-3."""
    _, cfg = smoke_cfgs(name)
    m = build_model(cfg, max_seq=32, chunk=8)
    params = m.init_params(torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(6)
    batch = port_batch({k: v for k, v in lm_batch(cfg, rng, S0).items()
                         if k not in ("targets", "mask")})
    _, cache = m.prefill(params, batch, m.init_cache(B, 32, device="cpu"))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
    db = {"token": nxt, "index": S0}
    kw = {}
    if cfg.family == "vlm":
        db["positions3"] = torch.full((3, B, 1), S0, dtype=torch.int32)
        kw = dict(vision_embeds=batch["vision_embeds"],
                  positions3=torch.cat([batch["positions3"], db["positions3"]], 2))
    logits_d, _ = m.decode_step(params, cache, db)
    with torch.no_grad():
        hid, _ = PT.forward(params, cfg, torch.cat([batch["tokens"], nxt], 1),
                            chunk=8, **kw)
        ref = PT.lm_head(params, cfg, hid[:, -1:])
    assert rel_err(logits_d, ref) < 5e-3
