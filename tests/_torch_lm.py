"""Shared pieces of the LM tests that hold the port (``repro_torch.models``)
against the reference (``repro.models``) on the CPU in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_for_smoke as ref_reduced
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced_for_smoke
from repro_torch.convert import lm_cache_to_numpy

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


def ref_params(ref_cfg, seed=0):
    """The reference's own init, as nested dicts of numpy arrays."""
    params = ref_build_model(ref_cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def caches_close(port_cache, ref_cache):
    port_np = lm_cache_to_numpy(port_cache)
    ref_np = jax.tree_util.tree_map(np.asarray, ref_cache)
    assert port_np.keys() == ref_np.keys()
    for t in ref_np:
        assert port_np[t].keys() == ref_np[t].keys()
        for n in ref_np[t]:
            assert rel_err(port_np[t][n], ref_np[t][n]) < TOL, (t, n)


def lm_batch(cfg, rng, S):
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
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
