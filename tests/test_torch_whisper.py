"""The port's Whisper encoder-decoder (``repro_torch.models.whisper``), the
``Model``'s audio branch and ``generate(enc_seq=)`` against the
reference's, on the CPU in float32, on the reference's own init: within
max |Δ| / max |ref| < 1e-4 (``_torch_lm.TOL``), token ids equal.

Covered: ``encode``; ``decode`` as a full pass, as a prefill (the self
cache and the cross K/V it sets) and as a decode step reading the cached
cross K/V; the cross K/V against ``cross_kv`` per layer; ``Model``'s
loss, prefill and decode; ``generate``; the port's decode against its
full pass; and ``python -m repro_torch.launch.serve --arch whisper-base
--smoke --device cpu``."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import whisper as RW  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import whisper as PW  # noqa: E402
from _torch_lm import (B, TOL, check_generate, check_model,  # noqa: E402
                       decode_matches_full_forward, ref_params, rel_err, smoke_cfgs)

ROOT = Path(__file__).resolve().parents[1]
NAME = "whisper-base"


def _setup(S_enc=12, S=9):
    ref_cfg, cfg = smoke_cfgs(NAME)
    tree = ref_params(ref_cfg, max_seq=32)
    rng = np.random.default_rng(2)
    frames = (rng.standard_normal((B, S_enc, cfg.d_model)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return (ref_cfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_reference(tree, cfg, "cpu"), frames, tokens)


@torch.no_grad()
def test_decode_in_all_three_modes():
    ref_cfg, cfg, rp, pp, frames, tokens = _setup()
    enc_r = RW.encode(rp, ref_cfg, jnp.asarray(frames), chunk=4)
    enc = PW.encode(pp, cfg, torch.from_numpy(frames), chunk=4)
    assert rel_err(enc, enc_r) < TOL

    full_r, none_r = RW.decode(rp, ref_cfg, jnp.asarray(tokens), enc_out=enc_r, chunk=4)
    full, none = PW.decode(pp, cfg, torch.from_numpy(tokens), enc_out=enc, chunk=4)
    assert none is None and none_r is None and rel_err(full, full_r) < TOL

    S0 = tokens.shape[1] - 1
    cache_r = RW.init_cache(ref_cfg, B, 16, frames.shape[1])
    cache = PW.init_cache(cfg, B, 16, frames.shape[1], "cpu")
    hid_r, cache_r = RW.decode(rp, ref_cfg, jnp.asarray(tokens[:, :S0]), enc_out=enc_r,
                               cache=cache_r, chunk=4)
    hid, cache = PW.decode(pp, cfg, torch.from_numpy(tokens[:, :S0]), enc_out=enc,
                           cache=cache, chunk=4)
    assert rel_err(hid, hid_r) < TOL
    for n in ("k", "v", "ck", "cv"):
        assert rel_err(cache[n], cache_r[n]) < TOL, n
    # the cross K/V are each decoder layer's projections of the encoder out
    for layer, p in enumerate(pp.dec_blocks):
        ck, cv = PW.cross_kv(p["cross_attn"], enc)
        assert torch.equal(cache["ck"][layer], ck) and torch.equal(cache["cv"][layer], cv)

    step_r, cache_r = RW.decode(rp, ref_cfg, jnp.asarray(tokens[:, S0:]), cache=cache_r,
                                cache_index=jnp.int32(S0), chunk=4)
    step, cache = PW.decode(pp, cfg, torch.from_numpy(tokens[:, S0:]), cache=cache,
                            cache_index=S0, chunk=4)
    assert rel_err(step, step_r) < TOL
    assert rel_err(step[:, 0], full_r[:, -1]) < 5e-3
    for n in ("k", "v", "ck", "cv"):
        assert rel_err(cache[n], cache_r[n]) < TOL, n
    assert rel_err(PW.lm_head(pp, step), RW.lm_head(rp, step_r)) < TOL


def test_model_audio_branch_matches_reference():
    """``Model``'s loss, prefill (the encoder on 16 frames, both caches)
    and a decode step."""
    check_model(*smoke_cfgs(NAME))


def test_generate_matches_reference():
    check_generate(*smoke_cfgs(NAME), P=12, gen=8)


def test_decode_matches_full_forward():
    decode_matches_full_forward(smoke_cfgs(NAME)[1])


def test_serve_cli_runs_whisper_on_the_cpu():
    code = ("import runpy, sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "sys.argv = ['serve'] + sys.argv[1:]\n"
            "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code, "--arch", NAME, "--smoke",
                          "--device", "cpu", "--batch", "2", "--gen", "8"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("[serve] generated 16 tokens in ")
