"""The port's LM configs and layers against the reference's, on the CPU in
float32: the same numpy inputs, drawn from a seed, through both packages,
within max |Δ| / max |ref| < 1e-4 (``_torch_lm.TOL``).

Covered: the config registry, ``reduced_for_smoke`` and the shapes table;
norms, RoPE, M-RoPE, ``attn_apply`` in every mode, ``mla_apply``, both
FFNs, the init and the cache writes' clamp; every cache type's layout and
the bf16 carry; ``param_specs`` at full size for all ten archs; the
parameter counts and step bounds of ``utils/roofline.py``.
``test_torch_model_forward.py``, ``test_torch_moe.py``,
``test_torch_recurrent.py``, ``test_torch_xlstm.py`` and
``test_torch_whisper.py`` hold the models."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs.base import reduced_for_smoke as ref_reduced  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.convert import (lm_cache_from_reference, lm_cache_to_numpy,  # noqa: E402
                                lm_params_from_reference, lm_params_to_reference)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from _torch_lm import B, DENSE, TOL, rel_err, smoke_cfgs  # noqa: E402

SLICE_B = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
           "xlstm-1.3b", "whisper-base"]


def tree_both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_and_smoke_configs_equal_the_reference():
    assert list_archs() == ref_list_archs() and len(list_archs()) == 10
    for name in list_archs():
        ref, port = ref_get_config(name), get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(reduced_for_smoke(port)) == \
            dataclasses.asdict(ref_reduced(ref)), name
        assert port.resolved_head_dim == ref.resolved_head_dim
    from repro.configs import shapes as ref_shapes
    from repro_torch.configs import shapes
    assert shapes.all_cells() == ref_shapes.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    for a, s in shapes.all_cells():
        assert shapes.applicable(get_config(a), shapes.SHAPES[s]) == \
            ref_shapes.applicable(ref_get_config(a), ref_shapes.SHAPES[s])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    rp, pp = tree_both(p)
    ref = RL.norm_apply(rp, jnp.asarray(x), kind, 1e-5)
    assert rel_err(PL.norm_apply(pp, torch.from_numpy(x), kind, 1e-5), ref) < TOL
    init = PL.norm_init(48, kind, torch.float32, "cpu")
    ref_init = RL.norm_init(48, kind, jnp.float32)
    assert set(init.keys()) == set(ref_init)
    for n in ref_init:
        assert np.array_equal(init[n].detach().numpy(), np.asarray(ref_init[n]))


def test_rope_and_mrope():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    for hd, theta in ((16, 500000.0), (128, 10000.0)):
        for r, p in zip(RL._rope_angles(jnp.asarray(pos), hd, theta),
                        PL._rope_angles(torch.from_numpy(pos), hd, theta)):
            assert np.max(np.abs(p.numpy() - np.asarray(r))) < 1e-4
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    cos, sin = RL._rope_angles(jnp.asarray(pos), 16, 10000.0)
    for c, s in ((cos, sin), (cos[0], sin[0])):     # (B, S, hd) and (S, hd)
        ref = RL.apply_rope(jnp.asarray(x), c, s)
        port = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(c)),
                             torch.from_numpy(np.array(s)))
        assert rel_err(port, ref) < TOL
    # M-RoPE with distinct t / h / w streams, at the smoke and full widths
    pos3 = np.stack([pos, pos // 3, pos % 5]).astype(np.int32)
    for sections, hd in (((2, 3, 3), 16), ((16, 24, 24), 128)):
        ref = RL._mrope_angles(jnp.asarray(pos3), sections, hd, 1e6)
        port = PL._mrope_angles(torch.from_numpy(pos3), sections, hd, 1e6)
        for r, p in zip(ref, port):
            assert np.max(np.abs(p.numpy() - np.asarray(r))) < 1e-4
    ref_cfg, cfg = smoke_cfgs("qwen2-vl-7b")
    for kw in ({}, {"positions3": pos3}):
        ref = RL.rope_cos_sin(ref_cfg, jnp.asarray(pos),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        port = PL.rope_cos_sin(cfg, torch.from_numpy(pos),
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
        for r, p in zip(ref, port):
            assert np.max(np.abs(p.numpy() - np.asarray(r))) < 1e-4
    assert np.allclose(PL.sinusoidal_positions(40, 16).numpy(),
                       np.asarray(RL.sinusoidal_positions(40, 16)))


def _attn_params(rng, d: RL.AttnDims, bias: bool):
    p = {"wq": rng.standard_normal((d.d_model, d.n_heads, d.head_dim)),
         "wk": rng.standard_normal((d.d_model, d.n_kv_heads, d.head_dim)),
         "wv": rng.standard_normal((d.d_model, d.n_kv_heads, d.head_dim)),
         "wo": rng.standard_normal((d.n_heads, d.head_dim, d.d_model))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    if bias:
        p.update(bq=rng.standard_normal((d.n_heads, d.head_dim)),
                 bk=rng.standard_normal((d.n_kv_heads, d.head_dim)),
                 bv=rng.standard_normal((d.n_kv_heads, d.head_dim)),
                 bo=rng.standard_normal(d.d_model))
        p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    return p


def _cache(rng, Smax, d):
    shape = (B, Smax, d.n_kv_heads, d.head_dim)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


ATTN_DIMS = PL.AttnDims(48, 6, 2, 8)
# (what, S, window, Smax of the cache (None: no cache), cache_index, chunk)
ATTN_MODES = [
    ("causal", 13, 0, None, None, 4),
    ("causal, one chunk", 13, 0, None, None, 1024),
    ("windowed", 13, 5, None, None, 4),
    ("prefill into cache", 13, 0, 20, None, 8),
    ("windowed prefill into a shorter ring", 13, 5, 5, None, 8),
    ("decode", 1, 0, 20, 13, 1024),
    ("windowed ring decode past the window", 1, 5, 5, 13, 1024),
    ("decode past the cache's end (clamped write)", 1, 0, 12, 15, 1024),
    ("decode at the cache's last slot", 1, 0, 12, 11, 1024),
]


@pytest.mark.parametrize("what,Sq,window,Smax,index,chunk", ATTN_MODES,
                         ids=[m[0] for m in ATTN_MODES])
@pytest.mark.parametrize("bias", [False, True])
def test_attn_apply(what, Sq, window, Smax, index, chunk, bias):
    rng = np.random.default_rng(2)
    d = ATTN_DIMS
    rp, pp = tree_both(_attn_params(rng, d, bias))
    x = rng.standard_normal((B, Sq, d.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq) + (index or 0), (B, Sq)).astype(np.int32)
    r_cs = RL._rope_angles(jnp.asarray(pos), d.head_dim, 10000.0)
    p_cs = PL._rope_angles(torch.from_numpy(pos), d.head_dim, 10000.0)
    rc = pc = None
    if Smax is not None:
        rc, pc = tree_both(_cache(rng, Smax, d))
    ref_out, ref_c = RL.attn_apply(rp, jnp.asarray(x), r_cs, dims=RL.AttnDims(48, 6, 2, 8),
                                   window=window, cache=rc, cache_index=index,
                                   chunk=chunk)
    out, c = PL.attn_apply(pp, torch.from_numpy(x), p_cs, dims=d, window=window,
                           cache=pc, cache_index=index, chunk=chunk)
    assert rel_err(out, ref_out) < TOL
    if Smax is not None:
        for n in ("k", "v"):
            assert rel_err(c[n], ref_c[n]) < TOL, n


@pytest.mark.parametrize("start,s_new", [(0, 3), (9, 3), (10, 3), (50, 3), (11, 1),
                                          (12, 1), (-2, 1), (-20, 2)])
def test_cache_write_clamps_like_dynamic_update_slice(start, s_new):
    buf = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    new = -np.ones((2, s_new, 3), np.float32)
    ref = jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(new), (0, start, 0))
    port = torch.from_numpy(buf.copy())
    PL._write(port, torch.from_numpy(new), start)
    assert np.array_equal(port.numpy(), np.asarray(ref))


def _mla_params(rng, cfg):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    shapes = {"wq": (D, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
              "w_dkv": (D, m.kv_lora_rank + m.qk_rope_head_dim),
              "w_uk": (m.kv_lora_rank, H, m.qk_nope_head_dim),
              "w_uv": (m.kv_lora_rank, H, m.v_head_dim),
              "wo": (H, m.v_head_dim, D)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("mode", ["prefill", "prefill into cache", "decode",
                                  "decode past the cache's end"])
def test_mla_apply(mode):
    rng = np.random.default_rng(3)
    ref_cfg, cfg = smoke_cfgs("deepseek-v2-lite-16b")
    m = cfg.mla
    rp, pp = tree_both(_mla_params(rng, cfg))
    Sq, index, Smax = {"prefill": (13, None, None), "prefill into cache": (13, None, 20),
                       "decode": (1, 13, 20),
                       "decode past the cache's end": (1, 25, 20)}[mode]
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq) + (index or 0), (B, Sq)).astype(np.int32)
    r_cs = RL.rope_cos_sin(ref_cfg, jnp.asarray(pos))
    p_cs = PL.rope_cos_sin(cfg, torch.from_numpy(pos))
    rc = pc = None
    if Smax is not None:
        rc, pc = tree_both({"ckv": rng.standard_normal(
            (B, Smax, m.kv_lora_rank + m.qk_rope_head_dim)).astype(np.float32)})
    ref_out, ref_c = RL.mla_apply(rp, jnp.asarray(x), r_cs, cfg=ref_cfg, cache=rc,
                                  cache_index=index, chunk=4)
    out, c = PL.mla_apply(pp, torch.from_numpy(x), p_cs, cfg=cfg, cache=pc,
                          cache_index=index, chunk=4)
    assert rel_err(out, ref_out) < TOL
    if Smax is not None:
        assert rel_err(c["ckv"], ref_c["ckv"]) < TOL


@pytest.mark.parametrize("kind", ["swiglu", "mlp_gelu"])
def test_ffn_apply(kind):
    rng = np.random.default_rng(4)
    ref_p = jax.tree_util.tree_map(
        np.asarray, RL.ffn_init(jax.random.PRNGKey(0), 48, 96, kind, jnp.float32))
    ref_p = {k: v + (0.1 * rng.standard_normal(v.shape).astype(np.float32)
                     if k.startswith("b_") else 0) for k, v in ref_p.items()}
    rp, pp = tree_both(ref_p)
    x = rng.standard_normal((B, 5, 48)).astype(np.float32) * 2
    ref = RL.ffn_apply(rp, jnp.asarray(x), kind)
    assert rel_err(PL.ffn_apply(pp, torch.from_numpy(x), kind), ref) < TOL
    port_p = PL.ffn_init(torch.Generator().manual_seed(0), 48, 96, kind,
                         torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in port_p.items()} == \
        {k: v.shape for k, v in ref_p.items()}


def test_init_draws_truncated_normal_and_zeroes_padded_heads():
    g = torch.Generator().manual_seed(0)
    d = PL.AttnDims(64, 8, 2, 16, n_real_heads=6)
    p = PL.attn_init(g, d, torch.float32, "cpu")
    real = PL.real_head_positions(d)
    assert real.tolist() == RL.real_head_positions(
        RL.AttnDims(64, 8, 2, 16, n_real_heads=6)).tolist() == [0, 1, 2, 4, 5, 6]
    wo = p["wo"].detach()
    pad = sorted(set(range(8)) - set(real.tolist()))
    assert (wo[pad] == 0).all() and (wo[real.tolist()] != 0).all()
    w = p["wq"].detach() * np.sqrt(64)
    assert w.abs().max() <= 2.0 and abs(float(w.std()) - 0.88) < 0.05
    e = PL.embed_init(g, (4096, 8), torch.bfloat16, "cpu")
    # 2 * 0.02, rounded to bf16 as the cast rounds it
    assert e.dtype == torch.bfloat16 and \
        e.float().abs().max() <= torch.tensor(0.04).bfloat16().float()


# ---------------------------------------------------------------------------
# caches, parameter specs, the families still to port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [a for a in ref_list_archs() if a != "whisper-base"])
def test_init_cache_keeps_the_reference_layout(name):
    ref_cfg, cfg = smoke_cfgs(name)
    ref = jax.tree_util.tree_map(np.asarray, RT.init_cache(ref_cfg, B, 40))
    port = PT.init_cache(cfg, B, 40, "cpu")
    assert ref.keys() == port.keys()
    for t in ref:
        assert ref[t].keys() == port[t].keys()
        for n, a in ref[t].items():
            p = port[t][n]
            assert tuple(p.shape) == a.shape and str(p.dtype) == f"torch.{a.dtype}", (t, n)
            assert np.array_equal(p.numpy(), a), (t, n)
    rt = lm_cache_from_reference(ref)
    assert all(torch.equal(rt[t][n], port[t][n]) for t in ref for n in ref[t])


def test_bf16_leaves_carry_across_bit_for_bit():
    a = jax.random.normal(jax.random.PRNGKey(0), (3, 5), jnp.bfloat16)
    cache = lm_cache_from_reference({"attn_block": {"k": np.asarray(a)}})
    t = cache["attn_block"]["k"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(lm_cache_to_numpy(cache)["attn_block"]["k"],
                          np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("name", DENSE)
def test_param_specs_match_reference_at_full_size(name):
    ref_specs = ref_build_model(ref_get_config(name)).param_specs()
    port = build_model(get_config(name)).param_specs()
    assert all(p.device.type == "meta" for p in port.parameters())

    def same(t, spec):
        return tuple(t.shape) == spec.shape and str(t.dtype) == f"torch.{spec.dtype}"

    assert same(port.embed, ref_specs["embed"])
    assert (port.unembed is None) == ("unembed" not in ref_specs)
    if port.unembed is not None:
        assert same(port.unembed, ref_specs["unembed"])
    assert all(same(port.final_norm[n], s) for n, s in ref_specs["final_norm"].items())
    layout = PT.block_layout(get_config(name))
    assert len(port.blocks) == len(layout)
    for blk, btype in zip(port.blocks, layout):
        flat = jax.tree_util.tree_flatten_with_path(ref_specs[btype])[0]
        assert len(flat) == len(list(blk.parameters()))
        for path, spec in flat:
            t = blk
            for k in path:
                t = t[k.key]
            assert tuple(t.shape) == spec.shape[1:] and \
                str(t.dtype) == f"torch.{spec.dtype}", (btype, path)


@pytest.mark.parametrize("name", SLICE_B)
def test_slice_b_families_raise(name):
    """The MoE, recurrent, xLSTM and audio archs build at full size: the
    port's ``param_specs()`` on ``meta``, in the reference's layout
    (``lm_params_to_reference``), equals the reference's ``param_specs()``
    (``jax.eval_shape``) leaf for leaf in path, shape and dtype; a small
    init on the CPU and its caches build too."""
    ref_specs = ref_build_model(ref_get_config(name)).param_specs()
    m = build_model(get_config(name))
    port = m.param_specs()
    assert all(p.device.type == "meta" for p in port.parameters())
    ref_leaves = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                  for k, v in jax.tree_util.tree_leaves_with_path(ref_specs)}
    port_leaves = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                   for k, v in jax.tree_util.tree_leaves_with_path(
                       lm_params_to_reference(port))}
    assert port_leaves == ref_leaves
    _, cfg = smoke_cfgs(name)
    small = build_model(cfg, max_seq=8)
    params = small.init_params(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.isfinite(p).all() for p in params.parameters())
    cache = small.init_cache(B, 8, enc_seq=4, device="cpu")
    assert all(t.device.type == "cpu" for d in cache.values()
               for t in (d.values() if isinstance(d, dict) else [d]))


@pytest.mark.parametrize("name", SLICE_B)
def test_bf16_params_carry_across_with_their_dtypes(name):
    """The reference's bf16 init (smoke widths) through
    ``lm_params_from_reference`` and back through ``lm_params_to_reference``
    returns every leaf bit for bit in its own dtype: the float32 router,
    RG-LRU gate biases and Λ, mLSTM gates and sLSTM cell inside a bf16
    model stay float32."""
    ref_cfg = ref_reduced(ref_get_config(name))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        ref_build_model(ref_cfg, max_seq=16).init_params)(jax.random.PRNGKey(0)))
    back = lm_params_to_reference(lm_params_from_reference(tree, reduced_for_smoke(
        get_config(name)), "cpu"))
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(tree))
    port_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert port_leaves.keys() == ref_leaves.keys()
    dtypes = set()
    for path, a in ref_leaves.items():
        t = port_leaves[path]
        dtypes.add(str(a.dtype))
        assert str(t.dtype) == f"torch.{a.dtype}", jax.tree_util.keystr(path)
        assert np.array_equal(t.float().numpy(), a.astype(np.float32)), jax.tree_util.keystr(path)
    assert "bfloat16" in dtypes
    assert ("float32" in dtypes) == (ref_cfg.family != "audio")


@pytest.mark.parametrize("name", ref_list_archs())
def test_roofline_counts_the_published_model(name):
    """``lm_param_counts`` equals the parameters ``init_params`` makes with
    the head padding off, for every arch; ``lm_step_roofline``'s prefill of
    8 x 4 and decode step at context 100 equal a count by hand for every
    arch: the attention-block decoders (dense and MoE) below, MLA, the
    RecurrentGemma pattern, xLSTM and Whisper in ``_hand_count``."""
    from repro_torch.utils import roofline as R
    cfg = get_config(name)
    specs = build_model(cfg.scaled(tp_pad_heads_to=0)).param_specs()
    counts = R.lm_param_counts(cfg)
    assert counts["total"] == sum(p.numel() for p in specs.parameters())
    if cfg.family == "audio":
        assert counts["enc_layer"] == sum(p.numel() for p in specs.enc_blocks[0].parameters())
        assert counts["dec_layer"] == sum(p.numel() for p in specs.dec_blocks[0].parameters())
        assert counts["pos_dec"] == specs.pos_dec.numel()
    else:
        for blk, btype in zip(specs.blocks, PT.block_layout(cfg)):
            assert counts["layers"][btype] == sum(p.numel() for p in blk.parameters())
    if cfg.family == "audio" or cfg.mla is not None or cfg.block_pattern:
        pre, dec = R.lm_step_roofline(cfg, 8, 4, 4), R.lm_step_roofline(cfg, 8, 1, 100)
        want = _hand_count(cfg, counts)
        for step, r in (("prefill", pre), ("decode", dec)):
            assert (r.flops, r.model_flops, r.hbm_bytes) == want[step], (name, step)
        assert dec.bound_by == "bytes"
        assert R.lm_step_roofline(cfg, 8, 512, 512, enc_seq=512).bound_by == "operations"
        return
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mm = 2 * D * H * hd + 2 * D * KV * hd
    experts = router_f32 = 0
    if cfg.moe is not None:         # olmoe: E 64, K 8, cf 1.25, no shared
        m = cfg.moe
        assert counts["expert"] == 3 * D * m.d_ff_expert and m.n_shared == 0
        assert counts["active"] == counts["total"] - L * (m.n_experts - m.top_k) * counts["expert"]
        mm += D * m.n_experts                       # the router, 2 ops a weight too
        experts = 2 * L * m.n_experts * counts["expert"]     # per slot of each buffer
        router_f32 = L * D * m.n_experts * 2
    else:
        mm += D * cfg.d_ff * (3 if cfg.ffn == "swiglu" else 2)
    bpe = 2
    kv_row = L * 2 * KV * hd
    head = V * D + (0 if cfg.tie_embeddings else 8 * 4 * D)
    pre = R.lm_step_roofline(cfg, 8, 4, 4)          # 8 sequences of 4: C = 5
    assert pre.flops == (2 * 32 * L * mm + experts * 5 + 4 * L * H * hd * 8 * 10
                         + 2 * D * V * 8)
    assert pre.hbm_bytes == bpe * (L * counts["layer"] + counts["final_norm"] + head
                                   + 32 * kv_row + 8 * V) + router_f32 + 4 * 32
    routed = 2 * L * 32 * cfg.moe.top_k * counts["expert"] if cfg.moe is not None else 0
    assert pre.model_flops == pre.flops - experts * 5 + routed   # T * K copies, not E * C
    dec = R.lm_step_roofline(cfg, 8, 1, 100)        # context 100: 99 cached; C = 2
    assert dec.flops == (2 * 8 * L * mm + experts * 2 + 4 * L * H * hd * 8 * 100
                         + 2 * D * V * 8)
    head = V * D + (0 if cfg.tie_embeddings else 8 * D)
    assert dec.hbm_bytes == bpe * (L * counts["layer"] + counts["final_norm"] + head
                                   + 8 * 99 * kv_row + 8 * kv_row + 8 * V) + router_f32 + 4 * 8
    assert dec.bound_by == "bytes"
    assert R.lm_step_roofline(cfg, 8, 512, 512).bound_by == "operations"


def _hand_count(cfg, counts) -> dict:
    """(flops, model_flops, hbm_bytes) of a prefill of 8 sequences of 4 and
    a decode step of 8 at context 100 (99 cached), bf16, for the four
    families that are not plain attention decoders, from the published
    widths. Prefill pairs: 8 x (1 + 2 + 3 + 4) = 80; decode: 8 x 100."""
    D, V, L, K = cfg.d_model, cfg.vocab_size, cfg.n_layers, cfg.conv_width
    head = 2 * D * V * 8                         # the last position's logits
    out = {}
    if cfg.mla is not None:                      # deepseek-v2-lite-16b
        m, e = cfg.mla, cfg.moe
        H, qk = cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim
        assert (D, H, qk, m.v_head_dim, m.kv_lora_rank, e.n_experts, e.top_k,
                e.d_ff_expert, e.n_shared) == (2048, 16, 192, 128, 512, 64, 6, 1408, 2)
        per_tok = (D * H * qk + D * (512 + 64) + H * 128 * D + D * 64     # q, kv-down, o, router
                   + 3 * D * 1408 * 2)                                  # the shared experts
        kv_up = 512 * H * (128 + 128)            # over the cached latent rows
        pair = 2 * H * (qk + 128)
        expert = 3 * D * 1408
        for step, T, ctx, pairs, C in (("prefill", 32, 4, 80, 4), ("decode", 8, 100, 800, 1)):
            # C = ceil(T * 6 / 64 * 1.25): 32 -> 4 slots an expert, 8 -> 1
            base = 2 * T * L * per_tok + 2 * 8 * ctx * L * kv_up + pair * L * pairs + head
            kv_row = L * (512 + 64)
            nbytes = (2 * (L * counts["layer"] + counts["final_norm"] + V * D + T * D
                           + 8 * (ctx - T // 8) * kv_row + T * kv_row + 8 * V)
                      + 2 * L * D * 64 + 4 * T)
            out[step] = (base + 2 * L * 64 * C * expert, base + 2 * L * T * 6 * expert, nbytes)
        return out
    if cfg.family == "audio":                    # whisper-base, 1,500 frames
        H, hd, F, S = cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff, 1500
        assert (D, H, hd, F, cfg.encdec.n_encoder_layers, L) == (512, 8, 64, 2048, 6, 6)
        proj, mlp = 4 * D * D, 2 * D * F         # q, k, v, o; the MLP
        enc = 6 * (2 * 8 * S * (proj + mlp) + 4 * H * hd * 8 * S * S)
        cross_kv = 6 * 2 * 8 * S * 2 * D * D
        kv_row, cross = 6 * 2 * D, 6 * 8 * S * 2 * D
        ln = 2 * D
        for step, T, pairs in (("prefill", 32, 80), ("decode", 8, 800)):
            dec = 6 * (2 * T * (proj + 2 * D * D + mlp) + 4 * H * hd * (pairs + T * S))
            if step == "prefill":
                flops = enc + cross_kv + dec + head
                nbytes = 2 * (6 * counts["enc_layer"] + 6 * counts["dec_layer"] + 2 * ln
                              + V * D + 4 * D + 8 * S * D + cross + T * kv_row + 8 * V) + 4 * T
            else:
                flops = dec + head
                nbytes = 2 * (6 * counts["dec_layer"] + ln + V * D + D + 8 * 99 * kv_row
                              + cross + T * kv_row + 8 * V) + 4 * T
            out[step] = (flops, flops, nbytes)
        return out
    if cfg.family == "hybrid":                   # recurrentgemma-9b: 26 rec + 12 attn
        W, H, KV = cfg.lru_width, cfg.n_heads, cfg.n_kv_heads
        hd, F = cfg.resolved_head_dim, cfg.d_ff
        assert (D, W, H, KV, hd, F, K, cfg.local_window) == (4096, 4096, 16, 1, 256, 12288, 4, 2048)
        rec_mm = 3 * D * W + 2 * W * W + 3 * D * F
        attn_mm = 2 * D * H * hd + 2 * D * KV * hd + 3 * D * F
        layers = 26 * counts["layers"]["rec"] + 12 * counts["layers"]["attn"]
        state = (4 * W + 3 * W * 2) * 8          # float32 h and the bf16 conv state
        row = 2 * KV * hd * 2
        for step, T, pairs in (("prefill", 32, 80), ("decode", 8, 800)):
            rec = 2 * T * rec_mm + 2 * K * W * T
            # the log-depth scan of 4 steps: 9 + 4 ops a channel, the cached h
            # folded in (2); the recurrence 2 a step; a decode step 2
            scan, model = (((13 + 2) * W * 8, 2 * 4 * W * 8) if step == "prefill"
                           else (2 * W * 8, 2 * W * 8))
            attn = 2 * T * attn_mm + 4 * H * hd * pairs
            moved = (26 * (state + 4 * W * 8) + 12 * 8 * 4 * row if step == "prefill"
                     else 26 * 2 * state + 12 * 8 * 100 * row)
            nbytes = (2 * (layers + counts["final_norm"] + V * D + T * D + 8 * V)
                      + 2 * 26 * 3 * W + moved + 4 * T)
            out[step] = (26 * (rec + scan) + 12 * attn + head,
                         26 * (rec + model) + 12 * attn + head, nbytes)
        return out
    # xlstm-1.3b: 42 mLSTM + 6 sLSTM blocks, no FFN outside the sLSTM
    nh, d_in, dh, dhs, F = cfg.n_heads, 2 * D, 1024, 512, 2688
    assert (D, nh, d_in // nh, D // nh, int(4 / 3 * D) // 64 * 64) == (2048, 4, dh, dhs, F)
    m_mm = 2 * D * d_in + 3 * d_in * d_in + 2 * d_in * nh + d_in * D
    s_tok = 2 * (4 * D * D + 3 * D * F) + 8 * nh * dhs * dhs
    layers = 42 * counts["layers"]["mlstm"] + 6 * counts["layers"]["slstm"]
    f32 = 42 * (2 * d_in * nh + 2 * nh) + 6 * (4 * D * D + 4 * D + 4 * nh * dhs * dhs)
    m_state = (nh * dh * dh * 4 + nh * dh * 4 + nh * 4 + 3 * d_in * 2) * 8
    s_state = 2 * 4 * D * 4 * 8                  # (c, n, h, m) read and written
    for step, T in (("prefill", 32), ("decode", 8)):
        base = 2 * T * m_mm + 2 * K * d_in * T
        if step == "prefill":                    # one chunk of 4: 4 x 4 keys + its 4 x 4 block
            build = 2 * 8 * nh * 4 * dh * dh     # the final C in closed form
            quad, model = 4 * 8 * nh * dh * (16 + 16) + build, 4 * 8 * nh * dh * 10 + build
            moved = 42 * m_state + 6 * s_state
        else:
            quad = model = 2 * 8 * nh * (dh * dh + dh)
            moved = 42 * 2 * m_state + 6 * s_state
        nbytes = (2 * (layers + counts["final_norm"] + V * D + T * D + 8 * V) + 2 * f32
                  + moved + 4 * T)
        out[step] = (42 * (base + quad) + 6 * T * s_tok + head,
                     42 * (base + model) + 6 * T * s_tok + head, nbytes)
    return out
