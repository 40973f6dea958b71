"""Shared neural layers: norms, RoPE/M-RoPE, GQA/MLA attention, FFNs.

Counterpart of ``repro.models.layers``. Each layer is an
``*_init(generator, ..., dtype, device)`` that returns its parameters as an
``nn.ParameterDict`` plus an ``*_apply(p, ...)`` that reads them by the
reference's names, so ``p`` may as well be a plain dict of tensors. Weights
keep the reference's einsum layouts (``wq`` is (D, H, hd), ``wo`` is
(H, hd, D)): carrying weights across is a copy, never a transpose.

Numerics follow the reference: norms, RoPE and the attention scores and
softmax are computed in float32 and cast back; masked scores are filled
with ``-1e30`` (not ``-inf``), so a fully masked row stays finite.

Caches are updated in place (``Tensor.copy_`` into a slice) and returned.
The reference returns a new cache from ``jax.lax.dynamic_update_slice``;
its serving loop donates the old one, so no caller sees the difference.
The write start is clamped as ``dynamic_update_slice`` clamps it: an index
past ``Smax - S_new`` writes the last slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _truncated_normal(generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn in float32 from
    ``generator`` on ``device``; on ``meta`` only the shape is made."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t


def uniform_init(generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """float32 uniform on [lo, hi) from ``generator`` on ``device``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.uniform_(lo, hi, generator=generator)
    return t


class ParamTree(nn.Module):
    """A dict of tensors and sub-trees that reads like the reference's
    params dict (``p["w_up"]``, ``"shared" in p``) and registers its
    tensors as parameters and its sub-trees as modules: for params that
    mix both (a MoE FFN with shared experts), which neither
    ``nn.ParameterDict`` nor ``nn.ModuleDict`` holds."""

    def __init__(self, tree: dict):
        super().__init__()
        self._names = list(tree)
        for k, v in tree.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self._names

    def items(self):
        return [(k, self[k]) for k in self._names]


def dense_init(generator, shape, dtype, device, scale: float | None = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (_truncated_normal(generator, shape, device) * scale).to(dtype)


def embed_init(generator, shape, dtype, device):
    return (_truncated_normal(generator, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(d: int, kind: str, dtype, device) -> nn.ParameterDict:
    p = nn.ParameterDict({"scale": torch.ones((d,), dtype=dtype, device=device)})
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        rms = torch.sqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
        out = xf / rms * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) / torch.sqrt(var + eps) * p["scale"].float()
        out = out + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim)."""
    ang = positions[..., None].float() * _inv_freq(head_dim, theta, positions.device)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _mrope_angles(positions3, sections, head_dim: int, theta: float):
    """positions3 (3, B, S), sections sum == head_dim//2 -> cos/sin (B,S,hd).

    Qwen2-VL M-RoPE: the first `sections[0]` rotary frequencies take their
    position from the temporal stream, the next from height, the last from
    width. Text tokens carry identical (t,h,w) positions, reducing to RoPE.
    """
    sec_id = torch.as_tensor(
        np.repeat(np.arange(len(sections)), np.asarray(sections)),
        device=positions3.device)
    # pos_f (B, S, half): per-frequency position stream
    pos_f = positions3[sec_id]                              # (half, B, S)
    pos_f = torch.movedim(pos_f, 0, -1).float()             # (B, S, half)
    ang = pos_f * _inv_freq(head_dim, theta, positions3.device)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x, cos, sin):
    """x (B, S, H, hd); cos/sin (B, S, hd) or (S, hd)."""
    while cos.ndim < x.ndim:
        cos = cos.unsqueeze(-2) if cos.ndim == x.ndim - 1 else cos[None]
        sin = sin.unsqueeze(-2) if sin.ndim == x.ndim - 1 else sin[None]
    xf = x.float()
    out = xf * cos + _rotate_half(xf) * sin
    return out.to(x.dtype)


def rope_cos_sin(cfg, positions, *, positions3=None):
    hd = cfg.resolved_head_dim if hasattr(cfg, "resolved_head_dim") else cfg.head_dim
    if getattr(cfg, "mla", None) is not None:
        hd = cfg.mla.qk_rope_head_dim
    if getattr(cfg, "mrope_sections", ()) and positions3 is not None:
        return _mrope_angles(positions3, cfg.mrope_sections, hd, cfg.rope_theta)
    return _rope_angles(positions, hd, cfg.rope_theta)


def sinusoidal_positions(max_len: int, d: int, device=None):
    """Whisper-style fixed sinusoidal embeddings (max_len, d)."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# attention (GQA, chunked-causal, optional sliding window, KV cache decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_real_heads: int = 0    # 0 = all heads real; else the tail heads are
    #                          TP padding with zeroed output rows


def real_head_positions(d: AttnDims):
    """Indices of the real heads inside the padded head layout, or None.

    GQA maps q-head h to kv-head h // (H/KV), so padding must be appended
    *within each kv group* (not at the tail) to preserve the real heads'
    kv assignment. Real head r of group g sits at g*(Hp/KV) + (r mod H/KV).
    """
    nr = d.n_real_heads or d.n_heads
    if nr == d.n_heads:
        return None
    kv = d.n_kv_heads
    rpg, ppg = nr // kv, d.n_heads // kv
    return np.concatenate([g * ppg + np.arange(rpg) for g in range(kv)])


def attn_init(generator, d: AttnDims, dtype, device, *, bias: bool = False):
    wq = dense_init(generator, (d.d_model, d.n_heads, d.head_dim), dtype, device)
    wk = dense_init(generator, (d.d_model, d.n_kv_heads, d.head_dim), dtype, device)
    wv = dense_init(generator, (d.d_model, d.n_kv_heads, d.head_dim), dtype, device)
    wo = dense_init(generator, (d.n_heads, d.head_dim, d.d_model), dtype, device)
    pos = real_head_positions(d)
    if pos is not None:
        # zero the padded heads' output rows: their attention output
        # contributes exactly nothing
        pad = np.ones(d.n_heads, dtype=bool)
        pad[pos] = False
        wo[torch.as_tensor(pad, device=wo.device)] = 0
    p = nn.ParameterDict({"wq": wq, "wk": wk, "wv": wv, "wo": wo})
    if bias:
        p["bq"] = torch.zeros((d.n_heads, d.head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((d.n_kv_heads, d.head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((d.n_kv_heads, d.head_dim), dtype=dtype, device=device)
        p["bo"] = torch.zeros((d.d_model,), dtype=dtype, device=device)
    return p


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, hd).reshape(B, S, KV * n_rep, hd)


def _write(buf, new, start: int) -> None:
    """``buf[:, start:start + S_new] = new`` with the start placed as
    ``jax.lax.dynamic_update_slice`` places it: a negative start counts
    from the end, then the start is clamped into [0, Smax - S_new]."""
    s_new, smax = new.shape[1], buf.shape[1]
    start = int(start)
    start = min(max(start + smax if start < 0 else start, 0), smax - s_new)
    buf[:, start:start + s_new].copy_(new)


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      window: int = 0, chunk: int = 1024,
                      kv_valid_len=None):
    """Memory-efficient attention: q chunked, full K/V per chunk.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). ``q_offset`` is the absolute
    position of q[0] (for decode/cache alignment). ``window`` > 0 enables a
    sliding-window (local) causal mask. ``kv_valid_len`` masks cache tails.
    Never materialises more than (B, H, chunk, Skv) scores — the softmax is
    exact (per-chunk rows are complete), so no online rescaling is needed.
    The reference pads q to whole chunks; a shorter last chunk gives the
    real rows the same values.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    scale = 1.0 / np.sqrt(hd)
    chunk = min(chunk, Sq)

    kT = k.permute(0, 2, 3, 1).float()  # (B, H, hd, Skv)
    vT = v.permute(0, 2, 1, 3).float()  # (B, H, Skv, hd)
    kv_pos = torch.arange(Skv, device=q.device)

    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk].transpose(1, 2)           # (B, H, c, hd)
        s = torch.einsum("bhqd,bhdk->bhqk", qc.float(), kT) * scale
        q_pos = q_offset + c0 + torch.arange(qc.shape[2], device=q.device)
        mask = torch.ones((qc.shape[2], Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_valid_len is not None:
            mask &= kv_pos[None, :] < kv_valid_len
        s = torch.where(mask[None, None], s, -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vT))
    out = torch.cat(outs, dim=2).transpose(1, 2)            # (B, Sq, H, hd_v)
    return out.to(q.dtype)


def attn_apply(p, x, cos_sin, *, dims: AttnDims, causal=True, window=0,
               cache=None, cache_index=None, chunk=1024, use_rope=True):
    """Returns (out, cache). cache = {'k','v'} (B, Smax, KV, hd).

    Prefill: cache=None or empty cache to fill. Decode: x is (B, 1, D) and
    cache_index is the write position (an int). The cache is written in
    place.
    """
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]; k = k + p["bk"]; v = v + p["bv"]
    if use_rope and cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is not None and cache_index is not None:
        # decode: append k/v at cache_index (ring for windowed layers)
        Smax = cache["k"].shape[1]
        widx = cache_index % Smax if window else cache_index
        _write(cache["k"], k.to(cache["k"].dtype), widx)
        _write(cache["v"], v.to(cache["v"].dtype), widx)
        valid = min(cache_index + 1, Smax) if window else cache_index + 1
        # with a window ring, mask by validity only (all entries in-window)
        out = chunked_attention(
            q, cache["k"], cache["v"], causal=False, q_offset=0, window=0,
            chunk=1, kv_valid_len=valid)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=chunk)
        if cache is not None:  # prefill into cache
            Smax = cache["k"].shape[1]
            if window and Smax < k.shape[1]:
                k, v = k[:, -Smax:], v[:, -Smax:]
            _write(cache["k"], k.to(cache["k"].dtype), 0)
            _write(cache["v"], v.to(cache["v"].dtype), 0)

    o = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    if "bo" in p:
        o = o + p["bo"]
    return o, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg, dtype, device):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {
        "wq": (D, H, qk_dim),
        "w_dkv": (D, m.kv_lora_rank + m.qk_rope_head_dim),
        "w_uk": (m.kv_lora_rank, H, m.qk_nope_head_dim),
        "w_uv": (m.kv_lora_rank, H, m.v_head_dim),
        "wo": (H, m.v_head_dim, cfg.d_model),
    }
    return nn.ParameterDict({n: dense_init(generator, s, dtype, device)
                             for n, s in shapes.items()})


def mla_apply(p, x, cos_sin, *, cfg, cache=None, cache_index=None, chunk=1024):
    """MLA with latent KV cache: cache = {'ckv': (B, Smax, r + rope_dim)}.

    The latent c_kv (+ shared rope key) is what gets cached — the paper-
    relevant serving win (cache bytes/token = r + rope_dim ≪ 2·H·hd).
    """
    m = cfg.mla
    H = cfg.n_heads
    r = m.kv_lora_rank
    cos, sin = cos_sin

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, apply_rope(q_rope, cos, sin)], dim=-1)

    ckv_full = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])   # (B, S, r+rope)
    k_rope_new = apply_rope(ckv_full[..., None, r:], cos, sin)  # (B,S,1,rope)
    ckv_new = torch.cat([ckv_full[..., :r], k_rope_new[..., 0, :]], dim=-1)

    decode = cache is not None and cache_index is not None
    if decode:
        _write(cache["ckv"], ckv_new.to(cache["ckv"].dtype), cache_index)
        ckv_att, kv_valid = cache["ckv"], cache_index + 1
    else:
        if cache is not None:
            _write(cache["ckv"], ckv_new.to(cache["ckv"].dtype), 0)
        ckv_att, kv_valid = ckv_new, None

    # up-project latent to per-head K (nope part) and V
    c = ckv_att[..., :r]
    k_nope = torch.einsum("bsr,rhk->bshk", c, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"])
    k_rope = ckv_att[..., None, r:].expand(*ckv_att.shape[:2], H, m.qk_rope_head_dim)
    k = torch.cat([k_nope, k_rope], dim=-1)

    out = chunked_attention(
        q, k, v, causal=not decode, chunk=(1 if decode else chunk),
        kv_valid_len=kv_valid)
    o = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return o, cache


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------


def ffn_init(generator, d_model: int, d_ff: int, kind: str, dtype, device):
    if kind == "swiglu":
        return nn.ParameterDict({
            "w_gate": dense_init(generator, (d_model, d_ff), dtype, device),
            "w_up": dense_init(generator, (d_model, d_ff), dtype, device),
            "w_down": dense_init(generator, (d_ff, d_model), dtype, device),
        })
    if kind == "mlp_gelu":
        return nn.ParameterDict({
            "w_in": dense_init(generator, (d_model, d_ff), dtype, device),
            "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_out": dense_init(generator, (d_ff, d_model), dtype, device),
            "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
        })
    raise ValueError(kind)


def ffn_apply(p, x, kind: str):
    if kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        u = torch.einsum("bsd,df->bsf", x, p["w_up"])
        return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"])
    if kind == "mlp_gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["w_in"]) + p["b_in"],
                   approximate="tanh")
        return torch.einsum("bsf,fd->bsd", h, p["w_out"]) + p["b_out"]
    raise ValueError(kind)
