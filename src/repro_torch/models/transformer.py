"""Decoder-only assembly for the dense, MoE, MLA, hybrid, SSM and VLM
families.

Counterpart of ``repro.models.transformer``. The reference stores layers
stacked per block type and runs them with ``jax.lax.scan`` (superblocks for
repeating patterns, a tail scan for the remainder); here the weights are
one module per layer and the forward is one Python loop over
``block_layout(cfg)``, which serves every pattern alike.

Caches keep the reference's per-type stacked layout: cache["attn_block"]["k"]
has shape (n_attn_block_layers, B, S_max, KV, hd), cache["rec"]["h"]
(n_rec_layers, B, W), etc. A layer reads and writes its own slice of the
stack in place.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl

# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def block_layout(cfg: ArchConfig) -> list[str]:
    """Per-layer block type, length n_layers."""
    if not cfg.block_pattern:
        base = "mla_block" if cfg.mla else "attn_block"
        return [base] * cfg.n_layers
    pat = list(cfg.block_pattern)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def type_counts(cfg: ArchConfig) -> dict[str, int]:
    lay = block_layout(cfg)
    return {t: lay.count(t) for t in dict.fromkeys(lay)}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    h = cfg.n_heads
    m = getattr(cfg, "tp_pad_heads_to", 0)
    if m and h % m:
        h = -(-h // m) * m      # pad: extra heads have zeroed output rows
    return L.AttnDims(cfg.d_model, h, cfg.n_kv_heads,
                      cfg.resolved_head_dim, n_real_heads=cfg.n_heads)


def init_block(generator, cfg: ArchConfig, btype: str, dtype, device) -> nn.ModuleDict:
    D = cfg.d_model
    p = nn.ModuleDict({"ln1": L.norm_init(D, cfg.norm, dtype, device)})
    if btype in ("attn_block", "attn"):   # "attn": hybrid local-attention block
        p["attn"] = L.attn_init(generator, _attn_dims(cfg), dtype, device)
    elif btype == "mla_block":
        p["attn"] = L.mla_init(generator, cfg, dtype, device)
    elif btype == "rec":
        p["rec"] = rg.rglru_init(generator, D, cfg.lru_width or D, cfg.conv_width,
                                 dtype, device)
    elif btype == "mlstm":
        p["cell"] = xl.mlstm_init(generator, D, cfg.n_heads, cfg.conv_width, dtype, device)
        return p
    elif btype == "slstm":
        p["cell"] = xl.slstm_init(generator, D, cfg.n_heads, dtype, device)
        return p
    else:
        raise ValueError(btype)

    if cfg.ffn != "none":
        p["ln2"] = L.norm_init(D, cfg.norm, dtype, device)
        if cfg.moe is not None:
            p["ffn"] = moe_mod.moe_init(generator, cfg, dtype, device)
        else:
            p["ffn"] = L.ffn_init(generator, D, cfg.d_ff, cfg.ffn, dtype, device)
    return p


class LMParams(nn.Module):
    """A decoder's weights: ``embed`` (V, D), ``final_norm``, ``unembed``
    (D, V; None when the embeddings are tied) and one block per layer in
    ``block_layout`` order, whose block types ``layout`` names (the
    checkpoint stacks the layers by type, as the reference stores them)."""

    def __init__(self, embed, final_norm, blocks, unembed=None, *, layout):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.final_norm = final_norm
        self.blocks = nn.ModuleList(blocks)
        self.register_parameter(
            "unembed", None if unembed is None else nn.Parameter(unembed))
        self.layout = tuple(layout)
        if len(self.layout) != len(self.blocks):
            raise ValueError(f"{len(self.blocks)} blocks, a layout of {len(self.layout)}")


def init_params(generator, cfg: ArchConfig, device) -> LMParams:
    dtype = getattr(torch, cfg.dtype)
    embed = L.embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype, device)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = L.dense_init(generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    layout = block_layout(cfg)
    blocks = [init_block(generator, cfg, t, dtype, device) for t in layout]
    return LMParams(embed, L.norm_init(cfg.d_model, cfg.norm, dtype, device),
                    blocks, unembed, layout=layout)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device, dtype=None):
    """Per-type stacked decode caches (every type the reference has)."""
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    hd = cfg.resolved_head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    cache = {}
    for btype, n in type_counts(cfg).items():
        if btype in ("attn_block", "attn"):
            S = min(max_seq, cfg.local_window) if (
                btype == "attn" and cfg.local_window) else max_seq
            cache[btype] = {"k": zeros((n, batch, S, cfg.n_kv_heads, hd)),
                            "v": zeros((n, batch, S, cfg.n_kv_heads, hd))}
        elif btype == "mla_block":
            m = cfg.mla
            cache[btype] = {"ckv": zeros(
                (n, batch, max_seq, m.kv_lora_rank + m.qk_rope_head_dim))}
        elif btype == "rec":
            w = cfg.lru_width or cfg.d_model
            cache[btype] = {"h": zeros((n, batch, w), torch.float32),
                            "conv": zeros((n, batch, cfg.conv_width - 1, w))}
        elif btype == "mlstm":
            d_in = xl.PF_MLSTM * cfg.d_model
            dh = d_in // cfg.n_heads
            cache[btype] = {
                "C": zeros((n, batch, cfg.n_heads, dh, dh), torch.float32),
                "n": zeros((n, batch, cfg.n_heads, dh), torch.float32),
                "m": full((n, batch, cfg.n_heads), -1e30),
                "conv": zeros((n, batch, cfg.conv_width - 1, d_in)),
            }
        elif btype == "slstm":
            D = cfg.d_model
            cache[btype] = {"c": zeros((n, batch, D), torch.float32),
                            "n": zeros((n, batch, D), torch.float32),
                            "h": zeros((n, batch, D), torch.float32),
                            "m": full((n, batch, D), -1e30)}
    return cache


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def apply_block(p, x, btype, cfg: ArchConfig, cos_sin, *, cache=None,
                cache_index=None, chunk=1024):
    """One residual block. Returns (x, new_cache_slice, aux_loss): the
    attention blocks write their cache slice in place and return it; the
    recurrent ones return their new state as fresh tensors. ``aux_loss``
    is the MoE load-balance loss, None without MoE. A decode step is a
    call with both a cache and a ``cache_index``."""
    aux = None
    decode = cache is not None and cache_index is not None
    h = L.norm_apply(p["ln1"], x, cfg.norm, cfg.norm_eps)

    if btype in ("attn_block", "attn"):
        window = cfg.local_window if btype == "attn" else 0
        o, new_c = L.attn_apply(
            p["attn"], h, cos_sin, dims=_attn_dims(cfg),
            causal=True, window=window, cache=cache,
            cache_index=cache_index, chunk=chunk,
            use_rope=cfg.rope_theta > 0)
    elif btype == "mla_block":
        o, new_c = L.mla_apply(p["attn"], h, cos_sin, cfg=cfg, cache=cache,
                               cache_index=cache_index, chunk=chunk)
    elif btype == "rec":
        o, new_c = rg.rec_block_apply(p["rec"], h, cache=cache, decode=decode)
    elif btype == "mlstm":
        o, new_c = xl.mlstm_block_apply(p["cell"], h, cfg.n_heads, cache=cache,
                                        decode=decode, chunk=min(chunk, 256))
        return x + o, new_c, aux
    elif btype == "slstm":
        o, new_c = xl.slstm_block_apply(p["cell"], h, cfg.n_heads, cache=cache,
                                        decode=decode)
        return x + o, new_c, aux
    else:
        raise ValueError(btype)

    x = x + o
    if cfg.ffn != "none":
        h2 = L.norm_apply(p["ln2"], x, cfg.norm, cfg.norm_eps)
        if cfg.moe is not None:
            f, aux = moe_mod.moe_apply(p["ffn"], h2, cfg)
        else:
            f = L.ffn_apply(p["ffn"], h2, cfg.ffn)
        x = x + f
    return x, new_c, aux


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def checkpointed(fn, *args, **kw):
    """``fn(*args, **kw)`` under activation checkpointing (the reference's
    ``jax.checkpoint`` of a block): its activations are recomputed in the
    backward pass instead of kept. The blocks draw no random numbers, so
    no RNG state is saved."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False, **kw)


def forward(params: LMParams, cfg: ArchConfig, tokens, *, positions=None,
            positions3=None, vision_embeds=None, cache=None,
            cache_index=None, chunk=1024, remat=False):
    """Returns (hidden (B,S,D), cache, aux_loss float32). Logits via lm_head().

    With a cache and no ``cache_index`` the tokens are prefilled into it
    from position 0; with ``cache_index`` (an int) they are decoded at that
    position. The cache is written in place and returned. ``aux_loss`` is
    the MoE load-balance loss summed over layers (0 without MoE).
    ``remat`` checkpoints each block when gradients are being taken and
    there is no cache.
    """
    B, S = tokens.shape
    x = params.embed[tokens.long()]
    if vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)

    if positions is None:
        base = cache_index if cache_index is not None else 0
        positions = (base + torch.arange(S, device=x.device))[None, :].expand(B, S)
    cos_sin = None
    if cfg.rope_theta > 0:
        cos_sin = L.rope_cos_sin(cfg, positions, positions3=positions3)

    aux_total = None
    seen: dict[str, int] = {}
    for p, btype in zip(params.blocks, block_layout(cfg)):
        j = seen.get(btype, 0)
        seen[btype] = j + 1
        c = None if cache is None else {n: t[j] for n, t in cache[btype].items()}
        if remat and cache is None and torch.is_grad_enabled():
            x, new_c, aux = checkpointed(apply_block, p, x, btype, cfg, cos_sin,
                                         chunk=chunk)
        else:
            x, new_c, aux = apply_block(p, x, btype, cfg, cos_sin, cache=c,
                                        cache_index=cache_index, chunk=chunk)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        if c is not None and new_c is not c:
            for n, t in new_c.items():
                c[n].copy_(t)

    x = L.norm_apply(params.final_norm, x, cfg.norm, cfg.norm_eps)
    if aux_total is None:
        aux_total = x.new_zeros((), dtype=torch.float32)
    return x, cache, aux_total


def lm_head(params: LMParams, cfg: ArchConfig, hidden):
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return torch.einsum("bsd,dv->bsv", hidden, w)


def lm_loss(params: LMParams, cfg: ArchConfig, hidden, targets, mask, *,
            chunk: int = 512):
    """Chunked cross-entropy over the sequence (bounds the (B,chunk,V)
    logits intermediate)."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        h, t = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        m = mask[:, c0:c0 + chunk].float()
        logits = lm_head(params, cfg, h).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        total = total + torch.sum((logz - gold) * m)
        count = count + torch.sum(m)
    return total / torch.clamp(count, min=1.0)
