"""Whisper-style encoder-decoder backbone (conv frontend stubbed).

Counterpart of ``repro.models.whisper``. The conv1d/mel frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
(B, S_enc, D). Encoder: bidirectional attention + sinusoidal positions.
Decoder: causal self-attention (cached) + cross-attention over the encoder
states (K/V cached at prefill) + GELU MLP, learned positions, LayerNorm,
tied unembedding. The reference scans over stacked layers; here each layer
is a module and the decoder reads and writes its slice of the caches in
place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import checkpointed


def _dims(cfg):
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def _enc_block_init(generator, cfg, dtype, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.norm_init(cfg.d_model, "layernorm", dtype, device),
        "attn": L.attn_init(generator, _dims(cfg), dtype, device, bias=True),
        "ln2": L.norm_init(cfg.d_model, "layernorm", dtype, device),
        "ffn": L.ffn_init(generator, cfg.d_model, cfg.d_ff, "mlp_gelu", dtype, device),
    })


def _dec_block_init(generator, cfg, dtype, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.norm_init(cfg.d_model, "layernorm", dtype, device),
        "self_attn": L.attn_init(generator, _dims(cfg), dtype, device, bias=True),
        "ln_x": L.norm_init(cfg.d_model, "layernorm", dtype, device),
        "cross_attn": L.attn_init(generator, _dims(cfg), dtype, device, bias=True),
        "ln2": L.norm_init(cfg.d_model, "layernorm", dtype, device),
        "ffn": L.ffn_init(generator, cfg.d_model, cfg.d_ff, "mlp_gelu", dtype, device),
    })


class WhisperParams(nn.Module):
    """An encoder-decoder's weights: ``embed`` (V, D, tied with the head),
    ``pos_dec`` (max_dec_seq, D), one block per encoder and decoder layer,
    and the two final norms."""

    def __init__(self, embed, pos_dec, enc_blocks, dec_blocks, enc_norm, dec_norm):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.pos_dec = nn.Parameter(pos_dec)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.enc_norm = enc_norm
        self.dec_norm = dec_norm


def init_params(generator, cfg: ArchConfig, device, *, max_dec_seq: int = 4096):
    dtype = getattr(torch, cfg.dtype)
    embed = L.embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype, device)
    pos_dec = L.embed_init(generator, (max_dec_seq, cfg.d_model), dtype, device)
    enc = [_enc_block_init(generator, cfg, dtype, device)
           for _ in range(cfg.encdec.n_encoder_layers)]
    dec = [_dec_block_init(generator, cfg, dtype, device) for _ in range(cfg.n_layers)]
    return WhisperParams(embed, pos_dec, enc, dec,
                         L.norm_init(cfg.d_model, "layernorm", dtype, device),
                         L.norm_init(cfg.d_model, "layernorm", dtype, device))


def _cross_attn(p, x, ck, cv, chunk):
    """Cross-attention with precomputed K/V (B, S_enc, H, hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"]) + p["bq"]
    out = L.chunked_attention(q, ck, cv, causal=False, chunk=chunk)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"]) + p["bo"]


def cross_kv(p, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]) + p["bk"]
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"]) + p["bv"]
    return k, v


def _enc_block(p, x, cfg, chunk):
    h = L.norm_apply(p["ln1"], x, "layernorm", cfg.norm_eps)
    o, _ = L.attn_apply(p["attn"], h, None, dims=_dims(cfg), causal=False,
                        chunk=chunk, use_rope=False)
    x = x + o
    h2 = L.norm_apply(p["ln2"], x, "layernorm", cfg.norm_eps)
    return x + L.ffn_apply(p["ffn"], h2, "mlp_gelu")


def encode(params: WhisperParams, cfg: ArchConfig, frame_embeds, *, chunk=1024,
           remat=False):
    """Encoder forward; ``remat`` checkpoints each block when gradients are
    being taken."""
    B, S, D = frame_embeds.shape
    pos = L.sinusoidal_positions(S, D, frame_embeds.device).to(frame_embeds.dtype)
    x = frame_embeds + pos[None]
    remat = remat and torch.is_grad_enabled()
    for p in params.enc_blocks:
        x = (checkpointed(_enc_block, p, x, cfg, chunk) if remat
             else _enc_block(p, x, cfg, chunk))
    return L.norm_apply(params.enc_norm, x, "layernorm", cfg.norm_eps)


def _dec_block(p, xx, cfg, *, sc=None, cache_index=None, ck=None, cv=None, chunk=1024):
    """One decoder block; a self-attention cache ``sc`` is written in place."""
    h = L.norm_apply(p["ln1"], xx, "layernorm", cfg.norm_eps)
    o, _ = L.attn_apply(p["self_attn"], h, None, dims=_dims(cfg), causal=True,
                        cache=sc, cache_index=cache_index, chunk=chunk, use_rope=False)
    xx = xx + o
    h = L.norm_apply(p["ln_x"], xx, "layernorm", cfg.norm_eps)
    xx = xx + _cross_attn(p["cross_attn"], h, ck, cv, chunk)
    h = L.norm_apply(p["ln2"], xx, "layernorm", cfg.norm_eps)
    return xx + L.ffn_apply(p["ffn"], h, "mlp_gelu")


def decode(params: WhisperParams, cfg: ArchConfig, tokens, *, enc_out=None,
           cache=None, cache_index=None, chunk=1024, remat=False):
    """Decoder forward. Returns (hidden, cache).

    * full pass: ``enc_out`` given, no cache     -> (hidden, None); with
      ``remat``, each block is checkpointed when gradients are being taken
      (its cross K/V computed outside, as the reference computes them)
    * prefill:   ``enc_out`` given, a cache      -> fills the self cache in
      place from position 0 and sets the cross K/V
    * decode:    a cache holding the cross K/V, tokens (B, 1) at
      ``cache_index`` (an int)
    """
    B, S = tokens.shape
    base = cache_index if cache_index is not None else 0
    pos_ids = base + torch.arange(S, device=tokens.device)
    x = params.embed[tokens.long()] + params.pos_dec[pos_ids][None]

    if cache is not None and cache_index is None:
        # prefill: the cross K/V replace the cache's (as the reference's
        # returned cache does), so they take the encoder's length and KV heads
        kv = [cross_kv(p["cross_attn"], enc_out) for p in params.dec_blocks]
        cache["ck"] = torch.stack([k for k, _ in kv]).to(cache["ck"].dtype)
        cache["cv"] = torch.stack([v for _, v in kv]).to(cache["cv"].dtype)

    remat = remat and cache is None and torch.is_grad_enabled()
    for layer, p in enumerate(params.dec_blocks):
        if cache is None:
            ck, cv = cross_kv(p["cross_attn"], enc_out)
            sc = None
        else:
            ck, cv = cache["ck"][layer], cache["cv"][layer]
            sc = {"k": cache["k"][layer], "v": cache["v"][layer]}
        if remat:
            x = checkpointed(_dec_block, p, x, cfg, ck=ck, cv=cv, chunk=chunk)
        else:
            x = _dec_block(p, x, cfg, sc=sc, cache_index=cache_index, ck=ck, cv=cv,
                           chunk=chunk)
    return L.norm_apply(params.dec_norm, x, "layernorm", cfg.norm_eps), cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, enc_seq: int, device,
               dtype=None):
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    hd = cfg.resolved_head_dim
    nl, H = cfg.n_layers, cfg.n_kv_heads

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": zeros((nl, batch, max_seq, H, hd)),
            "v": zeros((nl, batch, max_seq, H, hd)),
            "ck": zeros((nl, batch, enc_seq, cfg.n_heads, hd)),
            "cv": zeros((nl, batch, enc_seq, cfg.n_heads, hd))}


def lm_head(params: WhisperParams, hidden):
    return torch.einsum("bsd,vd->bsv", hidden, params.embed)
