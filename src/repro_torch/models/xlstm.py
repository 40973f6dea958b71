"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, parallelisable)
and sLSTM (scalar memory, sequential), composed 7:1 for xlstm-1.3b.

Counterpart of ``repro.models.xlstm``. mLSTM cell (per head, exponential
gating with stabiliser m):
    C_t = f_t C_{t-1} + i_t v_t k_tᵀ     n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_tᵀ q_t) / max(|n_tᵀ q_t|, exp(-m_t))
Prefill uses the stabilised parallel form with q-chunking (a Python loop
over chunks where the reference has ``lax.map``); decode carries (C, n, m)
as O(1) state, which prefill builds in closed form.

sLSTM keeps per-channel scalar memories with block-diagonal (per-head)
recurrent connections. Its prefill is a Python loop over time in float32,
where the reference runs ``lax.scan``: one step's four recurrent products
are one batched matmul over the heads.

GroupNorm is realised as per-head RMSNorm, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init
from repro_torch.models.rglru import causal_conv

PF_MLSTM = 2          # mLSTM up-projection factor
PF_SLSTM = 4.0 / 3.0  # sLSTM FFN projection factor


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(generator, d_model: int, n_heads: int, conv_width: int, dtype,
               device) -> nn.ParameterDict:
    d_in = PF_MLSTM * d_model

    def dense(shape, dt=dtype, **kw):
        return dense_init(generator, shape, dt, device, **kw)

    return nn.ParameterDict({
        "w_up": dense((d_model, 2 * d_in)),
        "conv_w": dense((conv_width, d_in), scale=0.5),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "w_q": dense((d_in, d_in)),
        "w_k": dense((d_in, d_in)),
        "w_v": dense((d_in, d_in)),
        # the gate projections stay float32 in a bf16 model
        "w_i": dense((d_in, n_heads), torch.float32, scale=0.02),
        "b_i": torch.zeros((n_heads,), dtype=torch.float32, device=device),
        "w_f": dense((d_in, n_heads), torch.float32, scale=0.02),
        "b_f": torch.full((n_heads,), 3.0, dtype=torch.float32, device=device),
        "out_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "w_down": dense((d_in, d_model)),
    })


def _heads(x, nh):
    B, S, D = x.shape
    return x.reshape(B, S, nh, D // nh).transpose(1, 2)      # (B,NH,S,DH)


def _unheads(x):
    B, NH, S, DH = x.shape
    return x.transpose(1, 2).reshape(B, S, NH * DH)


def mlstm_parallel(q, k, v, ig, fg, *, chunk: int = 256, separable: bool = True):
    """Stabilised parallel mLSTM. q/k/v (B,NH,S,DH); ig/fg (B,NH,S) pre-act.

    Two formulations, the reference's, with identical results:

    * ``separable=True`` (default): with the row stabiliser written as a
      running max, m_i = b_i + cummax_{j<=i} (ig_j - b_j), the decay factors
      as D_ij = exp(b_i - m_i) exp(ig_j - b_j), so its factors scale the q
      and k rows before the dot; each chunk re-centres on its first cummax
      value kappa. Intra-chunk pairs take the exact (chunk, chunk) form.
    * ``separable=False``: the paper's appendix form, which materialises the
      log-decay, its row max and exp per (chunk, S) block.

    A shorter last chunk stands in for the reference's zero padding: a real
    row's padded columns all lie after it and are masked either way.
    """
    B, NH, S, DH = q.shape
    lf = F.logsigmoid(fg)                               # (B,NH,S)
    bcum = torch.cumsum(lf, dim=-1)
    scale = 1.0 / np.sqrt(DH)
    chunk = min(chunk, S)
    j_pos = torch.arange(S, device=q.device)
    kf, vf = k.float(), v.float()

    outs = []
    if separable:
        a = ig - bcum                                    # (B,NH,S)
        cmax = torch.cummax(a, dim=-1).values            # m_i = b_i + cmax_i
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            qc, kc, vc = q[:, :, sl].float(), kf[:, :, sl], vf[:, :, sl]
            cmc, bc, ac = cmax[..., sl], bcum[..., sl], a[..., sl]
            n = qc.shape[2]
            # Inter-chunk (j < c0): D_ij = exp(a_j - kappa) * exp(kappa - cm_i);
            # for j < c0, a_j <= kappa, so the k factor is <= 1 and the
            # min(., 0) clamp only touches masked columns. At the running
            # max a_j == kappa exactly: torch.minimum splits the gradient
            # of that tie in half as jnp.minimum does (a clamp passes it whole).
            kappa = cmc[..., :1]
            m = bc + cmc                                 # row stabiliser
            qs = qc * torch.exp(kappa - cmc)[..., None] * scale
            ks = kf * torch.exp(torch.minimum(a - kappa, a.new_zeros(())))[..., None]
            s_inter = torch.einsum("bhqd,bhkd->bhqk", qs, ks)
            s_inter = torch.where((j_pos < c0)[None, None, None, :], s_inter, 0.0)
            # Intra-chunk (c0 <= j <= i): logD - m_i <= 0 by definition of m.
            logd = (bc[..., :, None] - bc[..., None, :]
                    + ac[..., None, :] + bc[..., None, :]) - m[..., :, None]
            tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
            d = torch.where(tri[None, None], torch.exp(logd), 0.0)
            s_intra = torch.einsum("bhqd,bhkd->bhqk", qc * scale, kc) * d
            num = (torch.einsum("bhqk,bhkd->bhqd", s_inter, vf)
                   + torch.einsum("bhqk,bhkd->bhqd", s_intra, vc))
            rowsum = torch.sum(s_inter, dim=-1) + torch.sum(s_intra, dim=-1)
            norm = torch.maximum(torch.abs(rowsum), torch.exp(-m))
            outs.append(num / norm[..., None])
    else:
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            qc, bc = q[:, :, sl].float(), bcum[..., sl]
            i_pos = c0 + torch.arange(qc.shape[2], device=q.device)
            logd = bc[..., :, None] - bcum[..., None, :] + ig[..., None, :]   # (B,NH,c,S)
            mask = j_pos[None, :] <= i_pos[:, None]
            logd = torch.where(mask[None, None], logd, -torch.inf)
            m = torch.clamp(torch.amax(logd, dim=-1), min=-1e30)
            d = torch.exp(logd - m[..., None])
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale * d
            norm = torch.maximum(torch.abs(torch.sum(s, dim=-1)), torch.exp(-m))
            outs.append(torch.einsum("bhqk,bhkd->bhqd", s, vf) / norm[..., None])
    return torch.cat(outs, dim=2).to(v.dtype)


def mlstm_step(q, k, v, ig, fg, state):
    """Recurrent decode step. q/k/v (B,NH,DH); ig/fg (B,NH).
    state = {"C": (B,NH,DH,DH), "n": (B,NH,DH), "m": (B,NH)}."""
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + state["m"], ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(lf + state["m"] - m_new)
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / np.sqrt(q.shape[-1])
    C = f_p[..., None, None] * state["C"] + \
        i_p[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = f_p[..., None] * state["n"] + i_p[..., None] * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf * scale)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qf * scale)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(v.dtype)
    return h, {"C": C, "n": n, "m": m_new}


def _mlstm_state_from_sequence(q, k, v, ig, fg):
    """Final (C, n, m) after consuming a sequence, in closed form: with
    b_t = Σ_{u<=t} log f_u,
        m_S = max_j (b_S - b_j + i_j)
        C_S = Σ_j exp(b_S - b_j + i_j - m_S) k_j v_jᵀ      (n_S likewise),
    the step recurrence (``mlstm_step``) unrolled, without a scan."""
    lf = F.logsigmoid(fg)                        # (B,NH,S)
    b = torch.cumsum(lf, dim=-1)
    w_log = b[..., -1:] - b + ig                 # b_S - b_j + i_j
    m = torch.amax(w_log, dim=-1)                # (B,NH)
    w = torch.exp(w_log - m[..., None])
    wk = w[..., None] * k.float()                # (B,NH,S,DH)
    C = torch.einsum("bhsk,bhsv->bhkv", wk, v.float())
    n = torch.sum(wk, dim=2)
    return {"C": C, "n": n, "m": m}


def mlstm_block_apply(p, x, nh: int, *, cache=None, decode=False, chunk=256):
    """cache = {"C","n","m","conv"}; returns (out, new_cache): the new state
    as fresh tensors (the caller writes them into its cache), None without
    a cache."""
    B, S, D = x.shape
    up = torch.einsum("bsd,de->bse", x, p["w_up"])
    x_in, z = torch.chunk(up, 2, dim=-1)

    conv_state = cache["conv"] if (decode and cache is not None) else None
    cx, new_conv = causal_conv(x_in, p["conv_w"], p["conv_b"], conv_state)
    cx = F.silu(cx)

    q = torch.einsum("bse,ef->bsf", cx, p["w_q"])
    k = torch.einsum("bse,ef->bsf", cx, p["w_k"])
    v = torch.einsum("bse,ef->bsf", x_in, p["w_v"])
    ig = cx.float() @ p["w_i"] + p["b_i"]                  # (B,S,NH)
    fg = cx.float() @ p["w_f"] + p["b_f"]

    if decode and cache is not None:
        h, new_state = mlstm_step(
            _heads(q, nh)[:, :, 0], _heads(k, nh)[:, :, 0], _heads(v, nh)[:, :, 0],
            ig[:, 0], fg[:, 0], {"C": cache["C"], "n": cache["n"], "m": cache["m"]})
        out_seq = _unheads(h[:, :, None, :])
        new_cache = {**new_state, "conv": new_conv.to(cache["conv"].dtype)}
    else:
        qh, kh, vh = _heads(q, nh), _heads(k, nh), _heads(v, nh)
        igt, fgt = ig.transpose(1, 2), fg.transpose(1, 2)
        out_seq = _unheads(mlstm_parallel(qh, kh, vh, igt, fgt, chunk=chunk))
        new_cache = None
        if cache is not None:  # prefill: leave the final state in the cache
            new_cache = _mlstm_state_from_sequence(qh, kh, vh, igt, fgt)
            kc = cache["conv"].shape[1]
            new_cache["conv"] = F.pad(x_in, (0, 0, max(kc - S, 0), 0))[:, -kc:].to(
                cache["conv"].dtype)

    # per-head RMS norm (GroupNorm stand-in) + gated output
    hs = out_seq.reshape(B, -1, nh, out_seq.shape[-1] // nh).float()
    hs = hs / torch.sqrt(torch.mean(hs ** 2, dim=-1, keepdim=True) + 1e-6)
    out_seq = hs.reshape(B, -1, out_seq.shape[-1]).to(x.dtype) * p["out_scale"]
    out = out_seq * F.silu(z)
    return torch.einsum("bse,ed->bsd", out, p["w_down"]), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SLSTM_STATE = ("c", "n", "h", "m")


def slstm_init(generator, d_model: int, n_heads: int, dtype, device) -> nn.ParameterDict:
    dh = d_model // n_heads
    d_ff = int(PF_SLSTM * d_model) // 64 * 64 or d_model

    def rmat():  # block-diagonal recurrent weights, per head (NH, DH, DH)
        return dense_init(generator, (n_heads, dh, dh), torch.float32, device,
                          scale=1.0 / np.sqrt(dh))

    return nn.ParameterDict({
        "w_zifo": dense_init(generator, (d_model, 4 * d_model), torch.float32, device),
        "b_zifo": torch.zeros((4 * d_model,), dtype=torch.float32, device=device),
        "r_z": rmat(), "r_i": rmat(), "r_f": rmat(), "r_o": rmat(),
        "out_scale": torch.ones((d_model,), dtype=dtype, device=device),
        "ffn_up": dense_init(generator, (d_model, 2 * d_ff), dtype, device),
        "ffn_down": dense_init(generator, (d_ff, d_model), dtype, device),
    })


def _slstm_cell(r_all, xt, st, nh):
    """One timestep. xt (B, 4*D) pre-projected; st: c/n/h/m (B, D);
    r_all (NH, DH, 4*DH) the four recurrent matrices side by side."""
    B, D4 = xt.shape
    D = D4 // 4
    dh = D // nh
    rec = torch.bmm(st["h"].reshape(B, nh, dh).transpose(0, 1), r_all)   # (NH,B,4DH)
    rec = rec.reshape(nh, B, 4, dh).permute(2, 1, 0, 3).reshape(4, B, D)
    z_in, i_in, f_in, o_in = torch.chunk(xt, 4, dim=-1)
    z = torch.tanh(z_in + rec[0])
    ig = i_in + rec[1]                             # log-space input gate
    fg = f_in + rec[2]
    o = torch.sigmoid(o_in + rec[3])
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + st["m"], ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(lf + st["m"] - m_new)
    c = f_p * st["c"] + i_p * z
    n = f_p * st["n"] + i_p
    h = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_block_apply(p, x, nh: int, *, cache=None, decode=False):
    """cache: {"c","n","h","m"} each (B, D) f32. Returns (out, new_cache):
    the new state as fresh tensors, None without a cache."""
    B, S, D = x.shape
    xp = x.float() @ p["w_zifo"] + p["b_zifo"]
    r_all = torch.cat([p["r_z"], p["r_i"], p["r_f"], p["r_o"]], dim=-1)

    if cache is not None:
        st = {k: cache[k] for k in SLSTM_STATE}
    else:
        zeros = x.new_zeros((B, D), dtype=torch.float32)
        st = {"c": zeros, "n": zeros, "h": zeros, "m": torch.full_like(zeros, -1e30)}

    if decode:
        st = _slstm_cell(r_all, xp[:, 0], st, nh)
        hs = st["h"][:, None]
    else:
        hseq = []
        for t in range(S):
            st = _slstm_cell(r_all, xp[:, t], st, nh)
            hseq.append(st["h"])
        hs = torch.stack(hseq, dim=1)
    new_cache = st if cache is not None else None

    hs = hs / torch.sqrt(torch.mean(hs ** 2, dim=-1, keepdim=True) + 1e-6)
    hs = hs.to(x.dtype) * p["out_scale"]
    # gated FFN (projection factor 4/3)
    u, g = torch.chunk(torch.einsum("bsd,de->bse", hs, p["ffn_up"]), 2, dim=-1)
    return torch.einsum("bse,ed->bsd", u * F.gelu(g, approximate="tanh"),
                        p["ffn_down"]), new_cache
