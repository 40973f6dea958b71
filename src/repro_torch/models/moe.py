"""Mixture-of-Experts FFN with sort-based dispatch and static capacity.

Counterpart of ``repro.models.moe``. Token->expert assignments are sorted
by expert id; each token-copy's slot within its expert buffer is its rank
in the sorted order minus the expert's segment start. Copies beyond the
per-expert capacity ``C`` are dropped (their gate mass is not combined).

The reference's default ``COMBINE_MODE = "gather"`` formulation is the one
ported: the (E, C, D) expert buffers are filled by a gather (slot (e, c)
holds the token ranked ``seg_starts[e] + c`` in the expert-sorted order) and
the combine gathers each token's K copies back before a float32 weighted
sum over K. The reference wraps both gathers in ``custom_vjp``s whose
backward is the dual gather; here they are two ``torch.autograd.Function``s
with the same backwards (``dispatch_gather`` / ``combine_gather``).
Autograd's own transposes would be scatter-adds, which on CUDA accumulate
in an order of their own; the Functions sum each token's K copies in the
reference's order and cast back. Its ``scatter_add`` branch is a baseline
kept there for a before/after measurement, and nothing reads it, so it is
not ported.

Tie orders follow the reference: ``jax.lax.top_k`` takes the lower expert
first among equal probabilities, which a stable descending sort gives
(``torch.topk`` promises no order), and ``jnp.argsort`` is stable.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamTree, dense_init, ffn_apply, ffn_init


def moe_init(generator, cfg, dtype, device) -> ParamTree:
    m = cfg.moe
    D, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": dense_init(generator, (D, E), torch.float32, device, scale=0.02),
        "w_gate": dense_init(generator, (E, D, Fe), dtype, device),
        "w_up": dense_init(generator, (E, D, Fe), dtype, device),
        "w_down": dense_init(generator, (E, Fe, D), dtype, device),
    }
    if m.n_shared:
        p["shared"] = ffn_init(generator, D, Fe * m.n_shared, "swiglu", dtype, device)
    return ParamTree(p)


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: the reference's float expression, in its order."""
    m = cfg.moe
    return max(int(np.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor)), 1)


def route(p, xt, cfg):
    """Router probabilities (T, E) float32 and the top-K gates (renormalised)
    and experts (T, K), the lower expert first among equal probabilities."""
    K = cfg.moe.top_k
    probs = torch.softmax(torch.einsum("td,de->te", xt.float(), p["router"]), dim=-1)
    gate_k, idx_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[:, :K], idx_k[:, :K]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_k, idx_k


def dispatch(idx_k, n_experts: int, C: int):
    """The sort-based dispatch plan of the (T, K) expert choices into
    (E, C) slots: ``slot_tok`` (E, C) the token each slot holds,
    ``slot_valid`` (E, C), per token copy (T, K) its slot ``tok_pos`` in
    its expert's buffer and ``tok_keep`` (False: dropped, past the capacity
    in the expert-sorted, then token-major order), and ``slot_k`` (E, C)
    which of its token's K choices a slot holds (the reference's
    ``slot_tok2[..., 1]``)."""
    T, K = idx_k.shape
    E, dev = n_experts, idx_k.device
    flat_e = idx_k.reshape(-1)                                  # (T*K,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # each expert's segment start in the sorted order (what the reference
    # takes from a bincount; CUDA's bincount reads its max on the host)
    seg_starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * K, device=dev) - seg_starts[sorted_e]   # rank in expert
    keep = pos_in_e < C

    slot_pos = seg_starts[:, None] + torch.arange(C, device=dev)[None, :]   # (E, C)
    sp = torch.clamp(slot_pos, 0, T * K - 1)
    slot_valid = (slot_pos < T * K) & (sorted_e[sp] == torch.arange(E, device=dev)[:, None])
    inv_sort = torch.argsort(sort_idx, stable=True)             # flat -> rank
    tok_pos = torch.where(keep, pos_in_e, 0)[inv_sort].reshape(T, K)
    tok_keep = keep[inv_sort].reshape(T, K)
    return (sort_idx // K)[sp], slot_valid, tok_pos, tok_keep, (sort_idx % K)[sp]


class _DispatchGather(torch.autograd.Function):
    """buf (E, C, D) = xt[slot_tok] where the slot is valid, else 0.
    Backward: the dual gather, each token's K slots summed over K."""

    @staticmethod
    def forward(ctx, xt, slot_tok, slot_valid, idx_k, tok_pos, tok_keep):
        ctx.save_for_backward(idx_k, tok_pos, tok_keep)
        return torch.where(slot_valid[:, :, None], xt[slot_tok], 0)

    @staticmethod
    def backward(ctx, dbuf):
        idx_k, tok_pos, tok_keep = ctx.saved_tensors
        g = torch.where(tok_keep[..., None], dbuf[idx_k, tok_pos], 0)    # (T, K, D)
        return torch.sum(g, dim=1).to(dbuf.dtype), None, None, None, None, None


class _CombineGather(torch.autograd.Function):
    """(T, K, D) = eo[idx_k, tok_pos] where the copy is kept, else 0.
    Backward: the dual gather, slot (e, c) reading its (token, k)."""

    @staticmethod
    def forward(ctx, eo, idx_k, tok_pos, tok_keep, slot_tok, slot_k, slot_valid):
        ctx.save_for_backward(slot_tok, slot_k, slot_valid)
        return torch.where(tok_keep[..., None], eo[idx_k, tok_pos], 0)

    @staticmethod
    def backward(ctx, dg):
        slot_tok, slot_k, slot_valid = ctx.saved_tensors
        deo = torch.where(slot_valid[:, :, None], dg[slot_tok, slot_k], 0)
        return deo, None, None, None, None, None, None


def dispatch_gather(xt, slot_tok, slot_valid, idx_k, tok_pos, tok_keep):
    return _DispatchGather.apply(xt, slot_tok, slot_valid, idx_k, tok_pos, tok_keep)


def combine_gather(eo, idx_k, tok_pos, tok_keep, slot_tok, slot_k, slot_valid):
    return _CombineGather.apply(eo, idx_k, tok_pos, tok_keep, slot_tok, slot_k, slot_valid)


def moe_apply(p, x, cfg):
    """x (B, S, D) -> (out (B, S, D), aux_loss float32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E = m.n_experts
    xt = x.reshape(T, D)
    probs, gate_k, idx_k = route(p, xt, cfg)
    slot_tok, slot_valid, tok_pos, tok_keep, slot_k = dispatch(idx_k, E, capacity(T, cfg))

    # ---- expert FFN over the (E, C, D) buffers -------------------------
    buf = dispatch_gather(xt, slot_tok, slot_valid, idx_k, tok_pos, tok_keep)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    eo = torch.bmm(F.silu(g) * u, p["w_down"])

    # ---- combine: gather each token's K copies back --------------------
    gk = combine_gather(eo, idx_k, tok_pos, tok_keep, slot_tok, slot_k, slot_valid)
    out = torch.sum(gk.float() * gate_k[..., None], dim=1).to(x.dtype)

    # ---- aux load-balance loss (Switch-style) ---------------------------
    routed = torch.zeros((T, E), dtype=torch.bool, device=x.device)
    routed[torch.arange(T, device=x.device)[:, None], idx_k] = True
    frac_tokens = torch.mean(routed.float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs) * m.aux_loss_weight

    if m.n_shared:
        out = out + ffn_apply(p["shared"], x, "swiglu").reshape(T, D).to(out.dtype)
    return out.reshape(B, S, D), aux
