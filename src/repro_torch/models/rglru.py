"""Griffin / RecurrentGemma recurrent block: RG-LRU + temporal conv + gating.

Counterpart of ``repro.models.rglru``. RG-LRU recurrence (per channel,
[arXiv:2402.19427] eq. 3-6):
    r_t = sigmoid(W_a x_t + b_a)              recurrence gate
    i_t = sigmoid(W_x x_t + b_x)              input gate
    a_t = exp(-c * softplus(Λ) * r_t)         with c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the diagonal linear recurrence h_t = a_t h_{t-1} + b_t over the
sequence as a log-depth (Hillis-Steele) scan in float32: ceil(log2 S) steps
of elementwise products, where the reference runs
``jax.lax.associative_scan``. Both compute the same function; the float32
products are taken in another order. Decode carries ``h`` as O(1) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, uniform_init

_C = 8.0


def rglru_init(generator, d_model: int, width: int, conv_width: int, dtype,
               device) -> nn.ParameterDict:
    def zeros(dt):
        return torch.zeros((width,), dtype=dt, device=device)

    return nn.ParameterDict({
        # gated-MLP style branch projections (Griffin recurrent block)
        "w_in_main": dense_init(generator, (d_model, width), dtype, device),
        "w_in_gate": dense_init(generator, (d_model, width), dtype, device),
        "w_out": dense_init(generator, (width, d_model), dtype, device),
        "conv_w": dense_init(generator, (conv_width, width), dtype, device, scale=0.5),
        "conv_b": zeros(dtype),
        # RG-LRU gates; their biases and Λ stay float32 in a bf16 model
        "w_a": dense_init(generator, (width, width), dtype, device),
        "b_a": zeros(torch.float32),
        "w_x": dense_init(generator, (width, width), dtype, device),
        "b_x": zeros(torch.float32),
        "lam": uniform_init(generator, (width,), 0.9, 0.999, device),
    })


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B,S,C), w (K,C). state: (B,K-1,C) history.

    Returns (out, new_state). new_state is the last K-1 inputs."""
    K = w.shape[0]
    if state is None:
        hist = F.pad(x, (0, 0, K - 1, 0))
    else:
        hist = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(hist[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = hist[:, -(K - 1):] if K > 1 else None
    return out.to(x.dtype), new_state


def _rglru_gates(p, x):
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r               # (B,S,C) <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2 * log_a), min=1e-12)) * (i * xf)
    return a, gated_x


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a log-depth
    inclusive scan of the pairs (a, b) under (a1, b1) ∘ (a2, b2) =
    (a1 a2, a2 b1 + b2): at step d every position t >= d folds in the
    pair d places back."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:             # the last step needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p, x, h0=None):
    """Full-sequence RG-LRU. x (B,S,C) -> (y, h_last float32)."""
    a, bx = _rglru_gates(p, x)
    if h0 is not None:
        # fold the initial state into the first step: b_0' = a_0 h_0 + b_0
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0.float()[:, None], bx[:, 1:]], dim=1)
    hh = linear_scan(a, bx)
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(p, x, h):
    """Single decode step. x (B,1,C), h (B,C) -> (y (B,1,C), h')."""
    a, bx = _rglru_gates(p, x)
    h_new = a[:, 0] * h.float() + bx[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def rec_block_apply(p, x, *, cache=None, decode=False):
    """The full Griffin recurrent block (replaces attention).

    cache = {"h": (B, C) f32, "conv": (B, K-1, C)} for decode.
    Returns (out, new_cache): the new state as fresh tensors (the caller
    writes them into its cache), None without a cache.
    """
    main = torch.einsum("bsd,dc->bsc", x, p["w_in_main"])
    gate = torch.einsum("bsd,dc->bsc", x, p["w_in_gate"])

    conv_state = cache["conv"] if (decode and cache is not None) else None
    conv_out, new_conv = causal_conv(main, p["conv_w"], p["conv_b"], state=conv_state)
    if decode and cache is not None:
        y, h_new = rglru_step(p, conv_out, cache["h"])
        new_cache = {"h": h_new, "conv": new_conv.to(cache["conv"].dtype)}
    else:
        h0 = cache["h"] if cache is not None else None
        y, h_last = rglru_scan(p, conv_out, h0=h0)
        new_cache = None
        if cache is not None:
            new_cache = {"h": h_last,
                         "conv": new_conv[:, -cache["conv"].shape[1]:].to(cache["conv"].dtype)}
    out = y * F.gelu(gate, approximate="tanh")
    return torch.einsum("bsc,cd->bsd", out, p["w_out"]), new_cache
