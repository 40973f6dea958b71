"""Device memory of one LM step on one chip, as the port runs it eagerly.

The dry run's ``memory_analysis`` (``launch/dryrun.py``) restated for
PyTorch: XLA reports the argument, output and temp bytes of its compiled
program; the port has no compiled program, so its bytes come from a model
of the eager step. Each function here walks the port's code in program
order over the shapes of one chip and keeps a ledger of the storages the
ops create: a tensor is born where the code makes it and dies where its
last Python reference goes, or, in a training forward, where autograd
releases what it saved. The ledger's high-water mark is the step's
``temp``. The walk mirrors the modules it counts (``models/layers.py``,
``moe.py``, ``rglru.py``, ``xlstm.py``, ``whisper.py``, ``transformer.py``,
``model.py``, ``train/step.py``, ``optim/adamw.py``, ``utils/treeutil``):
a change there changes the count. ``tests/test_torch_dryrun_memory.py``
holds the two together with a live-bytes tracker over the real step on
the CPU, and ``chip_smoke.py`` with the allocator on the card.

Conventions: ``e`` is the activation dtype's bytes (``cfg.dtype``);
float32 work is 4. Tensors of O(rows) (masks, int64 positions, norm
statistics, the sLSTM's per-step temporaries) are left out. Kernel scratch
below the ops (cuBLAS workspaces, sort buffers) is not counted. The
backward pass is counted a stage at a time (a norm, an attention, an FFN,
a recurrent cell, the loss): each stage frees what its forward saved, adds
its weights' gradients and, while it runs, the transient its stage names.
The model is stated in full in ``launch/dryrun.py``'s docstring.
"""
from __future__ import annotations

import dataclasses
import math

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
PF_MLSTM = 2          # xlstm's mLSTM up-projection factor
LOSS_CHUNK = 512      # transformer.lm_loss's default chunk


class _Ledger:
    """Live bytes and their high-water mark. ``grad``: a training forward,
    where ``rel`` keeps what autograd saves instead of freeing it."""

    def __init__(self, grad: bool = False):
        self.now = 0.0
        self.peak = 0.0
        self.grad = grad

    def new(self, *sizes) -> float:
        for n in sizes:
            self.now += n
            self.peak = max(self.peak, self.now)
        return float(sum(sizes))

    def free(self, *sizes) -> None:
        self.now -= sum(sizes)

    def rel(self, *sizes) -> None:
        """Release tensors that autograd saves: freed only without grad."""
        if not self.grad:
            self.free(*sizes)

    def spike(self, *sizes) -> None:
        self.new(*sizes)
        self.free(*sizes)


@dataclasses.dataclass(frozen=True)
class Split:
    """How one chip's share of a step's activations is cut over the model
    axis: each field divides the named dim (all 1 on one chip)."""
    heads: int = 1          # q heads (MLA's and the mLSTM's heads too)
    kv_heads: int = 1       # K/V heads of the projections
    kv_seq: int = 1         # a cache's sequence (a decode attends split-K)
    ffn: int = 1            # dense d_ff, the sLSTM FFN
    experts: int = 1        # MoE experts
    vocab: int = 1          # the logits' vocabulary
    width: int = 1          # RG-LRU width, mLSTM d_in, sLSTM gates


@dataclasses.dataclass(frozen=True)
class Memory:
    """One step's bytes on one chip. ``output``: what the step returns
    fresh (not its arguments, which it updates in place); ``temp``: the
    high-water mark of every byte that is not an argument, ``output``
    included while it lives. The peak is the arguments plus ``temp``."""
    output: float
    temp: float


@dataclasses.dataclass(frozen=True)
class Params:
    """A model's weights on one chip, in ``tree_leaves`` order: ``leaves``
    (numel, bytes a element, layer, part), one entry per leaf of the port's
    module (layer ``"blocks.3"``, part ``"ffn"``; top-level leaves have
    layer None and their name as the part); ``opt`` the elements of each
    leaf's AdamW shard (ZeRO-1 divides it over data)."""
    leaves: tuple
    opt: tuple

    @property
    def numel(self) -> float:
        return float(sum(n for n, _, _, _ in self.leaves))

    @property
    def bytes(self) -> float:
        return float(sum(n * b for n, b, _, _ in self.leaves))

    def part_bytes(self, layer, part) -> float:
        return float(sum(n * b for n, b, k, q in self.leaves if k == layer and q == part))


def params_of(cfg, *, divisor=None, opt_divisor=None, max_dec_seq: int = 4096) -> Params:
    """``Params`` of ``cfg``'s model from its ``meta`` parameters;
    ``divisor(path, shape)`` / ``opt_divisor``: the shards of a leaf (its
    reference-layout path, e.g. ``"attn_block/attn/wq"``) over the chips
    (1: one chip)."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_layout
    params = build_model(cfg, max_seq=max_dec_seq).param_specs()
    layout = block_layout(cfg)
    leaves, opt = [], []
    for name, p in params.named_parameters():
        parts = name.split(".")
        layer, part = None, parts[0]
        if parts[0] in ("blocks", "enc_blocks", "dec_blocks"):
            layer, part = f"{parts[0]}.{parts[1]}", parts[2]
            head = layout[int(parts[1])] if parts[0] == "blocks" else parts[0]
            parts = [head] + parts[2:]
        path = "/".join(parts)
        n = p.numel() / (divisor(path, tuple(p.shape)) if divisor else 1)
        leaves.append((n, p.element_size(), layer, part))
        opt.append(p.numel() / (opt_divisor(path, tuple(p.shape)) if opt_divisor else 1))
    return Params(tuple(leaves), tuple(opt))


def _copies(B: int, H: int, rows: int) -> bool:
    """Does ``einsum`` copy a (B, H, rows, d) operand that is a transposed
    view of a (B, rows, H, d) tensor? Only when B and H cannot merge."""
    return B > 1 and H > 1 and rows > 1


@dataclasses.dataclass(frozen=True)
class _Dims:
    e: int
    D: int
    H: int            # q heads on the chip (padded heads included)
    KV: int           # K/V heads on the chip
    hd: int
    F: int            # d_ff on the chip
    V: int            # vocabulary on the chip
    kind: str         # the norm
    split: Split


def _dims(cfg, split: Split) -> _Dims:
    h = cfg.n_heads
    pad = getattr(cfg, "tp_pad_heads_to", 0)
    if pad and h % pad:
        h = -(-h // pad) * pad
    return _Dims(e=_BYTES[cfg.dtype], D=cfg.d_model, H=max(h // split.heads, 1),
                 KV=max(cfg.n_kv_heads // split.kv_heads, 1), hd=cfg.resolved_head_dim,
                 F=cfg.d_ff // split.ffn, V=-(-cfg.vocab_size // split.vocab),
                 kind=cfg.norm, split=split)


# ---------------------------------------------------------------------------
# layers (models/layers.py)
# ---------------------------------------------------------------------------


def _norm(lv: _Ledger, n: float, e: int, kind: str) -> float:
    """``norm_apply`` over n elements; leaves its output (bytes returned).
    RMSNorm saves xf and xf / rms; LayerNorm xf - mu (twice) and the
    normalised x."""
    f = 4 * n
    xf = lv.new(f) if e != 4 else 0.0                  # x.float()
    if kind == "rmsnorm":
        lv.spike(f)                                    # square
        lv.new(f, f)                                   # xf / rms, * scale
        lv.rel(f)
        out = f
        if e != 4:
            out = lv.new(n * e)                        # .to(x.dtype)
            lv.free(f)
        lv.rel(xf)
        return out
    lv.new(f, f)                                       # xf - mu, its square
    lv.free(f)
    lv.rel(f)
    lv.new(f, f)                                       # xf - mu, / sqrt
    lv.rel(f)
    lv.new(f)                                          # * scale
    lv.rel(f)
    lv.new(f)                                          # + bias
    lv.free(f)
    if e == 4:
        return f
    out = lv.new(n * e)
    lv.free(f, xf)
    return out


def _rope(lv: _Ledger, n: float, e: int) -> float:
    """``apply_rope`` on n elements; leaves its output (saves only cos,
    sin, which the caller holds)."""
    f = 4 * n
    xf = lv.new(f) if e != 4 else 0.0
    lv.new(f)                                          # xf * cos
    lv.new(f / 2, f)                                   # -x[h:], cat
    lv.free(f / 2)
    lv.new(f)                                          # * sin
    lv.free(f)
    lv.new(f)                                          # the sum
    lv.free(f, f)
    if e == 4:
        return f
    out = lv.new(n * e)
    lv.free(f, xf)
    return out


def _attention(lv: _Ledger, B, Sq, Skv, H, KV, hd, hdv, chunk, e) -> tuple:
    """``chunked_attention``: (output bytes, whether the caller's q and k/v
    are saved as they are). Per q chunk autograd saves the product's
    operands (einsum's copies of q, K^T, V: K and V again each chunk) and
    the softmax."""
    held = 0.0
    repeat = H > KV > 1                                # one K/V head expands as a view
    if repeat:                                         # _repeat_kv
        held += lv.new(B * Skv * H * hd * e, B * Skv * H * hdv * e)
    k32 = lv.new(B * H * hd * Skv * 4, B * H * hdv * Skv * 4) if e != 4 else 0.0
    chunk = min(chunk, Sq)
    outs = s_old = p_old = 0.0
    q_copy = _copies(B, H, Sq)
    # einsum copies kT and vT per chunk; the float32 copy of one K/V head
    # expanded over H is laid out afresh, and needs none
    kv_copy = _copies(B, H, Skv) and not (e != 4 and KV == 1)
    for c0 in range(0, Sq, chunk):
        n = min(chunk, Sq - c0)
        sc = B * H * n * Skv * 4
        qf = lv.new(B * H * n * hd * 4) if e != 4 else 0.0
        qc = lv.new(B * H * n * hd * 4) if q_copy else 0.0
        kc = lv.new(B * H * hd * Skv * 4) if kv_copy else 0.0
        lv.new(sc)                                     # q k^T
        lv.rel(kc, qc)
        if q_copy:
            lv.free(qf)
        else:
            lv.rel(qf)
        lv.new(sc)                                     # * scale
        lv.free(sc, s_old)
        lv.new(sc)                                     # where
        lv.free(sc)
        lv.new(sc)                                     # softmax
        lv.rel(p_old)
        vc = lv.new(B * H * Skv * hdv * 4) if kv_copy else 0.0
        outs += lv.new(B * H * n * hdv * 4)            # p v
        lv.rel(vc)
        s_old = p_old = sc
    out = lv.new(B * H * Sq * hdv * 4)                 # cat
    if e != 4:
        lv.new(B * Sq * H * hdv * e)                   # .to(q.dtype)
        lv.free(out)
        out = B * Sq * H * hdv * e
    if kv_copy:                                        # the copies are the operands
        lv.free(held, k32)
    elif e != 4:                                       # the float32 K, V are
        lv.free(held)
        lv.rel(k32)
    else:                                              # K, V themselves are
        lv.rel(held)
    lv.free(outs, s_old)
    lv.rel(p_old)
    return out, not q_copy and e == 4, not kv_copy and e == 4 and not repeat


def _out_proj(lv: _Ledger, B, S, H, width, D, e) -> tuple:
    """``einsum("bshk,hkd->bsd")`` of an attention output: (o's bytes,
    whether the input itself is saved). The transposed (B, S, H, hd) is
    copied first unless S or H is 1."""
    copy = S > 1 and H > 1
    oc = lv.new(B * S * width * e) if copy else 0.0
    o = lv.new(B * S * D * e)
    lv.rel(oc)
    return o, not copy


def _attend(lv: _Ledger, q, k, v, out_args, proj_args) -> float:
    """Attention then the output projection, with the saved-or-freed
    bookkeeping of the caller's q, k, v; returns o's bytes."""
    out, q_kept, kv_kept = _attention(lv, *out_args)
    o, out_kept = _out_proj(lv, *proj_args)
    (lv.rel if q_kept else lv.free)(q)
    (lv.rel if kv_kept else lv.free)(k, v)
    (lv.rel if out_kept else lv.free)(out)
    return o


def _attn_apply(lv: _Ledger, g: _Dims, B, S, Skv, *, decode, chunk, bias=False,
                rope=True) -> float:
    """``attn_apply``: leaves o (B, S, D)."""
    T, e = B * S, g.e
    q = lv.new(T * g.H * g.hd * e)
    k = lv.new(T * g.KV * g.hd * e)
    v = lv.new(T * g.KV * g.hd * e)
    if bias:
        for n in (q, k, v):
            lv.new(n)
            lv.free(n)
    if rope:
        for n in (q, k):
            _rope(lv, n / e, e)
            lv.free(n)
    o = _attend(lv, q, k, v,
                (B, S, Skv if decode else S, g.H, g.KV, g.hd, g.hd,
                 1 if decode else chunk, e),
                (B, S, g.H, g.H * g.hd, g.D, e))
    if bias:
        lv.new(o)
        lv.free(o)
    return o


def _ffn(lv: _Ledger, T, D, F, kind, e) -> float:
    """``ffn_apply``: leaves its output (T, D); saves every (T, F)."""
    if kind == "swiglu":
        gu = lv.new(T * F * e, T * F * e)              # gate, up
        lv.new(T * F * e, T * F * e)                   # silu, * u
        lv.rel(T * F * e)
        o = lv.new(T * D * e)
        lv.rel(T * F * e, gu)
        return o
    lv.new(T * F * e, T * F * e)                       # w_in, + b_in
    lv.free(T * F * e)
    lv.new(T * F * e)                                  # gelu
    lv.rel(T * F * e)
    lv.new(T * D * e, T * D * e)                       # w_out, + b_out
    lv.free(T * D * e)
    lv.rel(T * F * e)
    return T * D * e


def _capacity(T: int, cfg) -> int:
    """``moe.capacity``: slots per expert, in its float expression."""
    m = cfg.moe
    return max(int(math.ceil(T * m.top_k / m.n_experts * m.capacity_factor)), 1)


def _moe(lv: _Ledger, cfg, T, e, split: Split) -> float:
    """``moe.moe_apply``: leaves its output (T, D). The router and the
    dispatch plan run over all E experts, the (E, C, .) buffers over the
    chip's."""
    m = cfg.moe
    D, K, E = cfg.d_model, m.top_k, m.n_experts
    C = _capacity(T, cfg)
    El, Fe = E // split.experts, m.d_ff_expert
    TK, EC = T * K, E * C
    xf = lv.new(T * D * 4) if e != 4 else 0.0         # route: xt.float()
    lv.new(T * E * 4, T * E * 4)                       # router logits, softmax
    lv.free(T * E * 4)
    lv.rel(xf)
    lv.new(T * E * 4, T * E * 8)                       # sort: values, indices
    lv.new(TK * 4)                                     # renormalised gates
    plan = 2 * EC * 8 + EC + TK * 8 + TK               # dispatch's outputs
    lv.spike(7 * TK * 8 + 2 * EC * 8)                  # its int64 work
    lv.new(plan)
    buf = El * C * D * e
    lv.new(buf, buf)                                   # xt[slot_tok], where
    lv.free(buf)
    gu = lv.new(El * C * Fe * e, El * C * Fe * e)      # gate, up
    lv.new(El * C * Fe * e, El * C * Fe * e)           # silu, * u
    lv.rel(El * C * Fe * e)
    eo = lv.new(buf)                                   # down
    lv.rel(El * C * Fe * e)
    gk = TK * D * e
    lv.new(gk, gk)                                     # eo[idx, pos], where
    lv.free(gk)
    gf = lv.new(TK * D * 4) if e != 4 else 0.0         # gk.float()
    lv.new(TK * D * 4)                                 # * gate
    lv.rel(gf)
    lv.new(T * D * 4)                                  # sum over K
    lv.free(TK * D * 4)
    out = T * D * 4
    if e != 4:
        lv.new(T * D * e)
        lv.free(out)
        out = T * D * e
    lv.spike(T * E * 4)                                # aux: routed.float()
    if m.n_shared:
        s = _ffn(lv, T, D, Fe * m.n_shared, "swiglu", e)
        lv.new(T * D * e)                              # out + shared
        lv.free(out, s)
        out = T * D * e
    lv.free(eo)
    (lv.free if e != 4 else lv.rel)(gk)
    lv.rel(T * E * 4, T * E * 4, T * E * 8, TK * 4, plan, buf, gu)
    return out


def _mla_apply(lv: _Ledger, cfg, g: _Dims, B, S, Skv, *, decode, chunk) -> float:
    """``mla_apply``: leaves o (B, S, D). The first q lives on through its
    two views until the function returns."""
    m, e, T = cfg.mla, g.e, B * S
    H, r, rope = g.H, m.kv_lora_rank, m.qk_rope_head_dim
    qk, hv = m.qk_nope_head_dim + rope, m.v_head_dim
    q0 = lv.new(T * H * qk * e)
    qr = _rope(lv, T * H * rope, e)
    q = lv.new(T * H * qk * e)                         # cat(q_nope, roped)
    lv.free(qr)
    ckv = lv.new(T * (r + rope) * e)
    kr = _rope(lv, T * rope, e)
    new = lv.new(T * (r + rope) * e)                   # cat(c, k_rope)
    rows = B * (Skv if decode else S)
    kn = lv.new(rows * H * m.qk_nope_head_dim * e)     # c @ w_uk
    v = lv.new(rows * H * hv * e)                      # c @ w_uv
    k = lv.new(rows * H * qk * e)                      # cat(k_nope, k_rope)
    o = _attend(lv, q, k, v,
                (B, S, Skv if decode else S, H, H, qk, hv, 1 if decode else chunk, e),
                (B, S, H, H * hv, g.D, e))
    lv.free(q0, ckv, kr, kn)
    lv.rel(new)
    return o


def _conv(lv: _Ledger, B, S, W, K, e, *, decode) -> tuple[float, float]:
    """``rglru.causal_conv``: (output bytes, its history, which the
    returned state views and the products save)."""
    hist = lv.new(B * ((K if decode else S + K - 1)) * W * e)
    t = B * S * W * e
    lv.new(t, t)                                       # hist * w[0], 0 + it
    lv.free(t)
    for _ in range(K - 1):
        lv.new(t, t)                                   # hist * w[i], s + it
        lv.free(t, t)
    lv.new(t)                                          # + b
    lv.free(t)
    return t, hist


def _linear_scan(lv: _Ledger, B, S, W) -> float:
    """``rglru.linear_scan`` in float32: leaves h. Training saves every
    level's a and b, the products' operands."""
    full = B * S * W * 4
    a = b = 0.0                                        # the caller's
    d = 1
    while d < S:
        part = B * (S - d) * W * 4
        lv.new(part, part)                             # a b, + b
        lv.free(part)
        lv.new(full)                                   # cat
        lv.free(part)
        lv.rel(b)
        b = full
        if 2 * d < S:
            lv.new(part, full)                         # a a, cat
            lv.free(part)
            lv.rel(a)
            a = full
        d *= 2
    lv.rel(a)
    return b


def _rec_block(lv: _Ledger, cfg, g: _Dims, B, S, *, decode, cache) -> tuple[float, float]:
    """``rglru.rec_block_apply``: (o's bytes, bytes its returned state
    pins until the next block returns)."""
    e, T = g.e, B * S
    W = (cfg.lru_width or cfg.d_model) // g.split.width
    Wi = cfg.lru_width or cfg.d_model                  # the gates' input, gathered
    main = lv.new(T * W * e)
    gate = lv.new(T * W * e)
    cx, hist = _conv(lv, B, S, W, cfg.conv_width, e, decode=decode)
    f = T * W * 4
    xf = lv.new(T * Wi * 4) if e != 4 else 0.0         # x.float()
    for _ in range(2):                                 # r, i
        w32 = lv.new(Wi * W * 4) if e != 4 else 0.0    # w.float()
        lv.new(f)                                      # xf @ w
        lv.rel(w32)
        lv.new(f)                                      # + b
        lv.free(f)
        lv.new(f)                                      # sigmoid
        lv.free(f)
    lv.new(f, f, f, f)                                 # log_a, a, 2 log_a, exp
    lv.free(f)
    lv.new(f)                                          # 1 -
    lv.rel(f)
    lv.new(f)                                          # clamp
    lv.rel(f)
    lv.new(f)                                          # sqrt
    lv.free(f)
    lv.new(f, f)                                       # i x, * sqrt: gated_x
    lv.rel(f, f)
    lv.free(f)                                         # log_a
    lv.rel(xf, f, f)                                   # xf, r, i
    if decode:
        lv.new(B * W * 4, B * W * 4)                   # a h, + b: h_new
        lv.free(B * W * 4)
        hh = B * W * 4
    else:
        if cache:
            lv.new(f)                                  # b_0 with h0
            lv.free(f)
        hh = _linear_scan(lv, B, S, W)
    lv.rel(f, f)                                       # a, gated_x
    y = lv.new(T * W * e) if e != 4 else hh            # .to(x.dtype)
    lv.new(T * W * e, T * W * e)                       # gelu(gate), y *
    lv.rel(T * W * e)
    o = lv.new(T * g.D * e)
    lv.rel(T * W * e, gate)
    lv.free(main)
    (lv.rel if e == 4 else lv.free)(cx)
    if e != 4:
        lv.rel(y)
    if cache:
        return o, hh + hist
    lv.rel(hist)
    (lv.free if e != 4 else lv.rel)(hh)
    return o, 0.0


def _mlstm_parallel(lv: _Ledger, B, S, NH, DH, e, chunk) -> float:
    """``xlstm.mlstm_parallel`` (separable): leaves its (B, NH, S, DH)
    output in the activation dtype. Each chunk's products read the whole
    sequence's k and v through einsum's copies, which training saves."""
    f = B * NH * S * DH * 4
    kf = lv.new(f) if e != 4 else 0.0                  # k.float(): ks saves it
    vf = lv.new(f) if e != 4 else 0.0                  # v.float(): einsum copies it
    chunk = min(chunk, S)
    outs = 0.0
    old = dict.fromkeys(("ks", "si", "ld", "d", "sa", "num", "qc", "qs"), 0.0)
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        qn, ns, nn = B * NH * n * DH * 4, B * NH * n * S * 4, B * NH * n * n * 4
        qc = lv.new(qn) if e != 4 else 0.0
        lv.rel(old["qc"])
        lv.new(qn, qn)                                 # qc * exp, * scale
        lv.free(qn)
        lv.rel(old["qs"])
        lv.new(f)                                      # ks
        lv.free(old["ks"])
        lv.new(f, ns)                                  # its copy, q k^T
        lv.rel(f)
        lv.rel(old["si"])
        lv.new(ns)                                     # where
        lv.free(ns)
        lv.new(nn, nn)                                 # logd's terms
        lv.free(nn)
        lv.new(nn, nn)
        lv.free(nn, nn)
        lv.new(nn)
        lv.free(nn, old["ld"])
        lv.new(nn, nn)                                 # exp, where: d
        lv.rel(nn, old["d"])
        lv.new(qn, qn, nn)                             # qc * scale, kc copy, q k^T
        lv.rel(qn, qn)
        lv.new(nn)                                     # * d
        lv.rel(nn, old["sa"])
        lv.new(f, qn)                                  # vf copy, s_inter v
        lv.rel(f)
        lv.new(qn, qn)                                 # vc copy, s_intra v
        lv.rel(qn)
        lv.new(qn)                                     # num
        lv.free(qn, qn)
        lv.rel(old["num"])
        outs += lv.new(qn)                             # num / norm
        old = {"ks": f, "si": ns, "ld": nn, "d": nn, "sa": nn, "num": qn,
               "qc": qc, "qs": qn}
    cat = lv.new(f)
    out = cat
    if e != 4:
        out = lv.new(f * e / 4)
        lv.free(cat)
    lv.free(outs, old["ks"], old["ld"], vf)
    lv.rel(kf, old["si"], old["d"], old["sa"], old["num"], old["qc"], old["qs"])
    return out


def _mlstm_block(lv: _Ledger, cfg, g: _Dims, B, S, *, decode, cache, chunk) -> tuple[float, float]:
    """``xlstm.mlstm_block_apply``: (o's bytes, bytes its returned state
    pins until the next block returns)."""
    e, T, NH = g.e, B * S, cfg.n_heads
    di = PF_MLSTM * cfg.d_model // g.split.width
    DH = PF_MLSTM * cfg.d_model // NH
    NHl = max(NH // g.split.heads, 1)
    t, f = T * di * e, T * di * 4
    up = lv.new(2 * t)
    cx, hist = _conv(lv, B, S, di, cfg.conv_width, e, decode=decode)
    lv.new(t)                                          # silu
    lv.rel(cx)
    qkv = lv.new(t, t, t)
    for _ in range(2):                                 # ig, fg
        xf = lv.new(f) if e != 4 else 0.0
        lv.new(T * NH * 4, T * NH * 4)
        lv.free(T * NH * 4)
        lv.rel(xf)
    pinned = 0.0
    if decode:
        Cb = B * NHl * DH * DH * 4
        lv.new(Cb, Cb, Cb)                             # f C, k v^T, i (k v^T)
        lv.free(Cb)
        lv.new(Cb)                                     # their sum: C
        lv.free(Cb, Cb)
        pinned = Cb + lv.new(B * NHl * DH * 4) + hist  # C, n; conv: a view
        seq = lv.new(B * di * e)                       # h
    else:
        par = _mlstm_parallel(lv, B, S, NHl, DH, e, chunk)
        seq = lv.new(t)                                # _unheads: a copy
        lv.free(par)
        if cache:
            kf = lv.new(f) if e != 4 else 0.0
            lv.new(f)                                  # w k
            lv.free(kf)
            vf = lv.new(f) if e != 4 else 0.0
            lv.spike(f, f)                             # einsum's copies
            Cb = lv.new(B * NHl * DH * DH * 4)
            lv.free(f, vf)
            pinned = Cb + lv.new(t)                    # F.pad(x_in) for the conv
    hs = lv.new(f) if e != 4 else 0.0                  # .float()
    lv.new(f, f)                                       # ** 2, /
    lv.free(f)
    lv.rel(hs)
    o32 = lv.new(t) if e != 4 else 0.0                 # .to(x.dtype)
    lv.new(t)                                          # * out_scale
    lv.rel(o32)
    (lv.free if e != 4 else lv.rel)(seq)
    lv.new(t, t)                                       # silu(z), *
    lv.rel(t)
    o = lv.new(T * g.D * e)
    lv.rel(t, t, t, up)                                # silu(cx), * out_scale, the product
    lv.rel(2 * T * NH * 4)                             # ig, fg
    if e == 4 and not decode:                          # q and k saved as they are
        lv.rel(t, t)
        lv.free(t)
    else:
        lv.free(qkv)
    (lv.free if e != 4 else lv.rel)(f)                 # the normalised hs
    if not decode:
        lv.rel(hist)
    return o, pinned


def _slstm_block(lv: _Ledger, cfg, g: _Dims, B, S, *, decode) -> float:
    """``xlstm.slstm_block_apply``: leaves o. Training saves a dozen
    (B, D) float32 tensors of each of the S steps."""
    e, T, D = g.e, B * S, cfg.d_model
    Dl = D // g.split.width
    Fs = (int(4.0 / 3.0 * D) // 64 * 64 or D) // g.split.ffn
    xf = lv.new(T * D * 4) if e != 4 else 0.0
    lv.new(T * 4 * Dl * 4, T * 4 * Dl * 4)             # x @ w_zifo, + b_zifo
    lv.free(T * 4 * Dl * 4)
    lv.rel(xf)
    xp = T * 4 * Dl * 4
    lv.new(T * D * 4 * (12 if lv.grad else 1))         # the steps' h (and saved)
    hseq = T * D * 4
    hs = lv.new(T * D * 4) if not decode else 0.0      # stack
    lv.new(T * D * 4, T * D * 4)                       # ** 2, /
    lv.free(T * D * 4)
    lv.rel(hs)
    h32 = lv.new(T * D * e) if e != 4 else 0.0         # .to(x.dtype)
    lv.new(T * D * e)                                  # * out_scale
    lv.rel(h32)
    (lv.free if e != 4 else lv.rel)(T * D * 4)
    up = lv.new(T * 2 * Fs * e)
    lv.new(T * Fs * e, T * Fs * e)                     # gelu, u *
    lv.rel(T * Fs * e)
    o = lv.new(T * D * e)
    lv.rel(T * Fs * e, T * D * e, up)
    lv.free(xp, hseq)
    return o


# ---------------------------------------------------------------------------
# assembly (models/transformer.py, whisper.py, model.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Stage:
    """One part of a block as the backward pass meets it: the bytes its
    forward left alive (saved tensors and its output), the transient its
    backward adds on top, and its module's name in ``Params``."""
    part: str
    saved: float = 0.0
    transient: float = 0.0


class _Stages(list):
    """The stages of one block in forward order, each measured off the
    ledger as the growth across its forward."""

    def run(self, lv: _Ledger, part: str, transient: float, fn, *args, **kw):
        mark = lv.now
        out = fn(*args, **kw)
        self.append(_Stage(part, lv.now - mark, transient))
        return out


def _norm_bwd(n: float, e: int, kind: str) -> float:
    """A norm's backward: four float32 gradients of its size at once (a
    float32 LayerNorm five), and the gradient's cast back in bf16."""
    if e != 4:
        return 4 * 4 * n + n * e
    return 4 * n * (4 if kind == "rmsnorm" else 5)


def _attn_bwd(B, Sq, Skv, H, hd, chunk, e) -> float:
    """chunked_attention's backward: a chunk's score gradients (two at a
    time) beside the float32 K and V gradients it accumulates."""
    n = min(chunk, Sq)
    return 2 * B * H * n * Skv * 4 + 2 * B * H * Skv * hd * 4 + B * Sq * H * hd * 4


def _ffn_bwd(T, D, F, e, kind="swiglu") -> float:
    """An FFN's backward: the down projection's weight gradient, then
    SwiGLU's two (T, F) gradients beside the one they come from (the
    GELU MLP's one, as its saved output goes)."""
    return F * D * e + (2 if kind == "swiglu" else 1) * T * F * e


def _block(lv: _Ledger, cfg, g: _Dims, btype, B, S, Skv, *, decode, cache, chunk,
           stages: _Stages | None = None):
    """``transformer.apply_block``: leaves the new x; returns the bytes its
    returned state pins until the next block returns. ``stages``: filled
    with the block's backward stages (a training forward)."""
    T, e, D = B * S, g.e, g.D
    st = stages if stages is not None else _Stages()
    h = st.run(lv, "ln1", _norm_bwd(T * D, e, g.kind), _norm, lv, T * D, e, g.kind)
    pinned = 0.0
    if btype in ("attn_block", "attn"):
        o = st.run(lv, "attn", _attn_bwd(B, S, S, g.H, g.hd, chunk, e), _attn_apply, lv,
                   g, B, S, Skv, decode=decode, chunk=chunk, rope=cfg.rope_theta > 0)
    elif btype == "mla_block":
        m = cfg.mla
        o = st.run(lv, "attn", _attn_bwd(B, S, S, g.H, m.qk_nope_head_dim + m.qk_rope_head_dim,
                                         chunk, e),
                   _mla_apply, lv, cfg, g, B, S, Skv, decode=decode, chunk=chunk)
    elif btype == "rec":
        W = (cfg.lru_width or D) // g.split.width
        o, pinned = st.run(lv, "rec", 4 * T * W * 4, _rec_block, lv, cfg, g, B, S,
                           decode=decode, cache=cache)
    elif btype == "mlstm":
        di = PF_MLSTM * D // g.split.width
        c = min(chunk, 256, S)
        # float32 gradients of two (T, d_in) activations (three in bf16,
        # with the casts back) and one chunk's score gradient
        tr = (2 if e == 4 else 3) * T * di * 4 + B * cfg.n_heads * c * S * 4
        o, pinned = st.run(lv, "cell", tr,
                           _mlstm_block, lv, cfg, g, B, S, decode=decode, cache=cache,
                           chunk=min(chunk, 256))
    else:
        Fs = (int(4.0 / 3.0 * D) // 64 * 64 or D) // g.split.ffn
        o = st.run(lv, "cell", _ffn_bwd(T, D, Fs, e), _slstm_block, lv, cfg, g, B, S,
                   decode=decode)
    x = lv.new(T * D * e)                              # x + o
    if btype in ("mlstm", "slstm") or cfg.ffn == "none":
        lv.rel(h)
        lv.free(o)
        return pinned
    h2 = st.run(lv, "ln2", _norm_bwd(T * D, e, g.kind), _norm, lv, T * D, e, g.kind)
    if cfg.moe is not None:
        m = cfg.moe
        El, C = m.n_experts // g.split.experts, _capacity(T, cfg)
        tr = max(T * m.top_k * D * 4 + El * C * D * e,          # the combine's
                 El * m.d_ff_expert * D * e + 3 * El * C * m.d_ff_expert * e)
        f = st.run(lv, "ffn", tr, _moe, lv, cfg, T, e, g.split)
    else:
        f = st.run(lv, "ffn", _ffn_bwd(T, D, g.F, e, cfg.ffn), _ffn, lv, T, D, g.F,
                   cfg.ffn, e)
    lv.new(T * D * e)                                  # x + f
    (lv.rel if e == 4 and g.kind == "rmsnorm" else lv.free)(x)
    lv.rel(h, h2)
    lv.free(o, f)
    return pinned


def _window(cfg, btype, Skv):
    return min(Skv, cfg.local_window) if btype == "attn" and cfg.local_window else Skv


def _rope_tables(lv: _Ledger, cfg, B, S) -> float:
    """``rope_cos_sin``: leaves cos and sin (B, S, rope dim) float32."""
    if cfg.rope_theta <= 0:
        return 0.0
    hr = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    ang = B * S * hr * 4
    lv.new(ang / 2, ang)                               # angles, cat
    cs = lv.new(ang, ang)                              # cos, sin
    lv.free(ang / 2, ang)
    return cs


def _decoder(lv: _Ledger, cfg, g: _Dims, B, S, Skv, *, decode, cache, chunk,
             vision: bool) -> float:
    """``transformer.forward`` without gradients: leaves the final norm's
    output."""
    from repro_torch.models.transformer import block_layout
    T, e, D = B * S, g.e, g.D
    x = lv.new(T * D * e)                              # embed[tokens]
    if vision:
        lv.new(T * D * e)                              # cat(vision, x[nv:])
        lv.free(x)
    rope = _rope_tables(lv, cfg, B, S)
    pinned = 0.0
    for btype in block_layout(cfg):
        kv = _window(cfg, btype, Skv) // (g.split.kv_seq if decode else 1)
        p = _block(lv, cfg, g, btype, B, S, kv, decode=decode, cache=cache, chunk=chunk)
        lv.free(x, pinned)
        pinned = p
    out = _norm(lv, T * D, e, g.kind)
    lv.free(x, pinned, rope)
    return out


def _enc_block(lv: _Ledger, g: _Dims, B, S, chunk, stages: _Stages | None = None):
    """``whisper._enc_block``: leaves the new x."""
    T, e, D = B * S, g.e, g.D
    st = stages if stages is not None else _Stages()
    h = st.run(lv, "ln1", _norm_bwd(T * D, e, "layernorm"), _norm, lv, T * D, e,
               "layernorm")
    o = st.run(lv, "attn", _attn_bwd(B, S, S, g.H, g.hd, chunk, e), _attn_apply, lv, g,
               B, S, S, decode=False, chunk=chunk, bias=True, rope=False)
    x1 = lv.new(T * D * e)
    h2 = st.run(lv, "ln2", _norm_bwd(T * D, e, "layernorm"), _norm, lv, T * D, e,
                "layernorm")
    f = st.run(lv, "ffn", _ffn_bwd(T, D, g.F, e, "mlp_gelu"), _ffn, lv, T, D, g.F,
               "mlp_gelu", e)
    lv.new(T * D * e)
    lv.rel(h, h2)
    lv.free(o, x1, f)


def _dec_block(lv: _Ledger, g: _Dims, B, S, Skv, enc_seq, *, decode, chunk,
               stages: _Stages | None = None):
    """``whisper._dec_block``: leaves the new x."""
    T, e, D = B * S, g.e, g.D
    st = stages if stages is not None else _Stages()
    qb = T * g.H * g.hd * e

    def cross():
        q = lv.new(qb, qb)                             # q, + bq
        lv.free(qb)
        q = qb
        o = _attend(lv, q, 0.0, 0.0,
                    (B, S, enc_seq, g.H, g.KV, g.hd, g.hd, 1 if decode else chunk, e),
                    (B, S, g.H, g.H * g.hd, D, e))
        lv.new(o)                                      # + bo
        lv.free(o)
        return o

    h = st.run(lv, "ln1", _norm_bwd(T * D, e, "layernorm"), _norm, lv, T * D, e,
               "layernorm")
    o = st.run(lv, "self_attn", _attn_bwd(B, S, S, g.H, g.hd, chunk, e), _attn_apply, lv,
               g, B, S, Skv, decode=decode, chunk=chunk, bias=True, rope=False)
    x1 = lv.new(T * D * e)
    h2 = st.run(lv, "ln_x", _norm_bwd(T * D, e, "layernorm"), _norm, lv, T * D, e,
                "layernorm")
    lv.rel(h)
    c = st.run(lv, "cross_attn", _attn_bwd(B, S, enc_seq, g.H, g.hd, chunk, e), cross)
    x2 = lv.new(T * D * e)
    lv.free(x1, c)
    h3 = st.run(lv, "ln2", _norm_bwd(T * D, e, "layernorm"), _norm, lv, T * D, e,
                "layernorm")
    lv.rel(h2)
    f = st.run(lv, "ffn", _ffn_bwd(T, D, g.F, e, "mlp_gelu"), _ffn, lv, T, D, g.F,
               "mlp_gelu", e)
    lv.new(T * D * e)
    lv.rel(h3)
    lv.free(o, x2, f)


def _encode(lv: _Ledger, g: _Dims, B, S, n_layers, chunk, *, on_block=None) -> tuple:
    """``whisper.encode``: (the encoder's output, the positions' bytes the
    caller frees)."""
    e, D = g.e, g.D
    pos = lv.new(S * D * 4)
    if e != 4:
        lv.new(S * D * e)
        lv.free(pos)
        pos = S * D * e
    x = lv.new(B * S * D * e)
    for i in range(n_layers):
        if on_block is None:
            _enc_block(lv, g, B, S, chunk)
            lv.free(x)
        else:
            on_block(i, x)
    enc = _norm(lv, B * S * D, e, "layernorm")
    lv.free(x, pos)
    return enc


def _whisper(lv: _Ledger, cfg, g: _Dims, B, S, Skv, *, decode, enc_seq, chunk) -> tuple:
    """``Model.prefill`` / ``decode_step`` of the audio family up to the
    decoder's final norm: (its output, the fresh cross K/V, bytes the
    caller frees after the head)."""
    T, e, D, L = B * S, g.e, g.D, cfg.n_layers
    ckv = kv_list = enc = 0.0
    if not decode:
        enc = _encode(lv, g, B, enc_seq, cfg.encdec.n_encoder_layers, chunk)
    lv.new(T * D * e, S * D * e, T * D * e)            # embed, pos_dec, their sum
    lv.free(T * D * e, S * D * e)
    x = T * D * e
    kvb = B * enc_seq * g.KV * g.hd * e
    if not decode:
        for _ in range(2 * L):                         # cross_kv: einsum, + bias
            lv.new(kvb, kvb)
            lv.free(kvb)
        kv_list = 2 * L * kvb
        ckv = lv.new(2 * L * kvb)                      # the stacks
        # they replace the cache's cross K/V (an argument, n_heads wide),
        # which is freed
        lv.free(2 * L * B * enc_seq * cfg.n_heads * g.hd * e / g.split.kv_seq)
    for _ in range(L):
        _dec_block(lv, g, B, S, Skv, enc_seq, decode=decode, chunk=chunk)
        lv.free(x)
    out = _norm(lv, T * D, e, "layernorm")
    lv.free(x)
    return out, ckv, kv_list + enc


def lm_step_memory(cfg, batch: int, new_tokens: int, cache_len: int, *,
                   enc_seq: int | None = None, chunk: int = 1024,
                   split: Split = Split()) -> Memory:
    """One ``Model.prefill`` (``new_tokens`` > 1: the prompt into a cache of
    ``cache_len``) or ``decode_step`` (``new_tokens`` == 1 at a cache of
    ``cache_len``) of ``batch`` sequences on one chip; ``enc_seq``: the
    audio family's encoder frames (and cross cache length). Output: the
    last position's logits, and the fresh cross K/V of an audio prefill."""
    g = _dims(cfg, split)
    lv = _Ledger()
    decode = new_tokens == 1
    B, S = batch, new_tokens
    ckv = after = 0.0
    if cfg.family == "audio":
        kv = cache_len // (split.kv_seq if decode else 1)
        h, ckv, after = _whisper(lv, cfg, g, B, S, kv, decode=decode,
                                 enc_seq=enc_seq or cache_len, chunk=chunk)
    else:
        h = _decoder(lv, cfg, g, B, S, cache_len, decode=decode, cache=True,
                     chunk=chunk, vision=cfg.family == "vlm" and not decode)
    logits = lv.new(B * g.V * g.e)
    lv.free(h, after)
    return Memory(output=logits + ckv, temp=lv.peak)


# ---------------------------------------------------------------------------
# training (train/step.py, optim/adamw.py)
# ---------------------------------------------------------------------------


def _backward(lv: _Ledger, stages: _Stages, params: Params, layer, flow: float) -> None:
    """One block's backward, its stages in reverse: each adds its transient
    (and ``flow``, the gradient passing through), frees what its forward
    left and adds its weights' gradients."""
    for s in reversed(stages):
        lv.spike(s.transient + flow)
        lv.free(s.saved)
        lv.new(params.part_bytes(layer, s.part))


def _recompute(lv: _Ledger, run, out: float) -> _Stages:
    """A checkpointed block's recompute before its backward: what its
    forward saves comes back (``run(ledger, stages)`` walks the forward,
    transients and all). It stops once the saved tensors are back: the
    block's last product and its residual add (``out`` each) are not made
    again."""
    tmp, st = _Ledger(grad=True), _Stages()
    run(tmp, st)
    lv.spike(max(tmp.peak - 2 * out, 0.0))
    total = lv.new(tmp.now - out)
    st.insert(0, _Stage("", total - sum(s.saved for s in st)))
    return st


def _loss_forward(lv: _Ledger, B, S, D, V, e, *, chunk: int) -> list:
    """``lm_loss`` (``chunk``) or Whisper's loss (one chunk): each chunk's
    logits in float32 stay saved (with the hidden rows einsum copies when
    the chunk is a strided slice); returns the chunks' (rows, saved)."""
    chunks = []
    c = min(chunk, S)
    for c0 in range(0, S, c):
        n = min(c, S - c0)
        saved = lv.new(B * n * D * e) if S > n and B > 1 else 0.0
        lg = lv.new(B * n * V * e)
        if e != 4:
            lv.new(B * n * V * 4)                      # .float()
            lv.free(lg)
        saved += B * n * V * 4
        chunks.append((B * n, saved))
    return chunks


def _loss_backward(lv: _Ledger, chunks, V, D, e, head: float, flow: float) -> None:
    """The loss's backward, last chunk first: logsumexp's and gather's
    (rows, V) float32 gradients (four at once), then the head's weight
    gradient (its first chunk allocates it; each later one adds a copy)."""
    first = True
    for rows, saved in reversed(chunks):
        lv.spike(4 * rows * V * 4 + flow)
        lv.free(saved)
        if first:
            lv.new(head)
            first = False
        else:
            lv.spike(head)


def _train_pass(lv: _Ledger, cfg, g: _Dims, params: Params, B, S, *, remat, chunk) -> None:
    """One ``model.loss_fn`` and its ``torch.autograd.grad``: leaves every
    leaf's gradient."""
    from repro_torch.models.transformer import block_layout
    T, e, D = B * S, g.e, g.D
    flow = T * D * e                                   # the gradient through the blocks
    base = lv.now
    if cfg.family == "audio":
        _whisper_train(lv, cfg, g, params, B, S, remat=remat, chunk=chunk)
        return
    lv.grad = True
    x = lv.new(T * D * e)                              # embed[tokens]
    if cfg.family == "vlm":
        lv.new(T * D * e)                              # cat(vision, x[nv:])
        lv.free(x)
    _rope_tables(lv, cfg, B, S)
    layout = block_layout(cfg)
    saved_x = e == 4 and g.kind == "rmsnorm"           # the norm saves x itself
    blocks = []
    for i, btype in enumerate(layout):
        if remat:
            lv.grad = False
            _block(lv, cfg, g, btype, B, S, S, decode=False, cache=False, chunk=chunk)
            lv.grad = True                             # the checkpoint keeps x
        else:
            st = _Stages()
            mark = lv.now
            _block(lv, cfg, g, btype, B, S, S, decode=False, cache=False, chunk=chunk,
                   stages=st)
            (lv.rel if saved_x else lv.free)(x)
            st.insert(0, _Stage("", lv.now - mark - sum(s.saved for s in st)))
            blocks.append(st)
    fin = _Stages()
    fin.run(lv, "final_norm", _norm_bwd(T * D, e, g.kind), _norm, lv, T * D, e, g.kind)
    (lv.rel if saved_x else lv.free)(x)                # the last block's output
    head = params.part_bytes(None, "unembed" if not cfg.tie_embeddings else "embed")
    chunks = _loss_forward(lv, B, S, D, g.V, e, chunk=LOSS_CHUNK)
    # the backward
    _loss_backward(lv, chunks, g.V, D, e, head, flow)
    _backward(lv, fin, params, None, flow)
    for i in reversed(range(len(layout))):
        layer = f"blocks.{i}"
        if remat:
            st = _recompute(lv, lambda led, stages, b=layout[i]: _block(
                led, cfg, g, b, B, S, S, decode=False, cache=False, chunk=chunk,
                stages=stages), T * D * e)
        else:
            st = blocks[i]
        _backward(lv, st, params, layer, flow)
        if remat:
            lv.free(T * D * e)                         # the block's input, kept
    embed = params.part_bytes(None, "embed")
    if cfg.tie_embeddings:
        lv.spike(2 * embed)                            # the lookup's, added to the head's
    else:
        lv.new(embed)
    lv.free(lv.now - base - params.bytes)              # what the pass leaves: gradients


def _whisper_train(lv: _Ledger, cfg, g: _Dims, params: Params, B, S, *, remat, chunk):
    """``Model.loss_fn`` of the audio family and its backward."""
    T, e, D, L = B * S, g.e, g.D, cfg.n_layers
    flow = T * D * e
    base = lv.now
    kvb = T * g.KV * g.hd * e
    enc_st = []

    def enc_block(i, x):
        if remat:
            lv.grad = False
            _enc_block(lv, g, B, S, chunk)
            lv.grad = True
        else:
            st = _Stages()
            mark = lv.now
            _enc_block(lv, g, B, S, chunk, stages=st)
            lv.free(x)
            st.insert(0, _Stage("", lv.now - mark - sum(s.saved for s in st)))
            enc_st.append(st)

    lv.grad = True
    enc = _encode(lv, g, B, S, cfg.encdec.n_encoder_layers, chunk, on_block=enc_block)
    lv.new(T * D * e, S * D * e, T * D * e)            # embed, pos_dec, their sum
    lv.free(T * D * e, S * D * e)
    x = T * D * e
    dec_st = []
    for _ in range(L):
        lv.new(kvb, kvb, kvb, kvb)                     # cross_kv: einsums, + biases
        lv.free(kvb, kvb)
        if remat:
            lv.grad = False
            _dec_block(lv, g, B, S, S, S, decode=False, chunk=chunk)
            lv.grad = True                             # x, ck, cv kept
        else:
            st = _Stages()
            mark = lv.now
            _dec_block(lv, g, B, S, S, S, decode=False, chunk=chunk, stages=st)
            lv.free(x, 2 * kvb)
            st.insert(0, _Stage("", lv.now - mark - sum(s.saved for s in st)))
            dec_st.append(st)
    fin = _Stages()
    fin.run(lv, "dec_norm", _norm_bwd(T * D, e, "layernorm"), _norm, lv, T * D, e,
            "layernorm")
    lv.free(x)                                         # the last block's output
    chunks = _loss_forward(lv, B, S, D, g.V, e, chunk=S)
    _loss_backward(lv, chunks, g.V, D, e, params.part_bytes(None, "embed"), flow)
    _backward(lv, fin, params, None, flow)
    for i in reversed(range(L)):
        layer = f"dec_blocks.{i}"
        if remat:
            st = _recompute(lv, lambda led, stages: _dec_block(
                led, g, B, S, S, S, decode=False, chunk=chunk, stages=stages), T * D * e)
        else:
            st = dec_st[i]
        _backward(lv, st, params, layer, flow)
        if i == L - 1:                                 # d enc_out, summed over the layers
            lv.new(enc)
        lv.spike(enc)
        if remat:
            lv.free(T * D * e, 2 * kvb)
    for i in reversed(range(cfg.encdec.n_encoder_layers)):
        layer = f"enc_blocks.{i}"
        if remat:
            st = _recompute(lv, lambda led, stages: _enc_block(
                led, g, B, S, chunk, stages=stages), T * D * e)
        else:
            st = enc_st[i]
        _backward(lv, st, params, layer, flow)
        if remat:
            lv.free(T * D * e)
    lv.spike(2 * params.part_bytes(None, "embed"))     # the lookup's, added to the head's
    lv.new(params.part_bytes(None, "pos_dec"))
    lv.free(lv.now - base - params.bytes)


def lm_train_memory(cfg, batch: int, seq: int, *, remat: bool = False,
                    n_microbatches: int = 1, chunk: int = 1024, split: Split = Split(),
                    params: Params | None = None) -> Memory:
    """One ``make_train_step`` step of ``batch`` sequences of ``seq`` tokens
    on one chip: the forward (blocks checkpointed with ``remat``), the
    backward, the microbatches' float32 sums, ``global_norm`` and
    ``adamw_update`` (in place). ``params``: the chip's weights
    (``params_of``; one chip by default). Output: the loss and metrics."""
    params = params or params_of(cfg)
    g = _dims(cfg, split)
    lv = _Ledger()
    mb = batch // n_microbatches
    if n_microbatches > 1:
        acc = lv.new(4 * params.numel)                 # float32 accumulators
        _train_pass(lv, cfg, g, params, mb, seq, remat=remat, chunk=chunk)
        lv.free(params.bytes)                          # added in, then dropped
        grads = [(n, 4) for n, _, _, _ in params.leaves]
    else:
        acc = 0.0
        _train_pass(lv, cfg, g, params, mb, seq, remat=remat, chunk=chunk)
        grads = [(n, b) for n, b, _, _ in params.leaves]
    lv.grad = False
    # global_norm: each leaf's float32 copy (bf16) and its square
    lv.spike(max((4 * n if b != 4 else 0.0) + 4 * n for n, b in grads))
    # adamw_update: a leaf's float32 g and g * (1 - b1), then delta, beside
    # the previous leaf's delta
    prev = 0.0
    for n in params.opt:
        lv.new(4 * n, 4 * n)
        lv.free(4 * n)
        lv.new(4 * n)
        lv.free(prev, 4 * n)
        prev = 4 * n
    lv.free(prev)
    return Memory(output=12.0, temp=lv.peak)
