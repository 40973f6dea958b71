"""Roofline terms of the port's kernels and LM steps on the NVIDIA H100
(SXM5, 80 GB).

Counterpart of both ``repro.utils.roofline`` and ``repro.utils.hlo_cost``.
The reference prices a compiled program by parsing XLA's optimised HLO
text; PyTorch has no such text, and ``torch.utils.flop_counter`` does not
see the kernels' ctypes launches. So the port's cost model is the
*analytic work of the function*: the operations it must do and the HBM
bytes it must move (each input read once, each output written once) —
the same whatever tiles, grids or splits implement it. ``chip_smoke.py``
and the tune sweep (:mod:`repro_torch.tune.sweep`) both read their bounds
from the work counts here.

Peaks (per card):
  * HBM3 bandwidth 3.35 TB/s — NVIDIA H100 Tensor Core GPU datasheet
    (SXM5);
  * dense int8 tensor-core rate 1,979 TOPS and bf16 989 TFLOP/s — the same
    datasheet (dense, without sparsity);
  * 64 32-bit integer add/logic results (LOP3 included) and 16 popc results
    per clock per SM — CUDA C++ Programming Guide, arithmetic instruction
    throughput, compute capability 9.0;
  * 0.589 ``mma.sync`` m16n8k256 b1 AND-popc instructions per clock per SM
    (16 x 8 pairs x 256 bits each) — measured by ``scripts/bmma_probe.py``
    on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md);
  * NVLink 450 GB/s per direction — the datasheet's 900 GB/s
    bidirectional;
  * InfiniBand 50 GB/s per direction a GPU between nodes — the NVIDIA DGX
    H100 datasheet's one single-port 400 Gb/s ConnectX-7 a GPU (8 GPUs a
    node);
  * 132 SMs at a 1,980 MHz maximum SM clock — the datasheet's SXM5 part,
    the default when the caller has not read the card's own clock.

The LM path (``models/``, ``launch/serve.py``) launches none of the
kernels above; ``lm_step_roofline`` and ``lm_train_roofline`` count one
prefill, decode or training step of every family the same way.

Terms (seconds; ``flops`` here are the integer or tensor-core operations
of the route that does them, at ``ops_per_s``):
    compute    = flops      / (chips * ops_per_s)
    memory     = hbm_bytes  / (chips * HBM_BYTES_PER_S)
    collective = coll_bytes / (chips * coll_bytes_per_s)
(``coll_bytes_per_s``: NVLink unless the caller reckons another rate, as
the dry run does for axes that cross nodes.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
PEAK_FLOPS_BF16 = 989e12
INT32_OPS_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
BMMA_PER_CLK_SM = 0.589
BMMA_PAIR_BITS = 16 * 8 * 256
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8
H100_SMS = 132
H100_SM_CLOCK_HZ = 1.98e9


@dataclasses.dataclass
class Roofline:
    flops: float                 # operations of the route (see ops_per_s)
    hbm_bytes: float             # bytes the function must move
    coll_bytes: float            # summed collective operand bytes
    chips: int
    model_flops: float = 0.0     # analytic "useful" ops (2 * D per pair)
    ops_per_s: float = INT8_TENSOR_OPS_PER_S   # the route's peak rate
    route: str = ""              # which units the ops run on
    coll_bytes_per_s: float = NVLINK_BYTES_PER_S   # the collectives' rate

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.ops_per_s)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BYTES_PER_S)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.coll_bytes_per_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-model time (no overlap assumption = max)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bound_by(self) -> str:
        """``"operations"`` or ``"bytes"``, as the kernels JSON line says."""
        return "operations" if self.t_compute >= self.t_memory else "bytes"

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ideal (useful-ops-only) time at the route's rate:
        how close the function is to the pure-compute roofline."""
        ideal = self.model_flops / (self.chips * self.ops_per_s)
        return ideal / self.t_bound if self.t_bound > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops, "ops_per_s": self.ops_per_s,
            "route": self.route,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_fraction": self.roofline_fraction,
        }


def useful_ops(dim: int, q_rows: int, r_rows: int) -> float:
    """Analytic "useful" work of one all-pairs scan: 2 * D ops per (query,
    reference) pair (the +-1 dot formulation)."""
    return 2.0 * dim * q_rows * r_rows


def hamming_routes(pairs: float, n_words: int, dim: int, *,
                   clock_hz: float = H100_SM_CLOCK_HZ,
                   n_sms: int = H100_SMS) -> dict[str, tuple[float, float]]:
    """The three routes to ``pairs`` Hamming distances of ``n_words`` words:
    route -> (operations, operations per second) — a popc per (pair,
    word); 2 * dim int8 tensor-core ops per pair (a +-1 dot); or one
    m16n8k256 AND-popc MMA per 16 x 8 pairs x 256 bits on the binary
    tensor cores, at the rate the probe measured."""
    return {
        "popc": (pairs * n_words, POPC_PER_CLK_SM * n_sms * clock_hz),
        "int8 tensor cores": (pairs * dim * 2.0, INT8_TENSOR_OPS_PER_S),
        "binary tensor cores": (pairs * 32 * n_words / BMMA_PAIR_BITS,
                                BMMA_PER_CLK_SM * n_sms * clock_hz),
    }


def _cheapest(routes: dict, names) -> tuple[str, float, float]:
    name = min(names, key=lambda n: routes[n][0] / routes[n][1])
    return name, *routes[name]


def tile_roofline(q_rows: int, r_rows: int, n_words: int, dim: int, *,
                  clock_hz: float = H100_SM_CLOCK_HZ,
                  n_sms: int = H100_SMS) -> Roofline:
    """All-pairs (Q, R) Hamming tile (``hamming_matrix``, ``hamming_mxu``):
    the rows and queries read once, the int32 tile written once; the
    operations by the cheaper of popc and the int8 +-1 dot."""
    pairs = float(q_rows) * r_rows
    route, ops, rate = _cheapest(
        hamming_routes(pairs, n_words, dim, clock_hz=clock_hz, n_sms=n_sms),
        ("popc", "int8 tensor cores"))
    nbytes = (r_rows * n_words + q_rows * n_words + q_rows * r_rows) * 4
    return Roofline(flops=ops, hbm_bytes=nbytes, coll_bytes=0.0, chips=1,
                    model_flops=useful_ops(dim, q_rows, r_rows),
                    ops_per_s=rate, route=route)


def fused_roofline(n_queries: int, rk: int, covered_rows: int, n_words: int,
                   dim: int, k: int, n_blocks: int, *,
                   clock_hz: float = H100_SM_CLOCK_HZ,
                   n_sms: int = H100_SMS) -> Roofline:
    """Fused dual-window top-k of ``n_queries`` sorted/padded queries, each
    block scanning ``rk`` rows: the ``covered_rows`` distinct rows the
    blocks scan read once (words, pmz, charge), the queries and their
    sidecars, the ``n_blocks`` start rows, four (Q, k) int32 outputs; the
    operations by the cheapest of the three Hamming routes."""
    pairs = float(n_queries) * rk
    route, ops, rate = _cheapest(
        hamming_routes(pairs, n_words, dim, clock_hz=clock_hz, n_sms=n_sms),
        ("popc", "int8 tensor cores", "binary tensor cores"))
    nbytes = (covered_rows * (n_words * 4 + 8) + n_queries * n_words * 4
              + n_queries * 8 + n_blocks * 4 + 4 * n_queries * k * 4)
    return Roofline(flops=ops, hbm_bytes=nbytes, coll_bytes=0.0, chips=1,
                    model_flops=useful_ops(dim, n_queries, rk),
                    ops_per_s=rate, route=route)


def hdencode_roofline(n_spectra: int, n_peaks: int, n_words: int,
                      n_valid: int, touched_rows: int, *,
                      clock_hz: float = H100_SM_CLOCK_HZ,
                      n_sms: int = H100_SMS) -> Roofline:
    """ID-level encode of ``n_spectra`` x ``n_peaks`` peaks (``n_valid``
    valid) into ``n_words``-word HVs. Per (valid peak, word): one XOR to
    bind and a carry-save add into a bit-sliced counter (~2 LOP3s); per
    output word the majority compare of a ceil(log2(P+1))-plane count
    (~2 ops a plane) and the tie-break select. Bytes: bins, levels and mask
    (9 bytes a peak), the ``touched_rows`` codebook rows, the tiebreak
    word row, the output."""
    planes = max(1, int(n_peaks).bit_length())
    ops = n_valid * n_words * 3 + n_spectra * n_words * (2 * planes + 1)
    nbytes = (n_spectra * n_peaks * 9 + touched_rows * n_words * 4
              + n_words * 4 + n_spectra * n_words * 4)
    return Roofline(flops=ops, hbm_bytes=nbytes, coll_bytes=0.0, chips=1,
                    ops_per_s=INT32_OPS_PER_CLK_SM * n_sms * clock_hz,
                    route="int32 ALU")


_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _norm_params(cfg, kind: str | None = None) -> int:
    return cfg.d_model * (2 if (kind or cfg.norm) == "layernorm" else 1)


def _attn_params(cfg, *, bias: bool = False) -> int:
    D, hd, H, KV = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    return 2 * D * H * hd + 2 * D * KV * hd + (H * hd + 2 * KV * hd + D if bias else 0)


def _ffn_params(d: int, f: int, kind: str) -> int:
    return 3 * d * f if kind == "swiglu" else 2 * d * f + f + d


def _expert_params(cfg) -> int:
    """One routed expert's weights (w_gate, w_up, w_down)."""
    return 3 * cfg.d_model * cfg.moe.d_ff_expert


def _block_params(cfg, btype: str) -> int:
    """One decoder block of type ``btype`` (norms, biases and gates in)."""
    D, nh, Kc = cfg.d_model, cfg.n_heads, cfg.conv_width
    if btype in ("attn_block", "attn"):
        mix = _attn_params(cfg)
    elif btype == "mla_block":
        m, H = cfg.mla, cfg.n_heads
        mix = (D * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
               + D * (m.kv_lora_rank + m.qk_rope_head_dim)
               + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
               + H * m.v_head_dim * D)
    elif btype == "rec":
        W = cfg.lru_width or D
        mix = 3 * D * W + Kc * W + W + 2 * W * W + 3 * W
    elif btype == "mlstm":              # up-projection factor 2, no FFN
        d_in = 2 * D
        return (_norm_params(cfg) + 2 * D * d_in + Kc * d_in + d_in
                + 3 * d_in * d_in + 2 * d_in * nh + 2 * nh + d_in + d_in * D)
    elif btype == "slstm":              # its own 4/3 gated FFN, no ln2
        dh, d_ff = D // nh, int(4.0 / 3.0 * D) // 64 * 64 or D
        return (_norm_params(cfg) + 4 * D * D + 4 * D + 4 * nh * dh * dh + D
                + 3 * D * d_ff)
    else:
        raise ValueError(btype)
    if cfg.ffn == "none":
        return _norm_params(cfg) + mix
    if cfg.moe is not None:
        m = cfg.moe
        ffn = (D * m.n_experts + m.n_experts * _expert_params(cfg)
               + (3 * D * m.d_ff_expert * m.n_shared if m.n_shared else 0))
    else:
        ffn = _ffn_params(D, cfg.d_ff, cfg.ffn)
    return 2 * _norm_params(cfg) + mix + ffn


def _block_types(cfg) -> list[str]:
    if not cfg.block_pattern:
        return ["mla_block" if cfg.mla else "attn_block"] * cfg.n_layers
    pat = list(cfg.block_pattern)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def lm_param_counts(cfg, *, max_dec_seq: int = 4096) -> dict:
    """Parameters of the published model (real heads: no TP padding), as
    the reference's ``param_specs`` makes them.

    Decoders: ``embed``, ``unembed`` (0 when tied), ``final_norm``,
    ``layers`` (one block's parameters per block type: norms, biases, the
    float32 gates and a MoE layer's router and all its experts included),
    ``layer`` (the same, for an arch with one block type), ``total``. MoE
    archs add ``expert`` (one routed expert's weights, 3 * D * F_expert)
    and ``active``: the parameters one token runs through, ``total`` less
    the (E - K) routed experts it skips in every layer (shared experts,
    router and embeddings counted).

    Audio (Whisper): ``embed`` (tied), ``pos_dec`` (``max_dec_seq`` rows,
    ``Model.max_seq``), ``enc_layer``, ``dec_layer`` (self- and
    cross-attention with biases, three LayerNorms, the GELU MLP),
    ``final_norm`` (each of the two), ``total``."""
    D, V = cfg.d_model, cfg.vocab_size
    if cfg.family == "audio":
        ln = _norm_params(cfg, "layernorm")
        mlp = _ffn_params(D, cfg.d_ff, "mlp_gelu")
        c = {"embed": V * D, "pos_dec": max_dec_seq * D,
             "enc_layer": 2 * ln + _attn_params(cfg, bias=True) + mlp,
             "dec_layer": 3 * ln + 2 * _attn_params(cfg, bias=True) + mlp,
             "final_norm": ln}
        c["total"] = (c["embed"] + c["pos_dec"] + cfg.encdec.n_encoder_layers * c["enc_layer"]
                      + cfg.n_layers * c["dec_layer"] + 2 * ln)
        return c
    types = _block_types(cfg)
    layers = {t: _block_params(cfg, t) for t in dict.fromkeys(types)}
    c = {"embed": V * D, "unembed": 0 if cfg.tie_embeddings else D * V,
         "final_norm": _norm_params(cfg), "layers": layers}
    if len(layers) == 1:
        c["layer"] = next(iter(layers.values()))
    c["total"] = (c["embed"] + c["unembed"] + sum(layers[t] for t in types)
                  + c["final_norm"])
    if cfg.moe is not None:
        c["expert"] = _expert_params(cfg)
        c["active"] = c["total"] - cfg.n_layers * (cfg.moe.n_experts - cfg.moe.top_k) * c["expert"]
    return c


def _attn_pairs(new_tokens: int, context: int, window: int = 0) -> int:
    """(query, key) pairs one sequence's causal attention scores: the new
    positions p = context - new_tokens + 1 .. context (1-based) each see p
    keys, or min(p, window) under a sliding window."""
    a, b = context - new_tokens + 1, context
    if not window or b <= window:
        return (a + b) * new_tokens // 2
    if a > window:
        return window * new_tokens
    return (a + window) * (window - a + 1) // 2 + window * (b - window)


def _scan_ops(seq: int) -> int:
    """Operations of ``rglru.linear_scan`` on one channel of one sequence
    of ``seq`` steps: at each doubling d < seq, a multiply-add on the
    seq - d folded positions, and seq - d products of ``a`` except at the
    last step."""
    ops, d = 0, 1
    while d < seq:
        ops += 2 * (seq - d) + ((seq - d) if 2 * d < seq else 0)
        d *= 2
    return ops


def _f32_params(cfg) -> int:
    """Parameters a bf16 model keeps in float32 (the MoE router, the RG-LRU
    gate biases and Λ, the mLSTM gates, the sLSTM's input and recurrent
    weights)."""
    D, nh = cfg.d_model, cfg.n_heads
    n = cfg.n_layers * D * cfg.moe.n_experts if cfg.moe is not None else 0
    for btype in (_block_types(cfg) if cfg.family != "audio" else ()):
        if btype == "rec":
            n += 3 * (cfg.lru_width or D)
        elif btype == "mlstm":
            n += 2 * 2 * D * nh + 2 * nh
        elif btype == "slstm":
            n += 4 * D * D + 4 * D + 4 * D * (D // nh)
    return n


@dataclasses.dataclass
class _Forward:
    """One forward's work: ``flops`` (the port's products and the named
    elementwise terms), ``model_flops``, HBM ``nbytes``, the lm_head's
    ``head`` flops, and ``outside``: flops that run outside the remat
    checkpoints besides the head (Whisper's cross K/V)."""
    flops: float
    model_flops: float
    nbytes: float
    head: float
    outside: float = 0.0


def lm_step_roofline(cfg, batch: int, new_tokens: int, context: int, *,
                     enc_seq: int | None = None, chunk: int = 1024) -> Roofline:
    """One step of the model on ``batch`` sequences: ``new_tokens``
    positions each, the last at position ``context - 1`` (a prefill of S:
    new_tokens = context = S; a decode step at context L: new_tokens = 1),
    the lm_head on the last position only, as ``Model.prefill`` and
    ``decode_step`` apply it; ``enc_seq``: Whisper's encoder frames
    (default ``encdec.encoder_seq``); ``chunk``: the ``Model``'s chunk,
    which sets the mLSTM's (min(chunk, 256), as ``apply_block`` passes it).

    Dense and MoE decoders of attention blocks (the published model, real
    heads). Operations (bf16 tensor cores): 2 per weight per token through
    the blocks' attention projections, dense FFN, shared experts and
    router; 4 * hd per (query, key) pair per head for QK^T and PV under the
    causal mask; 2 * D * V per logit row. A MoE layer's routed experts run
    as formulated: over all E capacity buffers of C = ceil(T K / E * cf)
    slots each, whatever the routing, so 2 * E * C * 3 * D * F_expert a
    layer (at 8 x 512 with olmoe's E 64, K 8, cf 1.25: C = 640, 1.25x the
    T * K routed copies; at decode B = 8: C = 2). ``model_flops`` counts
    the routed copies instead, 2 * T * K * 3 * D * F_expert a layer: the
    work of the active parameters, which an MFU divides by. Bytes: each weight read
    once, every expert's included (the expert products read all E weight
    stacks; a MoE router is float32), a tied embedding once, for the
    lm_head (untied, only the prompt's rows of it), the cached K/V of the earlier positions read,
    the new K/V written, the tokens read and the logits written.

    The other families are counted as the port formulates them (see
    :func:`_forward`): MLA (``layers.mla_apply``), the RecurrentGemma
    pattern (``rglru.rec_block_apply``, windowed attention), xLSTM
    (``xlstm.mlstm_block_apply`` / ``slstm_block_apply``) and Whisper
    (``whisper.encode`` / ``decode``)."""
    f = _forward(cfg, batch, new_tokens, context, enc_seq=enc_seq, chunk=chunk,
                 cache=True)
    return Roofline(flops=f.flops, hbm_bytes=float(f.nbytes), coll_bytes=0.0, chips=1,
                    model_flops=f.model_flops, ops_per_s=PEAK_FLOPS_BF16,
                    route="bf16 tensor cores")


def _forward(cfg, batch: int, new_tokens: int, context: int, *, enc_seq, chunk,
             cache: bool) -> _Forward:
    """A forward's work; ``cache``: a serving step that reads and writes a
    cache (``Model.prefill`` / ``decode_step``), else a training forward
    (no cache, nothing written but the output).

    * **MLA** (deepseek-v2-lite): per token the q (D x H x (nope + rope)),
      kv-down (D x (r + rope)), o, router and shared-expert products; the
      kv-up (r x H x (nope + v)) over the cached latent rows the step
      attends to (batch x context: the port up-projects the cache, where
      the published model may absorb w_uk into q); per pair 2 * H *
      (nope + rope) for QK^T and 2 * H * v for PV; the routed experts as
      above. Bytes as above with the latent cache's r + rope a layer.
    * **RecurrentGemma** (rec, rec, attn): the rec block's w_in_main,
      w_in_gate, w_out and the RG-LRU gates w_a, w_x (float32 GEMMs in the
      port, priced at the bf16 rate), 2 * conv_width ops a channel a token
      for the depthwise causal conv, and the scan as the port runs it: a
      log-depth scan of ~3 S log2 S operations a channel (``_scan_ops``)
      where the published recurrence takes 2 S (``model_flops``), a decode
      step 2 a channel. The attention blocks' pairs are bounded by
      ``local_window``. Every block's SwiGLU FFN. Bytes: the recurrent
      state (float32 h) and the conv state read and written, the windowed
      K/V of the earlier positions read and the new rows written.
    * **xLSTM** (7 mLSTM : 1 sLSTM): the mLSTM's w_up, w_q, w_k, w_v, the
      float32 gates w_i, w_f and w_down; its prefill's quadratic term as
      ``mlstm_parallel`` forms it: each q chunk of c rows scores against
      every key of the sequence and is masked after (4 * S * dh a row a
      head for the inter-chunk QK^T and PV) plus the chunk's own c x c
      block (4 * c * dh), where the published parallel form takes the
      causal pairs only (4 * dh a pair: ``model_flops``); a prefill into a
      cache builds the final (C, n, m) in closed form (2 * S * dh^2 a
      head); a decode step reads C q and n q (2 * dh^2 + 2 * dh a head; the
      rank-1 update of C is elementwise, not counted). The sLSTM's float32
      input product w_zifo, its per-step block-diagonal recurrent products
      (2 * 4 * nh * dh^2 a token, a Python loop over time in the port) and
      its 4/3 FFN. Both blocks' conv as above. Bytes: the mLSTM's
      (nh, dh, dh) C, n, m and conv state, the sLSTM's (c, n, h, m) read
      (decode, and the sLSTM's prefill) and written.
    * **Whisper**: the encoder over ``enc_seq`` frames (bidirectional:
      enc_seq^2 pairs) and the cross K/V of every decoder layer (2 * D *
      KV * hd a frame each) where ``Model.prefill`` runs them (once); the
      decoder's self-attention (causal pairs), cross-attention (q and o
      products, new_tokens * enc_seq pairs over the cached K/V) and MLP;
      the tied head. Bytes: a prefill reads the encoder's and decoder's
      weights and the frames and writes the self and cross K/V; a decode
      step reads the decoder's weights, the cached self K/V and the cross
      K/V. Biases, norms, softmax and gates are not counted, as for the
      dense decoders.

    Pairs are counted under the mask (causal, windowed or valid), where
    ``chunked_attention`` scores whole rectangles of q chunks against the
    keys and masks after: that masked work is not counted."""
    if cfg.family == "audio":
        return _whisper_forward(cfg, batch, new_tokens, context,
                                enc_seq=enc_seq or cfg.encdec.encoder_seq, cache=cache)
    if cfg.block_pattern:
        return _pattern_forward(cfg, batch, new_tokens, context, chunk=chunk, cache=cache)
    c = lm_param_counts(cfg)
    bpe = _DTYPE_BYTES[cfg.dtype]
    D, V, hd = cfg.d_model, cfg.vocab_size, cfg.resolved_head_dim
    L, H, KV = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * new_tokens
    pairs = batch * _attn_pairs(new_tokens, context)
    norms = 2 * _norm_params(cfg)
    bias = cfg.d_ff + D if cfg.ffn == "mlp_gelu" else 0
    matmul_weights = c["layer"] - norms - bias
    pair_ops, kv_up, kv_row = 4 * H * hd, 0, L * 2 * KV * hd
    if cfg.mla is not None:
        m = cfg.mla
        kv_up = m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
        matmul_weights -= kv_up
        pair_ops = 2 * H * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)
        kv_row = L * (m.kv_lora_rank + m.qk_rope_head_dim)
    expert_flops = routed_flops = 0.0
    if cfg.moe is not None:
        m = cfg.moe
        slots = m.n_experts * max(int(np.ceil(tokens * m.top_k / m.n_experts
                                              * m.capacity_factor)), 1)
        matmul_weights -= m.n_experts * c["expert"]
        expert_flops = 2.0 * L * slots * c["expert"]
        routed_flops = 2.0 * L * tokens * m.top_k * c["expert"]
    rest = (2.0 * tokens * L * matmul_weights + 2.0 * batch * context * L * kv_up
            + pair_ops * L * pairs + 2.0 * D * V * batch)
    head = V * D
    gathered = 0 if cfg.tie_embeddings else min(tokens, V) * D
    router_f32 = L * D * cfg.moe.n_experts * (4 - bpe) if cfg.moe is not None else 0
    nbytes = bpe * (L * c["layer"] + c["final_norm"] + head + gathered
                    + batch * (context - new_tokens) * kv_row + tokens * kv_row
                    + batch * V) + router_f32 + 4 * tokens
    return _Forward(flops=rest + expert_flops, model_flops=rest + routed_flops,
                    nbytes=nbytes, head=2.0 * D * V * batch)


def _decoding(cfg, new_tokens: int, context: int) -> bool:
    """A step that continues a cached sequence; the recurrent blocks decode
    one token at a time."""
    if context > new_tokens and new_tokens != 1:
        raise ValueError(f"{cfg.name}: a recurrent decode step takes one new "
                         f"token, not {new_tokens}")
    return context > new_tokens


def _pattern_block(cfg, btype: str, batch: int, n: int, context: int, *, chunk,
                   cache: bool) -> tuple[float, float, float]:
    """One layer of a patterned model (RecurrentGemma, xLSTM): (flops,
    model_flops, bytes of its state or cache) for ``batch`` x ``n`` new
    tokens; see :func:`_forward`."""
    D, K, nh = cfg.d_model, cfg.conv_width, cfg.n_heads
    bpe = _DTYPE_BYTES[cfg.dtype]
    tokens = batch * n
    decode = _decoding(cfg, n, context)
    if btype == "rec":
        W = cfg.lru_width or D
        mm = 3 * D * W + 2 * W * W + _ffn_params(D, cfg.d_ff, cfg.ffn)
        base = 2.0 * tokens * mm + 2.0 * K * W * tokens
        if decode:
            scan = model = 2.0 * W * batch
        else:
            scan = float(_scan_ops(n) * W * batch + (2 * W * batch if cache else 0))
            model = 2.0 * n * W * batch
        state = (4 * W + (K - 1) * W * bpe) * batch
        moved = 2 * state if decode else ((state + 4 * W * batch) if cache else 0)
        return base + scan, base + model, moved
    if btype == "attn":
        H, KV, hd, w = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.local_window
        mm = _attn_params(cfg) + _ffn_params(D, cfg.d_ff, cfg.ffn)
        f = 2.0 * tokens * mm + 4.0 * H * hd * batch * _attn_pairs(n, context, w)
        row = 2 * KV * hd * bpe
        read = max(min(context, w or context) - n, 0)
        moved = batch * (read + min(n, w or n)) * row if cache else 0
        return f, f, moved
    if btype == "mlstm":
        d_in = 2 * D
        dh = d_in // nh
        mm = 2 * D * d_in + 3 * d_in * d_in + 2 * d_in * nh + d_in * D
        base = 2.0 * tokens * mm + 2.0 * K * d_in * tokens
        if decode:
            quad = model = 2.0 * batch * nh * (dh * dh + dh)
        else:
            c = min(chunk, 256)
            sq = (n // c) * c * c + (n % c) ** 2
            quad = 4.0 * batch * nh * dh * (n * n + sq)
            model = 4.0 * batch * nh * dh * _attn_pairs(n, n)
            if cache:
                quad += 2.0 * batch * nh * n * dh * dh
                model += 2.0 * batch * nh * n * dh * dh
        state = (nh * dh * dh * 4 + nh * dh * 4 + nh * 4 + (K - 1) * d_in * bpe) * batch
        moved = 2 * state if decode else (state if cache else 0)
        return base + quad, base + model, moved
    if btype == "slstm":
        dh, d_ff = D // nh, int(4.0 / 3.0 * D) // 64 * 64 or D
        f = 2.0 * tokens * (4 * D * D + 3 * D * d_ff) + 8.0 * nh * dh * dh * tokens
        moved = 2 * 4 * D * 4 * batch if cache else 0
        return f, f, moved
    raise ValueError(btype)


def _pattern_forward(cfg, batch: int, new_tokens: int, context: int, *, chunk,
                     cache: bool) -> _Forward:
    c = lm_param_counts(cfg)
    bpe = _DTYPE_BYTES[cfg.dtype]
    D, V = cfg.d_model, cfg.vocab_size
    tokens = batch * new_tokens
    flops = model = moved = 0.0
    types = _block_types(cfg)
    for btype in dict.fromkeys(types):
        f, m, b = _pattern_block(cfg, btype, batch, new_tokens, context, chunk=chunk,
                                 cache=cache)
        nl = types.count(btype)
        flops, model, moved = flops + nl * f, model + nl * m, moved + nl * b
    head = 2.0 * D * V * batch
    gathered = 0 if cfg.tie_embeddings else min(tokens, V) * D
    nbytes = (bpe * (sum(c["layers"][t] for t in types) + c["final_norm"] + V * D
                     + gathered + batch * V)
              + (4 - bpe) * _f32_params(cfg) + moved + 4 * tokens)
    return _Forward(flops=flops + head, model_flops=model + head, nbytes=nbytes, head=head)


def _whisper_forward(cfg, batch: int, new_tokens: int, context: int, *, enc_seq: int,
                     cache: bool) -> _Forward:
    c = lm_param_counts(cfg)
    bpe = _DTYPE_BYTES[cfg.dtype]
    D, V, F = cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    Le, Ld = cfg.encdec.n_encoder_layers, cfg.n_layers
    tokens = batch * new_tokens
    decode = context > new_tokens
    proj = 2 * D * H * hd + 2 * D * KV * hd
    enc = cross_kv = 0.0
    if not decode:
        frames = batch * enc_seq
        enc = Le * (2.0 * frames * (proj + 2 * D * F) + 4.0 * H * hd * batch * enc_seq ** 2)
        cross_kv = Ld * 2.0 * frames * 2 * D * KV * hd
    dec = Ld * (2.0 * tokens * (proj + 2 * D * H * hd + 2 * D * F)
                + 4.0 * H * hd * batch * (_attn_pairs(new_tokens, context)
                                          + new_tokens * enc_seq))
    head = 2.0 * D * V * batch
    flops = enc + cross_kv + dec + head
    kv_row, cross = Ld * 2 * KV * hd, Ld * batch * enc_seq * 2 * KV * hd
    if decode:
        weights = Ld * c["dec_layer"] + c["final_norm"]
        moved = batch * (context - new_tokens) * kv_row + cross
    else:
        weights = Le * c["enc_layer"] + Ld * c["dec_layer"] + 2 * c["final_norm"]
        moved = batch * enc_seq * D + (cross if cache else 0)
    if cache:
        moved += tokens * kv_row
    nbytes = bpe * (weights + V * D + new_tokens * D + moved + batch * V) + 4 * tokens
    return _Forward(flops=flops, model_flops=flops, nbytes=nbytes, head=head,
                    outside=cross_kv)


def lm_train_roofline(cfg, batch: int, seq: int, *, remat: bool = False,
                      chunk: int = 1024) -> Roofline:
    """One training step on ``batch`` sequences of ``seq`` tokens (Whisper:
    ``seq`` frames and ``seq`` tokens, as the train cells feed it), from
    the training forward of :func:`_forward` (no cache: the mLSTM builds no
    final state).

    Operations: the forward, the lm_head over every position (the loss
    reads all logits); the backward pass twice the forward's; with
    ``remat`` the blocks' forward once more (the embedding, the head and
    Whisper's cross K/V are outside the checkpoints). ``model_flops``:
    three forwards of the useful work (the routed copies for MoE, the
    causal pairs of the mLSTM, the sequential RG-LRU recurrence), no
    recompute. Bytes: the forward reads every weight, the backward reads
    them again and writes their gradients (in the weights' dtype: the
    float32 leaves at 4 bytes), ``remat`` reads the blocks' weights once
    more; AdamW reads the params, the gradients and the float32 ``m`` /
    ``v`` and writes the params, ``m`` and ``v``; the tokens and targets
    (int32) and the mask (float32) are read. Activations are not counted:
    a bound, not an estimate."""
    fwd = _forward(cfg, batch, seq, seq, enc_seq=seq, chunk=chunk, cache=False)
    c = lm_param_counts(cfg, max_dec_seq=seq)
    bpe = _DTYPE_BYTES[cfg.dtype]
    D, V = cfg.d_model, cfg.vocab_size
    tokens = batch * seq
    head = 2.0 * D * V * tokens
    flops = fwd.flops + head - fwd.head                 # the head on every row
    model_flops = fwd.model_flops + head - fwd.head
    weights = bpe * c["total"] + (4 - bpe) * _f32_params(cfg)
    nbytes = 6 * weights + 16 * c["total"] + 12 * tokens
    if remat:
        outside = (c["embed"] + c["pos_dec"] + 2 * c["final_norm"] if cfg.family == "audio"
                   else c["embed"] + c["unembed"] + c["final_norm"])
        nbytes += weights - bpe * outside
    return Roofline(flops=3 * flops + (flops - head - fwd.outside if remat else 0.0),
                    hbm_bytes=float(nbytes), coll_bytes=0.0, chips=1,
                    model_flops=3 * model_flops, ops_per_s=PEAK_FLOPS_BF16,
                    route="bf16 tensor cores")


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6·N·D for a train step (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float,
                       kv_read_flops: float = 0.0) -> float:
    """2·N per generated token (+ attention score flops if significant)."""
    return 2.0 * n_params_active * tokens + kv_read_flops
