"""``utils/roofline.py``'s counts of the MLA, RecurrentGemma, xLSTM and
Whisper families held against ``torch.utils.flop_counter.FlopCounterMode``
over the port's own ``Model.prefill``, ``decode_step`` and a train step
(``make_train_step``, with and without remat), at ``reduced_for_smoke``
size in float32 on the CPU; and ``lm_train_roofline`` counted by hand for
xLSTM.

``FlopCounterMode`` counts 2 ops a multiply-add of every matmul, batched
matmul and einsum, forward and backward, and nothing elementwise. The
roofline counts what the port computes, with three differences, each
reckoned here from the shapes:

  * **masked pairs**: ``chunked_attention`` scores each q chunk against
    every key and masks after; the roofline counts the causal (or
    windowed) pairs only, so the counter sees (S_q S_kv - pairs) more a
    head (4 hd ops a pair; MLA 2 (nope + rope + v));
  * **elementwise terms** the roofline names: the depthwise causal conv
    (2 conv_width ops a channel a token) of the rec and mLSTM blocks, and
    the RG-LRU's log-depth scan (and a decode step's 2 ops a channel);
  * **the sLSTM's first step**: its recurrent product reads the constant
    zero h, whose gradient autograd does not take, so a train step's
    counter sees one (B, dh) x (dh, 4 dh) product a head fewer a sLSTM
    layer than the backward's two-forwards count;
  * **remat's early stop**: ``torch.utils.checkpoint`` (non-reentrant)
    stops recomputing a block once the tensors its backward saved are
    back, so each block's last product (its output projection, whose
    output nothing saves) is not run again; the roofline, as for the dense
    decoders, counts the blocks' whole forward once more.

The MoE experts are counted over all E x C capacity slots, as the port
runs them, so they need no term."""
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import block_layout  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.step import TrainState, make_train_step  # noqa: E402
from repro_torch.utils import roofline as R  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "recurrentgemma-9b", "xlstm-1.3b", "whisper-base"]
B, P, CHUNK = 2, 16, 8      # the prompt fills the smoke local window (16)


def counted(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


def scan_ops(S: int) -> int:
    """``rglru.linear_scan``'s products and sums on one channel: a
    multiply-add at each doubling d on the S - d folded positions, and the
    S - d products of ``a`` while 2 d < S."""
    ops, d = 0, 1
    while d < S:
        ops += 2 * (S - d) + (S - d) * (2 * d < S)
        d *= 2
    return ops


def layers(cfg, btype) -> int:
    return block_layout(cfg).count(btype)


def masked(cfg) -> int:
    """The masked (query, key) products a prefill of P scores: every
    attention layer's P x P rectangle less its 136 causal pairs (the
    window, 16, covers the prompt)."""
    pairs = P * (P + 1) // 2
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        per = 2 * H * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)
        n = cfg.n_layers
    elif cfg.family == "audio":
        per, n = 4 * H * hd, cfg.n_layers              # the decoder's self-attention
    else:
        per, n = 4 * H * hd, layers(cfg, "attn")
    return per * n * B * (P * P - pairs)


def named(cfg, tokens: int, *, prefill: bool, cache: bool) -> int:
    """The roofline's elementwise terms: the conv and the RG-LRU scan."""
    K = cfg.conv_width
    W, d_in = cfg.lru_width or cfg.d_model, 2 * cfg.d_model
    n = 2 * K * tokens * (W * layers(cfg, "rec") + d_in * layers(cfg, "mlstm"))
    scan = (scan_ops(P) + (2 if cache else 0)) if prefill else 2
    return n + scan * W * B * layers(cfg, "rec")


def slstm_first_step(cfg) -> int:
    dh = cfg.d_model // cfg.n_heads
    return 2 * B * cfg.n_heads * dh * 4 * dh * layers(cfg, "slstm")


def last_products(cfg) -> int:
    """Each block's last product on the 2 x 16 rows, summed over the blocks
    (the one remat's recompute skips): the shared experts' w_down (MLA),
    the FFN's w_down (RecurrentGemma), w_down / ffn_down (xLSTM), the MLP's
    w_out (Whisper, encoder and decoder)."""
    T, D = B * P, cfg.d_model
    if cfg.mla is not None:
        return cfg.n_layers * 2 * T * cfg.moe.d_ff_expert * cfg.moe.n_shared * D
    if cfg.family == "audio":
        return (cfg.encdec.n_encoder_layers + cfg.n_layers) * 2 * T * cfg.d_ff * D
    if cfg.family == "hybrid":
        return cfg.n_layers * 2 * T * cfg.d_ff * D
    d_ff = int(4 / 3 * D) // 64 * 64
    return 2 * T * D * (2 * D * layers(cfg, "mlstm") + d_ff * layers(cfg, "slstm"))


def setup(name, **model_kw):
    cfg = reduced_for_smoke(get_config(name)).scaled(dtype="float32")
    model = build_model(cfg, max_seq=P + 1, chunk=CHUNK, **model_kw)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn((B, P, cfg.d_model), generator=g)
    return cfg, model, params, batch


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_steps_are_the_counted_products(name):
    """A prefill of 2 x 16 (Whisper: 16 frames) into a cache of 17 and the
    decode step at index 16, which attends to all 17 slots (the windowed
    ring's 16)."""
    cfg, model, params, batch = setup(name)
    cache = model.init_cache(B, P + 1, enc_seq=P, device="cpu")
    pre = counted(lambda: model.prefill(params, batch, cache))
    dec = counted(lambda: model.decode_step(
        params, cache, {"token": batch["tokens"][:, :1], "index": P}))
    r_pre = R.lm_step_roofline(cfg, B, P, P, enc_seq=P, chunk=CHUNK)
    r_dec = R.lm_step_roofline(cfg, B, 1, P + 1, enc_seq=P, chunk=CHUNK)
    assert r_pre.flops == pre - masked(cfg) + named(cfg, B * P, prefill=True, cache=True)
    assert r_dec.flops == dec + named(cfg, B, prefill=False, cache=True)
    assert pre > 0 and dec > 0


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_is_the_counted_products(name, remat):
    """One ``make_train_step`` step on 2 x 16 (the loss's head over every
    row, its backward and AdamW; with remat the blocks' forward again)."""
    cfg, model, params, batch = setup(name, remat=remat)
    batch.update(targets=batch["tokens"], mask=torch.ones((B, P)))
    state = TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, AdamWConfig())
    n = counted(lambda: step(state, batch))
    r = R.lm_train_roofline(cfg, B, P, remat=remat, chunk=CHUNK)
    passes = 4 if remat else 3
    terms = passes * (named(cfg, B * P, prefill=True, cache=False) - masked(cfg))
    assert r.flops == n + terms + slstm_first_step(cfg) + (last_products(cfg) if remat else 0)
    assert int(state.step) == 1


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_roofline_matches_a_hand_count_for_xlstm(remat):
    """``lm_train_roofline`` on the xlstm-1.3b smoke config (7 mLSTM + 1
    sLSTM blocks, D 64, 4 heads, V 512, untied) in float32 at 2 x 8, by
    hand: the mLSTM's d_in 128 (head dim 32), its 8 rows one chunk; the
    sLSTM's head dim 16 and 4/3 FFN of 64."""
    cfg = reduced_for_smoke(get_config("xlstm-1.3b")).scaled(dtype="float32")
    T = 2 * 8
    m_tok = 2 * 64 * 128 + 3 * 128 * 128 + 2 * 128 * 4 + 128 * 64    # up, q k v, gates, down
    conv = 2 * 4 * 128 * T
    quad = 4 * 2 * 4 * 32 * (8 * 8 + 8 * 8)                       # 8 x 8 keys + its block
    quad_model = 4 * 2 * 4 * 32 * 36                              # the 36 causal pairs
    s_fwd = 2 * T * (4 * 64 * 64 + 3 * 64 * 64) + 8 * 4 * 16 * 16 * T
    head = 2 * 64 * 512 * T
    fwd = 7 * (2 * T * m_tok + conv + quad) + s_fwd + head
    fwd_model = 7 * (2 * T * m_tok + conv + quad_model) + s_fwd + head
    mlstm = (64 + 64 * 256 + 4 * 128 + 128 + 3 * 128 * 128 + 2 * 128 * 4 + 2 * 4 + 128
             + 128 * 64)
    slstm = 64 + 64 * 256 + 256 + 4 * 4 * 16 * 16 + 64 + 64 * 128 + 64 * 64
    n = 7 * mlstm + slstm + 2 * 512 * 64 + 64
    r = R.lm_train_roofline(cfg, 2, 8, remat=remat)
    assert n == R.lm_param_counts(cfg)["total"] == 627896
    assert r.flops == 3 * fwd + (fwd - head if remat else 0)
    assert r.model_flops == 3 * fwd_model
    assert r.hbm_bytes == 6 * 4 * n + 16 * n + 12 * T + (
        4 * n - 4 * (2 * 512 * 64 + 64) if remat else 0)
