"""The dry run's ``memory_analysis`` (``launch/dryrun.py``, the memory model
of ``utils/memory.py``): a prefill's and a decode step's ``temp`` against a
live-bytes tracker (``tests/_torch_memtrack.py``) over the port's real step
on the CPU at one chip's layout, for all ten archs in float32 and
bfloat16; two production cells counted by hand; and every ``ok`` record of
both meshes holding four positive byte counts with ``fits`` from the peak.

The serve steps run at the smoke widths with a vocabulary of 64, where a
prefill's activations are 0.46-0.78 of its peak (xLSTM-1.3B's 0.41-0.49,
its weights being most of the rest). A decode step's activations are small
beside its cache and weights by nature; its shapes give the attention the
most room the smoke configs do (16 sequences, a cache of 64). A Whisper
prefill replaces the cache's cross K/V, an argument, with fresh ones: the
tracker watches the cache, as the allocator does, and the model frees it.
Differences over 2% between the model and the tracker (the model counts
what the card allocates):

  * xLSTM-1.3B decode, bfloat16 (-2.3%): the sLSTM's per-step (B, D)
    temporaries and the mLSTM's (B, NH) gate terms, left out as O(rows).

Every other case lies within 2%."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

from _torch_lm import one_torch_thread  # noqa: E402,F401
from _torch_memtrack import serve_peak  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.configs.shapes import SHAPES, applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.utils import memory as M  # noqa: E402

TOL = 0.10
V = 64
# (batch, prompt, generated, chunk): a prefill of B x P into a cache of
# P + G, q chunks of 16 (four of them); the decode at index P
PREFILL = (4, 64, 8, 16)
DECODE = (16, 56, 8, 16)


def smoke(arch: str, dtype: str):
    return reduced_for_smoke(get_config(arch)).scaled(dtype=dtype, vocab_size=V)


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_serve_step_temp_matches_the_tracker(arch, dtype, step):
    cfg = smoke(arch, dtype)
    B, P, G, chunk = PREFILL if step == "prefill" else DECODE
    got, args = serve_peak(cfg, B, P, G, chunk, step)
    mem = M.lm_step_memory(cfg, B, P if step == "prefill" else 1, P + G, enc_seq=P,
                           chunk=chunk)
    assert abs(mem.temp / got - 1) <= TOL, (arch, dtype, step, got, mem.temp)
    assert mem.output == B * V * M._BYTES[dtype] + (
        2 * cfg.n_layers * B * P * cfg.n_kv_heads * cfg.resolved_head_dim
        * M._BYTES[dtype] if cfg.family == "audio" and step == "prefill" else 0)
    if step == "prefill" and arch != "xlstm-1.3b":
        assert got >= 0.8 * args, (arch, got, args)    # activations near half the peak or more


class PodMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def test_llama_decode_32k_counted_by_hand():
    """Llama-3.2-3B decode_32k on 16 x 16: 8 sequences a chip, one token;
    the 8 KV heads do not divide 16, so the cache's 32,768 rows shard over
    model (2,048 a chip) and the 32 (padded) heads attend whole, split-K.
    The peak is in a layer's attention, at its p v product: K and V
    repeated to 32 heads (bf16), their float32 copies, einsum's float32
    copy of V^T, the masked scores and the softmax of the one q row, the
    product; beside them the residual, RoPE's tables, the norm's output
    and the layer's q, k, v."""
    rec = dryrun.run_cell("llama3.2-3b", "decode_32k", multi_pod=False, verbose=False)
    B, S, H, KV, hd, D, e = 8, 2048, 32, 8, 128, 3072, 2
    rep = 2 * B * S * H * hd * e
    f32 = 2 * B * H * hd * S * 4
    v_copy = B * H * S * hd * 4
    scores = 2 * B * H * 1 * S * 4
    pv = B * H * hd * 4
    around = 2 * B * D * e + 2 * B * hd * 4 + B * H * hd * e + 2 * B * KV * hd * e
    temp = rep + f32 + v_copy + scores + pv + around
    assert rec["memory_analysis"] == {
        "argument_bytes": 2633291812,              # XLA's argument bytes, the same
        "output_bytes": B * 128256 // 16 * e,      # the logits' vocabulary shard
        "temp_bytes": temp, "peak_bytes": 2633291812 + temp}
    assert rec["arg_bytes_per_device"] == 2633291812
    assert rec["fits"] is True


def test_whisper_train_4k_counted_by_hand():
    """Whisper-base train_4k on 16 x 16: 16 sequences a chip in 4
    microbatches of 4 x 4,096, bf16, remat. The 8 heads and the 51,865-row
    vocabulary do not divide 16 and stay whole, d_ff (2,048) shards. The
    peak is the loss's backward: Whisper's loss is one chunk, so the
    (16,384, 51,865) float32 logits and four gradients of them at once,
    over the float32 gradient accumulators (4 bytes a weight), the 12
    checkpointed blocks' inputs, each decoder layer's cross K/V (kept as
    checkpoint inputs), the encoder's output and both final LayerNorms'
    saved tensors (three float32 copies and the bf16 output each)."""
    rec = dryrun.run_cell("whisper-base", "train_4k", multi_pod=False, verbose=False)
    T, D, V, e, F = 4 * 4096, 512, 51865, 2, 2048 // 16
    enc_layer = 4 * D * D + 4 * D + 4 * D + 2 * D * F + F + D
    dec_layer = 2 * (4 * D * D + 4 * D) + 6 * D + 2 * D * F + F + D
    weights = 6 * enc_layer + 6 * dec_layer + V * D + 4096 * D + 4 * D
    x, n = T * D * e, T * D
    acc = 4 * weights
    encoder = 6 * x + 3 * 4 * n + x
    decoder = 6 * x + 6 * 2 * T * 8 * 64 * e + 3 * 4 * n + x
    logits = T * V * 4
    temp = acc + encoder + decoder + logits + 4 * logits + x
    assert rec["memory_analysis"]["temp_bytes"] == temp
    assert rec["memory_analysis"]["output_bytes"] == 12      # loss, grad_norm, lr
    assert rec["memory_analysis"]["argument_bytes"] == rec["arg_bytes_per_device"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_every_ok_record_has_its_memory(multi_pod):
    n_ok = 0
    for arch in list_archs():
        for shape in SHAPES:
            if not applicable(get_config(arch), SHAPES[shape])[0]:
                continue
            rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
            ma = rec["memory_analysis"]
            assert set(ma) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
            assert all(isinstance(v, int) and v > 0 for v in ma.values()), (arch, shape, ma)
            assert ma["argument_bytes"] == rec["arg_bytes_per_device"]
            assert ma["peak_bytes"] == ma["argument_bytes"] + ma["temp_bytes"]
            assert rec["fits"] == (ma["peak_bytes"] <= rec["device_memory_bytes"])
            assert math.isfinite(ma["peak_bytes"])
            n_ok += 1
    assert n_ok == 32
