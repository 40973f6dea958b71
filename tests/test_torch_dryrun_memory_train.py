"""``utils/memory.lm_train_memory`` against a live-bytes tracker
(``tests/_torch_memtrack.py``) over one real ``make_train_step`` step on the
CPU at one chip's layout: all ten archs, float32 and bfloat16, with remat
off and on, and with two microbatches for one arch of each family's kind.
Each ``temp`` lies within 10% of the tracker's high-water mark.

The steps run 4 x 64 tokens, q chunks of 16, at the smoke widths with a
vocabulary of 64, where the activations are at least half the peak
(xLSTM-1.3B with remat: 0.48, its 2.3 MB of weights and their AdamW state
being most of the rest). Differences over 2% (the model against the
tracker):

  * every dense decoder in float32 with remat (+2.4%): the model adds a
    (T, D) gradient passing through to each backward stage's transient; at
    a block's first stage (its FFN) that gradient is already part of what
    the stage before it left;
  * the MoE archs with remat (OLMoE -2.8% / -4.8%, DeepSeek-V2-Lite -4.4%
    in bf16): the recompute stops before a block's last product and its
    residual add, so the model takes the recompute's high-water mark less
    two (T, D); in a MoE block that mark lies in the combine's float32
    work, before those two, which the card does hold;
  * xLSTM-1.3B without remat (-1.9% / -2.7%): on the CPU ``logsigmoid``
    also saves a buffer the size of its input for its backward, one (B, D)
    float32 a sLSTM step; on the card that buffer is empty, and the model
    counts the card.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import one_torch_thread  # noqa: E402,F401
from _torch_memtrack import train_peak  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.utils import memory as M  # noqa: E402

TOL = 0.10
B, S, CHUNK, V = 4, 64, 16, 64


def smoke(arch: str, dtype: str):
    return reduced_for_smoke(get_config(arch)).scaled(dtype=dtype, vocab_size=V)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_train_step_temp_matches_the_tracker(arch, dtype, remat):
    cfg = smoke(arch, dtype)
    got, args = train_peak(cfg, B, S, CHUNK, remat=remat)
    mem = M.lm_train_memory(cfg, B, S, remat=remat, chunk=CHUNK,
                            params=M.params_of(cfg, max_dec_seq=S))
    assert abs(mem.temp / got - 1) <= TOL, (arch, dtype, remat, got, mem.temp)
    assert mem.output == 12                            # loss, grad_norm, lr
    assert got >= 0.9 * args, (arch, got, args)        # activations near half the peak or more


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b", "recurrentgemma-9b",
                                  "xlstm-1.3b", "whisper-base"])
def test_microbatched_step_matches_the_tracker(arch):
    """Two microbatches of 2 x 64: the float32 accumulators live throughout,
    each microbatch's gradients until they are added in."""
    cfg = smoke(arch, "float32")
    got, _ = train_peak(cfg, B, S, CHUNK, remat=False, n_microbatches=2)
    mem = M.lm_train_memory(cfg, B, S, chunk=CHUNK, n_microbatches=2,
                            params=M.params_of(cfg, max_dec_seq=S))
    assert abs(mem.temp / got - 1) <= TOL, (arch, got, mem.temp)


def test_params_of_counts_every_weight_once():
    """``params_of`` at one chip walks the port's own module: its bytes are
    ``tree_bytes`` of the params, each block's parts add up to the block."""
    from repro_torch.models import build_model
    from repro_torch.utils.treeutil import tree_bytes
    for arch in list_archs():
        cfg = get_config(arch)
        p = M.params_of(cfg)
        assert p.bytes == tree_bytes(build_model(cfg).param_specs()), arch
        layer = next(k for _, _, k, _ in p.leaves if k is not None)
        parts = {q for _, _, k, q in p.leaves if k == layer}
        assert sum(p.part_bytes(layer, q) for q in parts) == sum(
            n * b for n, b, k, _ in p.leaves if k == layer)
