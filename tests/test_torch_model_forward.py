"""The port's transformer and Model against the reference's on the
reference's own ``init_params`` weights (carried across by
``lm_params_from_reference``), on the CPU in float32: ``forward`` +
``lm_head``, ``loss_fn``, ``prefill`` (logits and the whole cache) and a
``decode_step`` at the smoke shapes of ``tests/test_models_smoke.py`` for
the five dense-path archs and for small configs with padded heads, within
max |Δ| / max |ref| < 1e-4; and the port's decode against its full
forward at the reference's 5e-3."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from _torch_lm import (DENSE, check_model, decode_matches_full_forward,  # noqa: E402
                       smoke_cfgs)


@pytest.mark.parametrize("name", DENSE)
def test_model_matches_reference(name):
    check_model(*smoke_cfgs(name))


def test_padded_heads_model_matches_reference():
    """6 heads in 2 KV groups padded to 8 (``reduced_for_smoke`` turns the
    padding off; Llama and Qwen2-VL on the card use it)."""
    kw = dict(n_heads=6, n_kv_heads=2, tp_pad_heads_to=8)
    ref_cfg, cfg = smoke_cfgs("llama3.2-3b", **kw)
    assert PT._attn_dims(cfg) == PL.AttnDims(64, 8, 2, 16, n_real_heads=6)
    check_model(ref_cfg, cfg)
    check_model(*smoke_cfgs("qwen2-vl-7b", **kw))


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_full_forward(name):
    """The port alone, as tests/test_models_smoke.py holds the reference:
    prefill of 16 tokens + one decode step against a full forward over
    17, at the reference's 5e-3."""
    decode_matches_full_forward(smoke_cfgs(name)[1])
