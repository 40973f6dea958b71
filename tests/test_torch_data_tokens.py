"""``data.tokens.synthetic_batches`` against the reference's: three
batches of the text, vlm and audio families bit for bit (the same numpy
draws in the same order; the embeddings rounded to bfloat16 as
``jnp.asarray(..., dtype=bf16)`` rounds), each tensor's dtype and shape,
and the default device: the card, which raises without one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced_for_smoke as ref_reduced  # noqa: E402
from repro.data.tokens import synthetic_batches as ref_batches  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.data.tokens import synthetic_batches  # noqa: E402

ARCHS = {"text": "llama3.2-3b", "vlm": "qwen2-vl-7b", "audio": "whisper-base"}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _port_bits(t) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_batches_are_bit_equal(family, dtype):
    name = ARCHS[family]
    ref_cfg = ref_reduced(ref_get_config(name)).scaled(dtype=dtype)
    cfg = reduced_for_smoke(get_config(name)).scaled(dtype=dtype)
    kw = dict(batch=3, seq=12, family=cfg.family, seed=5, n_vision=4)
    ref, port = ref_batches(ref_cfg, **kw), synthetic_batches(cfg, **kw, device="cpu")
    for _ in range(3):
        r, p = next(ref), next(port)
        assert r.keys() == p.keys()
        for k in r:
            assert str(p[k].dtype).removeprefix("torch.") == str(r[k].dtype), k
            assert tuple(p[k].shape) == r[k].shape, k
            assert np.array_equal(_port_bits(p[k]), _bits(r[k])), k
    if family == "vlm":
        assert tuple(p["positions3"].shape) == (3, 3, 12) and p["positions3"].dtype == torch.int32


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_for_smoke(get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(synthetic_batches(cfg, batch=2, seq=8, family=cfg.family))
