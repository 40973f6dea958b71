"""One training step of the recurrent archs against the reference (see
``test_torch_train_step_dense.py``): RecurrentGemma (the log-depth RG-LRU
scan, the local attention) and xLSTM (``mlstm_parallel``'s chunks, the
sLSTM loop over time), through plain autograd. xLSTM's gradients and
AdamW state are held at 1e-3, not 1e-4: its gradient is ill-conditioned
in float32 (``_torch_lm.GRAD_TOL``)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_lm import one_torch_thread, check_train_steps, smoke_cfgs  # noqa: E402,F401


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_train_step_matches_reference(name):
    check_train_steps(*smoke_cfgs(name))
