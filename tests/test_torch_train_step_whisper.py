"""One training step of Whisper against the reference (see
``test_torch_train_step_dense.py``), with and without ``remat``: the
encoder and decoder blocks checkpointed, the decoder's cross K/V computed
outside each block as the reference computes them. The attention key
biases' gradient is zero in exact arithmetic, so both packages' are
rounding noise (``_torch_lm.ZERO_GRAD_LEAVES``)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_lm import one_torch_thread, check_train_steps, smoke_cfgs  # noqa: E402,F401


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(remat):
    check_train_steps(*smoke_cfgs("whisper-base"), remat=remat)
