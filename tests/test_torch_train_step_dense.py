"""One training step of the dense and VLM archs against the reference:
the port's counterpart of ``tests/test_models_smoke.py``'s
``test_forward_and_train_step``, on the CPU in float32 from one reference
init (``convert.train_state_from_reference``). The gradients of a batch
against ``jax.value_and_grad``, then two train steps of both packages
(``make_train_step``; the reference's jitted): losses, ``grad_norm``,
``m``, ``v`` and the params (``_torch_lm.check_train_steps``). Remat and
microbatching: ``test_torch_train_step_remat.py``."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_lm import one_torch_thread, DENSE, check_train_steps, smoke_cfgs  # noqa: E402,F401


@pytest.mark.parametrize("name", DENSE)
def test_train_step_matches_reference(name):
    losses = check_train_steps(*smoke_cfgs(name))
    assert all(5.0 < x < 8.0 for x in losses)      # ~ln(512) at init
