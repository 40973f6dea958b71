"""One training step of the MoE archs against the reference (see
``test_torch_train_step_dense.py``), at capacity factor 1.25 (copies drop)
and E (none drop); with ``remat`` in ``test_torch_train_step_remat.py``.
The dispatch and combine
gathers' backwards are ``torch.autograd.Function``s, the reference's
``custom_vjp``s: they are also held against autograd's own transposes of
plain indexing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_lm import (check_train_steps, one_torch_thread, rel_err,  # noqa: E402,F401
                       smoke_cfgs, with_capacity)
from repro_torch.models import moe as PM  # noqa: E402

MOE = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]


def _cfgs(name, cf):
    cfgs = smoke_cfgs(name)
    return with_capacity(cfgs, float(cfgs[1].moe.n_experts) if cf == "E" else cf)


@pytest.mark.parametrize("cf", [1.25, "E"])
@pytest.mark.parametrize("name", MOE)
def test_train_step_matches_reference(name, cf):
    check_train_steps(*_cfgs(name, cf))


def _plain_dispatch(xt, slot_tok, slot_valid, idx_k, tok_pos, tok_keep):
    return torch.where(slot_valid[:, :, None], xt[slot_tok], 0)


def _plain_combine(eo, idx_k, tok_pos, tok_keep, slot_tok, slot_k, slot_valid):
    return torch.where(tok_keep[..., None], eo[idx_k, tok_pos], 0)


@pytest.mark.parametrize("cf", [0.5, 1.25, "E"])
def test_gather_functions_match_autograd_transposes(monkeypatch, cf):
    """``moe_apply``'s gradients (input, router, experts, shared experts)
    with the two Functions against the same with plain indexing, whose
    backward is autograd's scatter-add: equal within float32 rounding
    (the sums over K run in another order), drops included."""
    _, cfg = _cfgs("deepseek-v2-lite-16b", cf)
    p = PM.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(x0.shape).astype(np.float32))

    def grads():
        x = x0.clone().requires_grad_(True)
        out, aux = PM.moe_apply(p, x, cfg)
        leaves = [x, *p.parameters()]
        return torch.autograd.grad((out * w).sum() + aux, leaves)

    with_functions = grads()
    monkeypatch.setattr(PM, "dispatch_gather", _plain_dispatch)
    monkeypatch.setattr(PM, "combine_gather", _plain_combine)
    with_autograd = grads()
    assert len(with_functions) == len(with_autograd) == 1 + len(list(p.parameters()))
    for a, b in zip(with_functions, with_autograd):
        assert rel_err(a, b.numpy()) < 1e-6
