"""Train steps with ``remat`` and with microbatches against the reference
(see ``test_torch_train_step_dense.py``): Llama and OLMoE (capacity
factor 1.25, copies drop) with ``remat`` on both sides (each block under
``torch.utils.checkpoint`` / ``jax.checkpoint``), and Qwen2-VL in two
microbatches, which splits ``positions3`` along its batch dim."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_lm import (check_train_steps, one_torch_thread, smoke_cfgs,  # noqa: E402,F401
                       with_capacity)


def test_train_step_with_remat_matches_reference():
    check_train_steps(*smoke_cfgs("llama3.2-3b"), remat=True)


def test_moe_train_step_with_remat_matches_reference():
    check_train_steps(*with_capacity(smoke_cfgs("olmoe-1b-7b"), 1.25), remat=True)


def test_train_step_in_two_microbatches_matches_reference():
    check_train_steps(*smoke_cfgs("qwen2-vl-7b"), n_micro=2)
