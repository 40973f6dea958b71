"""The training substrate of the port alone, as ``tests/test_train.py``
holds the reference's: the loss decreases, gradient accumulation over
microbatches matches the single batch, compressed gradients train, and the
loop resumes from its last committed checkpoint after an injected failure.
Then ``python -m repro_torch.launch.train --smoke --device cpu`` in
process, through one failure and its resume; without ``--device`` it
refuses a host without a GPU."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.data.tokens import synthetic_batches  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run_training  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.utils.treeutil import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the module runs (restored after): the
    smoke model is tiny, and beside the suite's other workers a step took
    ~190x longer with a thread per core (tests/_torch_lm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_for_smoke(get_config("llama3.2-3b")).scaled(dtype="float32")
    return cfg, build_model(cfg, chunk=16)


def _state(model, **kw):
    return init_train_state(model, torch.Generator().manual_seed(0), device="cpu", **kw)


def _memo_batch(cfg, B=4, S=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    return {"tokens": tokens, "targets": tokens, "mask": torch.ones((B, S))}


def test_loss_decreases(setup):
    cfg, model = setup
    state = _state(model)
    step = make_train_step(model, AdamWConfig(lr=1e-3), warmup=5, total_steps=100)
    batch = _memo_batch(cfg)
    losses = []
    for _ in range(25):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert int(state.step) == int(state.opt["step"]) == 25


def test_microbatch_equivalence(setup):
    """Grad accumulation must match the single-batch gradient."""
    cfg, model = setup
    batch = _memo_batch(cfg, B=4)
    s1 = make_train_step(model, AdamWConfig(lr=1e-3), n_microbatches=1, warmup=1,
                         total_steps=10)
    s2 = make_train_step(model, AdamWConfig(lr=1e-3), n_microbatches=2, warmup=1,
                         total_steps=10)
    st1, st2 = _state(model), _state(model)
    for _ in range(2):          # the first step's lr is 0: the second moves params
        st1, m1 = s1(st1, batch)
        st2, m2 = s2(st2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5 * float(m1["loss"])
    for a, b in zip(tree_leaves(st1.params), tree_leaves(st2.params)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-5)


def test_microbatches_must_split_evenly(setup):
    from repro_torch.train.step import microbatches, value_and_grad
    cfg, model = setup
    parts = microbatches({**_memo_batch(cfg, B=4),
                          "positions3": torch.zeros((3, 4, 32), dtype=torch.int32)}, 2)
    assert [tuple(p["positions3"].shape) for p in parts] == [(3, 2, 32)] * 2
    assert torch.equal(parts[1]["tokens"], _memo_batch(cfg, B=4)["tokens"][2:])
    with pytest.raises(ValueError, match="2 equal microbatches"):
        value_and_grad(model, _state(model).params, _memo_batch(cfg, B=3), 2)


def test_compression_trains(setup):
    cfg, model = setup
    state = _state(model, use_compression=True)
    assert state.grad_err is not None
    step = make_train_step(model, AdamWConfig(lr=1e-3), warmup=5, total_steps=100,
                           use_compression=True)
    batch = _memo_batch(cfg)
    l0 = None
    for _ in range(15):
        state, m = step(state, batch)
        if l0 is None:
            l0 = float(m["loss"])
    assert float(m["loss"]) < l0
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state.grad_err))


def test_loop_failure_and_resume(setup, tmp_path):
    """Inject a crash mid-training; a fresh loop must resume from the last
    committed checkpoint and finish with the full step count."""
    cfg, model = setup
    step = make_train_step(model, AdamWConfig(lr=1e-3), warmup=2, total_steps=20)
    batches = synthetic_batches(cfg, batch=2, seq=16, family=cfg.family, device="cpu")
    loop_cfg = LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                          fail_at=12, log_every=100)
    with pytest.raises(SimulatedFailure):
        run_training(step, _state(model), batches, loop_cfg, logger=lambda *_: None)
    # restart: resumes from the step-10 checkpoint, not from scratch
    loop_cfg2 = LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                           fail_at=None, log_every=100)
    state2, stats = run_training(step, _state(model), batches, loop_cfg2,
                                 logger=lambda *_: None)
    assert stats["final_step"] == 20 == int(state2.step)
    assert len(stats["losses"]) == 10  # steps 10..19 only (resumed)


def test_launcher_fails_and_resumes(tmp_path, capsys):
    args = ["--arch", "llama3.2-3b", "--smoke", "--steps", "6", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    with pytest.raises(SimulatedFailure, match="step 3"):
        launch.main(args + ["--fail-at", "3"])
    stats = launch.main(args)
    out = capsys.readouterr().out
    assert "[loop] resuming from checkpoint step 2" in out
    assert len(stats["losses"]) == 4 and stats["final_step"] == 6
    assert sum(line.startswith("[loop] step ") for line in out.splitlines()) == 3 + 4
    last = out.strip().splitlines()[-1]
    assert last.startswith("[train] done at step 6; loss ") and "stragglers=" in last


def test_launcher_refuses_a_host_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="needs exactly 256 devices, found 1"):
        launch.main(["--arch", "llama3.2-3b", "--smoke", "--mesh", "pod",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("remat", [False, True])
def test_train_roofline_matches_a_hand_count(remat):
    """``lm_train_roofline`` on the llama3.2-3b smoke config (2 layers, D 64,
    4 heads of 16, 2 KV heads, SwiGLU 128, V 512, tied), counted by hand."""
    from repro_torch.utils import roofline as R
    cfg = reduced_for_smoke(get_config("llama3.2-3b")).scaled(dtype="float32")
    B, S = 2, 8
    tokens, pairs = B * S, B * (S * S - S * (S - 1) // 2)          # 16, 72
    attn = 64 * 4 * 16 + 2 * 64 * 2 * 16 + 4 * 16 * 64              # wq wk wv wo
    mats = attn + 3 * 64 * 128                                        # + SwiGLU
    fwd = 2 * tokens * 2 * mats + 4 * 2 * 4 * 16 * pairs + 2 * 64 * 512 * tokens
    head = 2 * 64 * 512 * tokens
    n = 512 * 64 + 2 * (mats + 2 * 64) + 64                          # + norms
    nbytes = 6 * 4 * n + 16 * n + 12 * tokens
    r = R.lm_train_roofline(cfg, B, S, remat=remat)
    assert n == R.lm_param_counts(cfg)["total"] == 106816
    assert r.flops == 3 * fwd + (fwd - head if remat else 0)
    assert r.model_flops == 3 * fwd
    assert r.hbm_bytes == nbytes + ((4 * n - 4 * (512 * 64 + 64)) if remat else 0)
    assert r.bound_by == "bytes" and r.t_bound == r.t_memory
