"""The port's cell specs and restated dry run (``launch/specs.py``,
``launch/dryrun.py``) against the reference's: for the 64 runnable cells
(32 on each production mesh) the parameter counts, tokens per step, global
argument bytes, per-device argument bytes (the reference's
``dryrun._sharded_arg_bytes`` on its ``make_cell`` args) and
``model_flops`` are equal; every ``ok`` record reckons its work and
collectives (two cells' collectives counted by hand) and its
``memory_analysis`` (``fits`` from its peak; ``tests/test_torch_dryrun_memory.py``
holds the bytes); the dry run's CLI writes 80 records, 64 ``ok`` and 16
``skipped``, with no null in ``per_chip``, ``roofline`` or
``memory_analysis``; ``make_step_fn``'s three step functions run on smoke
inputs on the CPU.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices;
the JAX backend is brought up first and the environment restored after,
so nothing leaks into what runs next in the same worker."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from _torch_lm import one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import SHAPES, all_cells, applicable  # noqa: E402
from repro.launch.specs import make_cell as ref_make_cell  # noqa: E402
from repro.utils import roofline as ref_rl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced_for_smoke  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.train.step import TrainState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNNABLE = [c for c in all_cells() if applicable(ref_get_config(c[0]), SHAPES[c[1]])[0]]


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()                      # the backend is up before XLA_FLAGS moves
    saved = dict(os.environ)
    try:
        import repro.launch.dryrun as RD
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return RD


class PodMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class MultiPodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


def _ref_model_flops(cell):
    """``repro.launch.dryrun.run_cell``'s formulas."""
    if cell.kind == "train":
        return ref_rl.model_flops_train(cell.n_params_active, cell.tokens_per_step)
    if cell.kind == "prefill":
        return 2.0 * cell.n_params_active * cell.tokens_per_step
    return ref_rl.model_flops_decode(cell.n_params_active, cell.tokens_per_step)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_cell_numbers_equal_the_reference(ref_dryrun, multi_pod):
    mesh = MultiPodMesh if multi_pod else PodMesh
    chips = math.prod(mesh.shape.values())
    for arch, shape in RUNNABLE:
        ref = ref_make_cell(arch, shape, mesh=mesh)
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
        assert rec["status"] == "ok" and rec["chips"] == chips
        want = {"n_params": ref.n_params, "n_params_active": ref.n_params_active,
                "tokens_per_step": ref.tokens_per_step, "arg_bytes_global": ref.arg_bytes,
                "arg_bytes_per_device": ref_dryrun._sharded_arg_bytes(ref.args, ref.in_specs,
                                                                      mesh),
                "model_flops": _ref_model_flops(ref) / chips}
        got = {k: rec[k] for k in want if k != "model_flops"}
        got["model_flops"] = rec["roofline"]["model_flops"]
        assert got == want, (arch, shape)
        assert rec["memory_analysis"]["argument_bytes"] == rec["arg_bytes_per_device"]
        assert rec["fits"] == (rec["memory_analysis"]["peak_bytes"]
                               <= rec["device_memory_bytes"])
        for key in ("cost_analysis_raw", "lower_s", "compile_s"):
            assert rec[key] is None
        assert rec["per_chip"]["flops"] > 0 and rec["per_chip"]["bytes"] > 0
        assert rec["roofline"]["flops"] == rec["per_chip"]["flops"]
        assert rec["per_chip"]["coll_bytes"] == sum(rec["collectives"].values()) > 0
        assert rec["roofline"]["coll_bytes"] == rec["per_chip"]["coll_bytes"]
        assert rec["roofline"]["t_collective_s"] > 0


def test_reckoned_work_is_the_roofline_over_the_chips():
    """Llama-3.2-3B train_4k on the pod: ``per_chip`` is the whole step of
    ``lm_train_roofline`` (remat, as the cell builds it) over 256 chips;
    xLSTM-1.3B decode_32k on the multi-pod mesh: one ``lm_step_roofline``
    decode step of 128 sequences at context 32,768 over 512 chips."""
    from repro_torch.utils import roofline as rl
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", multi_pod=False, verbose=False)
    work = rl.lm_train_roofline(get_config("llama3.2-3b"), 256, 4096, remat=True)
    assert rec["per_chip"] == {"flops": work.flops / 256, "bytes": work.hbm_bytes / 256,
                               "coll_bytes": sum(rec["collectives"].values())}
    rec = dryrun.run_cell("xlstm-1.3b", "decode_32k", multi_pod=True, verbose=False)
    work = rl.lm_step_roofline(get_config("xlstm-1.3b"), 128, 1, 32768)
    assert rec["per_chip"] == {"flops": work.flops / 512, "bytes": work.hbm_bytes / 512,
                               "coll_bytes": sum(rec["collectives"].values())}
    assert rec["roofline"]["flops"] == work.flops / 512
    assert rec["roofline"]["t_memory_s"] == work.hbm_bytes / 512 / rl.HBM_BYTES_PER_S


def test_collectives_equal_a_hand_count():
    """The collective model of ``launch/dryrun.py`` counted by hand for a dense
    train cell and a MoE decode cell. Every axis of both meshes crosses
    8-GPU nodes, so each collective runs at the InfiniBand rate."""
    from repro_torch.utils import roofline as rl
    ib = rl.IB_BYTES_PER_S
    # Llama-3.2-3B train_4k on 16 x 16: 16 sequences of 4,096 a chip, D 3072,
    # bf16; heads padded to 32 shard, the 8 KV heads do not; the vocabulary
    # (128,256) shards. Forward: the embedding's all-reduce and two a layer
    # (after wo and w_down); backward two a layer and the head's input
    # gradient; remat two a layer more; the loss's max, sum and gold logit.
    act = 16 * 4096 * 3072 * 2
    ar = (1 + 3 * 2 * 28 + 1) * act + 3 * 16 * 4096 * 4
    # every leaf's ZeRO-1 m / v shard over data: the chip's model shard of
    # each bf16 gradient is reduce-scattered, the param all-gathered after
    local = 2 * (128256 * 3072 // 16 + 3072 + 28 * (
        3 * 3072 * 8192 // 16 + 2 * 3072 * 32 * 128 // 16 + 2 * 3072 * 8 * 128 + 2 * 3072))
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", multi_pod=False, verbose=False)
    assert rec["collectives"] == {"all-gather": local / 16, "all-reduce": ar,
                                  "reduce-scatter": local, "all-to-all": 0.0,
                                  "collective-permute": 0.0}
    t = (2 * 15 / 16 * ar + 15 / 16 * local + 15 * local / 16) / ib
    assert math.isclose(rec["roofline"]["t_collective_s"], t, rel_tol=1e-12)
    # OLMoE-1B-7B decode_32k on 2 x 16 x 16: 4 sequences a chip, one token
    # each; 16 heads and 16 KV heads shard (the cache by heads: no split-K);
    # the embedding's all-reduce, one a layer after wo; the experts shard,
    # C = ceil(4 * 8 / 64 * 1.25) = 1, so a dispatch and a combine of 64 x 1
    # x 2048 bf16 / 16 a layer; the untied head leaves its logits sharded.
    rec = dryrun.run_cell("olmoe-1b-7b", "decode_32k", multi_pod=True, verbose=False)
    ar, a2a = (1 + 16) * 4 * 2048 * 2, 16 * 2 * 64 * 2048 * 2 / 16
    assert rec["collectives"] == {"all-gather": 0.0, "all-reduce": ar, "reduce-scatter": 0.0,
                                  "all-to-all": a2a, "collective-permute": 0.0}
    t = (2 * 15 / 16 * ar + 15 / 16 * a2a) / ib
    assert math.isclose(rec["roofline"]["t_collective_s"], t, rel_tol=1e-12)


def test_the_port_sets_no_environment_variable():
    import importlib
    before = dict(os.environ)
    importlib.reload(dryrun)
    assert dict(os.environ) == before


def test_cli_writes_the_reference_records(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--both-meshes",
         "--out", str(tmp_path)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("0 failures")
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 80
    assert sum(r["status"] == "ok" for r in recs) == 64
    skipped = [r for r in recs if r["status"] == "skipped"]
    assert len(skipped) == 16 and {r["shape"] for r in skipped} == {"long_500k"}
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}
    for r in recs:
        if r["status"] != "ok":
            continue
        assert all(isinstance(v, float) for v in r["per_chip"].values()), r["arch"]
        assert None not in r["roofline"].values(), (r["arch"], r["shape"])
        assert all(isinstance(v, float) for v in r["collectives"].values())
        assert [k for k, v in r.items() if v is None] == [
            "lower_s", "compile_s", "cost_analysis_raw"]
        assert set(r["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                             "temp_bytes", "peak_bytes"}


SMOKE_SHAPES = {"train": ShapeConfig("train", 16, 2, "train"),
                "prefill": ShapeConfig("prefill", 16, 2, "prefill"),
                "decode": ShapeConfig("decode", 16, 2, "decode")}


def _real(t, g):
    """A CPU tensor for a ``meta`` one: random tokens below 64, ones for
    the mask, normal values otherwise."""
    if t.dtype == torch.int32:
        return torch.randint(0, 64, tuple(t.shape), generator=g, dtype=torch.int32)
    if t.dtype == torch.float32 and t.ndim == 2:
        return torch.ones(tuple(t.shape))
    return torch.randn(tuple(t.shape), generator=g).to(t.dtype)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-base"])
def test_step_functions_run_on_smoke_inputs(monkeypatch, arch):
    cfg = reduced_for_smoke(get_config(arch)).scaled(dtype="float32")
    monkeypatch.setattr(specs, "get_config", lambda name: cfg)
    monkeypatch.setattr(specs, "SHAPES", SMOKE_SHAPES)
    g = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        cell = specs.make_cell(arch, kind, mesh=PodMesh, chunk=8)
        step = specs.make_step_fn(cell, n_microbatches=2)
        params = cell.model.init_params(torch.Generator().manual_seed(1), "cpu")
        batch = {k: _real(v, g) for k, v in cell.args[2 if kind == "decode" else 1].items()}
        if kind == "train":
            state = TrainState(params, adamw_init(params),
                               torch.zeros((), dtype=torch.int32))
            state, metrics = step(state, batch)
            assert int(state.step) == 1 and np.isfinite(float(metrics["loss"]))
            continue
        cache_kw = {"enc_seq": 16} if cfg.family == "audio" else {}
        cache = cell.model.init_cache(2, 16, **cache_kw, device="cpu")
        if kind == "prefill":
            logits, cache = step(params, batch, cache)
            assert logits.shape == (2, 1, cfg.vocab_size)
        else:
            batch["index"] = torch.tensor(3, dtype=torch.int32)
            logits, _ = step(params, cache, batch)
            want, _ = cell.model.decode_step(params, cell.model.init_cache(
                2, 16, **cache_kw, device="cpu"), {**batch, "index": 3})
            assert logits.shape == (2, 1, cfg.vocab_size)
            assert torch.isfinite(logits).all() and torch.equal(logits, want)
