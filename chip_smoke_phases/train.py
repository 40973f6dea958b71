"""Phase 20: LM training, after phase 19; it launches none of the five
kernels.

20. Width checks in float32 with TF32 off: llama3.2-3b and olmoe-1b-7b
    (capacity factor 1.25: copies drop, so the MoE gathers' autograd
    Functions run) at full width and 2 layers, weights drawn on the card and
    copied to the host, from ``data.tokens.synthetic_batches`` at 2 x 64:
    the gradients of one batch, then two ``train_step``s (the schedule's lr
    is 0 at step 0), card against CPU: losses within 1e-4 relative, every
    gradient, m and v leaf within 1e-3 of max |CPU|, the params within 1e-3
    of max |CPU| plus the error AdamW propagates from rounding-level
    gradients. Llama-3.2-3B at full width and depth in bf16 with remat at
    4 x 512 (2 x 512 if that does not fit): a warm-up step, then one step
    whose allocator rise is held against the memory model within 10%, each
    loss and grad_norm finite, the peak device memory; no full-width
    checkpoint. The llama3.2-3b smoke config in bf16 trained two steps on
    the card, saved and restored onto the card bit for bit, its manifest
    equal to the same state's saved from the host. ``python -m
    repro_torch.launch.train --arch llama3.2-3b --smoke --steps 20 --batch 8
    --seq 128 --microbatches 2 --ckpt-every 5`` as subprocesses (beside the
    full-width step and the checkpoint): ``--fail-at 12`` exits nonzero with
    SimulatedFailure after committing step 10, the rerun resumes at 10 and
    logs steps 10..19 and ends at 20, ``--compress-grads`` from a fresh
    directory ends below its first loss.

``times_train`` (TRAIN_STEPS steps timed with CUDA events: median ms, MFU
against ``utils/roofline.lm_train_roofline``; one step under torch.profiler;
the gradients and the AdamW update of one step apart) is
scripts/chip_times.py's.
"""
from __future__ import annotations

import gc
import json
import math
import re
import shutil
import statistics
import time
from pathlib import Path

from . import common as C
from .common import log, require
from .lm import LM_PROFILE_TOP, memory_check, no_tf32, with_capacity

# Width checks in float32 (TF32 off) at full width cut to TRAIN_WIDTH_LAYERS
# layers, OLMoE at capacity factor 1.25 (copies drop, so the MoE gather
# Functions' backwards run): the gradients of one batch and
# TRAIN_WIDTH_STEPS train steps on the card against the CPU from the same
# weights (the schedule's lr is 0 at step 0, so the second step is the
# first to move the params).
TRAIN_WIDTH_ARCHS = ("llama3.2-3b", "olmoe-1b-7b")
TRAIN_WIDTH_B, TRAIN_WIDTH_S, TRAIN_WIDTH_LAYERS, TRAIN_WIDTH_STEPS = 2, 64, 2, 2
TRAIN_MOE_CAPACITY = 1.25
TRAIN_LOSS_TOL = 1e-4    # relative
TRAIN_TOL = 1e-3         # max |Δ| / max |CPU| of a leaf (gradients, m, v)
# Full-width training: Llama-3.2-3B at full depth in bf16 with remat, at
# TRAIN_BATCH // 2 if TRAIN_BATCH does not fit; the timing run takes
# TRAIN_STEPS timed steps after a warm-up.
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
# The launcher as subprocesses: a failure at step 12 after committing step
# 10, the resume to step 20, and a compressed run from a fresh directory.
TRAIN_CKPT_DIR = C.BUILD / "smoke_train_ckpt"
TRAIN_FRESH_DIR = C.BUILD / "smoke_train_ckpt_compressed"
TRAIN_CLI = ("--arch", "llama3.2-3b", "--smoke", "--steps", "20", "--batch", "8",
             "--seq", "128", "--microbatches", "2", "--ckpt-every", "5",
             "--log-every", "1")


def _reference_leaves(tree) -> dict:
    """A parameter-shaped module (params, a gradient list made one, m, v)
    in the reference's stacked layout, flattened to {keystr path: tensor}."""
    from repro_torch.convert import lm_params_to_reference

    def flat(d, prefix=""):
        out = {}
        for k in sorted(d):
            if isinstance(d[k], dict):
                out.update(flat(d[k], f"{prefix}[{k!r}]"))
            else:
                out[f"{prefix}[{k!r}]"] = d[k]
        return out

    return flat(lm_params_to_reference(tree))


def _leaf_errs(card: dict, host: dict) -> dict:
    """max |card - host| / max |host| per leaf (0 where both are 0)."""
    out = {}
    for k, h in host.items():
        h = h.float()
        d = float((card[k].float().cpu() - h).abs().max())
        out[k] = d / (float(h.abs().max()) or 1.0)
    return out


def _params_bound_excess(card: dict, host: dict, v: dict, lr: float, steps: int) -> tuple:
    """The params after AdamW steps: each element within TRAIN_TOL of its
    leaf's max |CPU| plus the error the optimizer propagates from the
    gradients, 4 lr ``steps`` min(1, TRAIN_TOL max(rms) / rms) (Adam divides
    each gradient element by its RMS ``sqrt(v)``, so an element whose
    gradient lies at the rounding level takes an O(lr) step of either sign
    on either device). Returns (the largest max |Δ| / max |CPU| of any leaf,
    the number of elements past TRAIN_TOL of their leaf's max, the largest
    ratio of |Δ| to its bound)."""
    worst, past, ratio = 0.0, 0, 0.0
    for k, h in host.items():
        h = h.float()
        d = (card[k].float().cpu() - h).abs()
        scale = float(h.abs().max()) or 1.0
        rms = v[k].float().sqrt()
        rel = (TRAIN_TOL * float(rms.max()) / rms.clamp(min=1e-30)).clamp(max=1.0)
        bound = TRAIN_TOL * scale + 4 * lr * steps * rel
        worst = max(worst, float(d.max()) / scale)
        past += int((d > TRAIN_TOL * scale).sum())
        ratio = max(ratio, float((d / bound).max()))
    return worst, past, ratio


def _state_on(state, device):
    """A copy of a TrainState on ``device``, every leaf in its own dtype."""
    from repro_torch.train.step import TrainState
    from repro_torch.utils.treeutil import tree_map

    def to(tree):
        return None if tree is None else tree_map(
            lambda t: t.detach().to(device).requires_grad_(t.requires_grad), tree)

    return TrainState(params=to(state.params), opt=to(state.opt), step=state.step.to(device),
                      grad_err=to(state.grad_err))


def train_width_check(torch, name: str) -> dict:
    """``name`` at full width and TRAIN_WIDTH_LAYERS layers in float32 (MoE
    at TRAIN_MOE_CAPACITY): the weights drawn on the card, the same state
    carried to the host (``convert.train_state_to_reference`` and back);
    the gradients of the first batch, then TRAIN_WIDTH_STEPS train steps
    (warmup 1) on both, the losses within TRAIN_LOSS_TOL, every gradient,
    ``m`` and ``v`` leaf within TRAIN_TOL of its max |CPU| and the params
    within the bound of ``_params_bound_excess``."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step, value_and_grad
    from repro_torch.utils.treeutil import tree_unflatten_like
    dev = C.DEVICE
    cfg = get_config(name).scaled(dtype="float32", n_layers=TRAIN_WIDTH_LAYERS)
    if cfg.moe is not None:
        cfg = with_capacity(cfg, TRAIN_MOE_CAPACITY)
    B, S = TRAIN_WIDTH_B, TRAIN_WIDTH_S
    model = build_model(cfg, max_seq=S, chunk=S)
    opt = AdamWConfig()
    t0 = time.perf_counter()
    card = init_train_state(model, torch.Generator(dev).manual_seed(C.SEED), device=dev)
    host = _state_on(card, "cpu")
    n = sum(p.numel() for p in card.params.parameters())
    data = synthetic_batches(cfg, batch=B, seq=S, family=cfg.family, seed=C.SEED, device="cpu")
    batches = [next(data) for _ in range(TRAIN_WIDTH_STEPS)]

    def on(batch, d):
        return {k: v.to(d) for k, v in batch.items()}

    grads = {}
    losses = {}
    for d, st in ((dev, card), ("cpu", host)):
        loss, g = value_and_grad(model, st.params, on(batches[0], d))
        grads[d] = _reference_leaves(tree_unflatten_like(st.params, g))
        losses[d] = [float(loss)]
        del g
    grad_errs = _leaf_errs(grads[dev], grads["cpu"])
    del grads
    step = make_train_step(model, opt, warmup=1, total_steps=10)
    step_losses = {}
    for d, st in ((dev, card), ("cpu", host)):
        step_losses[d] = []
        for b in batches:
            st, met = step(st, on(b, d))
            step_losses[d].append(float(met["loss"]))
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses[dev] + step_losses[dev],
                                                     losses["cpu"] + step_losses["cpu"])]
    m_errs = _leaf_errs(_reference_leaves(card.opt["m"]), _reference_leaves(host.opt["m"]))
    v_host = _reference_leaves(host.opt["v"])
    v_errs = _leaf_errs(_reference_leaves(card.opt["v"]), v_host)
    p_worst, p_past, p_ratio = _params_bound_excess(
        _reference_leaves(card.params), _reference_leaves(host.params), v_host, opt.lr,
        TRAIN_WIDTH_STEPS)
    del card, host
    out = {"layers": cfg.n_layers, "params": n, "batch": [B, S],
           "capacity_factor": cfg.moe.capacity_factor if cfg.moe is not None else None,
           "loss_rel_err": max(loss_errs), "grad_err": max(grad_errs.values()),
           "grad_worst_leaf": max(grad_errs, key=grad_errs.get),
           "m_err": max(m_errs.values()), "v_err": max(v_errs.values()),
           "params_err": p_worst, "params_elements_past_tol": p_past,
           "params_bound_ratio": p_ratio, "losses_card": step_losses[dev]}
    log(f"[train] {name} full width, {cfg.n_layers} layers, {n / 1e9:.3f} B params, "
        f"float32{'' if cfg.moe is None else f' capacity_factor={cfg.moe.capacity_factor:g}'}"
        f": card vs CPU loss {max(loss_errs):.3e} (bound {TRAIN_LOSS_TOL}), gradients "
        f"{out['grad_err']:.3e} ({out['grad_worst_leaf']}), after {TRAIN_WIDTH_STEPS} "
        f"steps m {out['m_err']:.3e}, v {out['v_err']:.3e} (bound {TRAIN_TOL}), params "
        f"{p_worst:.3e} of max |CPU| ({p_past} elements past {TRAIN_TOL}, largest share "
        f"of the propagated bound {p_ratio:.3f}); {time.perf_counter() - t0:.1f}s")
    require(max(loss_errs) < TRAIN_LOSS_TOL, f"{name} train losses card vs CPU: {loss_errs}")
    for what, errs in (("gradient", grad_errs), ("m", m_errs), ("v", v_errs)):
        bad = {k: e for k, e in errs.items() if not e < TRAIN_TOL}
        require(not bad, f"{name} {what} leaves card vs CPU past {TRAIN_TOL}: {bad}")
    require(p_ratio <= 1.0, f"{name} params card vs CPU past their bound: {p_ratio:.3f}")
    return out


class FullTrain:
    """TRAIN_ARCH at full width and depth in bf16 with remat at B x
    TRAIN_SEQ: its state drawn on the card from the seed, its train step and
    ``n_batches`` synthetic batches."""

    def __init__(self, torch, B: int, n_batches: int):
        from repro_torch.configs import get_config
        from repro_torch.data.tokens import synthetic_batches
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig
        from repro_torch.train.step import init_train_state, make_train_step
        from repro_torch.utils.treeutil import tree_bytes
        self.B = B
        self.cfg = cfg = get_config(TRAIN_ARCH)
        self.model = build_model(cfg, max_seq=TRAIN_SEQ, chunk=TRAIN_SEQ, remat=True)
        t0 = time.perf_counter()
        self.state = init_train_state(self.model, torch.Generator(C.DEVICE).manual_seed(C.SEED),
                                      device=C.DEVICE)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self.n_padded = sum(p.numel() for p in self.state.params.parameters())
        self.state_bytes = {"params": tree_bytes(self.state.params),
                            "m_v": tree_bytes(self.state.opt["m"])
                            + tree_bytes(self.state.opt["v"])}
        self.step = make_train_step(self.model, AdamWConfig(), warmup=1,
                                    total_steps=TRAIN_STEPS + 2)
        data = synthetic_batches(cfg, batch=B, seq=TRAIN_SEQ, family=cfg.family,
                                 seed=C.SEED, device=C.DEVICE)
        self.batches = [next(data) for _ in range(n_batches)]
        log(f"[train] {TRAIN_ARCH} bf16, {cfg.n_layers} layers, remat: "
            f"{self.n_padded / 1e9:.3f} B params as padded; params "
            f"{self.state_bytes['params'] / 1e9:.2f} GB, m + v "
            f"{self.state_bytes['m_v'] / 1e9:.2f} GB; init on the card {self.init_s:.2f}s")

    def run(self, batch) -> tuple[float, float]:
        """One train step: (loss, grad_norm), each required finite."""
        self.state, met = self.step(self.state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"{TRAIN_ARCH} train step: loss {loss}, grad_norm {gnorm}")
        return loss, gnorm


def with_batch_fallback(torch, fn) -> dict:
    """``fn(torch, B)`` at TRAIN_BATCH, or at TRAIN_BATCH // 2 if the card
    runs out of memory at TRAIN_BATCH (the cut is printed and recorded)."""
    full, why = None, None
    for B in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            full = fn(torch, B)
            break
        except torch.cuda.OutOfMemoryError as e:
            if B != TRAIN_BATCH:
                raise
            why = f"B={B} ran out of device memory: {str(e).splitlines()[0]}"
        log(f"[train] {why}; taking B={TRAIN_BATCH // 2}")
        gc.collect()
        torch.cuda.empty_cache()
    full["smaller_batch_because"] = why
    return full


def train_full_check(torch, B: int) -> dict:
    """A warm-up step, then one step whose allocator rise is held against
    ``memory.lm_train_memory``; each loss and grad_norm finite."""
    from repro_torch.utils import memory
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ft = FullTrain(torch, B, 2)
    losses = [ft.run(ft.batches[0])]
    peak = torch.cuda.max_memory_allocated()
    mem = memory_check(
        torch, f"{TRAIN_ARCH} train step {B}x{TRAIN_SEQ}, remat",
        lambda: losses.append(ft.run(ft.batches[1])),
        memory.lm_train_memory(ft.cfg, B, TRAIN_SEQ, remat=True, chunk=TRAIN_SEQ).temp)
    out = {"arch": TRAIN_ARCH, "dtype": ft.cfg.dtype, "layers": ft.cfg.n_layers,
           "remat": True, "batch": B, "seq": TRAIN_SEQ, "params_padded": ft.n_padded,
           "state_bytes": ft.state_bytes, "init_s": ft.init_s,
           "losses": [x[0] for x in losses], "grad_norms": [x[1] for x in losses],
           "peak_bytes": peak, "peak_bytes_above_baseline": peak - base, "memory_model": mem}
    del ft
    log(f"[train] losses {', '.join(f'{x:.4f}' for x in out['losses'])}; grad_norm "
        f"{', '.join(f'{x:.4f}' for x in out['grad_norms'])} (finite)")
    log(f"[train] peak device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
        f"GiB above the phase's baseline)")
    return out


def start_launcher(ctx) -> dict:
    """The launcher's fail-at and compressed runs, started together; the
    resume starts once the failure has committed its checkpoint."""
    for d in (TRAIN_CKPT_DIR, TRAIN_FRESH_DIR):
        shutil.rmtree(d, ignore_errors=True)
    ctx.remove_later(TRAIN_CKPT_DIR, TRAIN_FRESH_DIR)
    return {"fail_at_12": C.launch([*TRAIN_CLI, "--ckpt-dir", TRAIN_CKPT_DIR,
                                    "--fail-at", 12], "train --fail-at 12", module="train",
                                   expect_failure=True, threads=C.SIDE_THREADS),
            "compress_grads": C.launch([*TRAIN_CLI, "--ckpt-dir",
                                        TRAIN_FRESH_DIR, "--compress-grads"],
                                       "train --compress-grads", module="train",
                                       threads=C.SIDE_THREADS)}


def train_launcher(procs: dict) -> dict:
    """``--fail-at 12`` exits nonzero with SimulatedFailure after committing
    step 10; the same command without it resumes at 10, logs the 10 losses
    of steps 10..19 and ends at 20; ``--compress-grads`` from a fresh
    directory ends with its last loss below its first."""
    from repro_torch.checkpoint import latest_step
    out = {}
    _, err, t = procs["fail_at_12"].result()
    committed = latest_step(str(TRAIN_CKPT_DIR))
    require("SimulatedFailure: injected failure at step 12" in err and committed == 10,
            f"train --fail-at 12: committed step {committed}; stderr:\n{err[-2000:]}")
    out["fail_at_12"] = {"process_s": t, "committed": committed}
    o, _, t = C.cli([*TRAIN_CLI, "--ckpt-dir", TRAIN_CKPT_DIR],
                    "train (resume)", module="train", threads=C.SIDE_THREADS)
    steps = [int(x) for x in re.findall(r"^\[loop\] step (\d+) loss=", o, re.M)]
    done = [x for x in o.splitlines() if x.startswith("[train] done at step ")]
    require("[loop] resuming from checkpoint step 10" in o and steps == list(range(10, 20))
            and len(done) == 1 and done[0].startswith("[train] done at step 20;"),
            f"train resume: steps {steps}, output:\n{o[-2000:]}")
    out["resume"] = {"process_s": t, "line": done[0], "steps_logged": len(steps)}
    o, _, t = procs["compress_grads"].result()
    m = re.search(r"^\[train\] done at step 20; loss (\S+) -> (\S+);", o, re.M)
    require(m is not None and float(m.group(2)) < float(m.group(1)),
            f"train --compress-grads: the last loss is not below the first:\n{o[-2000:]}")
    out["compress_grads"] = {"process_s": t, "line": m.group(0),
                             "first": float(m.group(1)), "last": float(m.group(2))}
    for d in (TRAIN_CKPT_DIR, TRAIN_FRESH_DIR):
        shutil.rmtree(d, ignore_errors=True)
    for what, r in out.items():
        log(f"[train] launcher {what}: {json.dumps(r)}")
    return out


def train_checkpoint_on_card(torch) -> dict:
    """The llama3.2-3b smoke config in bf16 trained two steps on the card,
    saved, restored into a state of another init on the card: bit-equal;
    the same state carried to the host and saved there: manifest equal
    (names, files, shapes, dtypes, stored dtypes, shas)."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced_for_smoke
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.utils.treeutil import tree_leaves
    dev = C.DEVICE
    cfg = reduced_for_smoke(get_config(TRAIN_ARCH))
    model = build_model(cfg, max_seq=64, chunk=64)
    state = init_train_state(model, torch.Generator(dev).manual_seed(C.SEED), device=dev)
    step = make_train_step(model, AdamWConfig(lr=1e-2), warmup=1, total_steps=4)
    data = synthetic_batches(cfg, batch=4, seq=64, family=cfg.family, seed=C.SEED, device=dev)
    for _ in range(2):
        state, _ = step(state, next(data))
    card_dir, host_dir = (TRAIN_CKPT_DIR.with_name(TRAIN_CKPT_DIR.name + x)
                          for x in ("_card", "_host"))
    try:
        card_path = save_checkpoint(str(card_dir), 2, state)
        host_path = save_checkpoint(str(host_dir), 2, _state_on(state, "cpu"))
        target = init_train_state(model, torch.Generator(dev).manual_seed(C.SEED + 1),
                                  device=dev)
        restore_checkpoint(str(card_dir), 2, target)
        pairs = list(zip(tree_leaves([state.params, state.opt["m"], state.opt["v"],
                                      state.opt["step"], state.step]),
                         tree_leaves([target.params, target.opt["m"], target.opt["v"],
                                      target.opt["step"], target.step])))
        equal_bits = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                         for a, b in pairs)
        manifests = [json.loads((Path(p) / "manifest.json").read_text())
                     for p in (card_path, host_path)]
    finally:
        for d in (card_dir, host_dir):
            shutil.rmtree(d, ignore_errors=True)
    out = {"leaves": len(manifests[0]["leaves"]), "restored_bit_equal": equal_bits,
           "manifest_equal_to_host": manifests[0] == manifests[1],
           "bf16_leaves": sum(x["dtype"] == "bfloat16" for x in manifests[0]["leaves"])}
    log(f"[train] checkpoint on the card: {json.dumps(out)}")
    require(equal_bits and out["manifest_equal_to_host"] and out["bf16_leaves"] > 0,
            f"checkpoint on the card: {out}")
    return out


def train(ctx) -> None:
    """Phase 20: the width checks in float32 (TF32 off), the full-width
    step and its memory, the checkpoint on the card, the launcher's fail /
    resume / compressed runs. Sets the ``train`` JSON line's object."""
    torch = ctx.torch
    t_phase = time.perf_counter()
    width = no_tf32(torch, lambda: {name: train_width_check(torch, name)
                                    for name in TRAIN_WIDTH_ARCHS})
    # the launcher's runs beside the card's work below, not beside the
    # width checks' host halves, which they would slow
    procs = start_launcher(ctx)
    gc.collect()
    full = with_batch_fallback(torch, train_full_check)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = train_checkpoint_on_card(torch)
    cli = train_launcher(procs)
    dt = time.perf_counter() - t_phase
    ctx.lines["train"] = {"card": ctx.env["smi"], "width_check_float32": width,
                          "full_model": full, "launcher": cli, "checkpoint": ckpt,
                          "phase_s": dt}


# ---------------------------------------------------------------------------
# Timing run (scripts/chip_times.py)
# ---------------------------------------------------------------------------


def train_full_times(torch, B: int) -> dict:
    """One warm-up step, TRAIN_STEPS steps timed with CUDA events (and on the
    host clock, ended by the loss's read), one step under torch.profiler
    (device activity only), then the gradients and the AdamW update of one
    step timed apart."""
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils import roofline as R
    torch.cuda.empty_cache()
    ft = FullTrain(torch, B, TRAIN_STEPS + 2)
    ms, wall = [], []
    for batch in ft.batches[:-1]:
        torch.cuda.synchronize()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        ft.state, met = ft.step(ft.state, batch)
        ev[1].record()
        float(met["loss"])
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.synchronize()
    with C.device_profiler(torch) as prof:
        t0 = time.perf_counter()
        ft.run(ft.batches[-1])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    profile = C.device_profile(prof, prof_wall, top=LM_PROFILE_TOP)
    profile.pop("kernels")
    # where a step goes: the gradients (forward, recompute, backward) and
    # the AdamW update alone, each between CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = value_and_grad(ft.model, ft.state.params, ft.batches[-1])
    ev[1].record()
    adamw_update(ft.state.params, grads, ft.state.opt, AdamWConfig())
    ev[2].record()
    torch.cuda.synchronize()
    split = {"grads_ms": ev[0].elapsed_time(ev[1]), "adamw_ms": ev[1].elapsed_time(ev[2])}
    # AdamW's bound: read params, grads (bf16), m, v (float32); write params, m, v
    adamw_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                      for p in ft.state.params.parameters())
    split["adamw_bound_ms"] = adamw_bytes / R.HBM_BYTES_PER_S * 1e3
    cfg = ft.cfg
    del ft, grads
    roof = R.lm_train_roofline(cfg, B, TRAIN_SEQ, remat=True)
    med = statistics.median(ms[1:])
    out = {"arch": TRAIN_ARCH, "batch": B, "seq": TRAIN_SEQ, "step_ms": ms[1:],
           "step_ms_median": med, "warmup_step_ms": ms[0], "step_wall_ms": wall[1:],
           "tokens_per_s": B * TRAIN_SEQ / (med / 1e3),
           "flops": roof.flops, "model_flops": roof.model_flops,
           "bound_ms": roof.t_bound * 1e3, "bound_by": roof.bound_by,
           "mfu": roof.model_flops / (med / 1e3) / R.PEAK_FLOPS_BF16,
           "bound_share": roof.t_bound * 1e3 / med,
           "device_profile_one_step": profile, "split": split}
    log(f"[train] step {B}x{TRAIN_SEQ}: {med:.3f} ms (median of {TRAIN_STEPS}; "
        f"{', '.join(f'{x:.2f}' for x in ms[1:])}; warm-up {ms[0]:.2f}; host clock "
        f"{statistics.median(wall[1:]):.2f}), {out['tokens_per_s']:.0f} tok/s, "
        f"{roof.model_flops / 1e12:.2f} TFLOP (6NT-style, {roof.flops / 1e12:.2f} with "
        f"the recompute), bound {roof.t_bound * 1e3:.3f} ms ({roof.bound_by}), MFU "
        f"{out['mfu']:.4f}")
    log(f"[train] one step's parts (CUDA events): gradients {split['grads_ms']:.3f} ms, "
        f"AdamW update {split['adamw_ms']:.3f} ms (its bound {split['adamw_bound_ms']:.3f} "
        f"ms, bytes)")
    log(f"[train] device profile of one step: busy {profile['busy_ms']:.3f} of "
        f"{profile['wall_ms']:.3f} ms wall, idle share {profile['idle_share']:.4f}, "
        f"{profile['n_events']} device events; top kernels [name, launches, ms]: "
        f"{json.dumps(profile['top_kernels'])}")
    return out


def times_train(ctx) -> dict:
    return with_batch_fallback(ctx.torch, train_full_times)
