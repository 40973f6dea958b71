"""Phase 19: the LM serve path of every family; it launches none of the
five kernels.

19. Width checks in float32 with TF32 off: every arch at full width cut to
    LM_WIDTH_LAYERS (whisper-base whole), weights drawn on the card and
    copied to the host, a prefill of 2 x 64 (qwen2-vl with 4 vision
    embeddings and three position streams, whisper-base on 64 frames) and
    one decode step, logits on the card against the CPU within 1e-3 of max
    |ref|; the MoE archs at their own capacity factor and at n_experts.
    ``python -m repro_torch.launch.serve`` at full width and depth in bf16
    for llama3.2-3b, olmoe-1b-7b, recurrentgemma-9b, xlstm-1.3b and
    whisper-base as subprocesses side by side (each exits 0 and prints its
    ``[serve]`` line). One arch of every family at full width and depth in
    bf16 in process (LM_FULL_ARCHS at LM_FULL_SHAPES = batch, prompt,
    generated tokens; whisper-base's prefill encodes as many frames as its
    prompt holds tokens): parameter counts real and padded, one prefill and
    the greedy decode steps at context P + 1..P + G (the last logits
    finite), the peak device memory, each prefill and decode step's memory
    against the memory model (``utils/memory.py``) within MEMORY_TOL of the
    allocator, and the decode of token P + 1 against a full forward over
    P + 1 within 5e-2 of max |ref| (the MoE archs at capacity_factor =
    n_experts, where the sequences routed alike are held to it and a float32
    run to 1e-3; xLSTM in float32 within 1e-3, its bf16 noise floor
    printed).

``times_lm`` (each serve subprocess alone; each full model's prefill as
the median of 5 and its decode steps a step at a time in CUDA events,
tokens/s, MFU and the share of the HBM bound from ``utils/roofline.py``, a
device profile of one prefill and 8 steps; the new families' layers alone)
is scripts/chip_times.py's.
"""
from __future__ import annotations

import json
import statistics
import time

from . import common as C
from .common import cuda_ms, log, rel_err, require

# Width checks in float32 (TF32 off), each arch at full width cut to the
# layers below (whisper-base whole, 6 + 6).
LM_WIDTH_LAYERS = {"llama3.2-3b": 2, "deepseek-7b": 2, "mistral-nemo-12b": 2,
                   "starcoder2-15b": 2, "qwen2-vl-7b": 2, "olmoe-1b-7b": 2,
                   "deepseek-v2-lite-16b": 2, "recurrentgemma-9b": 3,  # rec, rec, attn
                   "xlstm-1.3b": 8,                                    # 7 mLSTM + 1 sLSTM
                   "whisper-base": None}
LM_WIDTH_B, LM_WIDTH_S = 2, 64
LM_VISION_TOKENS = 4
LM_WIDTH_TOL = 1e-3      # max |Δ| / max |ref| of the logits, float32
LM_BATCH, LM_PROMPT, LM_GEN = 8, 512, 64
LM_SERVE_RUNS = {"llama3.2-3b": (LM_BATCH, LM_PROMPT, LM_GEN),
                 "olmoe-1b-7b": (8, 512, 64), "recurrentgemma-9b": (4, 512, 32),
                 "xlstm-1.3b": (4, 512, 32), "whisper-base": (8, 512, 64)}
LM_FULL_ARCHS = ("llama3.2-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                 "recurrentgemma-9b", "xlstm-1.3b", "whisper-base")
# RecurrentGemma-9B and xLSTM-1.3B at their serve runs' 4 x 512 + 32 (the
# sLSTM's loop over 512 steps is ~0.8 s a prefill); Whisper-base encodes
# as many frames as its prompt holds tokens, as the serve launcher does.
LM_FULL_SHAPES = {"llama3.2-3b": (LM_BATCH, LM_PROMPT, LM_GEN),
                  "olmoe-1b-7b": (8, 512, 64), "deepseek-v2-lite-16b": (8, 512, 64),
                  "recurrentgemma-9b": (4, 512, 32), "xlstm-1.3b": (4, 512, 32),
                  "whisper-base": (8, 512, 64)}
# A MoE arch's decode against the full forward runs at capacity_factor = E,
# where nothing drops; its (E, C, D) buffers then hold C = T * K slots an
# expert, so it runs on this many of the sequences, in bf16 and again in
# float32 (DeepSeek-V2-Lite's 15.7 B params take 63 GB in float32, so one).
LM_MOE_CHECK_BATCH = {"olmoe-1b-7b": {"bfloat16": 4, "float32": 2},
                      "deepseek-v2-lite-16b": {"bfloat16": 4, "float32": 1}}
LM_PREFILL_ITERS = 5
LM_PROFILE_STEPS = 8     # decode steps under torch.profiler (device only)
LM_PROFILE_TOP = 8       # kernels listed by device time
# Decode of token 513 from the cache against a full forward over 513
# tokens, bf16: the two take different matmul shapes (1 row against 513),
# so their bf16 roundings differ and compound over 28 layers.
LM_DECODE_TOL = 5e-2
# xLSTM-1.3B's bf16 forward is 0.90 of max |ref| from its own float32
# forward on the same weights (48 blocks, 64 tokens, on the CPU; Llama-3.2-3B
# 0.011): the rounding of each block compounds through the exponential
# gates' normalisers. Its bf16 decode and bf16 full forward, two bf16
# evaluations of one function, differ by the same noise (0.12 there, 0.37
# at 512 tokens on the card), so that difference is measured and printed
# beside the noise floor, and the decode is held against the full forward
# in float32 (the weights cast in place, TF32 off) within LM_WIDTH_TOL.
LM_DECODE_FLOAT32 = ("xlstm-1.3b",)
# The memory model (utils/memory.py) against the caching allocator: one
# prefill and one decode step of each full model, and one Llama-3.2-3B
# train step, each within this fraction of the allocator's rise above what
# was allocated just before it.
MEMORY_TOL = 0.10


def with_capacity(cfg, capacity_factor: float):
    import dataclasses
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def no_tf32(torch, fn):
    """``fn()`` with TF32 matmuls off (float32 checks)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def lm_width_check(torch, name: str) -> dict:
    """``name`` at full width and LM_WIDTH_LAYERS[name] layers in float32: a
    prefill and one decode step on the card and on the CPU on the same
    weights (a MoE arch at its own capacity factor and at n_experts). The
    weights are drawn on the card and copied to the host (the host's
    truncated-normal draw takes ~75 ns an element, minutes for these
    widths). Returns the logits' errors, per capacity factor for MoE."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(name).scaled(dtype="float32")
    if LM_WIDTH_LAYERS[name] is not None:
        cfg = cfg.scaled(n_layers=LM_WIDTH_LAYERS[name])
    variants = {"": cfg}
    if cfg.moe is not None:
        variants = {f"capacity_factor={cf:g}": with_capacity(cfg, cf)
                    for cf in (cfg.moe.capacity_factor, float(cfg.moe.n_experts))}
    B, S = LM_WIDTH_B, LM_WIDTH_S
    rng = np.random.default_rng(C.SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    step = {"token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (B, LM_VISION_TOKENS, cfg.d_model))).astype(np.float32)
        ar = np.arange(S)
        batch["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([ar, ar // 2, ar % 3])[:, None], (3, B, S))).astype(np.int32)
        step["positions3"] = np.full((3, B, 1), S, np.int32)
    if cfg.family == "audio":
        batch["frame_embeds"] = (0.1 * rng.standard_normal((B, S, cfg.d_model))
                                 ).astype(np.float32)

    def run(params, dev):
        out = {}
        for what, c in variants.items():
            model = build_model(c, max_seq=S + 1, chunk=S)
            on = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            db = {k: torch.from_numpy(v).to(dev) for k, v in step.items()}
            logits, cache = model.prefill(params, on, model.init_cache(
                B, S + 1, enc_seq=S, device=dev))
            logits_d, _ = model.decode_step(params, cache, {**db, "index": S})
            out[what] = (logits.cpu(), logits_d.cpu())
        return out

    t0 = time.perf_counter()
    params = build_model(cfg, max_seq=S + 1).init_params(
        torch.Generator(C.DEVICE).manual_seed(C.SEED), C.DEVICE)
    n = sum(p.numel() for p in params.parameters())
    card = run(params, C.DEVICE)
    host = run(params.to("cpu"), "cpu")
    del params
    errs = {}
    for what in variants:
        e = {"prefill": rel_err(card[what][0], host[what][0]),
             "decode": rel_err(card[what][1], host[what][1])}
        for (step_name, err), logits in zip(e.items(), card[what]):
            require(err < LM_WIDTH_TOL and bool(torch.isfinite(logits).all()),
                    f"{name} {what} {step_name} logits: card against CPU {err:.3e} "
                    f"(max |Δ| / max |ref|, bound {LM_WIDTH_TOL}), finite "
                    f"{bool(torch.isfinite(logits).all())}")
        errs[what] = e
        log(f"[lm] {name} full width, {cfg.n_layers} layers, {n / 1e9:.3f} B params, "
            f"float32{' ' + what if what else ''}: prefill {B}x{S} logits card vs CPU "
            f"{e['prefill']:.3e}, decode {e['decode']:.3e} (bound {LM_WIDTH_TOL})")
    log(f"[lm] {name} width check {time.perf_counter() - t0:.1f}s")
    return errs if cfg.moe is not None else errs[""]


def moe_decode_check(torch, params, cfg, prompt, first, chunk: int) -> dict:
    """A MoE arch's decode of token P + 1 against its full forward over
    P + 1 at capacity_factor = n_experts (nothing drops), on the first
    LM_MOE_CHECK_BATCH[arch][dtype] sequences, in bf16 and then in float32 (the
    weights cast in place, TF32 off). Per sequence: the logits' error and
    the layers where the last token's K experts differ between the two
    (the router is discontinuous: where the K-th and (K+1)-th
    probabilities nearly tie, the 1-row and 513-row matmuls' roundings
    pick different experts). bf16 is held to LM_DECODE_TOL on the
    sequences routed alike in every layer; float32 on every sequence to
    LM_WIDTH_TOL."""
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    P = prompt.shape[1]
    orig, routes, out = M.route, [], {}

    def route(p, xt, c):
        r = orig(p, xt, c)
        routes.append(r[2].sort(-1).values)
        return r

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    M.route = route
    try:
        for dtype, nb in LM_MOE_CHECK_BATCH[cfg.name].items():
            if dtype == "float32":
                params.float()
            c = with_capacity(cfg, float(cfg.moe.n_experts)).scaled(dtype=dtype)
            model = build_model(c, max_seq=P + 1, chunk=chunk)
            toks, nxt = prompt[:nb], first[:nb]
            nb = toks.shape[0]
            cache = model.init_cache(nb, P + 1, device=C.DEVICE)
            model.prefill(params, {"tokens": toks}, cache)
            routes.clear()
            logits_d, _ = model.decode_step(params, cache, {"token": nxt, "index": P})
            dec = list(routes)
            routes.clear()
            hid, _, _ = T.forward(params, c, torch.cat([toks, nxt], 1), chunk=chunk)
            ref = T.lm_head(params, c, hid[:, -1:])
            full = [r.reshape(nb, P + 1, -1)[:, -1] for r in routes]
            del cache, hid
            flips = [[i for i, (a, b) in enumerate(zip(dec, full)) if not torch.equal(a[q], b[q])]
                     for q in range(nb)]
            errs = [rel_err(logits_d[q], ref[q]) for q in range(nb)]
            out[dtype] = {"batch": nb, "err_per_sequence": errs, "flipped_layers": flips}
            log(f"[lm] {cfg.name} {dtype} decode of token {P + 1} against the full forward "
                f"(capacity_factor {cfg.moe.n_experts}), per sequence: errors "
                f"{', '.join(f'{e:.3e}' for e in errs)} of max |ref|; layers whose last-token "
                f"experts differ {flips}")
    finally:
        M.route = orig
        torch.backends.cuda.matmul.allow_tf32 = tf32
    alike = [e for e, f in zip(out["bfloat16"]["err_per_sequence"],
                               out["bfloat16"]["flipped_layers"]) if not f]
    out["bfloat16"].update(bound=LM_DECODE_TOL, held_on=len(alike))
    require(all(e < LM_DECODE_TOL for e in alike),
            f"{cfg.name} bf16 decode against the full forward, sequences routed alike: "
            f"{alike} of max |ref| (bound {LM_DECODE_TOL})")
    out["float32"]["bound"] = LM_WIDTH_TOL
    require(all(e < LM_WIDTH_TOL for e in out["float32"]["err_per_sequence"]),
            f"{cfg.name} float32 decode against the full forward: "
            f"{out['float32']['err_per_sequence']} of max |ref| (bound {LM_WIDTH_TOL})")
    return out


def _lm_inputs(cfg, prompt, frames) -> dict:
    """A prefill's batch: the tokens, and Whisper's frame embeddings."""
    return {"tokens": prompt, **({"frame_embeds": frames} if frames is not None else {})}


def _full_forward_logits(params, cfg, tokens, frames, chunk: int):
    """The last position's logits of a forward over ``tokens`` without a
    cache (Whisper: its encoder over ``frames``, then the decoder)."""
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W
    if cfg.family == "audio":
        enc = W.encode(params, cfg, frames, chunk=chunk)
        hid, _ = W.decode(params, cfg, tokens, enc_out=enc, chunk=chunk)
        return W.lm_head(params, hid[:, -1:])
    hid, _, _ = T.forward(params, cfg, tokens, chunk=chunk)
    return T.lm_head(params, cfg, hid[:, -1:])


def _cache_bytes(cache) -> int:
    leaves = [t for v in cache.values() for t in (v.values() if isinstance(v, dict) else [v])]
    return sum(t.numel() * t.element_size() for t in leaves)


def _decode_vs_full(model, params, inputs, prompt, first, frames):
    """The decode of ``first`` after a prefill of ``inputs`` against the
    full forward over the prompt and ``first``: (max |Δ| / max |ref| of the
    logits, the full forward's logits)."""
    import torch
    B, P = prompt.shape
    enc = {"enc_seq": frames.shape[1]} if frames is not None else {}
    c1 = model.init_cache(B, P + 1, **enc, device=C.DEVICE)
    model.prefill(params, inputs, c1)
    logits_d, _ = model.decode_step(params, c1, {"token": first, "index": P})
    del c1
    ref = _full_forward_logits(params, model.cfg, torch.cat([prompt, first], 1), frames,
                               model.chunk)
    return rel_err(logits_d, ref), ref


def float32_decode_check(torch, model, params, prompt, first, frames, ref_bf16,
                         err_bf16: float) -> dict:
    """LM_DECODE_FLOAT32: the weights cast to float32 in place (TF32 off),
    the decode against the full forward held within LM_WIDTH_TOL; the bf16
    full forward's distance from the float32 one (the bf16 noise floor)
    printed beside it."""
    from repro_torch.models import build_model
    cfg = model.cfg.scaled(dtype="float32")
    params.float()
    m32 = build_model(cfg, max_seq=model.max_seq, chunk=model.chunk)
    f32 = None if frames is None else frames.float()
    err, ref = no_tf32(torch, lambda: _decode_vs_full(
        m32, params, _lm_inputs(cfg, prompt, f32), prompt, first, f32))
    floor = rel_err(ref_bf16, ref)
    log(f"[lm] {cfg.name} decode of token {prompt.shape[1] + 1} against the full forward: "
        f"bf16 {err_bf16:.3e} of max |ref| (not held: the bf16 full forward is {floor:.3e} "
        f"from the float32 one), float32 {err:.3e} (bound {LM_WIDTH_TOL})")
    require(err < LM_WIDTH_TOL, f"{cfg.name} float32 decode against the full forward: "
            f"{err:.3e} of max |ref| (bound {LM_WIDTH_TOL})")
    return {"max_abs_err_over_max_ref": err, "bound": LM_WIDTH_TOL,
            "bf16_full_vs_float32_full": floor, "batch": prompt.shape[0]}


def memory_check(torch, what: str, fn, predicted: float) -> dict:
    """``fn()`` once on the card: the caching allocator's high-water mark
    above what was allocated just before it (``max_memory_allocated`` after
    ``reset_peak_memory_stats``) against ``predicted``, the memory model's
    ``temp`` for the step (``utils/memory.py``); a miss beyond MEMORY_TOL
    fails the run."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    del out
    ratio = predicted / rise
    log(f"[memory] {what}: predicted {predicted / 2**30:.3f} / allocator {rise / 2**30:.3f} "
        f"GiB (ratio {ratio:.4f})")
    require(abs(ratio - 1) <= MEMORY_TOL,
            f"{what}: the memory model's {predicted:.0f} bytes against the allocator's "
            f"{rise} (ratio {ratio:.4f}, bound {MEMORY_TOL})")
    return {"predicted_bytes": predicted, "allocator_bytes": rise, "ratio": ratio}


def lm_memory_checks(torch, model, params, inputs, B: int, P: int, G: int) -> dict:
    """A prefill of B x P into a fresh cache of P + G and the decode step at
    index P after it, each against ``memory.lm_step_memory``."""
    from repro_torch.utils import memory
    cfg = model.cfg
    enc = {"enc_seq": P} if cfg.family == "audio" else {}
    cache = model.init_cache(B, P + G, **enc, device=C.DEVICE)
    kw = {"enc_seq": P, "chunk": model.chunk}
    out = {"prefill": memory_check(
        torch, f"{cfg.name} prefill {B}x{P}",
        lambda: model.prefill(params, inputs, cache),
        memory.lm_step_memory(cfg, B, P, P + G, **kw).temp)}
    token = inputs["tokens"][:, :1]
    out["decode"] = memory_check(
        torch, f"{cfg.name} decode B={B} at {P}",
        lambda: model.decode_step(params, cache, {"token": token, "index": P}),
        memory.lm_step_memory(cfg, B, 1, P + G, **kw).temp)
    del cache
    return out


class FullModel:
    """``arch`` at full width and depth in bf16 on the card at
    LM_FULL_SHAPES[arch] = (B, P, G): its model, parameters (drawn on the
    card from the seed) and prompt (Whisper: P frames too)."""

    def __init__(self, torch, arch: str):
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.utils import roofline as R
        self.arch = arch
        self.cfg = cfg = get_config(arch)
        self.B, self.P, self.G = B, P, G = LM_FULL_SHAPES[arch]
        self.model = build_model(cfg, max_seq=P + G, chunk=min(512, P))
        self.counts = R.lm_param_counts(cfg, max_dec_seq=self.model.max_seq)
        self.bpe = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
        self.audio = cfg.family == "audio"
        t0 = time.perf_counter()
        self.params = self.model.init_params(
            torch.Generator(C.DEVICE).manual_seed(C.SEED), C.DEVICE)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self.n_padded = sum(p.numel() for p in self.params.parameters())
        gen = torch.Generator(C.DEVICE).manual_seed(C.SEED + 1)
        self.prompt = torch.randint(0, cfg.vocab_size, (B, P), device=C.DEVICE, generator=gen)
        self.frames = (0.1 * torch.randn((B, P, cfg.d_model), device=C.DEVICE, generator=gen)
                       ).to(getattr(torch, cfg.dtype)) if self.audio else None
        self.inputs = _lm_inputs(cfg, self.prompt, self.frames)
        self.enc = {"enc_seq": P} if self.audio else {}

    def cache(self):
        return self.model.init_cache(self.B, self.P + self.G, **self.enc, device=C.DEVICE)

    def decode(self, cache, token, index: int):
        import torch
        logits, _ = self.model.decode_step(self.params, cache, {"token": token, "index": index})
        return logits, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    def describe(self) -> dict:
        out = {"arch": self.arch, "dtype": self.cfg.dtype, "layers": self.cfg.n_layers,
               "params_real": self.counts["total"], "params_padded": self.n_padded,
               "param_bytes_real": self.counts["total"] * self.bpe,
               "param_bytes_padded": self.n_padded * self.bpe, "init_s": self.init_s}
        log(f"[lm] {self.arch} bf16, {self.cfg.n_layers} layers: "
            f"{self.counts['total'] / 1e9:.3f} B params real "
            f"({out['param_bytes_real'] / 1e9:.2f} GB), {self.n_padded / 1e9:.3f} B padded "
            f"({out['param_bytes_padded'] / 1e9:.2f} GB); init on the card {self.init_s:.2f}s")
        return out


def lm_full_check(torch, arch: str) -> dict:
    """One prefill and G greedy decode steps (the last logits finite), the
    memory model against the allocator, and the decode of token P + 1
    against a full forward over it (a MoE arch at capacity_factor =
    n_experts on LM_MOE_CHECK_BATCH sequences; LM_DECODE_FLOAT32 in
    float32)."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fm = FullModel(torch, arch)
        cfg, B, P, G = fm.cfg, fm.B, fm.P, fm.G
        out = fm.describe()
        cache = fm.cache()
        out["kv_cache_bytes"] = _cache_bytes(cache)
        logits, _ = fm.model.prefill(fm.params, fm.inputs, cache)
        first = token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(G):
            logits, token = fm.decode(cache, token, P + i)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(logits).all()), f"{arch} decode logits are not finite")
        del cache
        if cfg.moe is None:
            decode_err, ref = _decode_vs_full(fm.model, fm.params, fm.inputs, fm.prompt,
                                              first, fm.frames)
            check = {"max_abs_err_over_max_ref": decode_err, "bound": LM_DECODE_TOL,
                     "batch": B}
            if arch not in LM_DECODE_FLOAT32:
                require(decode_err < LM_DECODE_TOL,
                        f"{arch} bf16 decode of token {P + 1} against the full forward: "
                        f"{decode_err:.3e} of max |ref| (bound {LM_DECODE_TOL})")
                log(f"[lm] {arch} decode of token {P + 1} against the full forward over "
                    f"{P + 1}: {decode_err:.3e} of max |ref| (bound {LM_DECODE_TOL})")
        peak = torch.cuda.max_memory_allocated()
        out["memory_model"] = lm_memory_checks(torch, fm.model, fm.params, fm.inputs, B, P, G)
        if cfg.moe is not None:
            check = moe_decode_check(torch, fm.params, cfg, fm.prompt, first, fm.model.chunk)
        elif arch in LM_DECODE_FLOAT32:
            check = {"bfloat16": {**check, "held": False},
                     "float32": float32_decode_check(torch, fm.model, fm.params, fm.prompt,
                                                     first, fm.frames, ref, decode_err)}
        del fm
    torch.cuda.empty_cache()
    out.update(decode_vs_full=check, peak_bytes=peak, peak_bytes_above_baseline=peak - base,
               batch=B, prompt=P, decode_steps=G)
    if cfg.moe is not None:
        out["capacity_factor"] = {"prefill_and_decode": cfg.moe.capacity_factor,
                                  "decode_vs_full": float(cfg.moe.n_experts)}
    log(f"[lm] {arch} peak device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
        f"GiB above the phase's baseline); cache {out['kv_cache_bytes'] / 1e9:.3f} GB")
    return out


def _serve_cli(arch: str) -> list:
    b, plen, gen = LM_SERVE_RUNS[arch]
    return ["--arch", arch, "--batch", b, "--prompt-len", plen, "--gen", gen]


def _serve_result(arch: str, proc) -> dict:
    """The serve subprocess exited 0 and printed its ``[serve]`` line."""
    b, _, gen = LM_SERVE_RUNS[arch]
    args = " ".join(map(str, _serve_cli(arch)))
    o, _, t = proc.result()
    lines = [x for x in o.splitlines() if x.startswith("[serve] generated ")]
    require(len(lines) == 1 and f"generated {b * gen} tokens" in lines[0],
            f"`serve {args}` printed no [serve] line:\n{o}")
    return {"args": args, "line": lines[0], "process_s": t}


def lm(ctx) -> None:
    """Phase 19: the width checks in float32 (TF32 off), the serve
    subprocesses side by side, the full models in process. Sets the ``lm``
    JSON line's object, keyed by arch."""
    torch = ctx.torch
    t_phase = time.perf_counter()
    width = no_tf32(torch, lambda: {name: lm_width_check(torch, name)
                                    for name in LM_WIDTH_LAYERS})
    torch.cuda.empty_cache()
    procs = {arch: C.launch(_serve_cli(arch), f"lm serve {arch}", module="serve",
                            threads=C.SIDE_THREADS) for arch in LM_SERVE_RUNS}
    serve = {}
    for arch, proc in procs.items():
        serve[arch] = _serve_result(arch, proc)
        log(f"[lm] `serve {serve[arch]['args']}` exited 0 (process {serve[arch]['process_s']:.1f}s "
            f"beside the others)")
    full = {arch: lm_full_check(torch, arch) for arch in LM_FULL_ARCHS}
    dt = time.perf_counter() - t_phase
    ctx.lines["lm"] = {"card": ctx.env["smi"], "width_check_float32": width,
                       "serve_cli": serve, "full_model": full, "phase_s": dt}


# ---------------------------------------------------------------------------
# Timing runs (scripts/chip_times.py)
# ---------------------------------------------------------------------------


def lm_full_times(torch, arch: str) -> dict:
    """The prefill of B x P (CUDA events, median of LM_PREFILL_ITERS after a
    warm-up) and G greedy decode steps at index P + i (CUDA events around
    each step: decode_step and the argmax), each against its bound from
    ``utils/roofline.py``; a device profile of one prefill and of
    LM_PROFILE_STEPS decode steps."""
    from repro_torch.utils import roofline as R
    torch.cuda.empty_cache()
    with torch.inference_mode():
        fm = FullModel(torch, arch)
        cfg, B, P, G = fm.cfg, fm.B, fm.P, fm.G
        cache = fm.cache()

        def prefill():
            return fm.model.prefill(fm.params, fm.inputs, cache)

        prefill_ms = cuda_ms(prefill, iters=LM_PREFILL_ITERS)
        logits, _ = prefill()
        first = token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        events = []
        for i in range(G):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, token = fm.decode(cache, token, P + i)
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
        del cache
        # the device's busy share: one prefill, then LM_PROFILE_STEPS steps
        prof_cache = fm.cache()
        profiles = {}
        for what in ("prefill", "decode"):
            torch.cuda.synchronize()
            with C.device_profiler(torch) as prof:
                t0 = time.perf_counter()
                if what == "prefill":
                    fm.model.prefill(fm.params, fm.inputs, prof_cache)
                else:
                    tok = first
                    for i in range(min(LM_PROFILE_STEPS, G)):
                        _, tok = fm.decode(prof_cache, tok, P + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            profiles[what] = C.device_profile(prof, wall, top=LM_PROFILE_TOP)
            profiles[what].pop("kernels")
        del prof_cache, fm
    torch.cuda.empty_cache()
    kw = {"enc_seq": P, "chunk": min(512, P)}
    pre = R.lm_step_roofline(cfg, B, P, P, **kw)
    dec = [R.lm_step_roofline(cfg, B, 1, P + i + 1, **kw) for i in range(G)]
    med = statistics.median(step_ms)
    out = {
        "arch": arch,
        "prefill": {"batch": B, "prompt": P, "ms": prefill_ms,
                    "tokens_per_s": B * P / (prefill_ms / 1e3),
                    "flops": pre.flops, "model_flops": pre.model_flops,
                    "bound_ms": pre.t_bound * 1e3, "bound_by": pre.bound_by,
                    "hbm_bound_share": pre.t_memory * 1e3 / prefill_ms,
                    "mfu": pre.model_flops / (prefill_ms / 1e3) / R.PEAK_FLOPS_BF16},
        "decode": {"batch": B, "steps": G, "context": [P + 1, P + G],
                   "ms_median": med, "ms_mean": statistics.fmean(step_ms),
                   "ms_min": min(step_ms), "ms_max": max(step_ms),
                   "tokens_per_s": B / (med / 1e3),
                   "hbm_bound_ms_median": statistics.median(r.t_memory for r in dec) * 1e3,
                   "bound_by": dec[G // 2].bound_by,
                   "hbm_bound_share": sum(r.t_memory for r in dec) * 1e3 / sum(step_ms),
                   "mfu": (sum(r.model_flops for r in dec) / (sum(step_ms) / 1e3)
                           / R.PEAK_FLOPS_BF16)},
        "device_profile": {"prefill": profiles["prefill"],
                           f"decode_{min(LM_PROFILE_STEPS, G)}_steps": profiles["decode"]},
    }
    audio = cfg.family == "audio"
    if audio:
        out["prefill"]["encoder_frames"] = P
    log(f"[lm] {arch} prefill {B}x{P}{f' ({P} encoder frames)' if audio else ''}: "
        f"{prefill_ms:.3f} ms (median of {LM_PREFILL_ITERS}), "
        f"{out['prefill']['tokens_per_s']:.0f} tok/s, {pre.flops / 1e12:.3f} TFLOP "
        f"({pre.model_flops / 1e12:.3f} useful), bound {pre.t_bound * 1e3:.3f} ms "
        f"({pre.bound_by}), MFU {out['prefill']['mfu']:.4f}, share of the HBM bound "
        f"{out['prefill']['hbm_bound_share']:.4f}")
    log(f"[lm] {arch} decode B={B}, context {P + 1}..{P + G}: {med:.3f} ms a step (median "
        f"of {G}; mean {out['decode']['ms_mean']:.3f}, min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), {out['decode']['tokens_per_s']:.0f} tok/s; HBM bound "
        f"{out['decode']['hbm_bound_ms_median']:.3f} ms, share "
        f"{out['decode']['hbm_bound_share']:.4f}, MFU {out['decode']['mfu']:.5f}")
    for what, pr in profiles.items():
        log(f"[lm] {arch} device profile, {what}"
            f"{f' ({min(LM_PROFILE_STEPS, G)} steps)' if what == 'decode' else ''}: busy "
            f"{pr['busy_ms']:.3f} of {pr['wall_ms']:.3f} ms wall, idle share "
            f"{pr['idle_share']:.4f}, {pr['n_events']} device events; top kernels "
            f"[name, launches, ms]: {json.dumps(pr['top_kernels'])}")
    return out


def lm_layer_times(torch) -> dict:
    """The new families' layers alone in bf16 at the serve shapes, on one
    layer of random weights (CUDA events, median of LM_PREFILL_ITERS after
    a warm-up; host launch gaps included): OLMoE's MoE FFN whole and its
    routing + dispatch plan at the 8 x 512 prefill and an 8-token decode
    step, RecurrentGemma-9B's RG-LRU scan (gates and the log-depth scan)
    and recurrent block at 4 x 512, xLSTM-1.3B's mLSTM and sLSTM blocks at
    4 x 512 (the sLSTM's 512-step time loop) and one sLSTM decode step, and
    Whisper-base's decoder cross-attention over 512 cached frames at 8
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import rglru as RG
    from repro_torch.models import whisper as W
    from repro_torch.models import xlstm as X
    dt = torch.bfloat16
    dev = C.DEVICE
    gen = torch.Generator(dev).manual_seed(C.SEED)

    def x(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    out = {}

    def timed(name, fn, shape):
        ms = cuda_ms(fn, iters=LM_PREFILL_ITERS)
        out[name] = {"shape": list(shape), "ms": ms}
        log(f"[lm] layer {name} {list(shape)}: {ms:.3f} ms")

    with torch.inference_mode():
        cfg = get_config("olmoe-1b-7b")
        p = M.moe_init(gen, cfg, dt, dev)
        for what, shape in (("prefill", (8, 512, cfg.d_model)), ("decode", (8, 1, cfg.d_model))):
            h = x(*shape)
            T = shape[0] * shape[1]
            timed(f"moe_apply {what}", lambda: M.moe_apply(p, h, cfg), shape)
            timed(f"moe route+dispatch {what}", lambda: M.dispatch(
                M.route(p, h.reshape(T, -1), cfg)[2], cfg.moe.n_experts, M.capacity(T, cfg)),
                shape)
        del p
        cfg = get_config("recurrentgemma-9b")
        p = RG.rglru_init(gen, cfg.d_model, cfg.lru_width, cfg.conv_width, dt, dev)
        h = x(4, 512, cfg.lru_width)
        timed("rglru_scan prefill", lambda: RG.rglru_scan(p, h), h.shape)
        h = x(4, 512, cfg.d_model)
        timed("rec_block_apply prefill", lambda: RG.rec_block_apply(p, h), h.shape)
        del p
        cfg = get_config("xlstm-1.3b")
        p = X.mlstm_init(gen, cfg.d_model, cfg.n_heads, cfg.conv_width, dt, dev)
        h = x(4, 512, cfg.d_model)
        timed("mlstm_block_apply prefill", lambda: X.mlstm_block_apply(p, h, cfg.n_heads), h.shape)
        p = X.slstm_init(gen, cfg.d_model, cfg.n_heads, dt, dev)
        timed("slstm_block_apply prefill (512-step loop)",
              lambda: X.slstm_block_apply(p, h, cfg.n_heads), h.shape)
        st = {k: torch.zeros((4, cfg.d_model), device=dev) for k in X.SLSTM_STATE}
        h1 = x(4, 1, cfg.d_model)
        timed("slstm_block_apply decode", lambda: X.slstm_block_apply(
            p, h1, cfg.n_heads, cache=st, decode=True), h1.shape)
        del p
        cfg = get_config("whisper-base")
        p = W._dec_block_init(gen, cfg, dt, dev)["cross_attn"]
        ck, cv = W.cross_kv(p, x(8, 512, cfg.d_model))
        h = x(8, 1, cfg.d_model)
        timed("whisper cross-attention decode (512 frames)",
              lambda: W._cross_attn(p, h, ck, cv, 512), h.shape)
    return out


def times_lm(ctx) -> dict:
    """Each serve subprocess alone, one after another ([serve] tok/s), each
    full model timed, the new families' layers alone."""
    torch = ctx.torch
    serve = {}
    for arch in LM_SERVE_RUNS:
        serve[arch] = _serve_result(arch, C.launch(_serve_cli(arch), f"lm serve {arch}",
                                                   module="serve"))
        log(f"[lm] `serve {serve[arch]['args']}` (process {serve[arch]['process_s']:.1f}s): "
            f"{serve[arch]['line']}")
    full = {arch: lm_full_times(torch, arch) for arch in LM_FULL_ARCHS}
    return {"serve_cli": serve, "full_model": full, "layers_bf16": lm_layer_times(torch)}
