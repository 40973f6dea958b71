"""A live-bytes tracker for the memory tests: a ``TorchDispatchMode`` that
counts each storage an op creates from its creation until it is freed, and
keeps the high-water mark of their sum.

An op's output is new when its storage aliases none of the op's inputs (a
view or an in-place op returns an input's storage, which is not counted),
so what existed before the mode was entered (parameters, the batch, the
caches: the step's arguments) never counts. Each new storage is followed
with a weak reference whose callback subtracts it when it is freed, as
``torch.distributed._tools.mem_tracker.MemTracker`` follows storages; the
result is the bytes the step itself brings to life, which is what
``utils/roofline.lm_step_memory`` / ``lm_train_memory`` call ``temp``.

Only the ops that reach the dispatcher are seen: a kernel's own scratch
(cuBLAS workspaces, sort buffers) is not, on the CPU as on the card.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _storages(tree) -> list:
    return [t.untyped_storage() for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.device.type != "meta"]


class LiveBytes(TorchDispatchMode):
    """``with LiveBytes() as mem: step()`` then ``mem.peak``: the most bytes
    of storages created inside the block that were alive at one time;
    ``mem.live`` is what is still alive, ``mem.peak_op`` the op at whose
    output the peak was reached. ``watch``: tensors that existed before
    (arguments the step may drop, as a prefill replaces Whisper's cross
    K/V); their storages count negative once freed, as the allocator sees
    them go."""

    def __init__(self, watch=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.peak_op = None
        self._refs = {}
        for st in _storages(list(watch)):
            key, n = id(st), st.nbytes()
            self._refs[key] = weakref.ref(st, lambda r, k=key, n=n: self._freed(k, n, r))

    def _freed(self, key, nbytes, _ref):
        self._refs.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {s.data_ptr() for s in _storages((args, kwargs)) if s.nbytes()}
        for st in _storages(out):
            n = st.nbytes()
            key = id(st)
            if not n or st.data_ptr() in seen or key in self._refs:
                continue
            self._refs[key] = weakref.ref(st, lambda r, k=key, n=n: self._freed(k, n, r))
            self.live += n
            if self.live > self.peak:
                self.peak, self.peak_op = self.live, str(func)
        return out


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for v in cache.values()
               for t in (v.values() if isinstance(v, dict) else [v]))


def smoke_batch(cfg, B: int, S: int, g) -> dict:
    """Random tokens (and the audio frames, the VLM's vision rows and
    positions) for ``cfg`` from generator ``g``."""
    dt = getattr(torch, cfg.dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn((B, S, cfg.d_model), generator=g).to(dt)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn((B, 4, cfg.d_model), generator=g).to(dt)
        ar = torch.arange(S)
        batch["positions3"] = torch.stack([ar, ar // 2, ar % 3])[:, None, :].expand(
            3, B, S).to(torch.int32).contiguous()
    return batch


def serve_peak(cfg, B: int, P: int, G: int, chunk: int, step: str) -> tuple[int, int]:
    """(the tracker's high-water mark, the arguments' bytes) of one
    ``Model.prefill`` of B x P into a cache of P + G, or of the
    ``decode_step`` at index P after it, on the CPU."""
    from repro_torch.models import build_model
    from repro_torch.utils.treeutil import tree_bytes
    model = build_model(cfg, max_seq=P + G, chunk=chunk)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = smoke_batch(cfg, B, P, torch.Generator().manual_seed(1))
    cache = model.init_cache(B, P + G, enc_seq=P, device="cpu")
    args = tree_bytes(params) + _cache_bytes(cache)
    if step == "prefill":
        watch = [t for v in cache.values() for t in (v.values() if isinstance(v, dict) else [v])]
        with LiveBytes(watch=watch) as mem:
            del watch
            model.prefill(params, batch, cache)
        return mem.peak, args
    model.prefill(params, batch, cache)
    token = {"token": batch["tokens"][:, :1], "index": P}
    if cfg.family == "vlm":
        token["positions3"] = batch["positions3"][:, :, :1].contiguous()
    args = tree_bytes(params) + _cache_bytes(cache)
    with LiveBytes() as mem:
        model.decode_step(params, cache, token)
    return mem.peak, args


def train_peak(cfg, B: int, S: int, chunk: int, *, remat: bool,
               n_microbatches: int = 1) -> tuple[int, int]:
    """(the tracker's high-water mark, the arguments' bytes: params, AdamW
    state and batch) of one ``make_train_step`` step on the CPU."""
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.utils.treeutil import tree_bytes
    model = build_model(cfg, max_seq=S, chunk=chunk, remat=remat)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = smoke_batch(cfg, B, S, torch.Generator().manual_seed(1))
    batch.update(targets=batch["tokens"], mask=torch.ones((B, S)))
    state = TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, AdamWConfig(), n_microbatches=n_microbatches)
    args = tree_bytes(params) + tree_bytes(state.opt["m"]) * 2 + tree_bytes(batch)
    with LiveBytes() as mem:
        step(state, batch)
    return mem.peak, args
