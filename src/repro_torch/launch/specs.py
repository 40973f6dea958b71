"""Input specs (``meta`` tensors) + sharding trees per cell.

Counterpart of ``repro.launch.specs``. ``make_cell(arch, shape, mesh=...)``
builds every input a step function takes — params, optimizer state, batch,
KV/state caches — as tensors on the ``meta`` device (shapes and dtypes, no
memory), plus the matching partition-spec trees. Where the reference
builds ``ShapeDtypeStruct``s by ``eval_shape``, the port calls its own
constructors on ``meta``: ``Model.param_specs()``, ``adamw_init`` on them,
``init_cache(..., device="meta")``. The spec trees are in the reference's
layout (``distributed/sharding.py``) and equal the reference's leaf for
leaf; the mesh is read only for ``axis_names`` and ``shape``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable
from repro_torch.distributed import sharding as shard_rules
from repro_torch.distributed.sharding import P
from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import TrainState
from repro_torch.utils.treeutil import tree_bytes

N_VISION_TOKENS = 256       # VLM stub: image patches at the sequence head
META = torch.device("meta")


@dataclasses.dataclass
class CellSpecs:
    model: Model
    kind: str                     # train | prefill | decode
    args: tuple                   # meta-tensor trees, the step fn's args
    in_specs: tuple               # PartitionSpec trees (reference layout)
    donate: tuple                 # argnums the step may overwrite
    arg_bytes: int                # global bytes of all args
    n_params: float
    n_params_active: float
    tokens_per_step: float


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        b = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            b["targets"] = _meta((B, S), torch.int32)
            b["mask"] = _meta((B, S), torch.float32)
        if cfg.family == "audio":
            b["frame_embeds"] = _meta((B, S, cfg.d_model), act)
        if cfg.family == "vlm":
            b["vision_embeds"] = _meta((B, N_VISION_TOKENS, cfg.d_model), act)
            b["positions3"] = _meta((3, B, S), torch.int32)
        return b
    # decode
    b = {"token": _meta((B, 1), torch.int32), "index": _meta((), torch.int32)}
    if cfg.family == "vlm":
        b["positions3"] = _meta((3, B, 1), torch.int32)
    return b


def count_params(cfg: ArchConfig, param_specs_tree) -> tuple[float, float]:
    """(total, active) parameter counts from the (meta) parameter tree."""
    total = expert = 0
    for names, leaf in shard_rules.tree_items(param_specs_tree):
        n = float(np.prod(leaf.shape))
        total += n
        if cfg.moe is not None and "ffn" in names and "shared" not in names \
                and leaf.ndim >= 4:
            expert += n
    active = total
    if cfg.moe is not None and expert:
        active = total - expert + expert * (cfg.moe.top_k / cfg.moe.n_experts)
    return total, active


def _fields(tree):
    """``tree`` with each ``TrainState`` as the tuple of its fields (the
    form ``treeutil`` walks)."""
    if isinstance(tree, TrainState):
        return tuple(_fields(x) for x in (tree.params, tree.opt, tree.step, tree.grad_err))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fields(x) for x in tree)
    return tree


def make_cell(arch: str, shape_name: str, *, mesh, n_microbatches: int = 4,
              remat: bool = True, chunk: int = 1024) -> CellSpecs:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell {arch} x {shape_name} skipped: {reason}")

    da = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    model_size = mesh.shape["model"]

    is_train = shape.kind == "train"
    model = build_model(cfg, max_seq=shape.seq_len,
                        chunk=chunk, remat=remat and is_train)

    params = model.param_specs()
    p_specs = shard_rules.param_pspecs(params, moe=cfg.moe is not None)
    p_specs = shard_rules.enforce_divisibility(p_specs, params, mesh)
    n_total, n_active = count_params(cfg, params)

    b_meta = batch_specs(cfg, shape)
    b_specs = shard_rules.batch_pspecs(b_meta, data_axes=da)
    b_specs = shard_rules.enforce_divisibility(b_specs, b_meta, mesh)
    if is_train:
        opt = adamw_init(params)
        state = TrainState(params=params, opt=opt, step=_meta((), torch.int32),
                           grad_err=None)
        opt_specs = shard_rules.opt_state_pspecs(
            params, p_specs, data_axis=da[-1], mesh_axis_size=mesh.shape[da[-1]])
        opt_specs = shard_rules.enforce_divisibility(opt_specs, opt, mesh)
        state_specs = TrainState(params=p_specs, opt=opt_specs, step=P(),
                                 grad_err=None)
        args = (state, b_meta)
        in_specs = (state_specs, b_specs)
        donate = (0,)
        tokens = shape.global_batch * shape.seq_len
    else:
        cache_kw = {"enc_seq": shape.seq_len} if cfg.family == "audio" else {}
        cache = model.init_cache(shape.global_batch, shape.seq_len, **cache_kw,
                                 device=META)
        c_specs = shard_rules.cache_pspecs(cache, data_axes=da, model_size=model_size)
        c_specs = shard_rules.enforce_divisibility(c_specs, cache, mesh)
        if shape.kind == "prefill":
            args = (params, b_meta, cache)
            in_specs = (p_specs, b_specs, c_specs)
            donate = (2,)
            tokens = shape.global_batch * shape.seq_len
        else:
            args = (params, cache, b_meta)
            in_specs = (p_specs, c_specs, b_specs)
            donate = (1,)
            tokens = shape.global_batch  # one token per sequence

    return CellSpecs(
        model=model, kind=shape.kind, args=args, in_specs=in_specs,
        donate=donate, arg_bytes=tree_bytes(_fields(args)),
        n_params=n_total, n_params_active=n_active, tokens_per_step=tokens)


def make_step_fn(cell: CellSpecs, *, n_microbatches: int = 4):
    """The cell's step function: the train step (AdamW in place on the
    state), ``Model.prefill`` or ``Model.decode_step``. A decode batch's
    ``index`` may be a 0-dim tensor; it is read as the Python int that
    ``decode_step`` takes."""
    model = cell.model
    if cell.kind == "train":
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.step import make_train_step
        return make_train_step(model, AdamWConfig(), n_microbatches=n_microbatches)
    if cell.kind == "prefill":
        def prefill_step(params, batch, cache):
            return model.prefill(params, batch, cache)
        return prefill_step

    def serve_step(params, cache, batch):
        index = batch["index"]
        if isinstance(index, torch.Tensor):
            batch = {**batch, "index": int(index)}
        return model.decode_step(params, cache, batch)
    return serve_step
