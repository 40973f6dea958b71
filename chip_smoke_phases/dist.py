"""Phase 21: LM distribution, after phase 20; it launches none of the five
kernels.

21. (a) ``distributed.pipeline_forward``: Llama-3.2-3B blocks at full width
    (heads padded as the config pads them) cut to 8 layers, 4 stages of 2
    layers on 4 entries of the card, 8 micro-batches of 1 x 512, float32
    with TF32 off, ``transformer.apply_block`` per layer, against the
    sequential loop over the same 8 blocks within 1e-3 of max |ref|. (b)
    elastic: an 8 x 8 tensor on a (4, 2) mesh of 8 card entries, 2 entries
    lost, ``remesh`` to (3, 2), ``reshard_tree``: the shard shapes the CPU
    test pins, bit-equal after ``full()``. (c) the Llama-3.2-3B bf16 train
    state at full width cut to CKPT_LAYERS layers (params, ``m`` normal,
    ``v`` uniform) saved, then ``restore_checkpoint(shardings=...)`` onto a
    (data 2, model 2) mesh of 4 card entries by ``param_pspecs`` /
    ``opt_state_pspecs`` and ``enforce_divisibility``: every leaf bit-equal
    after ``full()``, the shards' bytes equal to ``dryrun._sharded_arg_bytes``
    x 4 entries, and the allocator's rise in requested bytes equal to them.
    (d) ``python -m repro_torch.launch.dryrun --all --both-meshes`` as a
    subprocess (started with the phase): 80 records, 64 ``ok`` (each with
    its per-chip work and collectives, no null in ``per_chip`` or
    ``roofline``) and 16 ``skipped``.

``times_dist`` (the pipeline and the sequential loop in CUDA events; the
checkpoint's save and restore seconds and GB/s at CKPT_TIME_LAYERS layers,
scaled to the 28-layer state) is scripts/chip_times.py's.
"""
from __future__ import annotations

import gc
import json
import math
import shutil
import time

from . import common as C
from .common import cuda_ms, log, rel_err, require
from .lm import no_tf32

DIST_ARCH = "llama3.2-3b"
PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_SEQ = 8, 4, 8, 1, 512
PIPE_TOL = 1e-3          # max |Δ| / max |ref| of the pipeline's output, float32
PIPE_ITERS = 3
# The check's state is cut to 2 layers (the sharded restore runs every leaf
# kind at full width); the timing run saves and restores 4.
CKPT_LAYERS, CKPT_MESH, CKPT_STEP = 2, (2, 2), 7
CKPT_TIME_LAYERS = 4
DIST_CKPT_DIR = C.BUILD / "smoke_dist_ckpt"
DRYRUN_DIR = C.BUILD / "smoke_dryrun"


class Pipeline:
    """The GPipe schedule over 4 entries of the card and the sequential loop
    over the same blocks, float32."""

    def __init__(self, torch):
        from repro_torch.configs import get_config
        from repro_torch.distributed.pipeline import pipeline_forward
        from repro_torch.models import build_model
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        self.cfg = cfg = get_config(DIST_ARCH).scaled(n_layers=PIPE_LAYERS, dtype="float32")
        dev = torch.empty(0, device=C.DEVICE).device      # with its index
        g = torch.Generator(C.DEVICE).manual_seed(C.SEED)
        params = build_model(cfg, max_seq=PIPE_SEQ, chunk=PIPE_SEQ).init_params(g, dev)
        blocks = list(zip(params.blocks, params.layout))
        per = PIPE_LAYERS // PIPE_STAGES
        stages = [blocks[s * per:(s + 1) * per] for s in range(PIPE_STAGES)]
        positions = torch.arange(PIPE_SEQ, device=dev)[None].expand(PIPE_MB, PIPE_SEQ)
        cos_sin = L.rope_cos_sin(cfg, positions)

        def layer_fn(stage_blocks, h):
            for p, btype in stage_blocks:
                h, _, _ = T.apply_block(p, h, btype, cfg, cos_sin, chunk=PIPE_SEQ)
            return h

        x = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.d_model), generator=g, device=dev)
        devices = [dev] * PIPE_STAGES
        self.piped = lambda: pipeline_forward(layer_fn, stages, x, n_stages=PIPE_STAGES,
                                              n_micro=PIPE_MICRO, devices=devices)
        self.sequential = lambda: torch.stack([layer_fn(blocks, x[m])
                                               for m in range(PIPE_MICRO)])


def dist_pipeline(torch) -> dict:
    """(a) The pipeline against the sequential loop, TF32 off."""
    with torch.no_grad():
        pl = Pipeline(torch)
        got, ref = pl.piped(), pl.sequential()
        torch.cuda.synchronize()
    err = rel_err(got, ref)
    out = {"shape": list(got.shape), "rel_err": err, "layers": PIPE_LAYERS,
           "stages": PIPE_STAGES, "micro": PIPE_MICRO, "micro_batch": [PIPE_MB, PIPE_SEQ],
           "d_model": pl.cfg.d_model, "n_heads": pl.cfg.n_heads}
    log(f"[dist] pipeline: {json.dumps(out)}")
    require(tuple(got.shape) == (PIPE_MICRO, PIPE_MB, PIPE_SEQ, pl.cfg.d_model)
            and math.isfinite(err) and err <= PIPE_TOL,
            f"pipeline_forward against the sequential loop: {out}")
    return out


def dist_elastic(torch) -> dict:
    """(b) tests/test_torch_pipeline_elastic.py's elastic case on 8 entries
    of the card: the shard shapes it pins, bit-equal after ``full()``."""
    from repro_torch.distributed import elastic
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import P
    dev = torch.empty(0, device=C.DEVICE).device      # with its index
    mesh = make_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
    x = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
    specs = {"w": P("data", "model")}
    sharded = elastic.reshard_tree({"w": x}, specs, mesh)
    new_mesh = elastic.remesh(elastic.simulate_node_failure(mesh, n_lost_nodes=2),
                              model_axis_size=2)
    resharded = elastic.reshard_tree(sharded, specs, new_mesh)
    shapes = {k: sorted({tuple(t.shape) for t in v["w"].shards.flat})
              for k, v in (("initial", sharded), ("resharded", resharded))}
    on_card = all(t.device == dev for v in (sharded, resharded) for t in v["w"].shards.flat)
    out = {"new_mesh": new_mesh.shape, "shard_shapes": shapes,
           "spec_after": list(resharded["w"].spec), "on_card": on_card,
           "bit_equal": bool(torch.equal(resharded["w"].full(dev), x)
                             and torch.equal(sharded["w"].full(dev), x))}
    log(f"[dist] elastic: {json.dumps(out)}")
    require(out["bit_equal"] and on_card and new_mesh.shape == {"data": 3, "model": 2}
            and shapes == {"initial": [(2, 4)], "resharded": [(8, 4)]},
            f"elastic remesh and reshard: {out}")
    return out


def _requested_bytes(torch) -> int:
    """The bytes the caching allocator's live blocks were requested for."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dist_checkpoint(torch, layers: int) -> dict:
    """(c) The full-width bf16 train state cut to ``layers`` layers, saved,
    then restored sharded onto a (data 2, model 2) mesh of 4 card entries;
    every leaf bit-equal after ``full()``; the shards' bytes against
    ``_sharded_arg_bytes`` x 4 and the allocator's rise."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch.dryrun import _sharded_arg_bytes
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState
    from repro_torch.utils.treeutil import tree_bytes, tree_leaves
    dev = torch.empty(0, device=C.DEVICE).device      # with its index
    cfg = get_config(DIST_ARCH).scaled(n_layers=layers)
    model = build_model(cfg, max_seq=PIPE_SEQ, chunk=PIPE_SEQ)
    g = torch.Generator(C.DEVICE).manual_seed(C.SEED)
    params = model.init_params(g, dev)
    opt = adamw_init(params)
    for m, v in zip(tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        m.normal_(generator=g)
        v.uniform_(generator=g)
    state = TrainState(params, opt, torch.tensor(CKPT_STEP, dtype=torch.int32, device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    state_bytes = tree_bytes([params, opt["m"], opt["v"]]) + 4
    full_params = sum(p.numel() for p in build_model(get_config(DIST_ARCH)).param_specs()
                      .parameters())
    full_bytes = full_params * (2 + 4 + 4) + 4
    DIST_CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(DIST_CKPT_DIR.parent).free
    log(f"[dist] checkpoint: {layers} layers, {n_params:,} parameters, "
        f"{state_bytes / 1e9:.3f} GB of state; {free / 1e9:.1f} GB free under "
        f"{DIST_CKPT_DIR.parent}")
    require(free > 1.2 * state_bytes, f"{free / 1e9:.1f} GB free for a "
            f"{state_bytes / 1e9:.3f} GB checkpoint")
    shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(DIST_CKPT_DIR), CKPT_STEP, state)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in DIST_CKPT_DIR.rglob("*") if f.is_file())

        mesh = make_mesh(CKPT_MESH, ("data", "model"), devices=[dev] * math.prod(CKPT_MESH))
        meta = model.param_specs()
        target = TrainState(meta, adamw_init(meta),
                            torch.empty((), dtype=torch.int32, device="meta"))
        p_specs = S.enforce_divisibility(S.param_pspecs(meta), meta, mesh)
        o_specs = S.opt_state_pspecs(meta, p_specs, data_axis="data",
                                     mesh_axis_size=mesh.shape["data"])
        o_specs = S.enforce_divisibility(o_specs, target.opt, mesh)
        specs = TrainState(p_specs, o_specs, S.P(), None)
        shardings = TrainState(S.named_sharding_tree(mesh, p_specs),
                               S.named_sharding_tree(mesh, o_specs),
                               S.NamedSharding(mesh, S.P()), None)
        per_device = _sharded_arg_bytes((target,), (specs,), mesh)
        gc.collect()
        torch.cuda.synchronize()
        before = (torch.cuda.memory_allocated(), _requested_bytes(torch))
        t0 = time.perf_counter()
        restored = restore_checkpoint(str(DIST_CKPT_DIR), CKPT_STEP, target, shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rise = torch.cuda.memory_allocated() - before[0]
        requested = _requested_bytes(torch) - before[1]
    finally:
        shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    placed = [x for _, x in S.tree_items(restored)]
    shards = [t for x in placed for t in x.shards.flat]
    shard_bytes = sum(t.numel() * t.element_size() for t in shards)
    entries = math.prod(CKPT_MESH)
    src = [x for _, x in S.tree_items(state)]
    bit_equal = len(src) == len(placed) and all(t.device == dev for t in shards)
    for want, got in zip(src, placed):
        whole = want[:] if isinstance(want, S.Stacked) else want
        bit_equal = bit_equal and got.dtype == whole.dtype and torch.equal(got.full(dev), whole)
        del whole
    out = {"layers": layers, "parameters": n_params, "state_bytes": state_bytes,
           "disk_bytes": disk, "leaves": len(placed), "save_s": save_s,
           "save_GB_per_s": disk / save_s / 1e9, "restore_s": restore_s,
           "restore_GB_per_s": disk / restore_s / 1e9, "mesh": mesh.shape,
           "per_device_bytes": per_device, "shard_bytes": shard_bytes,
           "reckoned_x_entries": per_device * entries, "allocator_rise": rise,
           "allocator_requested_rise": requested, "bit_equal": bit_equal,
           "full_28_layer_state_bytes": full_bytes,
           "full_save_s_scaled": full_bytes / (disk / save_s),
           "full_restore_s_scaled": full_bytes / (disk / restore_s)}
    log(f"[dist] checkpoint save {save_s:.2f}s ({out['save_GB_per_s']:.3f} GB/s), sharded "
        f"restore {restore_s:.2f}s ({out['restore_GB_per_s']:.3f} GB/s) of {disk / 1e9:.3f} GB; "
        f"the 28-layer state ({full_bytes / 1e9:.2f} GB) at these rates: save "
        f"{out['full_save_s_scaled']:.1f}s, restore {out['full_restore_s_scaled']:.1f}s")
    log(f"[dist] checkpoint: {json.dumps(out)}")
    require(bit_equal, "sharded restore is not bit-equal to the saved state")
    require(shard_bytes == per_device * entries,
            f"shards hold {shard_bytes} bytes, _sharded_arg_bytes x {entries} = "
            f"{per_device * entries}")
    # memory_allocated counts the allocator's blocks (each request rounded
    # up to 512 bytes, a block not worth splitting counted whole); its
    # requested bytes count the requests themselves.
    require(requested == shard_bytes,
            f"the allocator's requested bytes rose {requested}, the shards hold {shard_bytes}")
    del restored, placed, shards, src, state, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_dryrun(ctx) -> C.Proc:
    """(d) The restated dry run over every cell and both production meshes."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    ctx.remove_later(DRYRUN_DIR)
    return C.launch(["--all", "--both-meshes", "--out", DRYRUN_DIR],
                    "dryrun --all --both-meshes", module="dryrun", threads=C.SIDE_THREADS)


def dist_dryrun(proc) -> dict:
    o, _, t = proc.result()
    recs = [json.loads(f.read_text()) for f in sorted(DRYRUN_DIR.glob("*.json"))]
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    status = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
    nulls = [(r["arch"], r["shape"], r["mesh"]) for r in recs if r["status"] == "ok" and (
        None in r["per_chip"].values() or None in r["roofline"].values()
        or r["collectives"] is None)]
    require(not nulls, f"dryrun: records with a null work or collective field: {nulls}")
    ok = [r for r in recs if r["status"] == "ok"]
    no_memory = [(r["arch"], r["shape"], r["mesh"]) for r in ok
                 if not isinstance(r.get("memory_analysis"), dict)]
    require(not no_memory, f"dryrun: ok records without memory_analysis: {no_memory}")
    largest = max(ok, key=lambda r: r["memory_analysis"]["peak_bytes"])
    llama = {r["mesh"]: r for r in recs if r["arch"] == DIST_ARCH and r["shape"] == "train_4k"}
    out = {"process_s": t, "records": len(recs), **status,
           "fits": sum(bool(r.get("fits")) for r in recs),
           "fits_by_mesh": {m: sum(bool(r["fits"]) for r in ok if r["mesh"] == m)
                            for m in ("16x16", "2x16x16")},
           "largest_peak": {"arch": largest["arch"], "shape": largest["shape"],
                            "mesh": largest["mesh"],
                            "peak_bytes": largest["memory_analysis"]["peak_bytes"]},
           "llama_train_4k_bytes_per_device": {m: r["arg_bytes_per_device"]
                                               for m, r in llama.items()},
           "device_memory": {r["device_memory_source"]: r["device_memory_bytes"]
                             for r in recs if r["status"] == "ok"}}
    log(f"[dist] dryrun: {len(recs)} records ({status['ok']} ok, {status['skipped']} skipped) "
        f"in {t:.1f}s; {DIST_ARCH} train_4k per-device bytes: "
        + ", ".join(f"{m} {b / 2**30:.3f} GiB ({b:.0f})"
                    for m, b in out["llama_train_4k_bytes_per_device"].items()))
    log(f"[dist] dryrun memory: cells that fit "
        + ", ".join(f"{m} {n} of 32" for m, n in out["fits_by_mesh"].items())
        + f"; largest peak {largest['memory_analysis']['peak_bytes'] / 2**30:.3f} GiB "
        f"({largest['arch']} {largest['shape']} on {largest['mesh']})")
    require(len(recs) == 80 and status == {"ok": 64, "skipped": 16, "error": 0}
            and set(llama) == {"16x16", "2x16x16"} and o.strip().endswith("0 failures"),
            f"dryrun: {out}")
    return out


def dist(ctx) -> None:
    """Phase 21: the pipeline (float32, TF32 off), elastic reshard, the
    sharded checkpoint restore and the dry run. Sets the ``dist`` JSON
    line's object."""
    torch = ctx.torch
    t_phase = time.perf_counter()
    dryrun = ctx.background.pop("dist", None) or start_dryrun(ctx)
    pipe = no_tf32(torch, lambda: dist_pipeline(torch))
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": ctx.env["smi"], "pipeline": pipe, "elastic": dist_elastic(torch),
           "checkpoint": dist_checkpoint(torch, CKPT_LAYERS), "dryrun": dist_dryrun(dryrun)}
    out["phase_s"] = time.perf_counter() - t_phase
    ctx.lines["dist"] = out


def times_dist(ctx) -> dict:
    """The pipeline and the sequential loop (CUDA events, median of
    PIPE_ITERS, TF32 off); the checkpoint at CKPT_TIME_LAYERS layers."""
    torch = ctx.torch

    def timed():
        with torch.no_grad():
            pl = Pipeline(torch)
            return {"pipeline_ms": cuda_ms(pl.piped, iters=PIPE_ITERS),
                    "sequential_ms": cuda_ms(pl.sequential, iters=PIPE_ITERS)}
    out = no_tf32(torch, timed)
    log(f"[dist] pipeline ({PIPE_LAYERS} layers, {PIPE_STAGES} stages on one card, "
        f"{PIPE_MICRO} x {PIPE_MB} x {PIPE_SEQ}, float32): {out['pipeline_ms']:.3f} ms, "
        f"sequential {out['sequential_ms']:.3f} ms (median of {PIPE_ITERS})")
    gc.collect()
    torch.cuda.empty_cache()
    out["checkpoint"] = dist_checkpoint(torch, CKPT_TIME_LAYERS)
    return out
