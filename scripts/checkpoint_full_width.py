"""Time a full-width, full-depth LM checkpoint save and sharded restore on
the card.

    python3 scripts/checkpoint_full_width.py [--arch llama3.2-3b] [--layers N]
        [--dir build/full_ckpt] [--mesh 2 2]

The arch's train state in its dtype (bf16 params, float32 ``m`` normal and
``v`` uniform from seed 0) is made on the card and written by
``save_checkpoint``; the card's copy is then freed, and
``restore_checkpoint(shardings=...)`` places it on a (data, model) mesh of
entries of the card by ``param_pspecs`` / ``opt_state_pspecs`` and
``enforce_divisibility``. Every restored leaf is gathered and compared bit
for bit with its ``.npy`` on disk; the allocator's requested bytes must
rise by exactly ``_sharded_arg_bytes`` x entries. Prints the card's name
and power limit, then one JSON line: save and restore seconds and GB/s.
The checkpoint (~34 GB for Llama-3.2-3B) is deleted at the end; free disk
space is checked first. Needs a GPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=None, help="default: the full depth")
    ap.add_argument("--dir", default=str(ROOT / "build" / "full_ckpt"))
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU: torch.cuda.is_available() is false")
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch.dryrun import _sharded_arg_bytes
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState
    from repro_torch.utils.treeutil import tree_bytes, tree_leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    model = build_model(cfg)
    dev = torch.empty(0, device="cuda").device
    g = torch.Generator(dev).manual_seed(0)
    params = model.init_params(g, dev)
    opt = adamw_init(params)
    for m, v in zip(tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        m.normal_(generator=g)
        v.uniform_(generator=g)
    state = TrainState(params, opt, torch.tensor(1, dtype=torch.int32, device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    state_bytes = tree_bytes([params, opt["m"], opt["v"]]) + 4
    ckpt = Path(args.dir)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(ckpt.parent).free
    print(f"{cfg.name}: {cfg.n_layers} layers, {n_params:,} parameters, "
          f"{state_bytes / 1e9:.2f} GB of state; {free / 1e9:.1f} GB free", flush=True)
    if free < 1.1 * state_bytes:
        raise SystemExit(f"{free / 1e9:.1f} GB free for {state_bytes / 1e9:.2f} GB")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(str(ckpt), 1, state)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        del state, params, opt, m, v
        gc.collect()
        torch.cuda.empty_cache()

        mesh = make_mesh(tuple(args.mesh), ("data", "model"),
                         devices=[dev] * math.prod(args.mesh))
        meta = model.param_specs()
        target = TrainState(meta, adamw_init(meta),
                            torch.empty((), dtype=torch.int32, device="meta"))
        p_specs = S.enforce_divisibility(S.param_pspecs(meta), meta, mesh)
        o_specs = S.opt_state_pspecs(meta, p_specs, data_axis="data",
                                     mesh_axis_size=mesh.shape["data"])
        o_specs = S.enforce_divisibility(o_specs, target.opt, mesh)
        per_device = _sharded_arg_bytes((target,), (TrainState(p_specs, o_specs, S.P(), None),),
                                        mesh)
        shardings = TrainState(S.named_sharding_tree(mesh, p_specs),
                               S.named_sharding_tree(mesh, o_specs),
                               S.NamedSharding(mesh, S.P()), None)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        t0 = time.perf_counter()
        restored = restore_checkpoint(str(ckpt), 1, target, shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        after = torch.cuda.memory_stats()["requested_bytes.all.current"]
        placed = [x for _, x in S.tree_items(restored)]
        shard_bytes = sum(t.numel() * t.element_size() for x in placed for t in x.shards.flat)
        manifest = json.loads((Path(path) / "manifest.json").read_text())
        t0 = time.perf_counter()
        bit_equal = len(placed) == len(manifest["leaves"])
        for x, meta_leaf in zip(placed, manifest["leaves"]):
            disk_arr = np.load(Path(path) / meta_leaf["file"])
            got = x.full("cpu")
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16).numpy().view(np.uint16)
            else:
                got = got.numpy()
            bit_equal = bit_equal and np.array_equal(got, disk_arr)
        check_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    entries = math.prod(args.mesh)
    out = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers, "parameters": n_params,
           "state_bytes": state_bytes, "disk_bytes": disk, "leaves": len(placed),
           "save_s": save_s, "save_GB_per_s": disk / save_s / 1e9,
           "restore_s": restore_s, "restore_GB_per_s": disk / restore_s / 1e9,
           "mesh": mesh.shape, "per_device_bytes": per_device, "shard_bytes": shard_bytes,
           "requested_rise": after - before,
           "bit_equal_to_disk": bit_equal, "check_s": check_s}
    print(json.dumps(out), flush=True)
    ok = bit_equal and shard_bytes == per_device * entries == after - before
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
