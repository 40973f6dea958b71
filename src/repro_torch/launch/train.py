"""Training launcher.

Counterpart of ``repro.launch.train``, with the same flags and final line
plus ``--device`` (default: the card, which raises without a GPU; ``cpu``
runs the same code on the host), ``--remat`` (checkpoint each block) and
``--log-every`` (the loop's log period, 10 as in the reference).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        [--steps 200] [--batch 8] [--seq 512] [--smoke] [--device cpu] \\
        [--ckpt-dir ckpt] [--compress-grads] [--microbatches 2]

It runs the real training loop (data pipeline, AdamW, checkpointing,
fault-tolerant resume). ``--mesh`` builds the mesh as the reference does:
``local`` over this host's devices of ``--device``'s type (every CUDA
device, or the one CPU), ``pod`` / ``multipod`` the production (16, 16) /
(2, 16, 16) mesh (``launch/mesh.py``), which raises, naming the count,
unless there are exactly 256 / 512 such devices. Training then runs on
``--device`` (by default the card that is current: the mesh's first), as
the reference's ``jit`` without in_shardings runs on its default device:
the state is not sharded. Weights are random, drawn
on the target device from seed 0.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import reduced_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data.tokens import synthetic_batches
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--mesh", choices=["local", "pod", "multipod"],
                    default="local")
    ap.add_argument("--ckpt-dir", default=LoopConfig.ckpt_dir,
                    help="checkpoint directory (default: repro_ckpt under $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block's activations in the backward pass")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    mesh = {"local": lambda: make_local_mesh(devices=devices),
            "pod": lambda: make_production_mesh(devices=devices),
            "multipod": lambda: make_production_mesh(multi_pod=True, devices=devices),
            }[args.mesh]()
    print(f"[train] mesh {mesh.shape}; the step runs on {dev}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg).scaled(dtype="float32")
    model = build_model(cfg, max_seq=args.seq, chunk=min(1024, args.seq),
                        remat=args.remat)

    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             use_compression=args.compress_grads, device=dev)
    train_step = make_train_step(
        model, AdamWConfig(lr=args.lr), n_microbatches=args.microbatches,
        warmup=min(50, args.steps // 10 + 1), total_steps=args.steps,
        use_compression=args.compress_grads)

    batches = synthetic_batches(cfg, batch=args.batch, seq=args.seq,
                                family=cfg.family, seed=0, device=dev)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, fail_at=args.fail_at,
                          log_every=args.log_every)
    state, stats = run_training(train_step, state, batches, loop_cfg)
    print(f"[train] done at step {stats['final_step']}; "
          f"loss {stats['losses'][0]:.4f} -> {stats['losses'][-1]:.4f}; "
          f"stragglers={stats['stragglers']}")
    return stats


if __name__ == "__main__":
    main()
