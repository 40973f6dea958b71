"""Train a ~100M-param model on the PyTorch port through the production
training stack (data pipeline -> AdamW -> async checkpointing -> resume) —
the counterpart of ``examples/train_lm.py`` with the same arguments.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--ckpt-dir DIR] [--device cpu]

Uses the width-reduced llama3.2-family smoke config; the full-size configs
train the same way through ``python -m repro_torch.launch.train --arch
llama3.2-3b``. Runs on the GPU unless ``--device`` names another torch
device. A rerun with the same ``--ckpt-dir`` resumes from its last
checkpoint.
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_example_ckpt"),
                    help="checkpoint directory (default: repro_example_ckpt under $TMPDIR)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without one)")
    args = ap.parse_args(argv)
    return train_launcher.main([
        "--arch", "llama3.2-3b", "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--microbatches", "2",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        *(["--device", args.device] if args.device else []),
    ])


if __name__ == "__main__":
    main()
