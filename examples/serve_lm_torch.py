"""Serve a (reduced) LM on the PyTorch port with prefill + batched greedy
decode and KV caches — the counterpart of ``examples/serve_lm.py`` with the
same arguments.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch mistral-nemo-12b] [--device cpu]

Runs on the GPU unless ``--device`` names another torch device.
"""
import argparse

from repro_torch.launch import serve as serve_launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without one)")
    args = ap.parse_args(argv)
    serve_launcher.main([
        "--arch", args.arch, "--smoke",
        "--batch", "4", "--prompt-len", "32", "--gen", "16",
        *(["--device", args.device] if args.device else []),
    ])


if __name__ == "__main__":
    main()
