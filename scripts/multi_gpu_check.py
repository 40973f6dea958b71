"""Check the port's multi-device OMS across distinct cards, in one process.

    python3 scripts/multi_gpu_check.py

Needs two or more CUDA devices (exits 2 otherwise) and ``nvcc``. The first
card stays the current device throughout, so every launch on another card
goes through the wrappers' device guard (``_build.on_device``):

1. hdencode, hamming_matrix and hamming_mxu on every card, on seeded
   inputs copied to each, bit for bit against the plain version on the
   CPU; the tile kernels also at
   W = 1,024 words, where their staged query words need more than 48 KB of
   dynamic shared memory (the opt-in is per device).
2. ``chip_smoke.py``'s phase 18 (``chip_smoke_phases/multi.py``) at Table I
   scale (the main path's ingest on the first card, the store under
   ``build/``): ``sharded_search`` with the shards on distinct cards (the
   fused kernels' launches there need the shared-memory opt-in too), each
   result bit for bit against the resident search on the first card, and
   the streamed search dealt over distinct cards against the one-card
   streamed result; then the phase's timing runs (``times_multi``: warm
   sharded searches, one shard's search, the merge), where distinct cards
   overlap.

Prints the cards and their power limits, then one JSON object as the last
line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke_phases import common as C  # noqa: E402
from chip_smoke_phases import multi  # noqa: E402
from chip_smoke_phases.context import Context  # noqa: E402
from chip_smoke_phases.oms_kernels import build  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.kernels.hamming import ref as href  # noqa: E402
from repro_torch.kernels.hamming_mxu import ops as mops  # noqa: E402
from repro_torch.kernels.hamming_mxu import ref as mref  # noqa: E402
from repro_torch.kernels.hdencode import ops as hd_ops  # noqa: E402
from repro_torch.kernels.hdencode import ref as hd_ref  # noqa: E402

SEED = 0
HD_SHAPE = dict(B=512, P=64, W=128, F=4096, L=32)
TILE_SHAPES = ((16, 8 * 512 + 3, 128), (16, 4099, 1024))
STORE_DIR = ROOT / "build" / "multi_gpu_store"


def _words(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
                            .view(np.int32))


def _same(name: str, outs) -> None:
    """``outs``: (where, tensor) pairs; every tensor equal to the first."""
    want = outs[0][1].cpu()
    for where, t in outs[1:]:
        C.require(t.dtype == want.dtype and torch.equal(t.cpu(), want),
                   f"{name} on {where} differs from {outs[0][0]}")


def check_kernels(cards: list[torch.device]) -> None:
    rng = np.random.default_rng(SEED)
    s = HD_SHAPE
    hd_args = (torch.from_numpy(rng.integers(0, s["F"], (s["B"], s["P"]), dtype=np.int32)),
               torch.from_numpy(rng.integers(0, s["L"], (s["B"], s["P"]), dtype=np.int32)),
               torch.from_numpy(rng.random((s["B"], s["P"])) < 0.7),
               _words(rng, s["F"], s["W"]), _words(rng, s["L"], s["W"]),
               _words(rng, s["W"]))
    outs = [("cpu (plain)", hd_ref.hdencode(*hd_args))]
    for dev in cards:
        outs.append((str(dev), hd_ops.hdencode(*(a.to(dev) for a in hd_args))))
    _same("hdencode", outs)
    for Q, R, W in TILE_SHAPES:
        q, r = _words(rng, Q, W), _words(rng, R, W)
        for name, kern, plain in (
                ("hamming_matrix", hops.hamming_matrix, href.hamming_matrix),
                ("hamming_mxu", lambda a, b: mops.hamming_matrix(a, b, 32 * W),
                 lambda a, b: mref.hamming_matrix(a, b, 32 * W))):
            outs = [("cpu (plain)", plain(q, r))]
            outs += [(str(d), kern(q.to(d), r.to(d))) for d in cards]
            _same(f"{name} {Q}x{R}x{W}", outs)
    torch.cuda.synchronize()
    C.log(f"[multi-gpu] hdencode {HD_SHAPE}, hamming_matrix and hamming_mxu at "
           f"{TILE_SHAPES} on {[str(d) for d in cards]} (current device cuda:0): "
           f"== the plain versions on the CPU")


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multi_gpu_check: needs two or more CUDA devices", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    for d in cards:
        C.log(f"[multi-gpu] {d}: {torch.cuda.get_device_name(d)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    build()
    check_kernels(cards)

    ctx = Context(torch, store_dir=STORE_DIR)
    try:
        multi.multi_device(ctx)
        times = multi.times_multi(ctx)
    finally:
        ctx.close()
    C.log(f"[multi-gpu] all checks passed in {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"ok": True, "cards": n, "launches_by_path": ctx.by_path,
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
