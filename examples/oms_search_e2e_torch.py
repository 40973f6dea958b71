"""End-to-end OMS serving on the PyTorch port: batched query search against
a resident reference DB, then every search backend the port registers, then
a top-k search — the counterpart of ``examples/oms_search_e2e.py`` at the
same sizes.

    PYTHONPATH=src python examples/oms_search_e2e_torch.py [--device cpu]

Runs on the GPU unless ``--device`` names another torch device (on the CPU
the kernel backends run their plain PyTorch versions). Every backend
computes the same function, so every ``[backend ...]`` line reports the
same identifications at 1% FDR.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import backends
from repro_torch.core.pipeline import OMSConfig, OMSPipeline
from repro_torch.data.spectra import LibraryConfig, make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without one)")
    args = ap.parse_args(argv)

    cfg = OMSConfig(dim=2048, max_r=512, q_block=16)
    ds = make_dataset(LibraryConfig(n_refs=8192, n_queries=512, seed=1))
    pipe = OMSPipeline(cfg, ds.refs, device=args.device)
    print(f"[ingest] {pipe.db.n_rows} rows, {pipe.db.n_blocks} blocks")

    def timed(**kw):
        t0 = time.perf_counter()
        out = pipe.search(ds.queries, **kw)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        return out, time.perf_counter() - t0

    # serve several request batches; the DB stays resident (near-storage pattern)
    for batch_id in range(3):
        out, dt = timed()
        print(f"[serve] batch {batch_id}: {len(ds.query_source)} queries in {dt:.2f}s, "
              f"ids={pipe.identifications(out)}")

    # every backend: the packed XOR+popcount tiles, the +-1 dot tiles and the
    # fused single-pass kernels (no (Q, R) score matrix), the same results
    for backend in backends.names():
        out, dt = timed(backend=backend)
        print(f"[backend {backend:10s}] {dt:.2f}s ids={pipe.identifications(out)}")

    # top-k rescoring workload (ANN-SoLo-style): ranked candidate lists per query
    out = pipe.search(ds.queries, top_k=4, backend="fused")
    idx = out.result.open_idx.cpu().numpy()          # (Q, 4), rank 0 = best
    src = np.asarray(ds.query_source)
    print(f"[top-k] recall@1={np.mean(idx[:, 0] == src):.3f} "
          f"recall@4={np.mean((idx == src[:, None]).any(1)):.3f}")


if __name__ == "__main__":
    main()
