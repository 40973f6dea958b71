"""Quickstart on the PyTorch port: the paper's pipeline end to end, the
counterpart of ``examples/quickstart.py`` at the same sizes.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the GPU unless ``--device`` names another torch device; on the CPU
the kernels' plain PyTorch versions run, and the lines printed equal the
JAX quickstart's.
"""
import argparse

import numpy as np

from repro_torch.core.pipeline import OMSConfig, OMSPipeline
from repro_torch.data.spectra import LibraryConfig, make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without one)")
    args = ap.parse_args(argv)

    # 1. A synthetic spectral library calibrated to the paper's Table I stats
    #    (scaled down) with planted post-translational modifications.
    dataset = make_dataset(LibraryConfig(n_refs=4096, n_queries=256, seed=0))

    # 2. Ingest: preprocess + HD-encode references (+ decoys), build the
    #    PMZ-sorted blocked DB — the paper's one-time near-storage step.
    cfg = OMSConfig(dim=4096, max_r=512, q_block=16, open_tol_da=75.0)
    pipe = OMSPipeline(cfg, dataset.refs, device=args.device)
    print(f"ingested {pipe.db.n_rows} rows into {pipe.db.n_blocks} blocks")

    # 3. Search: encode queries, blocked dual-window Hamming search, FDR filter.
    out = pipe.search(dataset.queries)

    src = np.asarray(dataset.query_source)
    mod = np.asarray(dataset.query_modified)
    open_hit = out.result.open_idx[:, 0].cpu().numpy() == src   # rank-0 of (Q, top_k)
    std_hit = out.result.std_idx[:, 0].cpu().numpy() == src

    print(f"open-search recall:      {open_hit.mean():.3f}")
    print(f"  on modified spectra:   {open_hit[mod].mean():.3f}  <- the OMS win")
    print(f"standard-search recall:  {std_hit.mean():.3f}")
    print(f"  on modified spectra:   {std_hit[mod].mean():.3f}  <- why OMS exists")
    print(f"identifications @1% FDR: {int(out.open_fdr.n_accepted)}/{len(src)}")


if __name__ == "__main__":
    main()
