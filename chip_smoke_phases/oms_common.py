"""Helpers of the OMS phases: the main path's sorted batch and check
blocks, seeded kernel inputs, the plain tile, and output comparisons."""
from __future__ import annotations

import statistics

from . import common as C
from .common import equal, require

FUSED_CHECK_BLOCKS = 8
NARROW_W = 7             # a word count that takes the kernels' scalar paths
PLAIN_TILE_ROWS = 1 << 16  # row chunk of the plain tile at bucket sizes
FUSED_OUTS = ("std_sim", "std_row", "open_sim", "open_row")
# Grouped fused kernels: runs of consecutive main-path query blocks (2G + 1
# with G = 8 tiles per CTA) held against the plain versions at these k.
FUSED_GROUP_RUN = 2 * 8 + 1
FUSED_GROUP_KS = (1, 4, 16)
NARROW_TOL_DA = 1.0
STREAM_KERNELS = {"fused": "fused_search", "fused_mxu": "fused_search_mxu"}
DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")


def sorted_batch(torch, pipe, hvs, q_pmz, q_charge):
    """The main path's sorted/padded query layout, its params and start rows."""
    from repro_torch.core import search
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    gather, _ = search.sort_pad_plan(q_pmz, q_charge, params.q_block)
    qh, qp, qc = hvs[gather], q_pmz[gather], q_charge[gather]
    starts = search.block_start_rows(pipe.db, params, qp, qc)
    return params, qh, qp, qc, starts


def check_blocks(torch, pipe, hvs, q_pmz, q_charge):
    """FUSED_CHECK_BLOCKS evenly spaced query blocks of the main path: the
    search params, the fused-kernel arguments restricted to those blocks,
    and the rows each block scans."""
    import numpy as np
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    QB = params.q_block
    nqb = starts.shape[0]
    pick = np.unique(np.linspace(0, nqb - 1, FUSED_CHECK_BLOCKS).astype(np.int64))
    rows = (pick[:, None] * QB + np.arange(QB)[None, :]).reshape(-1)
    rows_t = torch.from_numpy(rows).to(qh.device)
    db = pipe.db
    args = (qh[rows_t].contiguous(), qp[rows_t].contiguous(), qc[rows_t].contiguous(),
            db.hvs, db.pmz, db.charge,
            starts[torch.from_numpy(pick).to(qh.device)].contiguous())
    return params, args, pick, params.k_blocks * db.max_r


def block_pairs(pipe, params, args, rk):
    """(queries, scanned rows) of every checked main-path block."""
    QB = params.q_block
    qh, starts = args[0], args[6]
    return [(qh[b * QB:(b + 1) * QB], pipe.db.hvs[s:s + rk])
            for b, s in enumerate(starts.tolist())]


def outputs_equal(a, b) -> bool:
    same = all(equal(getattr(a.result, f), getattr(b.result, f))
               for f in a.result._fields)
    for fa, fb in ((a.open_fdr, b.open_fdr), (a.std_fdr, b.std_fdr)):
        same = same and all(equal(getattr(fa, f), getattr(fb, f))
                            for f in fa._fields)
    return same


def plain_tile(q, r, dim=None):
    """The plain popc tile, row-chunked so that a bucket-sized row set fits
    (its columns are independent)."""
    import torch
    from repro_torch.kernels.hamming import ref as href
    return torch.cat([href.hamming_matrix(q, r[i:i + PLAIN_TILE_ROWS])
                      for i in range(0, r.shape[0], PLAIN_TILE_ROWS)], dim=1)


def random_words(torch, g, n: int, w: int):
    """(n, w) packed words, uniform over all 32-bit patterns."""
    return torch.randint(0, 2 ** 32, (n, w), generator=g, device=C.DEVICE,
                         dtype=torch.int64).to(torch.int32)


def fused_edge_inputs(torch, g, n_rows: int, W: int, starts, rk: int, q_block: int):
    """Seeded synthetic fused-search arguments: rows drawn from 8 HVs (ties),
    ascending pmz with a PAD tail, queries copied from rows of their block's
    range or random, near those rows' pmz (std-window hits), one padded
    query per block."""
    dev = C.DEVICE
    pool = random_words(torch, g, 8, W)
    r = pool[torch.randint(0, 8, (n_rows,), generator=g, device=dev)]
    rp = torch.sort(torch.rand(n_rows, generator=g, device=dev) * 20 + 400).values
    rc = torch.randint(2, 4, (n_rows,), generator=g, device=dev, dtype=torch.int32)
    rp[-6:] = float(torch.finfo(torch.float32).max)
    rc[-6:] = -1
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    Q = st.shape[0] * q_block
    src = torch.clamp(st.repeat_interleave(q_block).long()
                      + torch.randint(0, rk, (Q,), generator=g, device=dev), max=n_rows - 7)
    q = r[src].clone()
    q[1::3] = random_words(torch, g, q[1::3].shape[0], W)
    qp = rp[src] + (torch.rand(Q, generator=g, device=dev) - 0.5) * 1.2
    qp[::4] = rp[src][::4]
    qc = rc[src].clone()
    qc[q_block - 1::q_block] = -(2 ** 30)
    return (q, qp.contiguous(), qc, r, rp, rc, st)


def fused_pair_check(torch, what, args, kw) -> None:
    """Both fused kernels against their plain versions at every k of
    FUSED_GROUP_KS."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    for k in FUSED_GROUP_KS:
        kk = dict(kw, k=k)
        for name, kern, plain in (("fused_search", hops, href), ("fused_search_mxu", mops, mref)):
            got = kern.fused_search(*args, **kk)
            torch.cuda.synchronize()
            want = plain.fused_search(*args, **kk)
            for out, g, w in zip(FUSED_OUTS, got, want):
                require(equal(g, w), f"{name} kernel differs from plain ({out}, k={k}) "
                        f"on {what}")


def plain_pair(torch, name, kern, plain, args, kw, what) -> None:
    got = kern.fused_search(*args, **kw)
    torch.cuda.synchronize()
    want = plain.fused_search(*args, **kw)
    for out, g, w in zip(FUSED_OUTS, got, want):
        require(equal(g, w), f"{name} kernel differs from plain ({out}) {what}")


def union_stats(starts, rk: int, n_rows: int) -> tuple[float, float]:
    """(mean, max) over the fused kernels' CTA groups of union rows / rk."""
    from repro_torch.kernels.hamming import ops as hops
    span = hops.group_spans(starts, rk, n_rows)
    u = (span[:, 1] - span[:, 0]).double() / rk
    return float(u.mean()), float(u.max())


def plan_of(kern, W: int, k: int) -> str:
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    p = hops.fused_plan(W, k, mops.FUSED_SCRATCH_PER_TILE if kern is mops else 0)
    return (f"G = {p.group}, {p.lists} lists, queries staged "
            f"{'whole' if p.query_words >= -(-W // 16) * 16 else f'in {p.query_words}-word chunks'}")


def db_nbytes(db) -> int:
    return sum(getattr(db, f).numel() * getattr(db, f).element_size() for f in DB_FIELDS)


def slab_line(stats) -> str:
    rows = stats["slabs"]
    g = [r["gather_s"] for r in rows]
    u = [r["upload_ms"] for r in rows]
    k = [r["search_ms"] for r in rows]
    return (f"per slab: host gather mean {statistics.mean(g):.4f} s (max {max(g):.4f}, "
            f"sum {sum(g):.3f}), upload mean {statistics.mean(u):.3f} ms, search "
            f"(kernel + merge) mean {statistics.mean(k):.3f} ms (sum {sum(k) / 1e3:.3f} s)")
