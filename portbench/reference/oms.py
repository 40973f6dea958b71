"""Plain reference of one OMS deployment: the library encoded with its
decoys, and each MS run answered by an exact dual-window top-k search and
the target-decoy FDR.

Nothing here comes from the program: the codebooks and decoys are drawn
again from the seed, the library and the queries encoded again, and the
search is this file's own. Per charge, the library rows are ordered by
(precursor m/z, library index), targets before decoys on equal keys; the
queries of one charge, in order of precursor m/z, go in blocks, each block
against the contiguous rows its windows can reach. Similarities come from
an exact integer product of +-1 vectors (``sim = (dim + q . r) / 2``), the
windows from the float32 predicates ``|q - r| <= q * float32(ppm * 1e-6)``
(standard) and ``|q - r| <= float32(open_tol_da)`` (open), and the top k by
one int64 key per pair, similarity high and position low, so ties go to
the lower library position.

Results are in query order: per window ``idx`` (library index, decoys
``n_targets + i``; -1 for an empty rank) and ``sim`` (-1 there), then the
FDR's ``accept`` and ``q``, as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import encode as enc
from portbench.reference.fdr import fdr_filter


def _pm1(words: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 words -> (R, 32 W) int8 +1 (bit 0) / -1 (bit 1)."""
    return (1 - 2 * enc.unpack_bits(words)).to(torch.int8).reshape(words.shape[0], -1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, D) x (N, D) -> (M, N) int32 dot of +-1 int8 rows (int32
    accumulation: no rounding)."""
    return torch._int_mm(a, b.t())


class ReferenceOMS:
    def __init__(self, config: dict, refs, seed: int, device, *,
                 chunk_rows: int = 1 << 18):
        oms = config["oms"]
        self.oms = oms
        self.device = torch.device(device)
        self.encoder = enc.Encoder(oms, seed, self.device)
        self.n_targets = int(refs.mz.shape[0])
        key = enc.decoy_key(seed, self.device)
        hvs = []
        for decoys in (False, True):
            for s in range(0, self.n_targets, chunk_rows):
                mz = torch.as_tensor(refs.mz[s:s + chunk_rows]).to(self.device)
                inten = torch.as_tensor(refs.intensity[s:s + chunk_rows]).to(self.device)
                if decoys:
                    mz, inten = enc.make_decoy_peaks(key, mz, inten, oms["mz_min"],
                                                     oms["mz_max"], row_offset=s)
                hvs.append(self.encoder(mz, inten))
        pmz = torch.as_tensor(np.asarray(refs.pmz, np.float32)).to(self.device)
        charge = torch.as_tensor(np.asarray(refs.charge, np.int32)).to(self.device)
        pmz, charge = torch.cat([pmz, pmz]), torch.cat([charge, charge])
        order = torch.argsort(pmz, stable=True)
        order = order[torch.argsort(charge[order], stable=True)]
        self.idx = order.to(torch.int32)            # library index of each position
        self.hvs = torch.cat(hvs)[order]
        self.pmz = pmz[order]
        self.charge = charge[order]

    def answer(self, queries, top_k: int, *, q_block: int = 512,
               max_pairs: int = 1 << 27) -> dict:
        oms, dev = self.oms, self.device
        q_hvs = self.encoder(torch.as_tensor(queries.mz).to(dev),
                             torch.as_tensor(queries.intensity).to(dev))
        q_pmz = torch.as_tensor(np.asarray(queries.pmz, np.float32)).to(dev)
        q_charge = torch.as_tensor(np.asarray(queries.charge, np.int32)).to(dev)
        Q, k = q_pmz.shape[0], int(top_k)
        out = {w: (torch.full((Q, k), -1, dtype=torch.int64, device=dev))
               for w in ("std", "open")}
        std_scale = float(np.float32(oms["ppm_tol"] * 1e-6))
        open_tol = float(np.float32(oms["open_tol_da"]))
        reach = float(oms["open_tol_da"]) + 1.0
        for c in torch.unique(q_charge).tolist():
            qsel = torch.nonzero(q_charge == c).flatten()
            qsel = qsel[torch.argsort(q_pmz[qsel], stable=True)]
            rows_c = torch.nonzero(self.charge == c).flatten()
            if rows_c.numel() == 0:
                continue
            r0, r1 = int(rows_c[0]), int(rows_c[-1]) + 1
            pmz_c = self.pmz[r0:r1]
            for b in range(0, qsel.numel(), q_block):
                qs = qsel[b:b + q_block]
                qp = q_pmz[qs]
                lo = int(torch.searchsorted(pmz_c, qp[0:1] - reach))
                hi = int(torch.searchsorted(pmz_c, qp[-1:] + reach, right=True))
                if hi <= lo:
                    continue
                tops = self._block_top(q_hvs[qs], qp, r0 + lo, r0 + hi, k,
                                       std_scale, open_tol, max_pairs)
                for w, top in tops.items():
                    out[w][qs, :top.shape[1]] = top
        res = {}
        for w, key in out.items():
            ok = key >= 0
            pos = torch.where(ok, (1 << 32) - 1 - (key & 0xFFFFFFFF), 0)
            res[f"{w}_idx"] = torch.where(ok, self.idx[pos].to(torch.int64), -1)
            res[f"{w}_sim"] = torch.where(ok, key >> 32, -1)
            accept, q = fdr_filter(res[f"{w}_sim"].to(torch.float32),
                                   ok & (res[f"{w}_idx"] >= self.n_targets), ok,
                                   oms["fdr_threshold"])
            res[f"{w}_accept"], res[f"{w}_q"] = accept, q
        return {n: t.cpu().numpy() for n, t in res.items()}

    def _block_top(self, q_hvs, qp, a: int, b: int, k: int, std_scale: float,
                   open_tol: float, max_pairs: int) -> dict:
        """Per window, the (Qb, <= k) largest int64 keys ``sim << 32 |
        (2**32 - 1 - position)`` of the block's pairs inside it (-1 for
        none), over rows ``[a, b)``: the top k of the top k of row slices.
        Within a slice the key is an int32, ``sim << p | (2**p - 1 - row in
        the slice)`` with ``p = 31 - bits(dim)``, so a slice holds at most
        ``2**p`` rows."""
        dim = self.oms["dim"]
        p = 31 - int(dim).bit_length()
        low = (1 << p) - 1
        Qb = q_hvs.shape[0]
        qm = _pm1(q_hvs)
        pad = max(0, 17 - Qb)                     # the int8 product wants > 16 rows
        if pad:
            qm = torch.cat([qm, qm.new_zeros((pad, qm.shape[1]))])
        step = min(1 << p, max(8, (max_pairs // Qb) // 8 * 8))
        parts = {"std": [], "open": []}
        for s in range(a, b, step):
            e = min(b, s + step)
            rm = _pm1(self.hvs[s:e])
            n_pad = (-rm.shape[0]) % 8
            if n_pad:
                rm = torch.cat([rm, rm.new_zeros((n_pad, rm.shape[1]))])
            sim = (dim + _dot(qm, rm)[:Qb, :e - s]) >> 1
            key = (sim << p) | (low - torch.arange(e - s, device=qp.device,
                                                   dtype=torch.int32))[None, :]
            dpmz = torch.abs(qp[:, None] - self.pmz[None, s:e])
            for w, inside in (("std", dpmz <= qp[:, None] * std_scale),
                              ("open", dpmz <= open_tol)):
                kw = torch.where(inside, key, -1)
                top = (kw.amax(dim=1, keepdim=True) if k == 1
                       else torch.topk(kw, min(k, kw.shape[1]), dim=1).values)
                row = s + low - (top & low).to(torch.int64)
                parts[w].append(torch.where(
                    top >= 0, ((top >> p).to(torch.int64) << 32) | ((1 << 32) - 1 - row), -1))
        return {w: torch.topk(torch.cat(ps, dim=1), min(k, sum(t.shape[1] for t in ps)),
                              dim=1).values
                for w, ps in parts.items()}
