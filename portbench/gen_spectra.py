"""Synthetic mass-spectral libraries and MS runs of Table I, drawn from a seed.

Frozen copy of ``src/repro_torch/data/spectra.py`` at commit 0d012dd (the
generative model and its parameters), with numpy's ``default_rng`` replaced
by a ``torch.Generator`` on the device, so that a library of millions of
spectra is drawn in a few large calls on the card. References are random
fragment ladders; an MS run is a set of noisy replicas of library spectra,
a share of them with a planted precursor and suffix mass shift (a
modification). Later edits of the port's generator do not move the
benchmark.

Unlike the port's generator, each run's replicas are drawn charge by
charge: run ``r`` holds ``first_counts[r]`` replicas of library spectra of
the configuration's first charge and the rest of the others, in an order
drawn from the seed. A pool of runs with distinct counts is a pool of
distinct per-charge count tuples, as new MS runs of a lab bring, so that
nothing keyed on them (the program memoizes its padding plan on them) can
serve a run from an earlier one.

Every parameter comes from a configuration file (``configs/<name>.json``):
``library`` holds the reference model, ``queries`` the replica model, and
from a traffic mix (``traffic/<name>.json``): ``pool_runs`` distinct runs
for the window and ``warm_runs`` more for the warm-up.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Spectra(NamedTuple):
    mz: object          # (B, P) float32, 0 padded: fragment m/z
    intensity: object   # (B, P) float32, 0 padded
    pmz: object         # (B,) float32: the precursor mass the windows apply to
    charge: object      # (B,) int32

    def numpy(self) -> "Spectra":
        return Spectra(*(t.cpu().numpy() for t in self))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * np.float32(hi - lo) + np.float32(lo)


def make_library(lib: dict, gen: torch.Generator, device) -> Spectra:
    """``lib["n_refs"]`` reference spectra of ``min_peaks``..``max_peaks``
    peaks, uniform fragment m/z, exponential intensities, uniform precursor
    m/z and charges drawn from ``lib["charges"]``."""
    B, P = int(lib["n_refs"]), int(lib["max_peaks"])
    n_peaks = torch.randint(int(lib["min_peaks"]), P + 1, (B,), generator=gen,
                            device=device)
    mask = torch.arange(P, device=device)[None, :] < n_peaks[:, None]
    mz = _uniform(gen, (B, P), lib["mz_min"], lib["mz_max"], device)
    inten = torch.empty((B, P), device=device, dtype=torch.float32).exponential_(
        generator=gen) + np.float32(0.05)
    pmz = _uniform(gen, (B,), lib["pmz_min"], lib["pmz_max"], device)
    charges = torch.tensor(lib["charges"], dtype=torch.int32, device=device)
    charge = charges[torch.randint(0, len(lib["charges"]), (B,), generator=gen,
                                   device=device)]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return Spectra(torch.where(mask, mz, zero), torch.where(mask, inten, zero),
                   pmz, charge)


def _replicas(refs: Spectra, lib: dict, q: dict, src: torch.Tensor,
              gen: torch.Generator) -> Spectra:
    """Replicas of the library spectra ``src`` (a flat index tensor) with
    peak dropout, m/z and intensity jitter, and in a share
    ``q["modified_frac"]`` of them a precursor shift of up to the open
    window (never within 2 Da of 0) applied to every fragment above a random
    breakpoint."""
    dev = refs.mz.device
    Q, P = int(src.shape[0]), refs.mz.shape[1]
    mz = refs.mz[src]
    inten = refs.intensity[src]
    valid = inten > 0

    keep = (torch.rand((Q, P), generator=gen, device=dev)
            < np.float32(1.0 - q["dropout"])) & valid
    mz = mz + torch.randn((Q, P), generator=gen, device=dev) * np.float32(q["mz_jitter"])
    inten = inten * torch.exp(torch.randn((Q, P), generator=gen, device=dev)
                              * np.float32(q["intensity_jitter"]))

    tol = float(q["shift_max_da"])
    modified = torch.rand((Q,), generator=gen, device=dev) < np.float32(q["modified_frac"])
    shift = _uniform(gen, (Q,), -tol, tol, dev)
    shift = torch.where(shift.abs() < 2.0, torch.sign(shift) * 2.0 + shift, shift)
    shift = torch.where(modified, shift, 0.0)
    breakpoint_mz = _uniform(gen, (Q,), lib["mz_min"], lib["mz_max"], dev)
    frag_shift = torch.where((mz > breakpoint_mz[:, None]) & modified[:, None],
                             shift[:, None], 0.0)
    mz = mz + frag_shift

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return Spectra(
        mz=torch.where(keep, mz.clamp(float(lib["mz_min"]),
                                      float(lib["mz_max"]) - 1e-3), zero),
        intensity=torch.where(keep, inten, zero),
        pmz=refs.pmz[src] + shift,
        charge=refs.charge[src])


# Replica rows drawn in one go on the device.
CHUNK_ROWS = 1 << 21


def make_runs(refs: Spectra, lib: dict, q: dict, n_queries: int, first_counts,
              gen: torch.Generator) -> Spectra:
    """``len(first_counts)`` MS runs of ``n_queries`` spectra each, as host
    arrays ``(runs, n_queries, ...)``: run ``r`` replicates
    ``first_counts[r]`` library spectra of the first charge of
    ``lib["charges"]`` and ``n_queries - first_counts[r]`` of the others,
    shuffled."""
    dev = refs.mz.device
    Q, P = int(n_queries), refs.mz.shape[1]
    first = refs.charge == int(lib["charges"][0])
    idx = (torch.nonzero(first).flatten(), torch.nonzero(~first).flatten())
    counts = [int(n) for n in first_counts]
    if min(i.numel() for i in idx) == 0 or not all(0 < n < Q for n in counts):
        raise ValueError(f"runs of {Q} spectra cannot hold {min(counts)}..{max(counts)} of "
                         f"the first charge and the rest of the others")
    R = len(counts)
    out = Spectra(np.empty((R, Q, P), np.float32), np.empty((R, Q, P), np.float32),
                  np.empty((R, Q), np.float32), np.empty((R, Q), np.int32))
    per = max(1, CHUNK_ROWS // Q)
    for r0 in range(0, R, per):
        n = torch.tensor(counts[r0:r0 + per], device=dev)
        m = int(n.shape[0])
        is_first = torch.arange(Q, device=dev)[None, :] < n[:, None]
        pick = [i[torch.randint(0, i.numel(), (m, Q), generator=gen, device=dev)]
                for i in idx]
        src = torch.where(is_first, pick[0], pick[1])
        order = torch.argsort(torch.rand((m, Q), generator=gen, device=dev), dim=1)
        src = torch.gather(src, 1, order).flatten()
        reps = _replicas(refs, lib, q, src, gen)
        for host, t in zip(out, reps):
            torch.from_numpy(host[r0:r0 + m]).copy_(t.reshape(m, *host.shape[1:]))
    return out


def make_inputs(config: dict, traffic: dict, seed: int, device):
    """The library, ``traffic["pool_runs"]`` MS runs for the window and
    ``traffic["warm_runs"]`` for the warm-up of one configuration, drawn on
    ``device`` from ``seed`` and returned as host numpy arrays: what a lab
    hands the system. Every run has its own count of first-charge spectra:
    the pool's are ``base + a permutation of range(pool_runs)``, around the
    library's share of that charge, and the warm-up's lie just outside that
    range, alternately below and above it, so that each warm-up run has one
    of the extreme sizes and none repeats a pool run's counts."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lib = config["library"]
    Q = int(config["queries_per_run"])
    n_pool, n_warm = int(traffic["pool_runs"]), int(traffic["warm_runs"])
    refs = make_library(lib, gen, device)
    share = float((refs.charge == int(lib["charges"][0])).float().mean())
    base = round(Q * share) - n_pool // 2
    perm = torch.randperm(n_pool, generator=gen, device=device).cpu().tolist()
    warm = [base - 1 - i // 2 if i % 2 == 0 else base + n_pool + i // 2
            for i in range(n_warm)]
    runs = make_runs(refs, lib, config["queries"], Q, [base + p for p in perm] + warm, gen)
    split = [Spectra(*(a[r] for a in runs)) for r in range(n_pool + n_warm)]
    return refs.numpy(), split[:n_pool], split[n_pool:]
