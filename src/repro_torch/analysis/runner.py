"""Contract-matrix runner: record every hot path, check every declaration.

Counterpart of ``repro.analysis.runner``; ``python -m
repro_torch.launch.oms analyze`` lands here. The runner builds one
smoke-scale fixture (synthetic library -> store -> resident and streamed
pipelines on the device), then for every registered (encode backend x
search backend x resident/streamed x cascade on/off, plus the dimension
cascade's prefix path) combination:

  * runs the path's hot function(s) once on real tensors under the op
    recorder (:mod:`repro_torch.analysis.op_walk`) — and, on CUDA, under
    ``torch.cuda.set_sync_debug_mode("error")`` with the allocator's peak
    reset around the call;
  * evaluates every :mod:`repro_torch.analysis.registry` declaration whose
    target the combination exercises;
  * runs the ``recompile_guard`` (the one runtime contract) by calling the
    real resident/streamed search twice with same-shaped batches and
    asserting no kernel build and no allocator growth on the repeat call.

Recordings are made once per distinct (target, path) — an encode backend
does not change the search ops — so the N-combination report costs one
recording per distinct hot function. The JSON report has the reference's
keys; :func:`run` returns it and the CLI exits nonzero if any non-exempt
contract fails.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import traceback
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.analysis import contracts as C
from repro_torch.analysis import registry
from repro_torch.analysis.op_walk import record_ops


@dataclasses.dataclass(frozen=True)
class SmokeShapes:
    """Small enough to record everything in seconds, large enough that the
    contract dimensions (q-block, scanned rows, word count, word tile)
    are all DISTINCT sizes — shape-membership tests must not collide."""

    dim: int = 512           # n_words = 16
    n_levels: int = 8
    max_r: int = 64
    q_block: int = 8
    top_k: int = 2
    n_refs: int = 768
    n_queries: int = 32
    encode_batch: int = 16
    slab_rows: int = 128     # 2 blocks per slab
    narrow_tol_da: float = 1.0
    seed: int = 3

    @property
    def n_words(self) -> int:
        return self.dim // 32


@dataclasses.dataclass
class Recording:
    """One run of a hot function: its ops, the sync-debug error (CUDA), and
    the allocator's rise over the call (CUDA)."""

    ops: list
    sync_error: str | None = None
    allocator_bytes: int | None = None


def record(fn, *args, device: torch.device, **kwargs) -> Recording:
    """Run ``fn(*args, **kwargs)`` once under the op recorder. On CUDA it
    runs under sync debug mode "error"; a call that synchronises is
    recorded again without it, and the error is kept for
    ``no_host_transfer``."""
    dev = device
    if dev.type != "cuda":
        return Recording(record_ops(fn, *args, **kwargs)[1])
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    sync_error = None
    try:
        ops = record_ops(fn, *args, **kwargs)[1]
    except RuntimeError as e:
        sync_error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    if sync_error is not None:
        ops = record_ops(fn, *args, **kwargs)[1]
    torch.cuda.synchronize(dev)
    rise = torch.cuda.max_memory_allocated(dev) - base
    return Recording(ops, sync_error, rise)


def _encode_ctx(sm: SmokeShapes, peaks: int, n_bins: int) -> dict[str, Any]:
    return {"dim": sm.dim, "n_words": sm.n_words, "batch": sm.encode_batch,
            "peaks": peaks, "n_levels": sm.n_levels, "n_bins": n_bins,
            "word_tile": min(8, sm.n_words)}


def _search_ctx(sm: SmokeShapes, rk: int, **extra) -> dict[str, Any]:
    return {"dim": sm.dim, "n_words": sm.n_words, "q_block": sm.q_block,
            "rk": rk, "top_k": sm.top_k, **extra}


def _eval_decls(target: str, rec: Recording, ctx) -> list[C.ContractResult]:
    return [C.evaluate(d, rec.ops, ctx, sync_error=rec.sync_error,
                       allocator_bytes=rec.allocator_bytes)
            for d in registry.declarations(target)
            if d.contract != "recompile_guard"]


def _guarded(target: str, contract: str, fn) -> list[C.ContractResult]:
    """``fn()``'s results, or one failed check if recording raised."""
    try:
        return fn()
    except Exception as e:
        return [C.ContractResult(contract, target, False,
                                 f"raised {type(e).__name__}: {e}",
                                 eqn=traceback.format_exc(limit=-1).strip()
                                 .splitlines()[-1])]


class _Fixture:
    """One smoke dataset + resident pipeline + streamed pipeline (tmp store),
    on ``device``."""

    def __init__(self, sm: SmokeShapes, device):
        from repro_torch.core.pipeline import OMSConfig, OMSPipeline
        from repro_torch.data.spectra import LibraryConfig, make_dataset

        self.sm = sm
        self.device = resolve_device(device)
        self.cfg = OMSConfig(dim=sm.dim, n_levels=sm.n_levels, max_r=sm.max_r,
                             q_block=sm.q_block, top_k=sm.top_k,
                             encode_batch=sm.encode_batch, seed=sm.seed)
        self.ds = make_dataset(LibraryConfig(n_refs=sm.n_refs,
                                             n_queries=sm.n_queries,
                                             seed=sm.seed))
        self.tmp = tempfile.mkdtemp(prefix="oms-analyze-")
        store = OMSPipeline.ingest(self.cfg, self.ds.refs,
                                   f"{self.tmp}/store", device=self.device)
        self.resident = OMSPipeline.from_store(store, self.cfg,
                                               device=self.device)
        self.streamed = OMSPipeline.from_store(store, self.cfg,
                                               device=self.device,
                                               resident=False,
                                               slab_rows=sm.slab_rows)
        hvs, qp, qc = self.resident.encode_queries(self.ds.queries)
        self.q = (hvs, qp, qc)
        self.qp_np = qp.cpu().numpy()
        self.qc_np = qc.cpu().numpy()

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)

    # -- padded query layout (what the blocked scan actually consumes) -----
    def padded_queries(self):
        from repro_torch.core.search import sort_pad_plan
        hvs, qp, qc = self.q
        gather, _ = sort_pad_plan(qp, qc, self.sm.q_block,
                                  q_charge_np=self.qc_np)
        return hvs[gather], qp[gather], qc[gather]

    def slab(self, n_words: int | None = None):
        """Slab 0 of the streamed layout on the device (the engine's slab
        shape; ``n_words`` gives a prefix slab)."""
        from repro_torch.core.blocking import reference_db_from_arrays
        from repro_torch.serve.slabs import slab_arrays
        eng = self.streamed.engine
        s = slab_arrays(eng.layout, 0, eng.plan, n_words=n_words)
        return reference_db_from_arrays(
            s.hvs, s.pmz, s.charge, s.is_decoy, s.orig_idx, s.block_min,
            s.block_max, s.block_charge, max_r=s.max_r, device=self.device)


def _n_sms(device: torch.device) -> int:
    """The SM count the fused wrappers split for (0 on the CPU, where no
    split buffer is allocated)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# Per-axis record+check passes (each hot function recorded once)
# ---------------------------------------------------------------------------


def _encode_results(fx: _Fixture) -> dict[str, list[C.ContractResult]]:
    """Record ``preprocess_encode`` per registered encode backend."""
    from repro_torch.core import encode_backends

    qs = fx.ds.queries
    peaks = int(qs.mz.shape[1])
    args = [torch.as_tensor(x, device=fx.device)
            for x in (qs.mz, qs.intensity, qs.pmz, qs.charge)]
    out: dict[str, list[C.ContractResult]] = {}
    for name in encode_backends.names():
        target = f"encode:{name}"

        def one(name=name, target=target):
            rec = record(encode_backends.preprocess_encode, *args,
                         fx.resident.codebooks, fx.cfg.preprocess_params,
                         backend=name, batch=fx.sm.encode_batch,
                         device=fx.device)
            return _eval_decls(target, rec,
                               _encode_ctx(fx.sm, peaks, fx.cfg.n_bins))
        out[name] = _guarded(target, "no_host_transfer", one)
    return out


def _record_search(fx: _Fixture, db, params) -> Recording:
    from repro_torch.core import search as search_mod
    qh, qp, qc = fx.padded_queries()
    return record(lambda: search_mod._search_sorted_padded(
        db, qh, qp, qc, params=params, dim=fx.sm.dim), device=fx.device)


def _search_results(fx: _Fixture) -> dict[tuple, list[C.ContractResult]]:
    """Record the blocked scan per (search backend, path, stage) and check
    the backend's declarations at that path's scanned-rows extent.

    Keys: (backend, "resident"|"streamed", "open"|"narrow").
    """
    from repro_torch.core import backends
    from repro_torch.core.search import narrow_search_params

    sm = fx.sm
    base = fx.resident.search_params(fx.qp_np, fx.qc_np)
    narrow = narrow_search_params(fx.resident.db, fx.qp_np, fx.qc_np, base,
                                  narrow_tol_da=sm.narrow_tol_da)
    eng = fx.streamed.engine
    slab = fx.slab()
    slab_cap = eng.plan.slab_blocks
    n_q = fx.padded_queries()[0].shape[0]
    n_sms = _n_sms(fx.device)

    out: dict[tuple, list[C.ContractResult]] = {}
    for be in backends.names():
        for stage, p in (("open", base), ("narrow", narrow)):
            pr = p._replace(backend=be)
            rk = pr.k_blocks * sm.max_r
            ctx = _search_ctx(sm, rk, n_queries=n_q, n_sms=n_sms,
                              n_rows=fx.resident.db.n_rows,
                              device=fx.device)
            out[(be, "resident", stage)] = _guarded(
                f"search:{be}", "no_host_transfer",
                lambda pr=pr, ctx=ctx: _eval_decls(
                    f"search:{be}", _record_search(fx, fx.resident.db, pr), ctx))

            ps = pr._replace(k_blocks=min(pr.k_blocks, slab_cap))
            rk_s = ps.k_blocks * sm.max_r
            ctx_s = _search_ctx(sm, rk_s, slab_rows=eng.plan.slab_rows,
                                n_queries=n_q, n_sms=n_sms,
                                n_rows=slab.n_rows, device=fx.device)

            def streamed(ps=ps, ctx_s=ctx_s, be=be):
                rec = _record_search(fx, slab, ps)
                return (_eval_decls(f"search:{be}", rec, ctx_s)
                        + _eval_decls("serve:slab_step", rec, ctx_s))
            out[(be, "streamed", stage)] = _guarded(
                f"search:{be}", "no_host_transfer", streamed)
    return out


_PREFIX_WORDS = 4    # distinct from n_words (16), word_tile (8), q_block (8)
_RESCORE_ROWS = 64   # the smallest survivor bucket (core.search.row_bucket)


def _prefix_results(fx: _Fixture) -> dict[str, dict[str, list]]:
    """Record the dimension cascade's two stages per search backend.

    Stage A (``_prefix_flags``) against both the resident DB's prefix
    columns and a prefix slab (k_blocks capped, slab shapes); stage B
    (``_rescore_rows_padded``) once per backend at the smallest survivor
    bucket. Keys: backend -> path -> results.
    """
    from repro_torch.core import backends
    from repro_torch.core import search as search_mod

    sm = fx.sm
    P = _PREFIX_WORDS
    dev = fx.device
    base = fx.resident.search_params(fx.qp_np, fx.qc_np)
    qh, qp, qc = fx.padded_queries()
    qh_p = qh[:, :P].contiguous()
    Qp = int(qp.shape[0])
    nqb = Qp // sm.q_block
    thr = torch.zeros((Qp,), dtype=torch.int32, device=dev)
    slab = fx.slab(n_words=P)
    slab_cap = fx.streamed.engine.plan.slab_blocks
    db = fx.resident.db
    prefix_hvs = fx.resident.prefix_hvs(P)

    S = _RESCORE_ROWS
    r_hvs = torch.zeros((S, sm.n_words), dtype=torch.int32, device=dev)
    r_rows = torch.arange(S, dtype=torch.int32, device=dev)
    r_pmz = torch.zeros((S,), dtype=torch.float32, device=dev)
    r_charge = torch.zeros((S,), dtype=torch.int32, device=dev)

    out: dict[str, dict[str, list]] = {}
    for be in backends.names():
        pr = base._replace(backend=be, prefix_words=P)
        per_path: dict[str, list] = {}
        for path, d, ph, p in (
                ("resident", db, prefix_hvs, pr),
                ("streamed", slab, slab.hvs,
                 pr._replace(k_blocks=min(pr.k_blocks, slab_cap)))):
            rk = p.k_blocks * sm.max_r
            ctx = {"dim": sm.dim, "n_words": P, "q_block": sm.q_block,
                   "rk": rk, "top_k": sm.top_k, "nqb": nqb,
                   "n_rows": int(d.pmz.shape[0])}

            def stage_a(d=d, ph=ph, p=p, ctx=ctx, be=be):
                rec = record(lambda: search_mod._prefix_flags(
                    d, ph, qh_p, qp, qc, thr, thr, params=p, dim=sm.dim),
                    device=dev)
                return _eval_decls(f"prefix:{be}", rec, ctx)
            per_path[path] = _guarded(f"prefix:{be}", "no_host_transfer",
                                      stage_a)

        ctx_r = {"dim": sm.dim, "n_words": sm.n_words,
                 "q_block": sm.q_block, "rk": S, "top_k": sm.top_k,
                 "nqb": nqb, "n_rows": int(db.pmz.shape[0])}

        def stage_b(pr=pr, be=be):
            rec = record(lambda: search_mod._rescore_rows_padded(
                r_hvs, r_rows, r_pmz, r_charge, qh, qp, qc, params=pr,
                dim=sm.dim), device=dev)
            return _eval_decls(f"rescore:{be}", rec, ctx_r)
        resc = _guarded(f"rescore:{be}", "no_host_transfer", stage_b)
        out[be] = {path: res + resc for path, res in per_path.items()}
    return out


def _merge_step_results(fx: _Fixture) -> list[C.ContractResult]:
    """The streamed path's cross-slab fold (offset + merge_topk) is part of
    the slab step — same contracts, tiny recording."""
    from repro_torch.serve.engine import _merge_partials, _offset_rows

    sm = fx.sm
    Q = fx.qp_np.shape[0]
    part = tuple(torch.zeros((Q, sm.top_k), dtype=torch.int32,
                             device=fx.device) for _ in range(4))
    out = []
    for rec in (record(_offset_rows, *part, 64, device=fx.device),
                record(_merge_partials, part, part, sm.top_k, device=fx.device)):
        out.append(C.check_no_host_transfer(rec.ops, target="serve:slab_step",
                                            sync_error=rec.sync_error))
        out.append(C.check_dtype_stability(rec.ops, target="serve:slab_step",
                                           hv_words=sm.n_words))
    return out


def _op_sequence(rec: Recording) -> list[tuple]:
    return [(op.name, op.outputs) for op in rec.ops]


def _obs_results(fx: _Fixture) -> list[C.ContractResult]:
    """The ``trace_transparency`` contract: installing a
    ``repro_torch.obs`` tracer must (a) leave the recorded op sequence of
    the hot search identical — host-side spans add no op to the path they
    wrap — and (b) change zero result bytes of a real resident AND
    streamed search. The tracer must also actually record spans during
    the instrumented calls, or the check would be vacuous."""
    from repro_torch.obs import trace as trace_mod

    target = "serve:obs"
    hvs, qp, qc = fx.q
    base = fx.resident.search_params(fx.qp_np, fx.qc_np)

    def snapshot():
        outs = []
        for pipe in (fx.resident, fx.streamed):
            out = pipe.search_encoded(hvs, qp, qc)
            outs.append(tuple(a.cpu().numpy().tobytes() for a in out.result))
        return outs

    ops_off = _op_sequence(_record_search(fx, fx.resident.db, base))
    res_off = snapshot()
    tracer = trace_mod.install(trace_mod.Tracer())
    try:
        ops_on = _op_sequence(_record_search(fx, fx.resident.db, base))
        res_on = snapshot()
    finally:
        trace_mod.uninstall()

    results = []
    if ops_on != ops_off:
        results.append(C.ContractResult(
            "trace_transparency", target, False,
            "hot search op sequence changed with a tracer installed — a "
            "span leaked inside the hot function"))
    else:
        results.append(C.ContractResult(
            "trace_transparency", target, True,
            f"hot search op sequence identical with tracer installed "
            f"({len(ops_on)} ops)"))
    if res_on != res_off:
        results.append(C.ContractResult(
            "trace_transparency", target, False,
            "search results differ with a tracer installed"))
    else:
        results.append(C.ContractResult(
            "trace_transparency", target, True,
            "resident+streamed results byte-identical with tracer "
            "installed"))
    names = {ev.name for ev in tracer.events()}
    expected = {"pipeline.plan", "pipeline.scan", "pipeline.fdr",
                "serve.scan"}
    missing = expected - names
    if missing:
        results.append(C.ContractResult(
            "trace_transparency", target, False,
            f"tracer recorded no {sorted(missing)} spans — the "
            f"transparency check ran against uninstrumented code"))
    else:
        results.append(C.ContractResult(
            "trace_transparency", target, True,
            f"{tracer.n_recorded} spans recorded across "
            f"{len(names)} stages"))
    return results


def _recompile_results(fx: _Fixture) -> dict[str, list[C.ContractResult]]:
    """The runtime contract: repeated same-shaped serve calls must build no
    kernel and (on CUDA) grow no allocator reservation. One warm-up + one
    armed call per (backend, path)."""
    from repro_torch.core import backends

    hvs, qp, qc = fx.q
    tracked = ["kernels._build", "cuda.memory_reserved"
               if fx.device.type == "cuda" else "kernels._build only (CPU)"]
    out: dict[str, list[C.ContractResult]] = {}
    for be in backends.names():
        results = []
        for path, pipe in (("resident", fx.resident),
                           ("streamed", fx.streamed)):
            target = f"serve:loop[{path}:{be}]"

            def one(pipe=pipe, target=target):
                guard = C.RecompileGuard(tracked)
                # warm-up: the plain scan AND the dimension cascade (its
                # survivor buckets are deterministic for same-shaped
                # batches, so steady-state repeats allocate the same)
                pipe.search_encoded(hvs, qp, qc, backend=be)
                pipe.search_encoded(hvs, qp, qc, backend=be,
                                    prefix_words=_PREFIX_WORDS)
                guard.arm()
                pipe.search_encoded(hvs, qp, qc, backend=be)
                pipe.search_encoded(hvs, qp, qc, backend=be,
                                    prefix_words=_PREFIX_WORDS)
                return [guard.check(target=target)]
            results += _guarded(target, "recompile_guard", one)
        out[be] = results
    return out


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def run(sm: SmokeShapes | None = None, *, with_recompile: bool = True,
        device=None) -> dict:
    """Full contract matrix -> JSON-able report dict (see module docstring).
    ``device`` None runs on the card (raising without a GPU)."""
    sm = sm or SmokeShapes()
    fx = _Fixture(sm, device)
    try:
        enc = _encode_results(fx)
        srch = _search_results(fx)
        pref = _prefix_results(fx)
        merge_res = _merge_step_results(fx)
        obs_res = _obs_results(fx)
        reco = _recompile_results(fx) if with_recompile else {}
    finally:
        fx.close()

    combos = []
    for e in sorted(enc):
        for (be, path, stage) in sorted(srch):
            cascade = stage == "narrow"
            results = list(enc[e]) + list(srch[(be, path, stage)])
            if path == "streamed":
                results += merge_res
            if not cascade and be in reco:
                results += [r for r in reco[be]
                            if f"[{path}:" in r.target]
            combos.append({
                "encode": e, "search": be, "path": path,
                "cascade": cascade, "prefix": False,
                "contracts": [r.as_dict() for r in results],
                "passed": all(r.passed for r in results),
            })
        for be in sorted(pref):
            for path in ("resident", "streamed"):
                results = list(enc[e]) + list(pref[be][path])
                combos.append({
                    "encode": e, "search": be, "path": path,
                    "cascade": False, "prefix": True,
                    "contracts": [r.as_dict() for r in results],
                    "passed": all(r.passed for r in results),
                })

    combos.append({
        "encode": "-", "search": "-", "path": "obs",
        "cascade": False, "prefix": False,
        "contracts": [r.as_dict() for r in obs_res],
        "passed": all(r.passed for r in obs_res),
    })

    n_checks = sum(len(c["contracts"]) for c in combos)
    failed = [c for c in combos if not c["passed"]]
    return {
        "smoke": dataclasses.asdict(sm),
        "n_combinations": len(combos),
        "n_checks": n_checks,
        "n_failed_combinations": len(failed),
        "combos": combos,
        "ok": not failed,
    }


def allocator_peaks(report: dict) -> dict[str, int]:
    """Per combination (``encode/search/path[/cascade][/prefix]``) the
    largest allocator rise its peak_intermediate checks saw (CUDA runs)."""
    out = {}
    for c in report["combos"]:
        rises = [r["allocator_bytes"] for r in c["contracts"]
                 if "allocator_bytes" in r]
        if rises:
            key = "/".join([c["encode"], c["search"], c["path"]]
                           + (["cascade"] if c["cascade"] else [])
                           + (["prefix"] if c["prefix"] else []))
            out[key] = max(rises)
    return out


def summarize(report: dict) -> str:
    """Human-readable digest of a :func:`run` report."""
    lines = [f"[analyze] {report['n_combinations']} combinations, "
             f"{report['n_checks']} contract checks"]
    seen: set[tuple] = set()
    for combo in report["combos"]:
        for r in combo["contracts"]:
            if r["passed"]:
                continue
            key = (r["target"], r["contract"], r.get("eqn"))
            if key in seen:
                continue
            seen.add(key)
            lines.append(f"  FAIL {r['target']} :: {r['contract']} — "
                         f"{r['detail']}")
            if r.get("eqn"):
                lines.append(f"       offending op: {r['eqn']}")
    lines.append("[analyze] " + ("ALL CONTRACTS HOLD" if report["ok"] else
                                 f"{report['n_failed_combinations']} "
                                 f"combination(s) FAILED"))
    return "\n".join(lines)
