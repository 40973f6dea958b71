"""One client in a closed loop over ``OMSPipeline.search``: each request is
a whole MS run, submitted as host arrays, its answer brought to the host
before the next is submitted.

Set-up draws the library and the runs from the seed
(``gen_spectra.make_inputs``: ``pool_runs`` distinct runs for the window,
``warm_runs`` more for the warm-up), builds ``OMSPipeline(cfg, library)``
(the ingest) and answers the warm-up runs. The window submits the pool's
runs in turn until the deadline has passed (the run under way then
finishes). The check's reference is ``reference.oms.ReferenceOMS``.
"""
from __future__ import annotations

import time

from portbench import check, gen_spectra


def oms_config(config: dict, seed: int):
    from repro_torch.core.pipeline import OMSConfig
    return OMSConfig(**config["oms"], seed=int(seed))


def inputs(ctx) -> None:
    ctx.library, ctx.pool, ctx.warm = gen_spectra.make_inputs(
        ctx.cell.config, ctx.cell.traffic, ctx.seed, ctx.device)


def build(ctx):
    from repro_torch.core.pipeline import OMSPipeline
    return OMSPipeline(oms_config(ctx.cell.config, ctx.seed), ctx.library, device=ctx.device)


def warm(ctx) -> None:
    for q in ctx.warm:
        check.answer_of(ctx.search(ctx.entry, q, ctx.top_k))


def window(ctx, deadline_ns: int, min_runs: int) -> None:
    from repro_torch.obs import trace as ptrace
    i = 0
    while True:
        j = i % len(ctx.pool)
        q = ctx.pool[j]
        a = time.perf_counter_ns()
        with ptrace.span("bench.search"):
            out = ctx.search(ctx.entry, q, ctx.top_k)
        with ptrace.span("bench.answer"):
            ans = check.answer_of(out)
        del out
        b = time.perf_counter_ns()
        ctx.done(a, b, j, int(q.pmz.shape[0]), ans)
        i += 1
        if b >= deadline_ns and i >= min_runs:
            return


def reference(ctx):
    """The plain reference's answer to pool run ``j``, by ``j``."""
    from portbench.reference.oms import ReferenceOMS
    ref = ReferenceOMS(ctx.cell.config, ctx.library, ctx.seed, ctx.device)
    return lambda j: ref.answer(ctx.pool[j], ctx.top_k)
