"""The port's on-card check, phase by phase, for ``chip_smoke.py`` (which
runs them) and ``scripts/chip_times.py`` (which times the same paths).

A phase holds results: a kernel bit-identical to its plain version, a path
bit-identical to ``fused``, float32 within its tolerance of the CPU, the
memory model within 10% of the allocator, launches by path, recall, store
bytes, a CLI or an example exiting 0. Lines that only report a time live in
the modules' ``times_*`` functions, which ``scripts/chip_times.py`` runs.

``PHASES`` lists the phases in the order the default run takes them (18
runs before 16, as it always has). Each names its module, the resources it
reads (``main``: the main path's pipeline and result; ``store``: the Table I
store on disk; ``streamed``: that store streamed at 2^18 rows a slab) and,
where it starts subprocesses that may run beside an earlier phase, the
phase at whose start they begin. Importing this package imports neither
torch nor the port.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class Phase:
    number: int              # the phase's number in chip_smoke.py's docstring
    name: str
    module: str              # chip_smoke_phases.<module>
    function: str            # the phase: function(ctx)
    needs: tuple = ()        # resources read: "main", "store", "streamed"
    background: str = ""     # function(ctx) starting the phase's side processes
    start_with: str = ""     # the phase at whose start they begin (default: its own)
    summary: str = ""

    def load(self, attr: str = ""):
        mod = importlib.import_module(f"{__name__}.{self.module}")
        return getattr(mod, attr or self.function)


_OMS = ("main",)
PHASES = (
    Phase(1, "env_build", "oms_kernels", "env_build",
          summary="card, power limit, toolchain; build the CUDA kernels"),
    Phase(2, "hdencode", "oms_kernels", "hdencode_check",
          summary="hdencode and the tile kernels at their edges against the plain versions"),
    Phase(3, "main_path", "oms_paths", "main_path", _OMS,
          summary="Table I main path; fused_search at k = 1, 4, grouped runs and edges"),
    Phase(4, "paths", "oms_paths", "paths", _OMS,
          summary="kernels against the plain torch ops, card against CPU"),
    Phase(5, "times", "oms_kernels", "times", _OMS,
          summary="hdencode and fused_search times, plain versions, bounds"),
    Phase(6, "tile_check", "oms_kernels", "tile_check", _OMS,
          summary="tile kernels on main-path blocks and the cascade's bucket; fused_search_mxu"),
    Phase(7, "fused_mxu_batch", "oms_kernels", "fused_mxu_batch", _OMS,
          summary="fused_search_mxu against fused_search on the whole batch"),
    Phase(8, "backends", "oms_paths", "backends", _OMS,
          summary="kernel_vpu, kernel_mxu, fused_mxu against fused"),
    Phase(9, "cascade", "oms_paths", "cascade", _OMS,
          summary="the dimension cascade, exact and margin mode"),
    Phase(10, "times_mxu", "oms_kernels", "times_mxu", _OMS,
          summary="tile kernels and fused_search_mxu times, plain versions, bounds"),
    Phase(11, "topk_limits", "oms_kernels", "topk_limits", _OMS,
          summary="top_k 17..1024 and the widened launch limits against the plain versions"),
    Phase(12, "store", "store_stream", "store", ("main", "store"),
          summary="store ingest and resident load against the in-memory DB"),
    Phase(13, "streamed", "store_stream", "streamed", ("main", "store", "streamed"),
          summary="streamed search at three slab sizes against resident fused"),
    Phase(14, "streamed_cascade", "store_stream", "streamed_cascade", ("main", "streamed"),
          summary="streamed exact cascade against the resident one"),
    Phase(15, "narrow_cascade", "store_stream", "narrow_cascade", ("main", "streamed"),
          summary="narrow-to-open cascade, resident and streamed"),
    Phase(18, "multi_device", "multi", "multi_device", ("main", "store", "streamed"),
          summary="sharded and multi-device streamed search against one device"),
    Phase(16, "launcher", "launcher", "launcher", ("main", "store"),
          summary="python -m repro_torch.launch.oms build, search, queries, serve, trace-report"),
    Phase(17, "tune_analyze", "tune_analyze", "tune_analyze", ("main", "store"),
          background="start_analyze", start_with="launcher",
          summary="tuner sweep, tuned search and serve; the contract analyzer"),
    Phase(19, "lm", "lm", "lm",
          summary="LM serve path: width checks, serve CLI, full models"),
    Phase(20, "train", "train", "train",
          summary="LM training: width checks, full model, checkpoint, launcher"),
    Phase(21, "dist", "dist", "dist", background="start_dryrun",
          summary="LM distribution: pipeline, elastic, sharded restore, dry run"),
    Phase(22, "examples", "examples", "examples", background="start_cpu_quickstart",
          start_with="dist", summary="the port's examples on the card and the CPU"),
)
NAMES = tuple(p.name for p in PHASES)
