"""Assigned input shapes (the 4 cells per architecture) + applicability.

  train_4k     seq_len=4096   global_batch=256  -> train_step
  prefill_32k  seq_len=32768  global_batch=32   -> serve prefill
  decode_32k   seq_len=32768  global_batch=128  -> serve_step (1 token, KV=32k)
  long_500k    seq_len=524288 global_batch=1    -> serve_step; sub-quadratic
                                                   archs only (skip + note for
                                                   pure full-attention archs)
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). All 40 cells are enumerated; skips follow
    the assignment rules (long_500k only for sub-quadratic archs)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (O(S^2) / unbounded KV); see DESIGN.md"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs.registry import list_archs
    return [(a, s) for a in list_archs() for s in SHAPES]
