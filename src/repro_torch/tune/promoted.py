"""Per-device PROMOTED launch parameters (stdlib only).

Counterpart of ``repro.tune.promoted``. The on-disk winner cache
(:mod:`repro_torch.tune.cache`) is the machine-local tier: whatever ``oms.py
tune`` measured on THIS machine. This module is the reviewed, committed
tier: a sweep winner that should ship for everyone on a device kind gets
promoted here, and thereby into the ``peak_intermediate`` contract bounds
(``repro_torch.core.backends`` states its bounds through
``repro_torch.tune.tiles_for``, which layers ``kernel defaults < PROMOTED <
cache``). The bound moves because the declared constant moved, visibly, in
this file, and ``oms.py analyze`` checks it.

It starts empty: the reference's winners were measured on other hardware,
and a winner is promoted only by a change that measures it on the card.
"""
from __future__ import annotations

# (device_kind, backend) -> partial launch-parameter dict. Keys match the
# sweep grid: waves / min_split_rows for the fused backends, ctas_per_sm
# for the tile backends, row_bucket for the "rescore" pseudo-backend.
# Absent keys fall back to the kernel defaults.
PROMOTED: dict[tuple[str, str], dict[str, int]] = {}

# Fallback pow2 floor for core.search.row_bucket when neither the cache
# nor PROMOTED names a tuned one.
DEFAULT_ROW_BUCKET_LO = 64


def declared_tiles(device_kind: str, backend: str) -> dict[str, int] | None:
    return PROMOTED.get((device_kind, backend))
