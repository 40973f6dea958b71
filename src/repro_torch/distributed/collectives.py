"""Sharded OMS search: the paper's multi-SmartSSD scale-out over several
devices (counterpart of ``repro.distributed.collectives``).

The paper deploys up to 24 SmartSSDs, each holding a DB slab and searching
it independently; the results merge on the host. Here:

  * the blocked ``ReferenceDB`` is split into contiguous PMZ slabs, one per
    ``model``-axis device (``shard_reference_db`` pads to a block
    boundary at the end, so real rows keep their numbers);
  * the queries are copied to every shard's device;
  * each device runs the single-device blocked dual-window search
    (``_search_sorted_padded``, so the ``fused`` / ``fused_mxu`` CUDA
    kernels) on its slab;
  * the per-shard (Q, k) winners, offset into the global row space, merge
    on the first model-axis device in ascending shard order with the
    first-maximum selection — the same (sim desc, row asc) tie order as
    the reference's all-gather + running argmax.

One process drives every device, as the reference's ``shard_map`` over a
``Mesh`` does: each shard's search is enqueued on its own device before
the merge reads anything, so shards on distinct cards run concurrently,
and nothing in the loop waits for the host. No ``torch.distributed``
process group is involved.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.blocking import ReferenceDB, shard_reference_db
from repro_torch.core.search import SearchParams, _search_sorted_padded
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels.topk import select_topk
from repro_torch.serve.engine import StreamingEngine

_DB_ROW_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx")
_DB_BLOCK_FIELDS = ("block_min", "block_max", "block_charge")


def _merge_best(sims: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
                k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine per-shard (Q, k) ranked winners into global (Q, k) on
    ``device``. ``sims`` / ``rows`` are in ascending shard order and each
    list is (sim desc, row asc), so the first-maximum selection over the
    (Q, S * k) concatenation keeps the global (sim desc, row asc) order."""
    s = torch.stack([x.to(device) for x in sims], dim=1)     # (Q, S, k)
    r = torch.stack([x.to(device) for x in rows], dim=1)
    Q, S = s.shape[0], s.shape[1]
    s, r = s.reshape(Q, S * k), r.reshape(Q, S * k)
    best, col = select_topk(s, k)
    picked = torch.gather(r, 1, col.clamp(0, S * k - 1).long())
    return best, torch.where(col >= 0, picked, -1)


@dataclasses.dataclass
class ShardedDB:
    """A blocked ``ReferenceDB`` cut into equal runs of whole blocks:
    ``shards[s]`` holds blocks ``[s * blocks_per_shard, (s + 1) *
    blocks_per_shard)`` on its model-axis device."""

    shards: list[ReferenceDB]
    max_r: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].n_rows

    @property
    def blocks_per_shard(self) -> int:
        return self.shards[0].n_blocks

    @property
    def n_rows(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def n_blocks(self) -> int:
        return self.blocks_per_shard * self.n_shards


def place_shards(db: ReferenceDB, devices: Sequence) -> ShardedDB:
    """Cut ``db`` (its block count a multiple of ``len(devices)``) into
    contiguous runs of whole blocks and move run ``s`` to ``devices[s]``
    (a view where it already lies there)."""
    n = len(devices)
    if n < 1 or db.n_blocks % n:
        raise ValueError(f"{db.n_blocks} blocks do not split into {n} shards")
    bps = db.n_blocks // n
    rps = bps * db.max_r
    shards = []
    for s, dev in enumerate(devices):
        rows = {f: getattr(db, f)[s * rps:(s + 1) * rps].to(dev)
                for f in _DB_ROW_FIELDS}
        blocks = {f: getattr(db, f)[s * bps:(s + 1) * bps].to(dev)
                  for f in _DB_BLOCK_FIELDS}
        shards.append(ReferenceDB(**rows, **blocks, max_r=db.max_r))
    return ShardedDB(shards, db.max_r)


def sharded_search(db: ReferenceDB | ShardedDB, q_hvs, q_pmz, q_charge,
                   params: SearchParams, *, dim: int, mesh: Mesh,
                   model_axis: str = "model", data_axes=("data",)):
    """Distributed blocked search. Queries must be (charge, pmz)-sorted and
    padded to ``q_block`` (``sort_pad_plan``), on any device.

    A ``ReferenceDB`` is padded with ``shard_reference_db`` and placed on
    the model-axis devices; a ``ShardedDB`` is used as it is. Each
    model-axis shard is computed once, on the first device of its
    data-axis column (``data_axes`` is accepted for the reference's
    signature: the queries are replicated over every axis). The reference
    computes the duplicates there, and its outputs are replicated, so the
    results are the same. Returns ``((std_sim, std_row, open_sim,
    open_row), sharded_db)``: four (Qp, top_k) int32 tensors on the first
    model-axis device, rows global over the sharded DB (-1 where empty).
    """
    del data_axes
    devices = mesh.axis_devices(model_axis)
    if isinstance(db, ShardedDB):
        if db.n_shards != len(devices):
            raise ValueError(f"ShardedDB has {db.n_shards} shards, the mesh's "
                             f"{model_axis!r} axis {len(devices)} devices")
        sdb = db
    else:
        sdb = place_shards(shard_reference_db(db, len(devices)), devices)
    local = params._replace(k_blocks=min(params.k_blocks, sdb.blocks_per_shard))
    # Copy the queries to every shard's device before any search is
    # enqueued: a copy between cards waits for all work queued on both, so
    # a copy made after shard 0's launch would hold shard 1 behind it.
    queries = {d: tuple(x.to(d) for x in (q_hvs, q_pmz, q_charge))
               for d in dict.fromkeys(sh.device for sh in sdb.shards)}
    parts = []
    for s, shard in enumerate(sdb.shards):
        std_b, std_row, open_b, open_row = _search_sorted_padded(
            shard, *queries[shard.device], params=local, dim=dim)
        off = s * sdb.rows_per_shard
        parts.append((std_b, torch.where(std_row >= 0, std_row + off, std_row),
                      open_b, torch.where(open_row >= 0, open_row + off, open_row)))
    merge_dev, k = sdb.shards[0].device, params.top_k
    std_b, std_row = _merge_best([p[0] for p in parts], [p[1] for p in parts],
                                 k, merge_dev)
    open_b, open_row = _merge_best([p[2] for p in parts], [p[3] for p in parts],
                                   k, merge_dev)
    return (std_b, std_row, open_b, open_row), sdb


# ---------------------------------------------------------------------------
# Near-storage loading: store shards -> mesh slabs
# ---------------------------------------------------------------------------


def streaming_engine_for_mesh(store_or_layout, mesh: Mesh, *, max_r: int,
                              slab_rows: int, model_axis: str = "model",
                              prefetch: bool = True):
    """A :class:`~repro_torch.serve.StreamingEngine` whose slab stream is
    dealt round-robin over the ``model``-axis devices of the mesh's first
    data row: the multi-SmartSSD scale-out with the library streamed
    instead of slab-resident (:func:`sharded_db_from_store`). Partial
    winners merge on the first of them in ascending slab order, so results
    equal the one-device engine's and a resident search's."""
    return StreamingEngine(store_or_layout, max_r=max_r, slab_rows=slab_rows,
                           devices=mesh.axis_devices(model_axis),
                           prefetch=prefetch)


def sharded_db_from_store(store, mesh: Mesh, *, max_r: int,
                          model_axis: str = "model") -> ShardedDB:
    """Cold-start the sharded serving DB straight from a LibraryStore: the
    store's sorted runs merge into the blocked layout on the host
    (memory-mapped reads, no re-encoding), the block dimension is padded
    so it splits into ``mesh.shape[model_axis]`` runs, and each run is
    copied to its model-axis device — the library is never whole on one
    card. The result feeds :func:`sharded_search` directly."""
    devices = mesh.axis_devices(model_axis)
    db = shard_reference_db(store.load_reference_db(max_r=max_r, device="cpu"),
                            len(devices))
    return place_shards(db, devices)
