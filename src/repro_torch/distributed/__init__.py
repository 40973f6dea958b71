"""Multi-device OMS (counterpart of ``repro.distributed``'s collectives):
a mesh of devices, the sharded search with its tie-stable merge, the
store-to-mesh loader and the mesh's streaming engine. One process drives
every device. The reference package's ``__init__`` also exports the LM
sharding rules (``distributed/sharding.py``), which are not part of the
OMS system and have no counterpart here."""
from repro_torch.distributed.collectives import (ShardedDB, place_shards,
                                                 sharded_db_from_store,
                                                 sharded_search,
                                                 streaming_engine_for_mesh)
from repro_torch.distributed.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "ShardedDB", "place_shards", "sharded_search",
           "sharded_db_from_store", "streaming_engine_for_mesh"]
