"""Multi-device work from one controller (counterpart of
``repro.distributed``): a mesh of devices; for the OMS search, the sharded
search with its tie-stable merge, the store-to-mesh loader and the mesh's
streaming engine; for the LM, the sharding rules (``sharding.py``), the
GPipe schedule (``pipeline.py``) and the elastic remesh (``elastic.py``).
One process drives every device."""
from repro_torch.distributed.collectives import (ShardedDB, place_shards,
                                                 sharded_db_from_store,
                                                 sharded_search,
                                                 streaming_engine_for_mesh)
from repro_torch.distributed.mesh import Mesh, make_mesh
from repro_torch.distributed.sharding import (batch_pspecs, cache_pspecs,
                                              opt_state_pspecs, param_pspecs)

__all__ = ["Mesh", "make_mesh", "ShardedDB", "place_shards", "sharded_search",
           "sharded_db_from_store", "streaming_engine_for_mesh", "param_pspecs",
           "opt_state_pspecs", "batch_pspecs", "cache_pspecs"]
