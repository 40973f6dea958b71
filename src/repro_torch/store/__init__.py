"""Near-storage library store: persistent sharded packed-HV references
(counterpart of ``repro.store``; the same directory format, byte for
byte)."""
from repro_torch.store.library_store import (DECOY, FORMAT_VERSION, TARGET,
                                             LibraryStore, ShardInfo,
                                             StoreConfigError, StoreError)

__all__ = ["LibraryStore", "ShardInfo", "StoreError", "StoreConfigError",
           "FORMAT_VERSION", "TARGET", "DECOY"]
