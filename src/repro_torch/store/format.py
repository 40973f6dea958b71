"""Store format constants (counterpart of ``repro.store.format``), shared
by the ingest writer (``repro_torch.core.pipeline``) and the store; the
directory format is the reference's, byte for byte."""
# v2: m/z binning multiplies by a host-computed 1/bin_size; stores written
# under v1 are not query-compatible and are refused.
FORMAT_VERSION = 2

TARGET = "target"
DECOY = "decoy"

# Per-shard files: "<name>.<part>.npy" for each part below.
SIDECARS = ("hvs", "pmz", "charge", "decoy", "orig")

# Manifest keys that must match the serving OMSConfig for search-compatible
# query encoding (codebooks + preprocessing all derive from these).
CONFIG_KEYS = ("dim", "n_levels", "bin_size", "mz_min", "mz_max", "seed",
               "add_decoys")
