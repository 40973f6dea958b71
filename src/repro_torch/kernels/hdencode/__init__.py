"""ID-Level encode kernel (counterpart of ``repro.kernels.hdencode``)."""
