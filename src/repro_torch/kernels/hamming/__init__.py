"""The popc kernels: fused dual-window search and the all-pairs Hamming
tile (counterpart of ``repro.kernels.hamming``)."""
