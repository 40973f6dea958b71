"""The packed Hamming kernels: the fused dual-window search (popc) and the
all-pairs Hamming tile (binary tensor cores); counterpart of
``repro.kernels.hamming``."""
