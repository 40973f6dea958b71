"""The +-1 int8 tensor-core kernels: the all-pairs Hamming tile and the
fused dual-window search (counterpart of ``repro.kernels.hamming_mxu``)."""
