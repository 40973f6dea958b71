"""Fused dual-window search kernel (counterpart of the fused half of
``repro.kernels.hamming``)."""
