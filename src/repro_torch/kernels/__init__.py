"""Hand-written CUDA kernels of the port (counterparts of ``repro.kernels``)
and their plain PyTorch versions."""
