"""PyTorch/CUDA port of the RapidOMS reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch.core.encoding`` is the
counterpart of ``repro.core.encoding`` and so on. The port imports ``torch``
and numpy only — never ``jax`` and never ``repro`` — so it runs where JAX is
absent. The TPU kernels on the resident search path are hand-written CUDA
kernels under ``repro_torch/kernels/**/csrc``; each has a plain PyTorch
version beside it, used when its tensors lie on the CPU.

Entry points (``OMSPipeline`` and friends) run on the card unless the caller
passes ``device="cpu"``; see :func:`repro_torch._device.resolve_device`.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
