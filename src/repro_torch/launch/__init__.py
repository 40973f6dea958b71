"""Entry points of the port (counterparts of ``repro.launch``):
``python -m repro_torch.launch.oms`` is the OMS launcher."""
