"""Entry points of the port (counterparts of ``repro.launch``):
``python -m repro_torch.launch.oms`` is the OMS launcher and
``python -m repro_torch.launch.serve`` the LM serving launcher."""
