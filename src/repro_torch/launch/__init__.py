"""Entry points of the port (counterparts of ``repro.launch``):
``python -m repro_torch.launch.oms`` is the OMS launcher,
``python -m repro_torch.launch.serve`` the LM serving launcher and
``python -m repro_torch.launch.train`` the LM training launcher."""
