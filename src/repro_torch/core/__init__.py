"""Core OMS modules of the port (counterparts of ``repro.core``)."""
