"""Synthetic datasets of the port (counterpart of ``repro.data``)."""
