"""Utilities of the port (the roofline work counts)."""
