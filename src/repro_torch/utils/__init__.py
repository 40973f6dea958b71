"""Utilities of the port: the roofline work counts and the tree helpers."""
from repro_torch.utils.treeutil import tree_bytes, tree_count
