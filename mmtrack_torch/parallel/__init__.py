"""Batched multi-sequence inference and the data-parallel layer of the port."""
