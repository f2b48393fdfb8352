"""Batched multi-sequence inference of the port."""
