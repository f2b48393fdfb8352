"""Tensor ops of the port (kernel wrappers and plain PyTorch)."""
