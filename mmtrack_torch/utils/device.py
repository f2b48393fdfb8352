"""Device selection for the port: the chip path has no CPU fallback."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return the first CUDA device, or raise if CUDA is absent.

    Entry points that measure or drive the card call this first, so a
    machine without a card fails loudly instead of running on the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this entry point needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def set_f32_precision() -> None:
    """Full f32 for matrix products and cuDNN convolutions (no TF32), so the
    card computes what the JAX package's f32 models compute."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
