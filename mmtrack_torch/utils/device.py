"""Device selection for the port: the chip path has no CPU fallback."""

from __future__ import annotations

import os

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


def set_deterministic() -> None:
    """Deterministic algorithms for every op of this process: an op with no
    deterministic CUDA form raises and names itself, cuDNN picks
    deterministic convolutions, and cuBLAS gets the fixed workspace it needs
    for reproducible products (CUBLAS_WORKSPACE_CONFIG, read when cuBLAS
    first runs, so call this before any product on the card)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False


_CONSTANTS: dict = {}


def device_constant(key: tuple, build, device, dtype=None) -> torch.Tensor:
    """`build()` (a numpy array or a CPU tensor) as a tensor on `device`
    (in `dtype` when given), built and copied there once per key, device
    and dtype, outside inference mode so that a training step can save it
    for its backward."""
    full = key + (torch.device(device), dtype)
    t = _CONSTANTS.get(full)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(build()).to(device=device, dtype=dtype)
        _CONSTANTS[full] = t
    return t
