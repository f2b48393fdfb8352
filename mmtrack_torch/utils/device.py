"""Device selection for the port: the chip path has no CPU fallback."""

from __future__ import annotations

import os
import subprocess

import torch

from mmtrack_torch.utils import profiling


def require_cuda() -> torch.device:
    """Return the first CUDA device, or raise if CUDA is absent.

    Entry points that measure or drive the card call this first, so a
    machine without a card fails loudly instead of running on the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this entry point needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi gives them
    (`name, power.limit`), the tag every speed number of the port carries."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def capture_graph(fn, device, warmup=None, key=None):
    """fn() captured as one CUDA graph on a side stream of `device`.
    `warmup` (fn when not given) runs there first, eagerly: library
    handles, the convolutions' algorithm choice, the kernel library's
    build and its one-time function attributes, and constants are made
    then, outside the capture. Returns (graph, what the captured call
    returned, its `profiling.Capture` under `key`: the graph's node count,
    and under `profiling.tracing()` the device spans that each replay
    stamps; call its `replayed()` after each replay). The graph's tensors
    live in its private pool, and every replay rewrites them."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        (warmup or fn)()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with profiling.capturing(device, key) as capture:
        with torch.cuda.graph(graph, stream=stream):
            out = fn()
        capture.count_nodes(graph)
    graph.instantiate()
    return graph, out, capture


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
