"""Operations and bytes of the program's hand-written kernels, per call,
and the share of the roofline a traced window reaches.

A call's bound is max(operations / the bf16 tensor peak, bytes / the HBM
bandwidth), with each input byte read once and each output byte written
once. A kernel's share of its roofline over a window is the sum of its
calls' bounds over the sum of their device times (torch.profiler). The
peaks are the card's datasheet numbers (`peaks.json`), looked up by the
name torch.cuda.get_device_name() gives.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

BF16, F32 = 2, 4
EPI_BIAS, EPI_GELU, EPI_RESIDUAL = "bias", "gelu", "residual"


def peaks(device_name: str) -> dict:
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r} in peaks.json")
    return table[device_name]


def bound_s(ops: float, nbytes: float, pk: dict) -> float:
    return max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])


def gemm(M: int, N: int, K: int, epilogue: str) -> tuple[float, float]:
    """y = epilogue(x @ w^T + b): x (M, K) bf16, w (N, K) bf16, b (N,) f32,
    y (M, N) bf16, the residual (M, N) bf16 read when there is one."""
    nbytes = (M * K + N * K + M * N) * BF16 + N * F32
    if epilogue == EPI_RESIDUAL:
        nbytes += M * N * BF16
    return 2.0 * M * N * K, float(nbytes)


def attention(B: int, L: int, C: int) -> tuple[float, float]:
    """softmax(q k^T s) v from a fused (B, L, 3C) bf16 qkv to (B, L, C)
    bf16: q k^T and p v, 2 L^2 C each per sequence."""
    return 4.0 * B * L * L * C, float(4 * B * L * C * BF16)


def crop_bytes(boxes: np.ndarray, H: int, W: int, C: int, S: int, factor: float) -> float:
    """Bytes of one crop launch over (B, 4) xywh boxes: the f32 output
    (B, S, S, C), and of each frame the source pixels its bilinear taps
    can read (the distinct rows times the distinct columns sampled; row
    H-1, column W-1 and the outside read none)."""
    total = float(boxes.shape[0] * S * S * C * F32)
    j = np.arange(S, dtype=np.float32) + np.float32(0.5)
    for x, y, w, h in np.asarray(boxes, np.float32):
        side = max(np.float32(math.ceil(np.float32(np.sqrt(np.float32(w * h))) * np.float32(factor))),
                   np.float32(1.0))
        x1 = np.round(x + np.float32(0.5) * w - side * np.float32(0.5))
        y1 = np.round(y + np.float32(0.5) * h - side * np.float32(0.5))
        s = np.minimum(np.maximum(j * (side / np.float32(S)) - np.float32(0.5), 0), side - 1)

        def used(origin, n):
            t = np.floor(origin + s).astype(np.int64)
            taps = np.unique(np.concatenate([t, t + 1]))
            return int(((taps >= 0) & (taps < n - 1)).sum())

        total += used(y1, H) * used(x1, W) * C
    return total


def share(calls: list[tuple[float, float]], device_s: float, pk: dict) -> float | None:
    """100 x the sum of the calls' bounds over their device seconds."""
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(o, b, pk) for o, b in calls) / device_s
