"""Hann windows and the Gaussian label map (port of mmtrack_tpu/ops/window.py)."""

from __future__ import annotations

import math

import torch


def hann1d(sz: int, centered: bool = True, dtype=torch.float32, device=None) -> torch.Tensor:
    """1D cosine window of length `sz` (ViPT lib/test/utils/hann.py:6-11).

    Centered: 0.5 (1 - cos(2 pi k / (sz + 1))) for k = 1..sz; uncentered
    puts the peak at index 0.
    """
    if centered:
        k = torch.arange(1, sz + 1, dtype=dtype, device=device)
        return 0.5 * (1.0 - torch.cos((2.0 * math.pi / (sz + 1)) * k))
    k = torch.arange(0, sz // 2 + 1, dtype=dtype, device=device)
    w = 0.5 * (1.0 + torch.cos((2.0 * math.pi / (sz + 2)) * k))
    return torch.cat([w, w[1:sz - sz // 2].flip(0)])


def hann2d(sz_h: int, sz_w: int | None = None, centered: bool = True, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """2D separable Hann window, shape (sz_h, sz_w)."""
    if sz_w is None:
        sz_w = sz_h
    wy = hann1d(sz_h, centered, dtype, device).reshape(-1, 1)
    wx = hann1d(sz_w, centered, dtype, device).reshape(1, -1)
    return wy * wx


def gauss_label_2d(sz_h: int, sz_w: int, sigma_h, sigma_w, center_y=0.0, center_x=0.0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Spatial Gaussian label map with its origin at the window centre
    (port of mmtrack_tpu/ops/window.py:43-55, the reference's
    label_function_spatial); sigmas and centres may be 0-dim tensors."""
    ky = torch.arange(-(sz_h - 1) / 2.0, (sz_h + 1) / 2.0, dtype=dtype, device=device)
    kx = torch.arange(-(sz_w - 1) / 2.0, (sz_w + 1) / 2.0, dtype=dtype, device=device)
    gy = torch.exp(-1.0 / (2.0 * sigma_h ** 2) * (ky - center_y) ** 2)
    gx = torch.exp(-1.0 / (2.0 * sigma_w ** 2) * (kx - center_x) ** 2)
    return gy.reshape(-1, 1) * gx.reshape(1, -1)
