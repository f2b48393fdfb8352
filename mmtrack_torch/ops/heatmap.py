"""CenterNet-style Gaussian target heatmaps, port of mmtrack_tpu/ops/heatmap.py
(:14-73; ViPT lib/utils/heapmap_utils.py:5-96): one closed-form expression
over the (S, S) grid for the whole batch."""

from __future__ import annotations

import torch


def gaussian_radius(wh: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet Gaussian radius for boxes of size wh[..., (w, h)], with the
    reference's kept "bug version" quadratic roots
    (heapmap_utils.py:40-68)."""
    w, h = wh[..., 0], wh[..., 1]

    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2

    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * 4 * c2).clamp(min=0.0))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / (2 * a3)

    return torch.minimum(r1, torch.minimum(r2, r3))


def generate_heatmap(boxes_norm: torch.Tensor, heatmap_size: int,
                     min_overlap: float = 0.7) -> torch.Tensor:
    """(..., S, S) f32 target maps for normalised xywh boxes (..., 4): a
    Gaussian of sigma (2r+1)/6 at the rounded box centre, zero outside
    |dx|, |dy| <= r, the radius clamped at 0 and truncated to an integer."""
    S = heatmap_size
    bbox = boxes_norm * S
    wh = bbox[..., 2:]
    centers = torch.round(bbox[..., :2] + wh / 2.0)
    radius = gaussian_radius(wh, min_overlap).clamp(min=0.0).to(torch.int32).float()

    dev = boxes_norm.device
    ii = torch.arange(S, dtype=torch.float32, device=dev).reshape(S, 1)   # rows = y
    jj = torch.arange(S, dtype=torch.float32, device=dev).reshape(1, S)   # cols = x

    cx = centers[..., 0][..., None, None]
    cy = centers[..., 1][..., None, None]
    r = radius[..., None, None]
    sigma = (2.0 * r + 1.0) / 6.0

    dx = jj - cx
    dy = ii - cy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    inside = (dx.abs() <= r) & (dy.abs() <= r)
    return torch.where(inside, g, torch.zeros_like(g))
