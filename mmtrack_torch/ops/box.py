"""Box clipping (port of mmtrack_tpu/ops/box.py::clip_box, :77-91)."""

from __future__ import annotations

import torch


def clip_box(box: torch.Tensor, img_h, img_w, margin: float = 0.0) -> torch.Tensor:
    """Clip xywh boxes (..., 4) to the image, keeping at least `margin` px
    inside (ViPT lib/utils/box_ops.py clip_box)."""
    x1, y1, w, h = box.unbind(-1)
    x2, y2 = x1 + w, y1 + h
    x1 = x1.clamp(0.0, img_w - margin)
    x2 = x2.clamp(margin, img_w)
    y1 = y1.clamp(0.0, img_h - margin)
    y2 = y2.clamp(margin, img_h)
    w = torch.clamp(x2 - x1, min=margin)
    h = torch.clamp(y2 - y1, min=margin)
    return torch.stack([x1, y1, w, h], dim=-1)
