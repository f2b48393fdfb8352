"""Bounding-box algebra, port of mmtrack_tpu/ops/box.py (:17-91): the
conversions, IoU and GIoU the training loss needs, and the tracker's clip.

Boxes are (..., 4): xywh = (x_left, y_top, w, h), cxcywh = (cx, cy, w, h),
xyxy = (x1, y1, x2, y2).
"""

from __future__ import annotations

import torch


def box_xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise IoU of xyxy boxes with matching leading dims -> (iou, union)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of xyxy boxes (DETR-style, as the ViPT loss uses it)."""
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    enclosing = (wh[..., 0] * wh[..., 1]).clamp(min=1e-9)
    return iou - (enclosing - union) / enclosing


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
