"""Bounding-box algebra, port of mmtrack_tpu/ops/box.py: the conversions
between the three forms, IoU and GIoU, the tracker's clip, and the map of
an image box into a crop's coordinates.

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


def box_xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def box_xywh_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x + 0.5 * w, y + 0.5 * h, w, h], dim=-1)


def box_cxcywh_to_xywh(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, w, h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def box_area_xyxy(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise IoU of xyxy boxes with matching leading dims -> (iou, union)."""
    area_a, area_b = box_area_xyxy(a), box_area_xyxy(b)
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


def transform_image_to_crop(box_in: torch.Tensor, box_extract: torch.Tensor, resize_factor,
                            crop_sz: float, normalize: bool = False) -> torch.Tensor:
    """An xywh image box in the coordinates of a crop centred on
    `box_extract` and resized by `resize_factor` (processing_utils.py:86-109),
    divided by `crop_sz` when `normalize`."""
    extract_center = box_extract[..., :2] + 0.5 * box_extract[..., 2:]
    in_center = box_in[..., :2] + 0.5 * box_in[..., 2:]
    out_center = (crop_sz - 1) / 2.0 + (in_center - extract_center) * resize_factor
    out_wh = box_in[..., 2:] * resize_factor
    out = torch.cat([out_center - 0.5 * out_wh, out_wh], dim=-1)
    return out / crop_sz if normalize else out
