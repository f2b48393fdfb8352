"""The ViPT training objective, port of mmtrack_tpu/train/actor.py (:20-75;
ViPTActor, ViPT lib/train/actors/vipt.py:48-123): forward the 6-channel
template/search pair, then loss = GIOU_W * (1 - GIoU) + L1_W * L1 (both on
clamped xyxy) + FOCAL_W * focal loss of the centre heatmap against a
CenterNet Gaussian target."""

from __future__ import annotations

import math
from typing import Optional

import torch

from mmtrack_torch.ops.box import box_cxcywh_to_xyxy, box_xywh_to_xyxy
from mmtrack_torch.ops.heatmap import generate_heatmap
from mmtrack_torch.ops.losses import focal_loss, giou_loss, l1_loss
from mmtrack_torch.parallel.mesh import SINGLE, Shard


def adjust_keep_rate(epoch: int, warmup_epochs: int, total_epochs: int,
                     base_keep_rate: float = 0.7, max_keep_rate: float = 1.0) -> float:
    """Cosine CE keep-rate anneal per epoch (ce_utils.py:68-80): 1.0 before
    `warmup_epochs`, `base_keep_rate` from `total_epochs` on."""
    if epoch < warmup_epochs:
        return 1.0
    if epoch >= total_epochs:
        return base_keep_rate
    t = (epoch - warmup_epochs) / (total_epochs - warmup_epochs)
    return base_keep_rate + (max_keep_rate - base_keep_rate) * (math.cos(t * math.pi) + 1) * 0.5


def quantize_keep_rate(rate: float, levels=(0.7, 0.8, 0.9, 1.0)) -> float:
    """Snap the annealed keep rate to the JAX package's static set, so the
    schedule is the same one step per level."""
    return min(levels, key=lambda level: abs(level - rate))


def vipt_forward_and_loss(model, batch: dict, *, box_mask_z, ce_keep_lens,
                          weights=(2.0, 5.0, 1.0), search_size: int = 256,
                          stride: int = 16,
                          generator: Optional[torch.Generator] = None,
                          shard: Shard = SINGLE):
    """Returns (loss, stats). batch: template (B,T,T,6), search (B,S,S,6),
    search_anno (B,4) xywh normalised to the search crop, `shard`'s rows
    of the global batch. Drop path is active exactly when a `generator`
    is given."""
    out = model(batch["template"], batch["search"], box_mask_z, ce_keep_lens,
                deterministic=generator is None, generator=generator)
    return vipt_loss(out, batch["search_anno"], weights, search_size, stride, shard)


def vipt_loss(out: dict, gt_bbox: torch.Tensor, weights=(2.0, 5.0, 1.0),
              search_size: int = 256, stride: int = 16, shard: Shard = SINGLE):
    """The objective of the model's outputs `out` (pred_boxes, score_map)
    against the (B, 4) xywh boxes: returns (loss, stats), `shard`'s share
    of the global batch's (GIoU and L1 are means over equal rows; the
    focal loss divides by the positives of the global batch)."""
    pred_xyxy = box_cxcywh_to_xyxy(out["pred_boxes"])
    gt_xyxy = box_xywh_to_xyxy(gt_bbox).clamp(0.0, 1.0)

    giou_l, iou = giou_loss(pred_xyxy, gt_xyxy)
    l1_l = l1_loss(pred_xyxy, gt_xyxy)
    focal_l = focal_loss(out["score_map"], generate_heatmap(gt_bbox, search_size // stride),
                         shard=shard)

    gw, lw, fw = weights
    loss = gw * giou_l + lw * l1_l + fw * focal_l
    stats = {"Loss/total": loss, "Loss/giou": giou_l, "Loss/l1": l1_l,
             "Loss/location": focal_l, "IoU": iou}
    return loss, stats
