"""Training losses of the ViPT, DiMP and LWL objectives, port of
mmtrack_tpu/ops/losses.py (:14-89; ViPT lib/utils/focal_loss.py:8-63,
lib/train/actors/vipt.py:86-123; keep_track_vot2021/ltr/models/loss/
lovasz_loss.py:20-122)."""

from __future__ import annotations

import torch

from mmtrack_torch.ops.box import box_iou, generalized_box_iou


def focal_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 2.0,
               beta: float = 4.0) -> torch.Tensor:
    """CenterNet penalty-reduced focal loss over (..., S, S) score maps,
    normalised by the number of positives (target == 1)."""
    pos = (target == 1.0).to(pred.dtype)
    neg = (target < 1.0).to(pred.dtype)

    neg_weights = torch.pow(1.0 - target, beta)
    p = pred.clamp(min=1e-12)

    pos_loss = torch.log(p) * torch.pow(1.0 - p, alpha) * pos
    neg_loss = torch.log((1.0 - p).clamp(min=1e-12)) * torch.pow(p, alpha) * neg_weights * neg

    num_pos = pos.sum()
    pos_loss = pos_loss.sum()
    neg_loss = neg_loss.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def giou_loss(pred_xyxy: torch.Tensor,
              target_xyxy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean (1 - GIoU) and mean IoU over the batch."""
    giou = generalized_box_iou(pred_xyxy, target_xyxy)
    iou, _ = box_iou(pred_xyxy, target_xyxy)
    return (1.0 - giou).mean(), iou.mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def lb_hinge_loss(pred: torch.Tensor, label: torch.Tensor,
                  threshold: float = 0.05) -> torch.Tensor:
    """Lower-bound hinge MSE of DiMP's classifier: where the label is below
    `threshold` (background) only a positive prediction is an error."""
    negative = (label < threshold).to(pred.dtype)
    positive = 1.0 - negative
    pred_eff = negative * torch.clamp(pred, min=0.0) + positive * pred
    return ((pred_eff - positive * label) ** 2).mean()


def lovasz_hinge_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Lovász hinge, the binary Jaccard surrogate of LWL's training, per
    image then averaged (lovasz_hinge with per_image=True): the hinge
    errors 1 - logit * sign sorted in decreasing order, each weighted by
    its step of the Jaccard loss along that order.

    logits, labels (B, H, W), labels in {0, 1}. The order is a stable sort
    of the negated errors, as JAX's argsort: tied errors keep their pixel
    order, which decides the Jaccard steps of tied pixels with different
    labels, and so the gradient. The order and the steps depend on the
    labels and on the order only, so the gradient reaches the logits
    through the sorted errors alone."""
    B = logits.shape[0]
    logits = logits.reshape(B, -1)
    labels = labels.reshape(B, -1).to(logits.dtype)
    errors = 1.0 - logits * (2.0 * labels - 1.0)
    order = torch.sort(-errors, dim=1, stable=True).indices
    errors_sorted = torch.gather(errors, 1, order)
    gt_sorted = torch.gather(labels, 1, order)
    gts = gt_sorted.sum(dim=1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=1)
    jaccard = 1.0 - intersection / union
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)
    return (torch.maximum(errors_sorted, torch.zeros_like(errors_sorted)) * grad).sum(dim=1).mean()
