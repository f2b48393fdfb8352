"""Training objectives of STARK, MixFormer and SiamFC, port of
mmtrack_tpu/train/zoo_actors.py (:39-175).

  - STARK (SPT/lib/train, actors/stark_s.py + stark_st.py): stage 'bbox'
    is GIoU (2.0) + L1 (5.0) on the corner-decoded box; stage 'score' is
    the BCE of the score head on positive pairs and on negatives made by
    rolling the searches one place along the batch (another sequence, so
    the target is absent). The caller freezes all but the score head.
  - MixFormer (MixFormer_RGBD/lib/train, actors/mixformer.py): 'bbox' as
    STARK's on the corner head; 'score' the BCE of the SPM logit pooled at
    the ground-truth box, on the same rolled negatives.
  - SiamFC: the balanced logistic loss on the 17 x 17 response against
    +1 / -1 labels within 16 px of the target centre, on crops taken back
    from the loader's ImageNet normalisation to [0, 1], as the tracker
    feeds them.

Each `make_*_train_step` returns `train_step(state, batch) -> (state,
stats)` over the sampler's batch (template (B, T, T, C), search (B, S, S,
C), search_anno (B, 4) normalised xywh), the contract of
train_step.make_train_step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmtrack_torch.data.processing import MEAN_6, STD_6
from mmtrack_torch.ops.box import box_cxcywh_to_xyxy, box_xywh_to_xyxy
from mmtrack_torch.ops.losses import giou_loss, l1_loss
from mmtrack_torch.train.train_step import (
    TrainState,
    apply_update,
    batch_to_device,
    compute_context,
)


def _bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of optax's sigmoid_binary_cross_entropy:
    -y log_sigmoid(x) - (1 - y) log_sigmoid(-x)."""
    return (-labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def _logit(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.clamp(p, eps, 1 - eps)
    return torch.log(p) - torch.log1p(-p)


def _box_loss(pred_cxcywh, gt_xyxy, weights):
    pred_xyxy = box_cxcywh_to_xyxy(pred_cxcywh.float())
    g, iou = giou_loss(pred_xyxy, gt_xyxy)
    l1 = l1_loss(pred_xyxy, gt_xyxy)
    loss = weights[0] * g + weights[1] * l1
    return loss, {"Loss/total": loss, "Loss/giou": g, "Loss/l1": l1, "IoU": iou}


def _score_loss(pos_logits, neg_logits, weight: float = 1.0):
    logits = torch.cat([pos_logits, neg_logits]).float()
    labels = torch.cat([torch.ones_like(pos_logits), torch.zeros_like(neg_logits)]).float()
    loss = weight * _bce_logits(logits, labels)
    acc = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, {"Loss/total": loss, "Acc": acc}


def make_stark_train_step(stage: str = "bbox", weights=(2.0, 5.0),
                          dtype: torch.dtype = torch.float32):
    """STARK's step (zoo_actors.py:53-86) for `stage` 'bbox' or 'score'."""

    def train_step(state: TrainState, batch: dict):
        model = state.model
        b = batch_to_device(batch, next(model.parameters()).device)
        with compute_context(b["search"].device, dtype):
            out = model(b["template"], b["search"])
            gt_xyxy = torch.clamp(box_xywh_to_xyxy(b["search_anno"]), 0, 1)
            if stage == "bbox":
                loss, stats = _box_loss(out["pred_boxes"], gt_xyxy, weights)
            else:
                neg_out = model(b["template"], torch.roll(b["search"], 1, dims=0))
                loss, stats = _score_loss(_logit(out["pred_scores"].float()),
                                          _logit(neg_out["pred_scores"].float()))
        return apply_update(state, loss, stats)

    return train_step


def make_mixformer_train_step(stage: str = "bbox", weights=(2.0, 5.0),
                              score_weight: float = 1.0, dtype: torch.dtype = torch.float32):
    """MixFormer's step (zoo_actors.py:93-127): the template is also the
    online template; stage 'score' pools the score head at the ground
    truth."""

    def train_step(state: TrainState, batch: dict):
        model = state.model
        b = batch_to_device(batch, next(model.parameters()).device)
        score = stage == "score"
        with compute_context(b["search"].device, dtype):
            gt_xyxy = torch.clamp(box_xywh_to_xyxy(b["search_anno"]), 0, 1)
            out = model(b["template"], b["template"], b["search"], run_score_head=score,
                        score_box_xyxy=gt_xyxy if score else None)
            if not score:
                loss, stats = _box_loss(out["pred_boxes"], gt_xyxy, weights)
            else:
                neg_out = model(b["template"], b["template"], torch.roll(b["search"], 1, dims=0),
                                run_score_head=True, score_box_xyxy=gt_xyxy)
                loss, stats = _score_loss(out["score_logits"], neg_out["score_logits"],
                                          score_weight)
        return apply_update(state, loss, stats)

    return train_step


def siamfc_response_labels(anno_xywh: torch.Tensor, search_size: int, response_sz: int,
                           total_stride: int, r_pos_px: float = 16.0) -> torch.Tensor:
    """(B, r, r) labels: +1 within r_pos_px of the target centre on the
    response grid, -1 outside (zoo_actors.py:130-143); anno normalised to
    the search crop."""
    cx = (anno_xywh[:, 0] + anno_xywh[:, 2] / 2 - 0.5) * search_size
    cy = (anno_xywh[:, 1] + anno_xywh[:, 3] / 2 - 0.5) * search_size
    c = (response_sz - 1) / 2.0
    grid = torch.arange(response_sz, dtype=torch.float32, device=anno_xywh.device)
    dy = (grid[None, :, None] - c) * total_stride - cy[:, None, None]
    dx = (grid[None, None, :] - c) * total_stride - cx[:, None, None]
    dist = torch.sqrt(dy * dy + dx * dx)
    return torch.where(dist <= r_pos_px, 1.0, -1.0)


def make_siamfc_train_step(search_size: int = 255, total_stride: int = 8,
                           dtype: torch.dtype = torch.float32):
    """SiamFC's step (zoo_actors.py:146-175)."""

    def train_step(state: TrainState, batch: dict):
        model = state.model
        b = batch_to_device(batch, next(model.parameters()).device)
        c = b["search"].shape[-1]
        std = torch.from_numpy(STD_6[:c]).to(b["search"].device)
        mean = torch.from_numpy(MEAN_6[:c]).to(b["search"].device)
        with compute_context(b["search"].device, dtype):
            resp = model(b["template"] * std + mean, b["search"] * std + mean).float()
            y = siamfc_response_labels(b["search_anno"], search_size, resp.shape[-1],
                                       total_stride)
            ll = torch.logaddexp(torch.zeros_like(resp), -y * resp)
            pos = (y > 0).float()
            neg = 1.0 - pos
            n_pos, n_neg = pos.sum().clamp(min=1), neg.sum().clamp(min=1)
            loss = 0.5 * ((ll * pos).sum() / n_pos + (ll * neg).sum() / n_neg)
            stats = {"Loss/total": loss, "Resp/pos_mean": (resp * pos).sum() / n_pos}
        return apply_update(state, loss, stats)

    return train_step
