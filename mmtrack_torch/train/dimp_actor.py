"""The DiMP family's training objective, port of
mmtrack_tpu/train/dimp_actor.py (:19-143; DiMPActor, RGBD/models/DeT/ltr/
actors/tracking.py:7-67).

The loss couples the IoUNet's proposal regression (MSE between the
predicted IoUs and the proposals' true IoUs mapped to [-1, 1]) with the
LBHinge of the target scores against a Gaussian label at the ground truth,
weighted 1 : 100. Each sequence of the batch learns its own filter from
its own train frame (the unrolled steepest-descent optimizer, through
which the gradient flows), as JAX's `vmap` over the batch does.

The proposals' normal noise is drawn from a `torch.Generator` seeded from
(seed, step), as the drop-path masks of train_step.py are; a step may be
given the noise instead (`noise=`), which is how the tests feed JAX's
`jax.random.normal` draws through both steps.
"""

from __future__ import annotations

import torch

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.ops.box import box_iou, box_xywh_to_xyxy
from mmtrack_torch.ops.losses import lb_hinge_loss
from mmtrack_torch.parallel.mesh import SINGLE, Shard
from mmtrack_torch.train.train_step import (
    TrainState,
    apply_update,
    compute_context,
    drop_path_generator,
)

N_PROPOSALS = 8


def gaussian_label_map(bb_xywh: torch.Tensor, score_sz: int, image_sz: int,
                       sigma_factor: float = 0.25, kernel_sz: int = 4) -> torch.Tensor:
    """Gaussian classification label (B, s, s) at the target centre, sigma
    = sigma_factor x the box's base size (dimp_actor.py:19-32)."""
    feat_stride = image_sz / (score_sz - (kernel_sz + 1) % 2)
    centers = div_const(bb_xywh[:, :2] + bb_xywh[:, 2:] / 2, feat_stride)
    offset = (kernel_sz % 2) / 2.0
    cy, cx = centers[:, 1] - offset, centers[:, 0] - offset
    sigma = div_const(sigma_factor * torch.sqrt(bb_xywh[:, 2] * bb_xywh[:, 3]), feat_stride)
    grid = torch.arange(score_sz, dtype=torch.float32, device=bb_xywh.device)
    d2 = ((grid[None, :, None] - cy[:, None, None]) ** 2
          + (grid[None, None, :] - cx[:, None, None]) ** 2)
    return torch.exp(-0.5 * d2 / torch.clamp(sigma[:, None, None] ** 2, min=1e-6))


def proposal_noise(generator: torch.Generator, batch: int, device,
                   n_proposals: int = N_PROPOSALS) -> torch.Tensor:
    """The (B, n, 4) standard normal draws of one step's proposals."""
    return torch.randn((batch, n_proposals, 4), generator=generator, device=device)


def make_proposals(gt_xywh: torch.Tensor, noise: torch.Tensor,
                   sigma: float = 0.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Jittered proposals (B, n, 4) around the boxes (B, 4) and their true
    IoUs (B, n): box + noise x sigma x (w, h, w, h), sizes at least 1
    (dimp_actor.py:35-45); `noise` is (B, n, 4) standard normal."""
    scale = torch.cat([gt_xywh[:, 2:], gt_xywh[:, 2:]], dim=1)
    proposals = gt_xywh[:, None] + (noise * sigma) * scale[:, None]
    proposals = torch.cat([proposals[..., :2], torch.clamp(proposals[..., 2:], min=1.0)], -1)
    iou, _ = box_iou(box_xywh_to_xyxy(proposals), box_xywh_to_xyxy(gt_xywh)[:, None])
    return proposals, iou


def per_sequence_scores(model, train_clf: torch.Tensor, test_clf: torch.Tensor,
                        train_bb: torch.Tensor, num_iter=None) -> torch.Tensor:
    """One filter per sequence: initialised and optimised on that
    sequence's train features alone, then applied to its test features
    (dimp_actor.py:82-102). (B, H, W, C) x2, (B, 4) -> scores (B, s, s)."""
    scores = []
    for i in range(train_clf.shape[0]):
        tc, bb = train_clf[i:i + 1], train_bb[i:i + 1]
        w = model.optimize_filter(model.get_filter(tc, bb), tc, bb, None, num_iter)
        scores.append(model.classify(w, test_clf[i:i + 1])[0])
    return torch.stack(scores)


def dimp_forward_and_loss(model, batch: dict, noise: torch.Tensor, *, image_sz: int = 288,
                          loss_weights=(1.0, 100.0)) -> tuple[torch.Tensor, dict]:
    """batch: train_im / test_im (B, S, S, C), train_bb / test_bb (B, 4) in
    crop pixels; noise (B, n, 4) for the proposals. Returns (loss, stats)
    (dimp_actor.py:105-143)."""
    proposals, gt_iou = make_proposals(batch["test_bb"], noise)
    train_feat = model.extract_backbone(batch["train_im"])
    test_feat = model.extract_backbone(batch["test_im"])
    iou_pred = model.bb_regressor([train_feat["layer2"], train_feat["layer3"]],
                                  [test_feat["layer2"], test_feat["layer3"]],
                                  batch["train_bb"], proposals)
    scores = per_sequence_scores(model, model.extract_classification_feat(train_feat),
                                 model.extract_classification_feat(test_feat),
                                 batch["train_bb"])

    iou_w, clf_w = loss_weights
    loss_iou = ((iou_pred.float() - (gt_iou * 2.0 - 1.0)) ** 2).mean()
    label = gaussian_label_map(batch["test_bb"], scores.shape[-1], image_sz)
    loss_clf = lb_hinge_loss(scores.float(), label)
    loss = iou_w * loss_iou + clf_w * loss_clf
    return loss, {"Loss/total": loss, "Loss/iou": loss_iou, "Loss/clf": loss_clf}


def make_dimp_train_step(*, image_sz: int = 288, loss_weights=(1.0, 100.0), seed: int = 0,
                         dtype: torch.dtype = torch.float32):
    """Build `train_step(state, batch, noise=None, shard=SINGLE) -> (state,
    stats)` for DiMP and DeT (dimp_actor.py:48-79). batch: template /
    search (B, S, S, C) normalised crops with template_anno / search_anno
    normalised xywh, scaled here to crop pixels by `image_sz`; `noise`
    the global batch's (B, n, 4) proposal draws. The step runs on
    `shard`'s rows; both losses are means over equal rows."""

    def train_step(state: TrainState, batch: dict, noise=None, shard: Shard = SINGLE):
        model = state.model
        device = next(model.parameters()).device
        b = {k: torch.as_tensor(shard.local(batch[k]), device=device)
             for k in ("template", "search", "template_anno", "search_anno")}
        dimp_batch = {"train_im": b["template"], "test_im": b["search"],
                      "train_bb": b["template_anno"] * image_sz,
                      "test_bb": b["search_anno"] * image_sz}
        if noise is None:
            noise = proposal_noise(drop_path_generator(seed, state.step, device),
                                   len(batch["search"]), device)
        with compute_context(device, dtype):
            loss, stats = dimp_forward_and_loss(
                model, dimp_batch, torch.as_tensor(shard.local(noise), device=device),
                image_sz=image_sz, loss_weights=loss_weights)
        return apply_update(state, loss, stats, shard)

    return train_step
