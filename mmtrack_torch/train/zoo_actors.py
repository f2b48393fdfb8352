"""Training objectives of STARK, MixFormer, SiamFC, the MDNet family, KYS
and LWL, port of mmtrack_tpu/train/zoo_actors.py (:39-348, :391-442,
:472-500).

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
  - MDNet / APFNet (pyMDNet train_mdnet.py, APFNet train_stage{1,2,3}.py):
    the 2-way softmax cross-entropy of 32 positive and 96 negative 107-px
    patches a sample, cropped from the search crop taken back to 0..255
    around gaussian jitters of the target box (positives: centre 0.1,
    scale 0.1; negatives: 1.0, 0.5), fc6 branch 0, no dropout. The box
    draws come from a generator seeded from (seed, step), or are given
    (`noise=`), as dimp_actor.py's proposals are.
  - KYS (MotionTrackerActor, tracking_motion.py:10-163): the DiMP base is
    frozen and runs without gradient (one filter per sequence from its
    train frame, applied to the current frame); the predictor's state is
    seeded from the previous frame's label and its fused response on the
    current frame is held to LBHinge + 0.25 x the BCE of the state's
    is-target map against label > 0.25.
  - LWL (SegmSeqActor, segmentation.py:265-516, one-shot form; LWTLBoxActor,
    segm_box.py:61-113): boxes rasterised to masks (exact on the synthetic
    rectangles), the Lovász hinge of the segmentation. 'lwl' learns the
    filter on the template's mask and segments the search crop,
    differentiating through the Gauss-Newton learner (the reference's
    create_graph=True meta-learning); 'lwl_box' decodes the box encoder's
    mask encoding of the search crop, only the box encoder trainable.

Each `make_*_train_step` returns `train_step(state, batch, shard=SINGLE)
-> (state, stats)` over the sampler's global batch (template (B, T, T, C),
search (B, S, S, C), search_anno (B, 4) normalised xywh), run on
`shard`'s rows of it, the contract of train_step.make_train_step. Every
loss here is a mean over equal rows (GIoU, L1, the score BCE over B
positives and B negatives, LBHinge, the MDNet / APFNet patch CE over
B x 128 patches, the per-image Lovász mean) but SiamFC's, whose positive
and negative counts are summed over the ranks; the rolled negatives are
rows of the global batch's roll; LWL's one filter for the batch is learned
over the global batch (models/lwl.py::optimize_lwl_filter).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmtrack_torch.data.processing import MEAN_6, STD_6
from mmtrack_torch.ops.box import box_cxcywh_to_xyxy, box_xywh_to_xyxy
from mmtrack_torch.ops.crop import crop_resize
from mmtrack_torch.ops.losses import giou_loss, l1_loss, lb_hinge_loss, lovasz_hinge_loss
from mmtrack_torch.parallel.mesh import SINGLE, Shard
from mmtrack_torch.train.dimp_actor import gaussian_label_map, per_sequence_scores
from mmtrack_torch.train.train_step import (
    BATCH_KEYS,
    TrainState,
    apply_update,
    batch_to_device,
    compute_context,
    drop_path_generator,
)


def _bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of optax's sigmoid_binary_cross_entropy:
    -y log_sigmoid(x) - (1 - y) log_sigmoid(-x)."""
    return (-labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def _unnormalise(x: torch.Tensor) -> torch.Tensor:
    """The loader's crop x taken back to [0, 1]: x * std + mean."""
    c = x.shape[-1]
    return x * torch.from_numpy(STD_6[:c]).to(x.device) + torch.from_numpy(MEAN_6[:c]).to(x.device)


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


def _rolled_search(batch: dict, shard: Shard, dev) -> torch.Tensor:
    """`shard`'s rows of the global searches rolled one place along the
    batch: each row's negative is the previous sequence's search."""
    return torch.as_tensor(shard.rolled(batch["search"]), device=dev)


def make_stark_train_step(stage: str = "bbox", weights=(2.0, 5.0),
                          dtype: torch.dtype = torch.float32):
    """STARK's step (zoo_actors.py:53-86) for `stage` 'bbox' or 'score'."""

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = batch_to_device(shard.local_batch(batch, BATCH_KEYS), dev)
        with compute_context(dev, dtype):
            out = model(b["template"], b["search"])
            gt_xyxy = torch.clamp(box_xywh_to_xyxy(b["search_anno"]), 0, 1)
            if stage == "bbox":
                loss, stats = _box_loss(out["pred_boxes"], gt_xyxy, weights)
            else:
                neg_out = model(b["template"], _rolled_search(batch, shard, dev))
                loss, stats = _score_loss(_logit(out["pred_scores"].float()),
                                          _logit(neg_out["pred_scores"].float()))
        return apply_update(state, loss, stats, shard)

    return train_step


def make_mixformer_train_step(stage: str = "bbox", weights=(2.0, 5.0),
                              score_weight: float = 1.0, dtype: torch.dtype = torch.float32):
    """MixFormer's step (zoo_actors.py:93-127): the template is also the
    online template; stage 'score' pools the score head at the ground
    truth."""

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = batch_to_device(shard.local_batch(batch, BATCH_KEYS), dev)
        score = stage == "score"
        with compute_context(dev, dtype):
            gt_xyxy = torch.clamp(box_xywh_to_xyxy(b["search_anno"]), 0, 1)
            out = model(b["template"], b["template"], b["search"], run_score_head=score,
                        score_box_xyxy=gt_xyxy if score else None)
            if not score:
                loss, stats = _box_loss(out["pred_boxes"], gt_xyxy, weights)
            else:
                neg_out = model(b["template"], b["template"], _rolled_search(batch, shard, dev),
                                run_score_head=True, score_box_xyxy=gt_xyxy)
                loss, stats = _score_loss(out["score_logits"], neg_out["score_logits"],
                                          score_weight)
        return apply_update(state, loss, stats, shard)

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

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = batch_to_device(shard.local_batch(batch, BATCH_KEYS), dev)
        with compute_context(dev, dtype):
            resp = model(_unnormalise(b["template"]), _unnormalise(b["search"])).float()
            y = siamfc_response_labels(b["search_anno"], search_size, resp.shape[-1],
                                       total_stride)
            ll = torch.logaddexp(torch.zeros_like(resp), -y * resp)
            pos = (y > 0).float()
            neg = 1.0 - pos
            # the global batch's counts; each rank's share scaled by the world
            n_pos = shard.total(pos.sum()).clamp(min=1)
            n_neg = shard.total(neg.sum()).clamp(min=1)
            w = shard.world
            loss = 0.5 * ((ll * pos).sum() / n_pos + (ll * neg).sum() / n_neg) * w
            stats = {"Loss/total": loss, "Resp/pos_mean": (resp * pos).sum() / n_pos * w}
        return apply_update(state, loss, stats, shard)

    return train_step


# ------------------------------------------------------------ MDNet family

MDNET_PATCH = 107
# 16 px of context on each side at the 107-px patch (the runtime's
# RegionExtractor), a Python float that JAX rounds to f32 where it is used
MDNET_CONTEXT = (MDNET_PATCH + 32) / MDNET_PATCH
# (centre sigma x mean(w, h), log-scale sigma) of the positive and negative boxes
MDNET_JITTER = {"pos": (0.1, 0.1), "neg": (1.0, 0.5)}


def mdnet_box_noise(generator: torch.Generator, batch: int, n_pos: int, n_neg: int,
                    device) -> dict:
    """The standard normal draws of one step's patch boxes: per sign, the
    centre noise (B, n, 2) and the log-scale noise (B, n, 1)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {"pos": (normal(batch, n_pos, 2), normal(batch, n_pos, 1)),
            "neg": (normal(batch, n_neg, 2), normal(batch, n_neg, 1))}


def mdnet_sample_boxes(anno_xywh: torch.Tensor, search_sz: int, noise: dict) -> torch.Tensor:
    """Positive then negative patch boxes (B, n_pos + n_neg, 4) xywh in
    search-crop pixels around the normalised boxes (B, 4)
    (zoo_actors.py:176-200): centre + N x sigma_c x mean(w, h), size x
    exp(N x sigma_s)."""
    box = (anno_xywh * search_sz)[:, None]                          # (B, 1, 4)
    out = []
    for sign in ("pos", "neg"):
        c_noise, s_noise = noise[sign]
        pos_std, scale_std = MDNET_JITTER[sign]
        mean_wh = (box[..., 2] + box[..., 3]) / 2
        wh = box[..., 2:] * torch.exp(s_noise * scale_std)
        ctr = box[..., :2] + box[..., 2:] / 2 + c_noise * pos_std * mean_wh[..., None]
        out.append(torch.cat([ctr - wh / 2, wh], dim=-1))
    return torch.cat(out, dim=1)


def mdnet_training_patches(raw: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(B x N, 107, 107, C) patches of the 0..255 search crops (B, S, S, C)
    at their boxes (B, N, 4), with MDNet's 16 px of context
    (zoo_actors.py:202-206)."""
    patches, _ = crop_resize(raw, boxes, MDNET_CONTEXT, MDNET_PATCH)
    return patches.flatten(0, 1)


def make_mdnet_train_step(n_pos: int = 32, n_neg: int = 96, branch: int = 0, seed: int = 0,
                          dtype: torch.dtype = torch.float32):
    """The MDNet family's step (zoo_actors.py:212-243) for MDNet-dual and
    APFNet: `train_step(state, batch, noise=None)`, `noise` as
    mdnet_box_noise gives it."""

    def train_step(state: TrainState, batch: dict, noise=None, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = batch_to_device(shard.local_batch(batch, BATCH_KEYS), dev)
        search = b["search"]
        B, S = search.shape[0], search.shape[1]
        if noise is None:
            noise = mdnet_box_noise(drop_path_generator(seed, state.step, dev),
                                    len(batch["search"]), n_pos, n_neg, dev)
        noise = {k: tuple(torch.as_tensor(shard.local(t), device=dev) for t in v)
                 for k, v in noise.items()}
        raw = _unnormalise(search) * 255.0
        patches = mdnet_training_patches(raw, mdnet_sample_boxes(b["search_anno"], S, noise))
        labels = torch.cat([torch.ones(n_pos, device=dev), torch.zeros(n_neg, device=dev)])
        labels = labels.repeat(B)
        with compute_context(dev, dtype):
            logits = model((patches - 128.0).permute(0, 3, 1, 2), branch).float()
            logp = torch.log_softmax(logits, dim=-1)
            loss = -(labels * logp[:, 1] + (1 - labels) * logp[:, 0]).mean()
            acc = ((logits[:, 1] > logits[:, 0]) == (labels > 0.5)).float().mean()
        return apply_update(state, loss, {"Loss/total": loss, "Acc": acc}, shard)

    return train_step


# ------------------------------------------------------------------- KYS

KYS_FEAT_STRIDE = 16


def kys_pair_adapt_batch(batch: dict, search_sz: int, feat_stride: int = KYS_FEAT_STRIDE,
                         channels: int = 3) -> dict:
    """A collate_pair batch of tensors (KYSPairProcessing: the previous and
    current search frames in one crop) as KYS's step reads it
    (zoo_actors.py:422-442): the template is the filter's train frame, its
    box in crop pixels; Gaussian labels (kernel 4) of both search frames on
    the stride-16 grid; the first `channels` channels of each crop."""
    hS = search_sz // feat_stride
    return {
        "train_images": batch["template"][..., :channels],
        "train_anno": batch["template_anno"] * search_sz,
        "test_prev": batch["search_prev"][..., :channels],
        "test_cur": batch["search"][..., :channels],
        "label_prev": gaussian_label_map(batch["search_prev_anno"] * search_sz, hS, search_sz,
                                         kernel_sz=4),
        "label_cur": gaussian_label_map(batch["search_anno"] * search_sz, hS, search_sz,
                                        kernel_sz=4),
    }


KYS_BATCH_KEYS = ("template", "template_anno", "search", "search_anno", "search_prev",
                  "search_prev_anno")


def make_kys_train_step(image_sz: int = 288, channels: int = 3, clf_weight: float = 1.0,
                        is_target_weight: float = 0.25, filter_optim_iter: int = 5,
                        dtype: torch.dtype = torch.float32):
    """KYS's step (zoo_actors.py:247-317) on collate_pair batches at
    `image_sz`: the DiMP base under no_grad (JAX's stop_gradient), the
    predictor from the previous frame's label to the current frame's fused
    response. Only the predictor should be trainable (tools/train.py:
    362-366)."""

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = kys_pair_adapt_batch({k: torch.as_tensor(shard.local(batch[k]), device=dev)
                                  for k in KYS_BATCH_KEYS}, image_sz, channels=channels)
        label_cur = b["label_cur"]
        S = label_cur.shape[-1]
        with compute_context(dev, dtype):
            with torch.no_grad():
                bf_tr = model.extract_backbone(b["train_images"])
                bf_c = model.extract_backbone(b["test_cur"])
                score_cur = per_sequence_scores(
                    model, model.extract_classification_feat(bf_tr),
                    model.extract_classification_feat(bf_c), b["train_anno"],
                    filter_optim_iter)[:, :S, :S]
                feat_p = model.motion_feat(model.extract_backbone(b["test_prev"]))
                feat_c = model.motion_feat(bf_c)
            state0 = model.init_motion_state(b["label_prev"])
            fused, state1, _ = model.predict_response(feat_p, feat_c, state0, score_cur)
            fused = fused.float()
            loss_clf = lb_hinge_loss(fused, label_cur)
            is_target = model.predictor.predictor.is_target(state1).float()
            loss_aux = _bce_logits(is_target, (label_cur > 0.25).float())
            loss = clf_weight * loss_clf + is_target_weight * loss_aux
        return apply_update(state, loss, {"Loss/total": loss, "Loss/test_clf": loss_clf,
                                          "Loss/is_target": loss_aux}, shard)

    return train_step


# ------------------------------------------------------------------- LWL

def rect_masks(anno_px: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size, size) f32 masks of the boxes (B, 4) xywh in crop pixels:
    the pixels with y0 <= y < y0 + h and x0 <= x < x0 + w, in f32
    (zoo_actors.py:472-480)."""
    r = torch.arange(size, dtype=torch.float32, device=anno_px.device)
    ys, xs = r[None, :, None], r[None, None, :]
    x0, y0 = anno_px[:, 0, None, None], anno_px[:, 1, None, None]
    w, h = anno_px[:, 2, None, None], anno_px[:, 3, None, None]
    return ((ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)).float()


def lwl_adapt_batch(batch: dict, image_sz: int, template_factor: float, box_mode: bool,
                    channels: int = 3) -> dict:
    """A sampler batch of tensors as LWL's steps read it (zoo_actors.py:
    483-500): the template's box is the centred S / tf square (the crop's
    own construction, c = (S - S / tf) / 2 rounded to f32), the search box
    the normalised anno times S; boxes rasterised by rect_masks; the
    first `channels` channels of each crop. box_mode: the search crop, its
    box and mask alone."""
    S = image_sz
    side = S / template_factor
    c = (S - side) / 2.0
    dev = batch["search"].device
    anno_s = batch["search_anno"] * S
    if box_mode:
        return {"train_images": batch["search"][..., :channels], "train_anno": anno_s,
                "train_masks": rect_masks(anno_s, S)}
    anno_t = torch.tensor([c, c, side, side], dtype=torch.float32,
                          device=dev).repeat(batch["template"].shape[0], 1)
    return {"train_images": batch["template"][..., :channels],
            "test_images": batch["search"][..., :channels],
            "train_masks": rect_masks(anno_t, S), "test_masks": rect_masks(anno_s, S)}


def _mask_accuracy(seg: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    return ((seg > 0) == (masks > 0.5)).float().mean()


def make_lwl_train_step(image_sz: int = 256, template_factor: float = 6.0, channels: int = 3,
                        dtype: torch.dtype = torch.float32):
    """LWL's step (zoo_actors.py:318-348): the filter learned on the
    template's mask by the model's Gauss-Newton steps (ops/optimization.py::
    steepest_descent_gn; its torch.func vjp / jvp stay differentiable, so
    the backward runs through the learner to the label encoder, filter_reg
    and the target-model features), the search crop segmented, Lovász hinge
    against its mask. Every parameter trains (tools/train.py sets no
    mask)."""

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = lwl_adapt_batch(batch_to_device(shard.local_batch(batch, BATCH_KEYS), dev),
                            image_sz, template_factor, False, channels)
        with compute_context(dev, dtype):
            seg = model(b["train_images"], b["test_images"], b["train_masks"], shard).float()
            loss = lovasz_hinge_loss(seg, b["test_masks"])
        return apply_update(state, loss, {"Loss/total": loss, "Loss/segm": loss,
                                          "Acc": _mask_accuracy(seg, b["test_masks"])}, shard)

    return train_step


def make_lwl_box_train_step(image_sz: int = 256, template_factor: float = 6.0,
                            channels: int = 3, dtype: torch.dtype = torch.float32):
    """LWL-box's step (zoo_actors.py:391-419): the search crop's backbone
    and target-model features, the box encoder's mask encoding of its box
    decoded to the image (mask_from_box), Lovász hinge against the box's
    mask. Only box_label_encoder.* should be trainable (tools/train.py:
    397-399); the frozen backbone runs outside the graph."""

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        dev = next(model.parameters()).device
        b = lwl_adapt_batch(batch_to_device(shard.local_batch(batch, BATCH_KEYS), dev),
                            image_sz, template_factor, True, channels)
        im = b["train_images"]
        with compute_context(dev, dtype):
            bf = model.extract_backbone(im)
            tm = model.extract_target_model_features(bf)
            raw = model.mask_from_box(b["train_anno"], tm, bf, tuple(im.shape[1:3])).float()
            loss = lovasz_hinge_loss(raw, b["train_masks"])
        return apply_update(state, loss, {"Loss/total": loss, "Stats/acc_box_train":
                                          _mask_accuracy(raw, b["train_masks"])}, shard)

    return train_step
