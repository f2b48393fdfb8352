"""DiMP / DeT / PrDiMP online tracker runtime, port of
mmtrack_tpu/trackers/dimp_tracker.py.

Init: the 2x-expanded crop at the rounded target centre, the 13 image
augmentations and 2 feature-dropout copies (or the plain crop), the
filter initialised and optimised over them, the IoU modulation from the
identity sample, and the 50-slot memory seeded with weight 1/N.

A step: the sample crop (`ops/crop.py::crop_at`, the plain gather the JAX
step uses) at the reference's integer geometry, the backbones, the
filter's scores (PrDiMP: their softmax), ATOM's advanced localisation
(the not_found / uncertain / hard_negative lattice), the IoUNet's
gradient ascent on the boxes, the min-weight memory replacement and the
filter update: 1 iteration on a hard negative, 2 every 20th frame, else
none.

Everything a decision touches stays a tensor on the frames' device and is
selected with `torch.where`, as the JAX step does; so a frame reads the
card once, for its outputs. The filter update runs a masked loop of
max(net_opt_update_iter, net_opt_hn_iter) iterations (models/dimp.py
`_iterate`): a masked iteration leaves the filter bit-equal. The memory
slot is written in place (`index_copy_`), the old row kept where the
frame does not update. The IoU ascent needs autograd on the boxes, so
the facade runs under `torch.no_grad` (not inference mode: inference
tensors cannot enter autograd) and only the ascent enables grad.

Random draws: JAX draws from threefry keys (PRNGKey(0) split into a shift
and a dropout key at init, one split per step for the box jitter). The
port takes its uniforms from a draw source `draw(kind, shape)` with kind
'shift' (n_rand, 2), 'dropout' (num, 1, 1, C) or 'jitter' (P - 1, 4),
returning CPU f32 tensors: by default `TorchDraws`, a CPU
`torch.Generator` seeded with the recipe's seed at every initialize, so
a CPU run and a card run draw the same numbers. Tests inject a source
that follows JAX's keys.

Constants default to DeT_DiMP50_Max; `prdimp50_runtime` gives PrDiMP-50's.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mmtrack_torch.models.dimp import DiMPNet, div_const
from mmtrack_torch.ops.augment import (
    dimp_init_augmentations,
    feature_dropout,
    num_image_augmentations,
    num_random_shifts,
)
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.trackers.vipt_tracker import MEAN_6CH, STD_6CH, as_frames

FLAG_NORMAL, FLAG_NOT_FOUND, FLAG_UNCERTAIN, FLAG_HARD_NEG = 0, 1, 2, 3
FLAG_NAMES = ("normal", "not_found", "uncertain", "hard_negative")


@dataclass(frozen=True)
class DiMPRuntime:
    """The JAX runtime's fields (dimp_tracker.py:40-103)."""
    image_sample_size: int = 288
    search_area_scale: float = 5.0
    feat_stride: int = 16
    kernel_size: int = 4
    sample_memory_size: int = 50
    learning_rate: float = 0.01
    init_samples_minimum_weight: float = 0.25
    train_skipping: int = 20
    net_opt_iter: int = 10
    net_opt_update_iter: int = 2
    net_opt_hn_iter: int = 1
    target_not_found_threshold: float = 0.25
    distractor_threshold: float = 0.8
    hard_negative_threshold: float = 0.5
    target_neighborhood_scale: float = 2.2
    displacement_scale: float = 0.8
    hard_negative_learning_rate: float = 0.02
    target_inside_ratio: float = 0.2
    # False: classifier-only tracking, the scale re-quantised from the
    # sample geometry (dimp.py:130-131)
    use_iou_net: bool = True
    iounet_k: int = 3
    num_init_random_boxes: int = 9
    box_jitter_pos: float = 0.1
    box_jitter_sz: float = 0.5
    maximal_aspect_ratio: float = 6.0
    box_refinement_iter: int = 5
    box_refinement_step_length: float = 1.0
    # 'default' (box space scaled by size) | 'relative' (PrDiMP's
    # [cx/sw, cy/sh, log w, log h])
    box_refinement_space: str = "default"
    # 'replicate' | 'inside' | 'inside_major' (sample_patch's border modes)
    border_mode: str = "replicate"
    patch_max_scale_change: float = float("inf")
    # 'none' | 'softmax' (PrDiMP localises on the softmax of the scores)
    score_preprocess: str = "none"
    use_augmentation: bool = True
    augmentation_expansion_factor: int = 2
    random_shift_factor: float = 1.0 / 3.0
    aug_dropout_num: int = 2
    aug_dropout_prob: float = 0.2

    @property
    def num_init_samples(self) -> int:
        if not self.use_augmentation:
            return 1
        return num_image_augmentations() + self.aug_dropout_num

    @property
    def feat_sz(self) -> int:
        return self.image_sample_size // self.feat_stride

    @property
    def score_sz(self) -> int:
        return self.feat_sz + (self.kernel_size + 1) % 2

    @property
    def max_update_iter(self) -> int:
        """Iterations of the masked filter-update loop a frame runs."""
        return max(self.net_opt_update_iter, self.net_opt_hn_iter)


def prdimp50_runtime(**overrides) -> DiMPRuntime:
    """PrDiMP-50's constants (dimp_tracker.py:574-585): 352 px samples at
    scale 6, inside_major borders, softmax scores with a 0.04 not-found
    threshold, relative box refinement (2.5e-3 x 10)."""
    base = dict(image_sample_size=22 * 16, search_area_scale=6.0,
                border_mode="inside_major", patch_max_scale_change=1.5,
                score_preprocess="softmax", target_not_found_threshold=0.04,
                box_refinement_space="relative", box_refinement_iter=10,
                box_refinement_step_length=2.5e-3)
    base.update(overrides)
    return DiMPRuntime(**base)


class TorchDraws:
    """The default draw source: uniforms from a CPU torch.Generator."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(seed)

    def __call__(self, kind: str, shape: tuple) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator)


@functools.lru_cache(maxsize=None)
def _vec(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant f32 vector on `device`, made once: `torch.tensor(...,
    device=cuda)` copies from pageable memory, which waits for the stream."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def _to_device(u: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host uniforms to the card without a stream sync (a pinned copy)."""
    if device.type != "cuda":
        return u.to(device)
    return u.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=None)
def _norm_constants(c: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and the f32 reciprocal of the std of c channels."""
    with torch.inference_mode(False):
        return (torch.from_numpy(MEAN_6CH[:c]).to(device),
                torch.from_numpy(np.float32(1.0) / STD_6CH[:c]).to(device))


def _normalize(patch: torch.Tensor) -> torch.Tensor:
    """(patch / 255 - mean) / std, the divisions by constants as the jitted
    JAX step takes them (models/dimp.py::div_const)."""
    mean, inv_std = _norm_constants(patch.shape[-1], patch.device)
    return (div_const(patch, 255.0) - mean) * inv_std


def _sample_geometry(rt: DiMPRuntime, pos_yx: torch.Tensor, target_scale: torch.Tensor,
                     out_size: Optional[int] = None, im_hw=None):
    """The reference's integer crop geometry (dimp_tracker.py:112-160):
    centre by truncation, side by rounding (the inside modes: shrunk to
    the image and truncated), tl = posl - (szl - 1) // 2, br = posl +
    szl // 2 + 1, shifted inside the image in the inside modes. Returns
    (szl, tl (y, x), sample_pos, sample_scale), f32 tensors.

    The shrink divides by the image size as the jitted JAX step does, by a
    product with its f32 reciprocal (models/dimp.py::div_const): the side
    trunc(x / (x / size)) then comes out one pixel short where the true
    division, as the reference computes it, gives the size itself."""
    S = rt.image_sample_size if out_size is None else out_size
    posl = torch.trunc(pos_yx)
    im_sz = None
    if rt.border_mode in ("inside", "inside_major") and im_hw is not None:
        im_sz = _vec((float(im_hw[0]), float(im_hw[1])), pos_yx.device)
        inv_im = _vec(tuple(float(np.float32(1.0) / np.float32(v)) for v in im_hw),
                      pos_yx.device)
        shrink = (target_scale * S) * inv_im
        shrink = shrink.max() if rt.border_mode == "inside" else shrink.min()
        shrink = torch.clamp(shrink, 1.0, rt.patch_max_scale_change)
        szl = torch.clamp(torch.trunc(target_scale * S / shrink), min=2.0)
    else:
        szl = torch.clamp(torch.round(target_scale * S), min=2.0)
    tl = posl - torch.floor((szl - 1.0) / 2.0)
    br = posl + torch.floor(szl / 2.0) + 1.0
    if im_sz is not None:
        shift = torch.clamp(-tl, min=0.0) - torch.clamp(br - im_sz, min=0.0)
        tl, br = tl + shift, br + shift
        outside = torch.floor((torch.clamp(-tl, min=0.0) + torch.clamp(br - im_sz, min=0.0)) / 2.0)
        shift = (-tl - outside) * (outside > 0)
        tl, br = tl + shift, br + shift
    sample_pos = 0.5 * (tl + br - 1.0)
    sample_scale = div_const(szl, S)
    return szl, tl, sample_pos, sample_scale


def _get_iounet_box(rt: DiMPRuntime, pos_yx, sz_hw, sample_pos, sample_scale) -> torch.Tensor:
    """Image-coordinate target -> (x, y, w, h) in the crop frame."""
    box_center = (pos_yx - sample_pos) / sample_scale + (rt.image_sample_size - 1) / 2
    box_sz = sz_hw / sample_scale
    ul = box_center - (box_sz - 1) / 2
    return torch.cat([ul.flip(0), box_sz.flip(0)])


def _max2d(scores: torch.Tensor):
    """(value, (row, col) f32) of the map's maximum; ties go to the first
    index in row-major order (torch.argmax, as jnp.argmax)."""
    idx = torch.argmax(scores)
    W = scores.shape[1]
    return scores.max(), torch.stack([idx // W, idx % W]).float()


def dimp_init_state(rt: DiMPRuntime, model: DiMPNet, frame: torch.Tensor,
                    init_box_xywh: torch.Tensor, draw: Callable) -> dict:
    """First-frame state (dimp_tracker.py:178-244). frame (H, W, C) uint8
    on the model's device, init box (4,) f32 on it."""
    x, y, w, h = init_box_xywh.unbind()
    pos = torch.stack([y + (h - 1) / 2, x + (w - 1) / 2])
    target_sz = torch.stack([h, w])
    search_area = torch.prod(target_sz * rt.search_area_scale)
    target_scale = div_const(torch.sqrt(search_area), rt.image_sample_size)
    base_target_sz = target_sz / target_scale
    # the init sample sits at the rounded centre; its box uses the exact
    # target_scale, not the rounded szl / S
    init_sample_pos = torch.round(pos)
    box_crop = _get_iounet_box(rt, pos, target_sz, init_sample_pos, target_scale)

    if rt.use_augmentation:
        S_e = rt.image_sample_size * rt.augmentation_expansion_factor
        szl_e, tl_e, _, _ = _sample_geometry(rt, init_sample_pos, target_scale, out_size=S_e)
        expanded = _normalize(crop_at(frame, init_sample_pos, szl_e, S_e, origin_yx=tl_e))
        patches, shifts = dimp_init_augmentations(
            expanded, rt.image_sample_size, draw("shift", (num_random_shifts(), 2)),
            random_shift_factor=rt.random_shift_factor)
        bfeat = model.extract_backbone(patches)
        clf_feat = model.extract_classification_feat(bfeat)
        if rt.aug_dropout_num > 0:
            u = draw("dropout", (rt.aug_dropout_num, 1, 1, clf_feat.shape[-1]))
            drop = feature_dropout(clf_feat[0], _to_device(u, clf_feat.device),
                                   rt.aug_dropout_prob)
            clf_feat = torch.cat([clf_feat, drop])
        shifts = torch.cat([shifts, shifts.new_zeros((rt.aug_dropout_num, 2))])
        boxes = box_crop[None] + torch.cat([shifts.flip(1), torch.zeros_like(shifts)], dim=1)
        bfeat0 = {k: v[:1] for k, v in bfeat.items()}
    else:
        szl, tl, _, _ = _sample_geometry(rt, init_sample_pos, target_scale)
        patch = _normalize(crop_at(frame, init_sample_pos, szl, rt.image_sample_size,
                                   origin_yx=tl))
        bfeat0 = model.extract_backbone(patch[None])
        clf_feat = model.extract_classification_feat(bfeat0)
        boxes = box_crop[None]
    return dimp_assemble_init_state(rt, model, clf_feat, boxes, bfeat0, box_crop, pos,
                                    target_sz, target_scale, base_target_sz)


def dimp_assemble_init_state(rt: DiMPRuntime, model: DiMPNet, clf_feat, boxes, bfeat0,
                             box_crop, pos, target_sz, target_scale, base_target_sz) -> dict:
    """The state from extracted init samples (dimp_tracker.py:247-289):
    the filter initialised and optimised over the N samples, the IoU
    modulation of the identity sample, the memory seeded with weight 1/N.
    The memory's features are (M, S, S, C) views of NCHW storage."""
    N, S, _, C = clf_feat.shape
    M, dev = rt.sample_memory_size, clf_feat.device
    w0 = model.get_filter(clf_feat, boxes)
    filt = model.optimize_filter(w0, clf_feat, boxes, None, rt.net_opt_iter)
    mod3, mod4 = model.bb_regressor.get_modulation([bfeat0["layer2"], bfeat0["layer3"]],
                                                   box_crop[None])
    memory_feat = torch.zeros((M, C, S, S), dtype=torch.float32, device=dev).permute(0, 2, 3, 1)
    memory_feat[:N] = clf_feat
    memory_boxes = torch.zeros((M, 4), dtype=torch.float32, device=dev)
    memory_boxes[:N] = boxes
    sample_weights = torch.zeros((M,), dtype=torch.float32, device=dev)
    sample_weights[:N] = 1.0 / N
    i32 = dict(dtype=torch.int32, device=dev)
    return {"pos": pos, "target_sz": target_sz, "target_scale": target_scale,
            "base_target_sz": base_target_sz, "filter": filt,
            "memory_feat": memory_feat, "memory_boxes": memory_boxes,
            "sample_weights": sample_weights,
            "num_stored": torch.tensor(N, **i32), "prev_replace_ind": torch.tensor(-1, **i32),
            "frame_num": 1, "iou_mod3": mod3[0], "iou_mod4": mod4[0],
            "last_flag": torch.tensor(-1, **i32)}


def _localize_advanced(rt: DiMPRuntime, scores: torch.Tensor, state: dict, sample_pos,
                       sample_scale):
    """ATOM's distractor-aware localisation (dimp_tracker.py:292-343).
    Returns (translation (y, x), flag, max score)."""
    S = rt.score_sz
    output_sz = float(S - (rt.kernel_size + 1) % 2)
    score_center = (S - 1) / 2.0
    dev = scores.device

    max1, disp1 = _max2d(scores)
    target_disp1 = disp1 - score_center
    scale_fac = (rt.image_sample_size / output_sz) * sample_scale
    trans1 = target_disp1 * scale_fac

    # mask the target's neighbourhood (round half to even, the +1 bottom /
    # right edge, clamped to the map) and find the second peak
    neigh = rt.target_neighborhood_scale * (state["target_sz"] / sample_scale) \
        * (output_sz / rt.image_sample_size)
    iy = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    top = torch.clamp(torch.round(disp1[0] - neigh[0] / 2), min=0.0)
    bottom = torch.clamp(torch.round(disp1[0] + neigh[0] / 2 + 1), max=float(S))
    left = torch.clamp(torch.round(disp1[1] - neigh[1] / 2), min=0.0)
    right = torch.clamp(torch.round(disp1[1] + neigh[1] / 2 + 1), max=float(S))
    inside = (iy >= top) & (iy < bottom) & (ix >= left) & (ix < right)
    max2, disp2 = _max2d(torch.where(inside, 0.0, scores))
    target_disp2 = disp2 - score_center
    trans2 = target_disp2 * scale_fac

    prev_vec = (state["pos"] - sample_pos) / scale_fac
    disp_norm1 = torch.sqrt(((target_disp1 - prev_vec) ** 2).sum())
    disp_norm2 = torch.sqrt(((target_disp2 - prev_vec) ** 2).sum())
    disp_thresh = rt.displacement_scale * math.sqrt(S * S) / 2

    not_found = max1 < rt.target_not_found_threshold
    distractor = max2 > rt.distractor_threshold * max1
    hn_d1 = distractor & (disp_norm2 > disp_thresh) & (disp_norm1 < disp_thresh)
    hn_d2 = distractor & (disp_norm2 < disp_thresh) & (disp_norm1 > disp_thresh)
    uncertain_d = distractor & ~hn_d1 & ~hn_d2
    hard_neg2 = (~distractor & (max2 > rt.hard_negative_threshold * max1)
                 & (max2 > rt.target_not_found_threshold))
    flag = torch.where(not_found, FLAG_NOT_FOUND,
                       torch.where(hn_d1 | hn_d2, FLAG_HARD_NEG,
                                   torch.where(uncertain_d, FLAG_UNCERTAIN,
                                               torch.where(hard_neg2, FLAG_HARD_NEG,
                                                           FLAG_NORMAL))))
    translation = torch.where(hn_d2 & ~not_found, trans2, trans1)
    return translation, flag.to(torch.int32), max1


def _refine_box(rt: DiMPRuntime, model: DiMPNet, bfeat: dict, state: dict, sample_pos,
                sample_scale, jitter_u: Optional[torch.Tensor]):
    """IoUNet gradient ascent (dimp_tracker.py:346-427): the current box
    and num_init_random_boxes jittered ones (`jitter_u` (P - 1, 4)
    uniforms), box_refinement_iter ascent steps, the top-k mean of the
    boxes with a plausible aspect ratio. As JAX (and the reference) do,
    the boxes after the last step are ranked by the IoU predicted before
    it. Returns (pos, sz, scale, ok)."""
    init_box = _get_iounet_box(rt, state["pos"], state["target_sz"], sample_pos, sample_scale)
    if rt.num_init_random_boxes > 0:
        sq = torch.sqrt(torch.prod(init_box[2:]))
        rand_factor = sq * _vec((rt.box_jitter_pos, rt.box_jitter_pos, rt.box_jitter_sz,
                                 rt.box_jitter_sz), init_box.device)
        min_edge = div_const(torch.min(init_box[2:]), 3)
        r = (jitter_u - 0.5) * rand_factor
        new_sz = torch.maximum(init_box[2:] + r[:, 2:], min_edge)
        new_center = init_box[:2] + init_box[2:] / 2 + r[:, :2]
        boxes = torch.cat([init_box[None], torch.cat([new_center - new_sz / 2, new_sz], 1)])
    else:
        boxes = init_box[None]

    iounet = model.bb_regressor
    att = iounet.modulate((state["iou_mod3"][None], state["iou_mod4"][None]),
                          iounet.get_iou_feat([bfeat["layer2"], bfeat["layer3"]]))

    def iou_and_grad(x, to_rect):
        """IoU of the boxes `to_rect(x)` (P,) and its gradient in x."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            ious = iounet.predict_modulated(att, to_rect(x)[None])[0]
            (g,) = torch.autograd.grad(ious, x, torch.ones_like(ious))
        return ious.detach(), g

    step = rt.box_refinement_step_length
    ious = torch.zeros((boxes.shape[0],), dtype=boxes.dtype, device=boxes.device)
    if rt.box_refinement_space == "relative":
        sz_norm = boxes[:1, 2:]

        def to_rect(rel):
            sz = torch.exp(rel[:, 2:])
            c = rel[:, :2] * sz_norm
            return torch.cat([c - 0.5 * sz, sz], dim=1)

        c0 = boxes[:, :2] + 0.5 * boxes[:, 2:]
        rel = torch.cat([c0 / sz_norm, torch.log(boxes[:, 2:])], dim=1)
        for _ in range(rt.box_refinement_iter):
            ious, g = iou_and_grad(rel, to_rect)
            rel = rel + step * g
        boxes = to_rect(rel)
    else:
        for _ in range(rt.box_refinement_iter):
            ious, g = iou_and_grad(boxes, lambda b: b)
            boxes = boxes + step * g * boxes[:, 2:].repeat(1, 2)

    boxes = torch.cat([boxes[:, :2], torch.clamp(boxes[:, 2:], min=1.0)], dim=1)
    ar = boxes[:, 2] / boxes[:, 3]
    keep = (ar < rt.maximal_aspect_ratio) & (ar > 1 / rt.maximal_aspect_ratio)
    ious_k = torch.where(keep, ious, -math.inf)
    top_iou, top_idx = torch.topk(ious_k, min(rt.iounet_k, boxes.shape[0]))
    valid = torch.isfinite(top_iou)
    denom = torch.clamp(valid.sum(), min=1)
    pred = (boxes[top_idx] * valid[:, None]).sum(0) / denom

    new_pos = (pred[:2] + pred[2:] / 2).flip(0)
    new_pos = (new_pos - (rt.image_sample_size - 1) / 2) * sample_scale + sample_pos
    new_sz = pred[2:].flip(0) * sample_scale
    new_scale = torch.sqrt(torch.prod(new_sz) / torch.prod(state["base_target_sz"]))
    return new_pos, new_sz, new_scale, keep.any()


def _update_memory(rt: DiMPRuntime, state: dict, clf_feat: torch.Tensor, box_crop: torch.Tensor,
                   lr: torch.Tensor, update_ok: Optional[torch.Tensor] = None) -> dict:
    """Min-weight sample replacement (dimp_tracker.py:430-462) with the
    init samples protected. The memory's row is written in place
    (`index_copy_` into state['memory_feat'] / ['memory_boxes']); with
    `update_ok` (a bool tensor) false the frame leaves every field as it
    was. Returns the new state."""
    sw = state["sample_weights"]
    num, prev = state["num_stored"], state["prev_replace_ind"]
    M, num_init = rt.sample_memory_size, rt.num_init_samples
    slots = torch.arange(M, device=sw.device)
    cand = torch.where(slots >= num_init, sw, math.inf)
    r_ind = torch.where(num < M, num, torch.argmin(cand).to(torch.int32)).reshape(1)

    first_update = prev < 0
    sw1 = torch.where(first_update, sw / (1 - lr), sw)
    prev_w = sw1.gather(0, torch.clamp(prev, min=0).long().reshape(1))[0]
    new_w = torch.where(first_update, lr, prev_w / (1 - lr))
    sw1 = sw1.index_put((r_ind.long(),), new_w.reshape(1))
    sw1 = sw1 / sw1.sum()
    need = sw1[:num_init].sum() < rt.init_samples_minimum_weight
    rest = sw1[num_init:].sum()
    sw2 = sw1 / (rt.init_samples_minimum_weight + rest)
    sw2[:num_init] = rt.init_samples_minimum_weight / num_init
    sw1 = torch.where(need, sw2, sw1)
    new_num = torch.clamp(num + 1, max=M)

    idx, new_prev = r_ind.long(), r_ind[0]
    feat, boxes = clf_feat[None], box_crop[None]
    if update_ok is not None:
        feat = torch.where(update_ok, feat, state["memory_feat"].index_select(0, idx))
        boxes = torch.where(update_ok, boxes, state["memory_boxes"].index_select(0, idx))
        sw1 = torch.where(update_ok, sw1, sw)
        new_num = torch.where(update_ok, new_num, num)
        new_prev = torch.where(update_ok, new_prev, prev)
    state["memory_feat"].index_copy_(0, idx, feat)
    state["memory_boxes"].index_copy_(0, idx, boxes)
    return {**state, "sample_weights": sw1, "num_stored": new_num.to(torch.int32),
            "prev_replace_ind": new_prev.to(torch.int32)}


def dimp_step_from_patch(rt: DiMPRuntime, model: DiMPNet, state: dict, patch: torch.Tensor,
                         sample_pos, sample_scale, img_hw, jitter_u: Optional[torch.Tensor]):
    """A tracked frame from its raw (0..255) sample patch (S, S, C) and
    geometry (dimp_tracker.py:478-571). Returns (state, box (4,) xywh,
    max score, aux {'flag', 'num_iter'}), all tensors."""
    H, W = img_hw
    dev = patch.device
    state = {**state, "frame_num": state["frame_num"] + 1}
    bfeat = model.extract_backbone(_normalize(patch)[None])
    clf_feat = model.extract_classification_feat(bfeat)
    scores = model.classify(state["filter"], clf_feat)[0]
    if rt.score_preprocess == "softmax":
        scores = torch.softmax(scores.reshape(-1), dim=0).reshape(scores.shape)

    translation, flag, max_score = _localize_advanced(rt, scores, state, sample_pos,
                                                      sample_scale)
    found = flag != FLAG_NOT_FOUND
    new_pos = sample_pos + translation
    img_sz = _vec((float(H), float(W)), dev)
    if rt.use_iou_net:
        inside_offset = (rt.target_inside_ratio - 0.5) * state["target_sz"]
        new_pos = torch.maximum(torch.minimum(new_pos, img_sz - inside_offset), inside_offset)
        state = {**state, "pos": torch.where(found, new_pos, state["pos"])}
        ref_pos, ref_sz, ref_scale, ref_ok = _refine_box(rt, model, bfeat, state, sample_pos,
                                                         sample_scale, jitter_u)
        apply_ref = found & ref_ok
        state = {**state, "pos": torch.where(apply_ref, ref_pos, state["pos"]),
                 "target_sz": torch.where(apply_ref, ref_sz, state["target_sz"]),
                 "target_scale": torch.where(apply_ref, ref_scale, state["target_scale"])}
    else:
        # the scale re-quantised from the sample geometry, clamped to the
        # init bounds; the inside clamp uses the new size
        min_sf = torch.max(10.0 / state["base_target_sz"])
        max_sf = torch.min(img_sz / state["base_target_sz"])
        new_scale = torch.minimum(torch.maximum(sample_scale, min_sf), max_sf)
        new_sz = state["base_target_sz"] * new_scale
        inside_offset = (rt.target_inside_ratio - 0.5) * new_sz
        new_pos = torch.maximum(torch.minimum(new_pos, img_sz - inside_offset), inside_offset)
        state = {**state, "pos": torch.where(found, new_pos, state["pos"]),
                 "target_sz": torch.where(found, new_sz, state["target_sz"]),
                 "target_scale": torch.where(found, new_scale, state["target_scale"])}

    update_ok = (flag == FLAG_NORMAL) | (flag == FLAG_HARD_NEG)
    hard_neg = flag == FLAG_HARD_NEG
    lr = torch.where(hard_neg, rt.hard_negative_learning_rate, rt.learning_rate).float()
    box_crop = _get_iounet_box(rt, state["pos"], state["target_sz"], sample_pos, sample_scale)
    state = _update_memory(rt, state, clf_feat[0], box_crop, lr, update_ok)

    scheduled = rt.net_opt_update_iter if (state["frame_num"] - 1) % rt.train_skipping == 0 \
        else 0
    num_iter = torch.where(~update_ok, 0, torch.where(hard_neg, rt.net_opt_hn_iter, scheduled))
    new_filter = model.optimize_filter(state["filter"], state["memory_feat"],
                                       state["memory_boxes"], state["sample_weights"],
                                       num_iter, rt.max_update_iter)
    state = {**state, "filter": new_filter, "last_flag": flag}
    box = torch.cat([(state["pos"] - (state["target_sz"] - 1) / 2).flip(0),
                     state["target_sz"].flip(0)])
    return state, box, max_score, {"flag": flag, "num_iter": num_iter}


def dimp_track_step(rt: DiMPRuntime, model: DiMPNet, state: dict, frame: torch.Tensor,
                    jitter_u: Optional[torch.Tensor]):
    """One frame (H, W, C) uint8: the sample crop at the reference's
    geometry, then `dimp_step_from_patch`."""
    H, W = frame.shape[0], frame.shape[1]
    crop_sz, tl, sample_pos, sample_scale = _sample_geometry(
        rt, state["pos"], state["target_scale"], im_hw=(H, W))
    patch = crop_at(frame, state["pos"], crop_sz, rt.image_sample_size, origin_yx=tl)
    return dimp_step_from_patch(rt, model, state, patch, sample_pos, sample_scale,
                                (float(H), float(W)), jitter_u)


class DiMPTracker:
    """Single-sequence facade (BaseTracker API). `model` must hold its
    weights; it is moved to `device` and its parameters frozen. `draws` is
    a factory of draw sources, called at every initialize (default:
    TorchDraws(seed)). A frame reads the card once: its box, score, flag
    and filter iterations in one copy. `flags` counts the frames of each
    localisation flag and `optimizer_iters` the filter-update iterations
    that ran (not the masked ones) since construction."""

    def __init__(self, model: DiMPNet, device, runtime: Optional[DiMPRuntime] = None,
                 seed: int = 0, draws: Optional[Callable[[], Callable]] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or DiMPRuntime()
        self.draws = draws or (lambda: TorchDraws(seed))
        self.state = None
        self.flags = dict.fromkeys(FLAG_NAMES, 0)
        self.optimizer_iters = 0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        self._draw = self.draws()
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self.state = dimp_init_state(self.rt, self.model, as_frames(image, self.device), box,
                                     self._draw)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        frame = as_frames(image, self.device)
        jitter = None
        if self.rt.num_init_random_boxes > 0:
            jitter = _to_device(self._draw("jitter", (self.rt.num_init_random_boxes, 4)),
                                self.device)
        self.state, box, score, aux = dimp_track_step(self.rt, self.model, self.state, frame,
                                                      jitter)
        out = torch.cat([box, score.reshape(1), aux["flag"].reshape(1).float(),
                         aux["num_iter"].reshape(1).float()]).cpu().numpy()
        flag = FLAG_NAMES[int(out[5])]
        self.flags[flag] += 1
        self.optimizer_iters += int(out[6])
        return {"target_bbox": out[:4].tolist(), "best_score": float(out[4]), "flag": flag,
                "optimizer_iters": int(out[6])}
