"""MixFormer online tracker runtime (MixFormer-RGBD, SAMF, ProMixTrack),
port of mmtrack_tpu/trackers/mixformer_tracker.py (:39-244).

State: the init template, a ring of up to K online templates, the
nominee for the ring and its score, the forget pointer, the frame count
and the his_w / his_h meters of the complex re-constraint. One step:

  - one search crop per scale (the crop kernel on CUDA, one launch per
    scale: the kernel takes one factor per launch); the template and the
    ring are tiled over the scales and the most confident scale wins
    (torch.argmax takes the first of tied scores, as jnp.argmax does);
  - map back, clip with a 10 px margin, and the 'simple' or 'complex'
    re-constraint against the previous box ('none' skips it); the meters
    add the box that results;
  - the nomination: the confidence decays by max_score_decay every frame,
    and a score above online_threshold and above the decayed best makes
    the template cropped at the new box the nominee;
  - every update_interval frames the nominee enters the ring, which grows
    from 1 to K and then replaces at the forget pointer; the nominee
    becomes the init template again and the best score -1.

The JAX step keeps K static slots and masks the empty ones out of the
attention (the model's ot_mask); here the model sees only the n_online
templates that the ring holds, which is the same attention without the
masked keys. The JAX step crops the candidate every frame and keeps it
with `where`; here the nomination is read on the host (the score is one
f32 read a frame, the decayed best an f32 on the host, so the gate is
JAX's f32 comparison) and the candidate is cropped only when it happens.
So a sequence of N frames runs 1 + (N - 1) * scales + nominations crops.
The his meters stay f32 tensors on the frames' device, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mmtrack_torch.models.mixformer import MixFormer
from mmtrack_torch.ops.box import clip_box
from mmtrack_torch.ops.crop import crop_resize_normalized
from mmtrack_torch.trackers.vipt_tracker import _stats, as_frames


@dataclass(frozen=True)
class MixFormerRuntime:
    template_factor: float = 2.0
    template_size: int = 128
    search_factor: float = 5.0     # TEST.SEARCH_FACTOR
    search_size: int = 320
    margin: float = 10.0
    # baseline_large.yaml VOT2022RGBD deployment: UPDATE_INTERVALS [10],
    # ONLINE_SIZES [5], MAX_SCORE_DECAY 0.98
    update_interval: int = 10
    online_size: int = 5
    online_threshold: float = 0.5
    max_score_decay: float = 0.98
    # 'simple' | 'complex' | 'none' (TEST.RE_CONSTRAIN_TYPE)
    re_constrain: str = "simple"
    conf_thr: float = 0.5          # re_constraint_complex defaults
    scale_thr: float = 1.35
    # SAMF's search-window scales, evaluated in one batched forward;
    # (1.0,) is plain MixFormer
    scale_factors: tuple[float, ...] = (1.0,)


def mixformer_init_state(rt: MixFormerRuntime, frames: torch.Tensor,
                         init_box: torch.Tensor) -> dict:
    """State from (1, H, W, C) uint8 frames and the (1, 4) xywh init box:
    the template crop fills the ring's K slots, of which one is valid."""
    mean, std = _stats(frames.shape[-1], frames.device)
    patch, _ = crop_resize_normalized(frames, init_box, rt.template_factor, rt.template_size,
                                      mean, std)
    box = init_box.float()
    return {"box": box,
            "template": patch,
            "online_templates": patch.expand(rt.online_size, -1, -1, -1).clone(),
            "n_online": 1,
            "online_max_template": patch,
            "max_pred_score": np.float32(-1.0),
            "forget_id": 0,
            "frame_num": 0,
            # his_w / his_h meters seeded with the init box: (sum_w, sum_h), count
            "his_sum": box[0, 2:4].clone(),
            "his_count": torch.ones((), dtype=torch.float32, device=box.device)}


def _re_constrain(rt: MixFormerRuntime, prev: torch.Tensor, box: torch.Tensor,
                  score: torch.Tensor, his_avg: torch.Tensor) -> torch.Tensor:
    """re_constraint_simple / re_constraint_complex: the previous box
    (4,) where the new one (4,) jumps implausibly."""
    prev_avg_wh = (prev[2] + prev[3]) / 2
    dis = (torch.abs(box[0] + box[2] / 2 - prev[0] - prev[2] / 2)
           + torch.abs(box[1] + box[3] / 2 - prev[1] - prev[3] / 2))
    if rt.re_constrain == "simple":
        return torch.where(dis > 2 * prev_avg_wh, prev, box)

    def change(r):
        return torch.maximum(r, 1.0 / r)

    scale_change = torch.maximum(change(box[2] / his_avg[0]), change(box[3] / his_avg[1]))
    reject = ((dis > 2 * prev_avg_wh)
              | ((dis > 1.5 * prev_avg_wh) & (score < rt.conf_thr))
              | (scale_change > rt.scale_thr))
    return torch.where(reject, prev, box)


def _mixformer_core(rt: MixFormerRuntime, model: MixFormer, state: dict, search: torch.Tensor,
                    resize_factors: torch.Tensor, im_hw, cand_fn: Callable):
    """The step from the normalised search crops (S, Ss, Ss, C) of the S
    scales and their resize factors (S,); `cand_fn(box (1, 4))` gives the
    nominee's template (1, St, St, C) and is called only on a nomination.
    Returns (state, box (1, 4), score (1,), aux)."""
    H, W = im_hw
    state = {**state, "frame_num": state["frame_num"] + 1}
    prev = state["box"][0]
    n_scales, n = search.shape[0], state["n_online"]
    out = model(state["template"].expand(n_scales, -1, -1, -1),
                state["online_templates"][None, :n].expand(n_scales, -1, -1, -1, -1), search)
    best = torch.argmax(out["pred_scores"])
    pred = out["pred_boxes"][best]
    score = out["pred_scores"][best]
    resize_factor = resize_factors[best]

    # map_box_back + clip_box(margin=10)
    pred_img = pred * rt.search_size / resize_factor
    half_side = 0.5 * rt.search_size / resize_factor
    cx = pred_img[0] + (prev[0] + 0.5 * prev[2] - half_side)
    cy = pred_img[1] + (prev[1] + 0.5 * prev[3] - half_side)
    box = torch.stack([cx - 0.5 * pred_img[2], cy - 0.5 * pred_img[3], pred_img[2], pred_img[3]])
    box = clip_box(box, float(H), float(W), margin=rt.margin)
    box_raw = box
    if rt.re_constrain != "none":
        box = _re_constrain(rt, prev, box, score, state["his_sum"] / state["his_count"])
    state = {**state, "box": box[None], "his_sum": state["his_sum"] + box[2:4],
             "his_count": state["his_count"] + 1.0}

    # the nomination, in f32 on the host
    max_score = state["max_pred_score"] * np.float32(rt.max_score_decay)
    s = np.float32(score.item())
    nominate = bool(s > np.float32(rt.online_threshold) and s > max_score)
    if nominate:
        state = {**state, "online_max_template": cand_fn(box[None]), "max_pred_score": s}
    else:
        state = {**state, "max_pred_score": max_score}

    # the ring at the interval: grow while it is not full, then replace at
    # the forget pointer
    at_interval = state["frame_num"] % rt.update_interval == 0
    if at_interval:
        K = rt.online_size
        ring = state["online_templates"].clone()
        if n < K:
            ring[n] = state["online_max_template"][0]
            state = {**state, "n_online": n + 1}
        else:
            ring[state["forget_id"]] = state["online_max_template"][0]
            state = {**state, "forget_id": (state["forget_id"] + 1) % K}
        state = {**state, "online_templates": ring, "max_pred_score": np.float32(-1.0),
                 "online_max_template": state["template"]}
    aux = {"nominate": nominate, "at_interval": at_interval, "box_raw": box_raw,
           "pred_score": score}
    return state, box[None], score[None], aux


def mixformer_track_step(rt: MixFormerRuntime, model: MixFormer, state: dict,
                         frames: torch.Tensor):
    """One frame (1, H, W, C) uint8: one search crop per scale, the step,
    and the nominee's crop when a nomination happens. Returns (state, box
    (1, 4), score (1,), aux)."""
    H, W = frames.shape[1], frames.shape[2]
    mean, std = _stats(frames.shape[-1], frames.device)
    crops, rfs = [], []
    for sf in rt.scale_factors:
        crop, rf = crop_resize_normalized(frames, state["box"], rt.search_factor * sf,
                                          rt.search_size, mean, std)
        crops.append(crop)
        rfs.append(rf)

    def cand_fn(box):
        return crop_resize_normalized(frames, box, rt.template_factor, rt.template_size,
                                      mean, std)[0]

    return _mixformer_core(rt, model, state, torch.cat(crops), torch.cat(rfs), (H, W), cand_fn)


def mixformer_step_from_patch(rt: MixFormerRuntime, model: MixFormer, state: dict,
                              search: torch.Tensor, resize_factor, cand: torch.Tensor, im_hw):
    """Parity-harness step: one host-cropped normalised search patch
    (1, S, S, C), its resize factor and an injected nominee (1, St, St, C)."""
    rf = torch.as_tensor(resize_factor, dtype=torch.float32, device=search.device).reshape(1)
    return _mixformer_core(rt, model, state, search, rf, im_hw, lambda box: cand)


class MixFormerTracker:
    """Single-sequence facade (BaseTracker API). `model` must hold its
    weights; it is moved to `device`. `nominations` and `ring_updates`
    count the nominee crops and the ring writes since construction."""

    def __init__(self, model: MixFormer, device, runtime: Optional[MixFormerRuntime] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.rt = runtime or MixFormerRuntime()
        self.state = None
        self.nominations = self.ring_updates = 0

    @torch.inference_mode()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32)[None], device=self.device)
        self.state = mixformer_init_state(self.rt, as_frames(image[None], self.device), box)

    @torch.inference_mode()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, score, aux = mixformer_track_step(
            self.rt, self.model, self.state, as_frames(image[None], self.device))
        self.nominations += aux["nominate"]
        self.ring_updates += aux["at_interval"]
        return {"target_bbox": box[0].cpu().numpy().tolist(), "best_score": float(score[0]),
                "nominated": aux["nominate"], "ring_update": aux["at_interval"]}
