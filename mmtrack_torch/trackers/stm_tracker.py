"""STM mask tracker runtime, port of mmtrack_tpu/trackers/stm_tracker.py.

A tracked frame: the crop around the current position (replicate border,
LWL's sample geometry), segmented against the memory plus the previous
frame's key / value, the prediction memorized as the new previous frame,
the previous frame committed into the memory every memory_skip_rate
frames (slot 0 is the init frame, slots 1..T-1 a ring), the crop's
probabilities pasted into the image (zero outside), and the position from
their centre of mass ('md_hack' keeps the size; 'var' also re-estimates
it).

The commit schedule and the ring pointer depend on the frame count alone,
so they are host ints, and the read runs over the valid slots only: JAX
folds the empty ones out of its softmax with -1e30 logits, whose
exponentials are exact zeros. A frame reads the card once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.stm import STMNet
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.trackers.lwl_tracker import (
    _crop_geometry,
    _crop_mask_nearest,
    _moments,
    _rectangle,
    paste_crop,
    read_outputs,
)
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class STMRuntime:
    """stm_tracker.py:45-60, the same defaults (a 384 px crop)."""
    image_sample_size: int = 384
    search_area_scale: float = 5.0
    feat_stride: int = 16
    mem_slots: int = 20
    memory_skip_rate: int = 5
    seg_to_bb_mode: str = "md_hack"
    seg_to_bb_sz_factor: float = 4.0
    min_mask_area: float = -10.0
    max_scale_change: tuple[float, float] = (0.95, 1.1)
    mask_threshold: float = 0.5

    @property
    def feat_sz(self) -> int:
        return self.image_sample_size // self.feat_stride


def _to_unit(patch: torch.Tensor) -> torch.Tensor:
    return div_const(patch[..., :3], 255.0)


def _seg_to_state(rt: STMRuntime, prob_im: torch.Tensor, pos, target_sz):
    """get_target_state (stm_tracker.py:67-89): the centre of mass; 'var'
    also 4 sqrt(variance) as the size; the old state below min_mask_area."""
    total, safe, row, col, ys, xs, e_y, e_x = _moments(prob_im)
    new_pos = torch.stack([e_y, e_x])
    if rt.seg_to_bb_mode == "var":
        e_h = (row * (ys - e_y) ** 2).sum() / safe
        e_w = (col * (xs - e_x) ** 2).sum() / safe
        new_sz = torch.stack([torch.sqrt(torch.clamp(e_h, min=0.0)),
                              torch.sqrt(torch.clamp(e_w, min=0.0))]) * rt.seg_to_bb_sz_factor
    else:
        new_sz = target_sz
    ok = total >= rt.min_mask_area
    return torch.where(ok, new_pos, pos), torch.where(ok, new_sz, target_sz)


def _paste_prob(rt: STMRuntime, prob, sample_pos, sample_scale, im_hw):
    """convert_mask_crop_to_im (stm_tracker.py:92-121): zero outside."""
    return paste_crop(rt.image_sample_size, prob, sample_pos, sample_scale, im_hw, 0.0)


def stm_init_state(rt: STMRuntime, model: STMNet, frame: torch.Tensor,
                   init_box_xywh: torch.Tensor, init_mask: Optional[torch.Tensor] = None) -> dict:
    """initialize (stm_tracker.py:124-161): the init mask (or the box as a
    rectangle) memorized in slot 0."""
    H, W = frame.shape[0], frame.shape[1]
    x, y, w, h = init_box_xywh
    pos = torch.stack([y + (h - 1) / 2, x + (w - 1) / 2])
    target_sz = torch.stack([h, w])
    if init_mask is None:
        init_mask = _rectangle(H, W, init_box_xywh)
    target_scale = div_const(torch.sqrt(torch.prod(target_sz * rt.search_area_scale)),
                             rt.image_sample_size)
    S = rt.image_sample_size
    szl, tl, _, _ = _crop_geometry(rt, pos, target_scale)
    patch = _to_unit(crop_at(frame[..., :3], pos, szl, S, origin_yx=tl))
    mask_crop = _crop_mask_nearest(init_mask, tl, szl, S)
    k, v = model.memorize(patch[None], mask_crop[None])
    T = rt.mem_slots
    keys = torch.zeros((T,) + tuple(k.shape[1:]), dtype=torch.float32, device=k.device)
    vals = torch.zeros((T,) + tuple(v.shape[1:]), dtype=torch.float32, device=v.device)
    keys[0], vals[0] = k[0], v[0]
    return {"pos": pos, "target_sz": target_sz, "target_scale": target_scale,
            "base_target_sz": target_sz / target_scale,
            "mem_keys": keys, "mem_vals": vals, "mem_valid": 1, "mem_ptr": 1,
            "prev_key": k[0], "prev_val": v[0], "frame_num": 1}


def stm_track_step(rt: STMRuntime, model: STMNet, state: dict, frame: torch.Tensor):
    """One tracked frame (stm_tracker.py:164-175): the crop, then
    `stm_step_from_patch`."""
    S = rt.image_sample_size
    szl, tl, sample_pos, sample_scale = _crop_geometry(rt, state["pos"], state["target_scale"])
    patch = _to_unit(crop_at(frame[..., :3], state["pos"], szl, S, origin_yx=tl))
    return stm_step_from_patch(rt, model, state, patch, sample_pos, sample_scale,
                               (frame.shape[0], frame.shape[1]))


def stm_step_from_patch(rt: STMRuntime, model: STMNet, state: dict, patch: torch.Tensor,
                        sample_pos, sample_scale, img_hw):
    """The step from a [0, 1] crop and its geometry (stm_tracker.py:178-235).
    `mem_valid` counts the valid slots (they are the first ones). Returns
    (state, box (4,) xywh, mask (H, W) bool, max probability, committed)."""
    H, W = int(img_hw[0]), int(img_hw[1])
    frame_num = state["frame_num"] + 1
    n = state["mem_valid"]
    keys = torch.cat([state["mem_keys"][:n], state["prev_key"][None]], dim=0)
    vals = torch.cat([state["mem_vals"][:n], state["prev_val"][None]], dim=0)
    valid = torch.ones(n + 1, dtype=torch.float32, device=keys.device)
    prob = model.segment(patch[None], keys, vals, valid)
    k, v = model.memorize(patch[None], prob[None])

    commit = (frame_num - 1) % rt.memory_skip_rate == 0
    mem_keys, mem_vals, ptr = state["mem_keys"], state["mem_vals"], state["mem_ptr"]
    if commit:
        slot = 1 + (ptr - 1) % (rt.mem_slots - 1)
        mem_keys, mem_vals = mem_keys.clone(), mem_vals.clone()
        mem_keys[slot], mem_vals[slot] = state["prev_key"], state["prev_val"]
        n, ptr = max(n, slot + 1), ptr + 1

    prob_im = _paste_prob(rt, prob, sample_pos, sample_scale, (H, W))
    pos, target_sz = _seg_to_state(rt, prob_im, state["pos"], state["target_sz"])
    new_scale = torch.sqrt(torch.prod(target_sz) / torch.prod(state["base_target_sz"]))
    change = new_scale / state["target_scale"]
    lo, hi = rt.max_scale_change
    new_scale = torch.where(change < lo, state["target_scale"] * lo,
                            torch.where(change > hi, state["target_scale"] * hi, new_scale))
    target_sz = state["base_target_sz"] * new_scale
    state = {**state, "pos": pos, "target_sz": target_sz, "target_scale": new_scale,
             "mem_keys": mem_keys, "mem_vals": mem_vals, "mem_valid": n, "mem_ptr": ptr,
             "prev_key": k[0], "prev_val": v[0], "frame_num": frame_num}
    box = torch.cat([(pos - (target_sz - 1) / 2).flip(0), target_sz.flip(0)])
    return state, box, prob_im > rt.mask_threshold, prob_im.max(), commit


class STMTracker:
    """Single-sequence facade (BaseTracker API) that predicts its own mask:
    `model` an STMNet holding its weights, moved to `device`. `commits`
    counts the frames committed into the memory."""

    predicts_segmentation_mask = True

    def __init__(self, model: STMNet, device, runtime: Optional[STMRuntime] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or STMRuntime()
        self.state = None
        self.commits = 0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        mask = info.get("init_mask")
        if mask is not None:
            mask = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
        self.state = stm_init_state(self.rt, self.model, as_frames(image, self.device), box,
                                    mask)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, mask, score, commit = stm_track_step(
            self.rt, self.model, self.state, as_frames(image, self.device))
        self.commits += int(commit)
        box, score, mask = read_outputs(box, score, mask)
        return {"target_bbox": box, "segmentation": mask, "best_score": score}
