"""OSTrack-online: dual-template OSTrack with a confidence-gated template
refresh, port of mmtrack_tpu/trackers/ostrack_online.py (:50-247).

The published online entry (search 320 px at factor 5, template 128 px at
factor 2, candidate elimination at blocks 3/6/9 keeping 0.7 under the
CTR_POINT template mask, ScoreTransformer with 2 class-attention and 12 MLP
layers). One step:

  - the init template and the online template run as a template batch of
    2 against the search crop tiled twice, so the ViT sees 64 + 400 tokens
    per sample (202 after elimination); each sample keeps its own CE
    indices, and the two token streams (pruned positions recovered as
    zeros) are averaged;
  - the CENTER head decodes the averaged map under a Hann window;
  - the ScoreTransformer scores the decoded box against the init
    template's full z + x token sequence;
  - `main_lobe` measures the 8-connected region around the averaged score
    map's peak;
  - the online template is re-cropped at the new box when the area is at
    most `main_lobe_area_threshold` and the confidence at least
    `cls_threshold`.

The JAX step crops the candidate template every frame and keeps it with
`where`; here the gate is read on the host and the candidate is cropped
only when it opens, which gives the same boxes. So a sequence of N frames
runs 1 + (N - 1) + refreshes crops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mmtrack_torch.models.heads import cal_bbox
from mmtrack_torch.models.vipt import (
    ScoreTransformer,
    ViPTrack,
    ce_keep_schedule,
    generate_ctr_mask,
)
from mmtrack_torch.ops.box import clip_box
from mmtrack_torch.ops.crop import crop_resize_normalized
from mmtrack_torch.ops.window import hann2d
from mmtrack_torch.trackers.vipt_tracker import _stats, as_frames


@dataclass(frozen=True)
class OSTrackOnlineRuntime:
    """Published constants (ostrack320_elimination_cls_t2m12_ep50.yaml and
    the OSTrack config defaults), the JAX runtime's fields."""
    template_factor: float = 2.0
    template_size: int = 128
    search_factor: float = 5.0
    search_size: int = 320
    stride: int = 16
    margin: float = 10.0
    cls_threshold: float = 0.5
    main_lobe_score_ratio: float = 0.2
    main_lobe_area_threshold: int = 10
    redetect: bool = False
    redetect_threshold: float = 0.05
    ce_loc: tuple = (3, 6, 9)
    ce_keep_ratio: tuple = (0.7, 0.7, 0.7)
    ce_template_range: str = "CTR_POINT"
    cls_attn_layers: int = 2
    cls_mlp_layers: int = 12

    @property
    def feat_sz(self) -> int:
        return self.search_size // self.stride

    @property
    def ce_keep_lens(self) -> tuple:
        return ce_keep_schedule(self.feat_sz ** 2, self.ce_loc, self.ce_keep_ratio)


def main_lobe(score_map: torch.Tensor, ratio: float):
    """(area, mask) of the 8-connected component of `score_map` (S, S) above
    ratio * peak that holds the peak (psr_dynamic, psr.py:40-76), grown from
    the first-index argmax by 3x3 max dilations until it stops changing, as
    the JAX while_loop does. The loop reads its stop condition on the host
    once per dilation: the map is 20 x 20 and the tracker reads its box on
    the host anyway. Returns (area int, mask (S, S) bool)."""
    S = score_map.shape[-1]
    flat = score_map.reshape(-1)
    region = score_map > ratio * flat.max()
    seed = torch.zeros_like(flat)
    seed[torch.argmax(flat)] = 1.0           # torch.argmax takes the first index, as jnp
    cur = seed.reshape(S, S) * region.float()
    while True:
        win = torch.nn.functional.max_pool2d(cur[None, None], 3, stride=1, padding=1)[0, 0]
        grown = torch.where(region, win > 0, False).float()
        if torch.equal(grown, cur):
            break
        cur = grown
    return int(cur.sum()), cur.bool()


def ostrack_online_init_state(rt: OSTrackOnlineRuntime, frames: torch.Tensor,
                              init_box: torch.Tensor) -> dict:
    """State from (1, H, W, C) frames: the box, the init template and the
    online template (the same crop), and frame_num 0."""
    mean, std = _stats(frames.shape[-1], frames.device)
    patch, _ = crop_resize_normalized(frames, init_box, rt.template_factor, rt.template_size,
                                      mean, std)
    return {"box": init_box, "template": patch, "online_template": patch, "frame_num": 0}


def ostrack_online_step_from_patch(rt: OSTrackOnlineRuntime, model: ViPTrack,
                                   cls_model: ScoreTransformer, state: dict,
                                   search: torch.Tensor, resize_factor: torch.Tensor,
                                   im_hw: tuple[int, int]):
    """The step from a normalised (1, S, S, C) search crop (ostrack_online.py:
    128-194). Returns (state with the new box, the online template not yet
    refreshed; box (1, 4); conf (1,); update_ok bool; aux maps)."""
    H, W = im_hw
    state = {**state, "frame_num": state["frame_num"] + 1}
    prev = state["box"]
    dev = search.device
    templates = torch.cat([state["template"], state["online_template"]], dim=0)
    searches = search.expand(2, -1, -1, -1)
    box_mask_z = generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range,
                                   device=dev)
    out = model(templates, searches, box_mask_z, rt.ce_keep_lens)

    S = rt.feat_sz
    tokens = out["backbone_tokens"]                                   # (2, L, C)
    merged = tokens.mean(dim=0, keepdim=True)
    feat = merged[:, -S * S:].reshape(1, S, S, -1)
    score_m, size_m, offset_m = model.box_head(feat)
    window = hann2d(S, device=dev)
    response = score_m * window[None]
    pred, _ = cal_bbox(response, size_m, offset_m)
    if rt.redetect:
        f1_score = out["score_map"][0:1]
        idx = torch.argmax(response.reshape(-1))
        tracked = f1_score.reshape(-1)[idx]
        f1_pred, _ = cal_bbox(f1_score * window[None], out["size_map"][0:1],
                              out["offset_map"][0:1])
        pred = torch.where(tracked <= rt.redetect_threshold, f1_pred, pred)

    conf = cls_model(tokens[0:1], pred)
    area, _ = main_lobe(score_m[0], rt.main_lobe_score_ratio)
    update_ok = area <= rt.main_lobe_area_threshold and float(conf[0]) >= rt.cls_threshold

    rf = resize_factor[:, None]
    pred_img = pred * rt.search_size / rf
    half_side = torch.full_like(resize_factor, 0.5 * rt.search_size) / resize_factor
    cx = pred_img[:, 0] + (prev[:, 0] + 0.5 * prev[:, 2] - half_side)
    cy = pred_img[:, 1] + (prev[:, 1] + 0.5 * prev[:, 3] - half_side)
    box = torch.stack([cx - 0.5 * pred_img[:, 2], cy - 0.5 * pred_img[:, 3],
                       pred_img[:, 2], pred_img[:, 3]], dim=1)
    box = clip_box(box, float(H), float(W), margin=rt.margin)
    aux = {"merged_score": score_m[0], "response": response[0], "f1_score": out["score_map"],
           "area": area}
    return {**state, "box": box}, box, conf, update_ok, aux


def ostrack_online_track_step(rt: OSTrackOnlineRuntime, model: ViPTrack,
                              cls_model: ScoreTransformer, state: dict, frames: torch.Tensor):
    """One frame (1, H, W, C) uint8: search crop, step, and the gated
    refresh of the online template at the new box (lines 193-198).
    Returns (state, box (1, 4), conf (1,), update_ok)."""
    H, W = frames.shape[1], frames.shape[2]
    mean, std = _stats(frames.shape[-1], frames.device)
    search, rf = crop_resize_normalized(frames, state["box"], rt.search_factor,
                                        rt.search_size, mean, std)
    state, box, conf, update_ok, _ = ostrack_online_step_from_patch(
        rt, model, cls_model, state, search, rf, (H, W))
    if update_ok:
        cand, _ = crop_resize_normalized(frames, box, rt.template_factor, rt.template_size,
                                         mean, std)
        state = {**state, "online_template": cand}
    return state, box, conf, update_ok


class OSTrackOnlineTracker:
    """Single-sequence facade (BaseTracker API). `model` (a prompt-free
    ViPTrack, models/vipt.py::build_ostrack) and `cls_model` (the
    ScoreTransformer at the published t2m12 depth) must hold their
    weights; both are moved to `device`."""

    def __init__(self, model: ViPTrack, cls_model: ScoreTransformer, device,
                 runtime: Optional[OSTrackOnlineRuntime] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cls_model = cls_model.to(self.device).eval()
        self.rt = runtime or OSTrackOnlineRuntime()
        self.state = None

    @torch.inference_mode()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32)[None], device=self.device)
        self.state = ostrack_online_init_state(self.rt, as_frames(image[None], self.device),
                                               box)

    @torch.inference_mode()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, conf, upd = ostrack_online_track_step(
            self.rt, self.model, self.cls_model, self.state, as_frames(image[None], self.device))
        return {"target_bbox": box[0].cpu().numpy().tolist(), "best_score": float(conf[0]),
                "update_flag": bool(upd)}
