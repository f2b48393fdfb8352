"""STARK-S / ST / SPT tracker runtime, port of
mmtrack_tpu/trackers/stark_tracker.py (:27-230).

The template is embedded once at init (the reference caches its backbone
output, stark_s.py forward_backbone). Each frame: one search crop (the crop
kernel on CUDA) with its padded-pixel mask, the search embed, the
transformer, the corner decode and, for ST, the confidence head; no Hann
window. Map back and clip with a 10 px margin. STARK-ST keeps a second,
dynamic template: when `frame_num % update_interval == 0` and the score is
above `update_threshold` (stark_st.py:91-99), it is re-cropped at the new
box and re-embedded. The JAX step crops and embeds that candidate every
frame and keeps it with `where`; here the gate is read on the host first
and the candidate is made only when it opens, which gives the same boxes
with one crop per update instead of one per frame. So a sequence of N
frames runs 1 + (N - 1) + updates crops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mmtrack_torch.data.processing import sample_target_np
from mmtrack_torch.models.stark import STARK
from mmtrack_torch.ops.box import clip_box
from mmtrack_torch.ops.crop import crop_att_mask, crop_resize_normalized
from mmtrack_torch.trackers.vipt_tracker import MEAN_6CH, STD_6CH, _stats, as_frames


@dataclass(frozen=True)
class STARKRuntime:
    template_factor: float = 2.0
    template_size: int = 128
    search_factor: float = 5.0
    search_size: int = 320
    margin: float = 10.0
    dynamic_template: bool = False       # STARK-ST
    update_interval: int = 200
    update_threshold: float = 0.5


def _embed_template(rt: STARKRuntime, model: STARK, frames: torch.Tensor, box: torch.Tensor,
                    patch: Optional[torch.Tensor] = None, att: Optional[torch.Tensor] = None):
    """Template tokens of (1, H, W, C) frames at box (1, 4): the device crop
    and mask, or the given host-made `patch` and `att`."""
    if patch is None:
        mean, std = _stats(frames.shape[-1], frames.device)
        patch, _ = crop_resize_normalized(frames, box, rt.template_factor, rt.template_size,
                                          mean, std)
        att = crop_att_mask(box, rt.template_factor, rt.template_size, frames.shape[1],
                            frames.shape[2])
    return model.embed(patch, att)


def _template_state(model: STARK, embedded, prefix: str) -> dict:
    z_c, z_d, z_pos, z_m = embedded
    keys = ("z_tokens", "z_pos", "z_mask", "z_tokens_d") if prefix == "z" else \
        ("z_dyn", "z_dyn_pos", "z_dyn_mask", "z_dyn_d")
    state = dict(zip(keys[:3], (z_c, z_pos, z_m)))
    if model.six_channel:
        state[keys[3]] = z_d
    return state


def stark_init_state(rt: STARKRuntime, model: STARK, frames: torch.Tensor,
                     init_box: torch.Tensor, patch=None, att=None) -> dict:
    """Tracker state from the first frame (stark_tracker.py:45-64): the box
    (1, 4), the template's tokens, positions and mask (and depth tokens
    for SPT), ST's dynamic template (the same at init) and frame_num 0."""
    embedded = _embed_template(rt, model, frames, init_box, patch, att)
    state = {"box": init_box, "frame_num": 0, **_template_state(model, embedded, "z")}
    if rt.dynamic_template:
        state.update(_template_state(model, embedded, "dyn"))
    return state


def stark_step_from_crop(rt: STARKRuntime, model: STARK, state: dict, search: torch.Tensor,
                         search_att_mask: torch.Tensor, resize_factor: torch.Tensor,
                         img_h: float, img_w: float):
    """Embed + transformer + heads + map back + clip from a normalised
    search crop (1, S, S, C) and its mask (1, S, S) (stark_tracker.py:67-117).
    Returns (box (1, 4), score (1,))."""
    x_c, x_d, x_pos, x_m = model.embed(search, search_att_mask)
    z_c, z_d = state["z_tokens"], state.get("z_tokens_d")
    z_pos, z_m = state["z_pos"], state["z_mask"]
    if rt.dynamic_template:
        z_c = torch.cat([z_c, state["z_dyn"]], dim=1)
        if z_d is not None:
            z_d = torch.cat([z_d, state["z_dyn_d"]], dim=1)
        z_pos = torch.cat([z_pos, state["z_dyn_pos"]], dim=1)
        z_m = torch.cat([z_m, state["z_dyn_mask"]], dim=1)
    dec, mem = model.transformer_forward(z_c, z_d, z_pos, x_c, x_d, x_pos, z_m, x_m)
    pred = model.forward_box_head(dec, mem)
    score = (model.predict_score(dec) if model.has_score_head
             else torch.ones(1, device=pred.device))

    rf = resize_factor[:, None]
    pred_img = pred * rt.search_size / rf
    prev = state["box"]
    half_side = torch.full_like(resize_factor, 0.5 * rt.search_size) / resize_factor
    cx = pred_img[:, 0] + (prev[:, 0] + 0.5 * prev[:, 2] - half_side)
    cy = pred_img[:, 1] + (prev[:, 1] + 0.5 * prev[:, 3] - half_side)
    box = torch.stack([cx - 0.5 * pred_img[:, 2], cy - 0.5 * pred_img[:, 3],
                       pred_img[:, 2], pred_img[:, 3]], dim=1)
    return clip_box(box, img_h, img_w, margin=rt.margin), score


def stark_track_step(rt: STARKRuntime, model: STARK, state: dict, frames: torch.Tensor):
    """One frame (1, H, W, C) uint8: the search crop, the step and ST's
    gated template update. Returns (new_state, box (1, 4), score (1,),
    updated)."""
    H, W = frames.shape[1], frames.shape[2]
    mean, std = _stats(frames.shape[-1], frames.device)
    state = {**state, "frame_num": state["frame_num"] + 1}
    search, rf = crop_resize_normalized(frames, state["box"], rt.search_factor,
                                        rt.search_size, mean, std)
    att = crop_att_mask(state["box"], rt.search_factor, rt.search_size, H, W)
    box, score = stark_step_from_crop(rt, model, state, search, att, rf, float(H), float(W))
    state = {**state, "box": box}
    updated = (rt.dynamic_template and state["frame_num"] % rt.update_interval == 0
               and float(score[0]) > rt.update_threshold)
    if updated:
        state.update(_template_state(model, _embed_template(rt, model, frames, box), "dyn"))
    return state, box, score, updated


class STARKTracker:
    """Single-sequence facade with the BaseTracker API (stark_tracker.py:
    120-230). `model` must hold its weights; it is moved to `device`.

    host_preproc=True crops on the host with the bit-exact cv2 twin of the
    reference's sample_target (data/processing.py::sample_target_np, its
    att_mask included) and uploads the normalised crop and mask instead of
    the frame; ST's update is then cropped on the host too."""

    def __init__(self, model: STARK, device, runtime: Optional[STARKRuntime] = None,
                 host_preproc: bool = False):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.rt = runtime or STARKRuntime()
        self.host_preproc = host_preproc
        self.state = None

    def _host_crop(self, image: np.ndarray, box, factor: float, size: int):
        crop, rf, att = sample_target_np(np.asarray(image), np.asarray(box, np.float64),
                                         factor, size)
        c = crop.shape[-1]
        normalized = (crop.astype(np.float32) / 255.0 - MEAN_6CH[:c]) / STD_6CH[:c]
        return (torch.from_numpy(normalized[None]).to(self.device), rf,
                torch.from_numpy(att[None]).to(self.device))

    @torch.inference_mode()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32)[None], device=self.device)
        rt = self.rt
        if self.host_preproc:
            patch, _, att = self._host_crop(image, info["init_bbox"], rt.template_factor,
                                            rt.template_size)
            self.state = stark_init_state(rt, self.model, None, box, patch, att)
        else:
            self.state = stark_init_state(rt, self.model, as_frames(image[None], self.device),
                                          box)

    @torch.inference_mode()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        rt = self.rt
        if self.host_preproc:
            H, W = image.shape[0], image.shape[1]
            state = {**self.state, "frame_num": self.state["frame_num"] + 1}
            prev = state["box"][0].cpu().numpy().astype(np.float64)
            search, rf, att = self._host_crop(image, prev, rt.search_factor, rt.search_size)
            rf = torch.tensor([rf], dtype=torch.float32, device=self.device)
            box, score = stark_step_from_crop(rt, self.model, state, search, att, rf,
                                              float(H), float(W))
            state["box"] = box
            updated = (rt.dynamic_template and state["frame_num"] % rt.update_interval == 0
                       and float(score[0]) > rt.update_threshold)
            if updated:
                patch, _, att_z = self._host_crop(image, box[0].cpu().numpy().astype(np.float64),
                                                  rt.template_factor, rt.template_size)
                state.update(_template_state(self.model, self.model.embed(patch, att_z), "dyn"))
            self.state = state
        else:
            self.state, box, score, updated = stark_track_step(
                rt, self.model, self.state, as_frames(image[None], self.device))
        return {"target_bbox": box[0].cpu().numpy().tolist(), "best_score": float(score[0]),
                "update_flag": bool(updated)}
