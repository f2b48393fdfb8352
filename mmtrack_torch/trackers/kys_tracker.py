"""KYS tracker runtime, port of mmtrack_tpu/trackers/kys_tracker.py.

The DiMP runtime (trackers/dimp_tracker.py) with the scene-propagation
fusion of models/kys.py. A tracked frame:

  1. the DiMP score, trimmed to the 18 x 18 feature grid;
  2. the previous frame's motion features and GRU state aligned: centred
     when the box left the central region, else shifted by the sub-pixel
     rounding; the half-cell `fix_coordinate_shift` on the score in and
     the response out;
  3. the fused response (cost volume and ResponsePredictor);
  4. the fused peak, or the DiMP peak when the two are one cell apart;
  5. hard-negative mining on the raw DiMP score;
  6. the IoUNet refinement, the scale kept unless the DiMP score at the
     peak passes min_dimp_score_for_scale_update;
  7. DiMP's memory and filter update;
  8. the motion state handed on, reset while the target is lost.

The GRU state starts invalid: the first tracked frame derives it from the
stored init label. Everything stays a tensor on the frames' device, so a
frame reads the card once, for its outputs. `jnp.round` and `torch.round`
both round half to even, so the mining window's edges agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.kys import KYSNet, center_shift_translation, shift_features
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.ops.window import gauss_label_2d, hann2d
from mmtrack_torch.trackers.dimp_tracker import (
    FLAG_HARD_NEG,
    FLAG_NAMES,
    FLAG_NORMAL,
    FLAG_NOT_FOUND,
    DiMPRuntime,
    TorchDraws,
    _get_iounet_box,
    _max2d,
    _normalize,
    _refine_box,
    _sample_geometry,
    _to_device,
    _update_memory,
    _vec,
    dimp_init_state,
)
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class KYSRuntime(DiMPRuntime):
    """DiMP-50's geometry and the KYS tracker's own defaults
    (kys_tracker.py:60-84)."""
    target_not_found_threshold_fused: float = 0.05
    dimp_threshold: Optional[float] = 0.05
    remove_offset_in_fused_score: bool = True
    perform_hn_mining_dimp: bool = True
    target_neighborhood_scale_safe: float = 2.2
    min_dimp_score_update: float = -1.0
    min_dimp_score_for_scale_update: float = -1.0
    move_feat_to_center: bool = True
    prev_feat_remove_subpixel_shift: bool = True
    reset_state_during_occlusion: bool = True
    apply_window_to_dimp_score: bool = True
    window_output: bool = True
    output_sigma_factor: float = 0.25
    score_downsample_factor: int = 1

    @property
    def motion_sz(self) -> int:
        """The motion grid: the feature grid, the score trimmed to it."""
        return self.feat_sz


def _motion_window(rt: KYSRuntime, device) -> torch.Tensor:
    """hann2d over the score map, trimmed to the feature grid."""
    S = rt.feat_sz + (rt.kernel_size + 1) % 2
    return hann2d(S, device=device)[:rt.feat_sz, :rt.feat_sz]


def _label_at(rt: KYSRuntime, pos, sample_pos, sample_scale, base_target_sz):
    """The Gaussian label on the motion grid at the target's position."""
    S = rt.motion_sz
    sigma = (torch.sqrt(torch.prod(base_target_sz))
             * (S / rt.score_downsample_factor / rt.image_sample_size) * rt.output_sigma_factor)
    center = S * ((pos - sample_pos) / (sample_scale * rt.image_sample_size)) \
        + 0.5 * ((rt.kernel_size + 1) % 2)
    return gauss_label_2d(S, S, sigma, sigma, center[0], center[1], device=pos.device)


def kys_init_state(rt: KYSRuntime, model: KYSNet, frame: torch.Tensor,
                   init_box_xywh: torch.Tensor, draw: Callable) -> dict:
    """DiMP's init and the motion module's: one more extraction at the
    centred position for the motion features and the label; the GRU state
    invalid."""
    state = dimp_init_state(rt, model, frame, init_box_xywh, draw)
    crop_sz, tl, sample_pos, sample_scale = _sample_geometry(
        rt, state["pos"], state["target_scale"], im_hw=(frame.shape[0], frame.shape[1]))
    patch = _normalize(crop_at(frame, state["pos"], crop_sz, rt.image_sample_size,
                               origin_yx=tl))
    motion_feat = model.motion_feat(model.extract_backbone(patch[None]))[0]
    S, dev = rt.motion_sz, frame.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {**state,
            "motion_feat": motion_feat,
            "gru_state": torch.zeros((S, S, model.state_dim), **f32),
            "gru_valid": torch.zeros((), dtype=torch.bool, device=dev),
            "prev_label": _label_at(rt, state["pos"], sample_pos, sample_scale,
                                    state["base_target_sz"]),
            "prev_box_patch": _get_iounet_box(rt, state["pos"], state["target_sz"], sample_pos,
                                              sample_scale),
            "last_dimp": torch.zeros((S, S), **f32), "last_fused": torch.zeros((S, S), **f32),
            "last_flag": torch.tensor(FLAG_NORMAL, dtype=torch.int32, device=dev)}


def _prev_alignment(rt: KYSRuntime, state: dict) -> torch.Tensor:
    """The (t_x, t_y) shift of the previous frame's motion features and GRU
    state: the centre shift when the box left the central region, else
    the sub-pixel rounding shift (with the half cell of
    fix_coordinate_shift); zeros while the GRU state is invalid."""
    S = rt.motion_sz
    box = state["prev_box_patch"]
    box_c = box[:2] + 0.5 * box[2:]
    c_max = rt.image_sample_size * (0.5 + 1.0 / rt.search_area_scale)
    c_min = rt.image_sample_size * (0.5 - 1.0 / rt.search_area_scale)
    off_center = ~torch.all((box_c < c_max) & (box_c > c_min))
    t_center = center_shift_translation(box, (S, S), rt.feat_stride)
    box_c_feat = box_c / rt.feat_stride
    feat_trans = div_const(torch.round(box_c_feat) + 0.5 - box_c_feat, S)
    zeros = torch.zeros_like(feat_trans)
    t = torch.where(rt.move_feat_to_center & off_center, t_center,
                    feat_trans if rt.prev_feat_remove_subpixel_shift else zeros)
    return torch.where(state["gru_valid"], t, zeros)


def kys_track_step(rt: KYSRuntime, model: KYSNet, state: dict, frame: torch.Tensor,
                   jitter_u: Optional[torch.Tensor]):
    """One frame (H, W, C) uint8: the sample crop, then
    `kys_step_from_patch`."""
    H, W = frame.shape[0], frame.shape[1]
    crop_sz, tl, sample_pos, sample_scale = _sample_geometry(
        rt, state["pos"], state["target_scale"], im_hw=(H, W))
    patch = crop_at(frame, state["pos"], crop_sz, rt.image_sample_size, origin_yx=tl)
    return kys_step_from_patch(rt, model, state, patch, sample_pos, sample_scale,
                               (float(H), float(W)), jitter_u)


def kys_step_from_patch(rt: KYSRuntime, model: KYSNet, state: dict, patch: torch.Tensor,
                        sample_pos, sample_scale, img_hw, jitter_u: Optional[torch.Tensor]):
    """A tracked frame from its raw (0..255) sample patch (S, S, C) and
    geometry (kys_tracker.py:178-329). Returns (state, box (4,) xywh, the
    fused maximum, aux {'flag', 'num_iter', 'do_shift', 'gru_valid'}), all
    tensors."""
    dev = patch.device
    state = {**state, "frame_num": state["frame_num"] + 1}
    bfeat = model.extract_backbone(_normalize(patch)[None])
    clf_feat = model.extract_classification_feat(bfeat)
    S = rt.motion_sz
    scores_dimp = model.classify(state["filter"], clf_feat)[0][:S, :S]
    motion_feat = model.motion_feat(bfeat)[0]
    window = _motion_window(rt, dev) if rt.window_output else None
    scores_win = scores_dimp * window if (window is not None
                                          and rt.apply_window_to_dimp_score) else scores_dimp

    # the previous frame aligned, then the propagation predictor
    t_prev = _prev_alignment(rt, state)
    do_shift = state["gru_valid"] & torch.any(t_prev != 0.0)
    feat_prev = torch.where(do_shift, shift_features(state["motion_feat"], t_prev),
                            state["motion_feat"])
    gru_prev = torch.where(do_shift, shift_features(state["gru_state"], t_prev),
                           state["gru_state"])
    t_half = torch.full((2,), -0.5 / S, dtype=torch.float32, device=dev)
    score_in = shift_features(scores_win[..., None], t_half)[..., 0]
    label_in = shift_features(state["prev_label"][..., None], t_half)[..., 0]
    state_in = torch.where(state["gru_valid"], gru_prev,
                           model.init_motion_state(label_in[None])[0])
    fused_s, gru_new, _ = model.predict_response(feat_prev[None], motion_feat[None],
                                                 state_in[None], score_in[None],
                                                 rt.dimp_threshold, window)
    scores_am = torch.relu(shift_features(fused_s[0][..., None], -t_half)[..., 0])

    # the fused peak, or the DiMP peak one cell from it
    max_fused, disp_fused = _max2d(scores_am)
    dimp_at_loc = scores_win.reshape(-1).gather(0, (disp_fused[0] * S + disp_fused[1])
                                                .long().reshape(1))[0]
    _, disp_dimp = _max2d(scores_win)
    use_dimp_peak = rt.remove_offset_in_fused_score & (
        (disp_fused - disp_dimp).abs().max() == 1.0)
    disp = torch.where(use_dimp_peak, disp_dimp, disp_fused)
    output_sz = float(S)
    translation = (disp - S // 2) * (rt.image_sample_size / output_sz) * sample_scale
    not_found = max_fused < rt.target_not_found_threshold_fused

    # hard-negative mining on the raw DiMP score
    neigh = rt.target_neighborhood_scale_safe \
        * (torch.sqrt(torch.prod(state["target_sz"])) / sample_scale) \
        * (output_sz / rt.image_sample_size)
    iy = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    top = torch.clamp(torch.round(disp[0] - neigh / 2), min=0.0)
    bottom = torch.clamp(torch.round(disp[0] + neigh / 2 + 1), max=output_sz)
    left = torch.clamp(torch.round(disp[1] - neigh / 2), min=0.0)
    right = torch.clamp(torch.round(disp[1] + neigh / 2 + 1), max=output_sz)
    inside = (iy >= top) & (iy < bottom) & (ix >= left) & (ix < right)
    max2, _ = _max2d(torch.where(inside, 0.0, scores_dimp))
    dimp_at_disp = scores_dimp.reshape(-1).gather(0, (disp[0] * S + disp[1]).long()
                                                  .reshape(1))[0]
    hard_neg = (rt.perform_hn_mining_dimp & ~not_found
                & (max2 > rt.hard_negative_threshold * dimp_at_disp) & (max2 > 0.1))
    flag = torch.where(not_found, FLAG_NOT_FOUND,
                       torch.where(hard_neg, FLAG_HARD_NEG, FLAG_NORMAL)).to(torch.int32)
    found = flag != FLAG_NOT_FOUND
    state = {**state, "last_dimp": scores_dimp, "last_fused": scores_am, "last_flag": flag}

    # the position and the IoUNet's scale
    H_im, W_im = img_hw
    img_sz = _vec((float(H_im), float(W_im)), dev)
    inside_offset = (rt.target_inside_ratio - 0.5) * state["target_sz"]
    new_pos = torch.maximum(torch.minimum(sample_pos + translation, img_sz - inside_offset),
                            inside_offset)
    state = {**state, "pos": torch.where(found, new_pos, state["pos"])}
    ref_pos, ref_sz, ref_scale, ref_ok = _refine_box(rt, model, bfeat, state, sample_pos,
                                                     sample_scale, jitter_u)
    apply_ref = found & ref_ok
    apply_scale = apply_ref & (dimp_at_loc > rt.min_dimp_score_for_scale_update)
    state = {**state, "pos": torch.where(apply_ref, ref_pos, state["pos"]),
             "target_sz": torch.where(apply_scale, ref_sz, state["target_sz"]),
             "target_scale": torch.where(apply_scale, ref_scale, state["target_scale"])}

    # the memory and the filter
    update_ok = found & (dimp_at_loc > rt.min_dimp_score_update)
    lr = torch.where(hard_neg, rt.hard_negative_learning_rate, rt.learning_rate).float()
    box_crop = _get_iounet_box(rt, state["pos"], state["target_sz"], sample_pos, sample_scale)
    state = _update_memory(rt, state, clf_feat[0], box_crop, lr, update_ok)
    scheduled = rt.net_opt_update_iter if (state["frame_num"] - 1) % rt.train_skipping == 0 \
        else 0
    num_iter = torch.where(~update_ok, 0, torch.where(hard_neg, rt.net_opt_hn_iter, scheduled))
    state = {**state, "filter": model.optimize_filter(
        state["filter"], state["memory_feat"], state["memory_boxes"], state["sample_weights"],
        num_iter, rt.max_update_iter)}

    # the motion state handed on
    new_label = _label_at(rt, state["pos"], sample_pos, sample_scale, state["base_target_sz"])
    gru_kept = torch.zeros_like(gru_new[0]) if rt.reset_state_during_occlusion \
        else state["gru_state"]
    state = {**state,
             "motion_feat": torch.where(found, motion_feat, state["motion_feat"]),
             "gru_state": torch.where(found, gru_new[0], gru_kept),
             "gru_valid": state["gru_valid"] | found,
             "prev_label": torch.where(found, new_label, state["prev_label"]),
             "prev_box_patch": torch.where(found, box_crop, state["prev_box_patch"])}
    box = torch.cat([(state["pos"] - (state["target_sz"] - 1) / 2).flip(0),
                     state["target_sz"].flip(0)])
    return state, box, max_fused, {"flag": flag, "num_iter": num_iter, "do_shift": do_shift,
                                   "gru_valid": state["gru_valid"]}


class KYSTracker:
    """Single-sequence facade (BaseTracker API), as DiMPTracker: `model` a
    KYSNet holding its weights, moved to `device`; `draws` a factory of
    draw sources called at every initialize. A frame reads the card once;
    `best_score` is the fused maximum. `flags` counts the frames of each
    flag, `shifts` those whose previous frame was shifted, and
    `optimizer_iters` the filter-update iterations that ran."""

    def __init__(self, model: KYSNet, device, runtime: Optional[KYSRuntime] = None,
                 seed: int = 0, draws: Optional[Callable[[], Callable]] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or KYSRuntime()
        self.draws = draws or (lambda: TorchDraws(seed))
        self.state = None
        self.flags = dict.fromkeys(FLAG_NAMES, 0)
        self.shifts = 0
        self.optimizer_iters = 0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        self._draw = self.draws()
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self.state = kys_init_state(self.rt, self.model, as_frames(image, self.device), box,
                                    self._draw)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        frame = as_frames(image, self.device)
        jitter = None
        if self.rt.num_init_random_boxes > 0:
            jitter = _to_device(self._draw("jitter", (self.rt.num_init_random_boxes, 4)),
                                self.device)
        self.state, box, score, aux = kys_track_step(self.rt, self.model, self.state, frame,
                                                     jitter)
        out = torch.cat([box, score.reshape(1)] + [aux[k].reshape(1).float() for k in
                                                   ("flag", "num_iter", "do_shift",
                                                    "gru_valid")]).cpu().numpy()
        flag = FLAG_NAMES[int(out[5])]
        self.flags[flag] += 1
        self.shifts += int(out[7])
        self.optimizer_iters += int(out[6])
        return {"target_bbox": out[:4].tolist(), "best_score": float(out[4]), "flag": flag,
                "optimizer_iters": int(out[6]), "do_shift": bool(out[7]),
                "gru_valid": bool(out[8])}
