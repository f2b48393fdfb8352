"""ATOM online tracker, port of mmtrack_tpu/trackers/atom_tracker.py: a
factorised-convolution classifier optimised online by Gauss-Newton CG,
and the IoUNet's box refinement.

  - The classification features are the power-normalised layer3 maps
    (ResNet-18, 256 channels), projected to 64 by a 1 x 1 matrix P that is
    learned at init.
  - Init: the 2x-expanded crop at the unrounded centre, ATOM's 30 image
    augmentations and 7 feature-dropout copies, then the joint (filter,
    projection) problem by 6 Gauss-Newton steps of 10 preconditioned CG
    iterations from random inits.
  - A step: the raw response (the projected features convolved with the
    filter, no mlu) on the 18 x 18 grid (the trailing row and column
    dropped for the even kernel), Fourier-interpolated to 288 x 288; ATOM's
    localisation (absolute crop-centre displacements), the DiMP IoU
    refinement, the min-weight memory of projected features and Gaussian
    labels.
  - The filter update: one Gauss-Newton linearisation with 5 Polak-Ribiere
    CG iterations over the 250-slot memory, on every train_skipping-th
    frame and on hard negatives.

Everything a decision touches stays a tensor on the frame's device and is
selected with torch.where, as the JAX step does, with one exception: JAX
decides the filter update by a `lax.cond` on a traced iteration count.
The port reads the frame's box, score and flag in one copy (the facade's
one host read a frame) and decides the update on the host from the flag
and the frame number, then runs it on the device. So `atom_track_step`
stops before the update and `atom_update_filter` is the update.

Random draws come from a draw source `draw(kind, shape)` as in
trackers/dimp_tracker.py: 'shift', 'dropout' and 'jitter' uniforms, and
'projection' and 'filter' standard normals for the random inits of P
(N(0, 1) / sqrt(256)) and f (N(0, 1) / numel); by default a CPU
torch.Generator seeded with the recipe's seed. Tests inject JAX's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.models.atom import ATOMNet
from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.ops.augment import (
    dimp_init_augmentations,
    feature_dropout,
    num_image_augmentations,
    num_random_shifts,
)
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.ops.fourier import cfft2, sample_scores, shift_spectrum
from mmtrack_torch.ops.optimization import gauss_newton_cg, mlu
from mmtrack_torch.ops.window import gauss_label_2d
from mmtrack_torch.trackers.dimp_tracker import (
    FLAG_HARD_NEG,
    FLAG_NAMES,
    FLAG_NORMAL,
    FLAG_NOT_FOUND,
    FLAG_UNCERTAIN,
    DiMPRuntime,
    TorchDraws,
    _get_iounet_box,
    _max2d,
    _normalize,
    _refine_box,
    _sample_geometry,
    _to_device,
    _vec,
)
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class ATOMRuntime(DiMPRuntime):
    """ATOM's default.py numbers on top of the shared DiMP geometry and
    refinement fields (atom_tracker.py:72-109)."""
    feat_dim: int = 256
    compressed_dim: int = 64
    filter_reg: float = 1e-1
    projection_reg: float = 1e-4
    init_gn_iter: int = 6
    init_cg_per_gn: int = 10
    update_cg_iter: int = 5
    hard_negative_cg_iter: int = 5
    output_sigma_factor: float = 0.25
    response_act_param: float = 0.05
    sample_memory_size: int = 250
    train_skipping: int = 10
    score_upsample_factor: int = 1
    feat_normalize_power: Optional[int] = 2
    aug_rotate: tuple = (5, -5, 10, -10, 20, -20, 30, -30, 45, -45, -60, 60)
    aug_blur: tuple = ((2, 0.2), (0.2, 2), (3, 1), (1, 3), (2, 2))
    aug_dropout_num: int = 7
    aug_dropout_prob: float = 0.2

    @property
    def num_init_samples(self) -> int:
        return num_image_augmentations(blur_sigmas=self.aug_blur,
                                       rotate_angles=self.aug_rotate) + self.aug_dropout_num

    @property
    def output_sz(self) -> int:
        """The Fourier-interpolated score grid."""
        return self.score_upsample_factor * self.image_sample_size


class ATOMDraws(TorchDraws):
    """The default draw source: uniforms, and standard normals for the
    'projection' and 'filter' inits, from a CPU torch.Generator."""

    def __call__(self, kind: str, shape: tuple) -> torch.Tensor:
        if kind in ("projection", "filter"):
            return torch.randn(shape, generator=self.generator)
        return super().__call__(kind, shape)


def _normalize_feat(rt: ATOMRuntime, feat: torch.Tensor) -> torch.Tensor:
    """Per-sample power normalisation: feat / (sum |feat|^p / numel +
    1e-10)^(1/p) over (S, S, C)."""
    p = rt.feat_normalize_power
    if p is None:
        return feat
    numel = feat.shape[1] * feat.shape[2] * feat.shape[3]
    s = div_const(torch.sum(torch.abs(feat) ** p, dim=(1, 2, 3), keepdim=True), numel)
    # XLA takes x ** 0.5 as a square root
    return feat / (torch.sqrt(s + 1e-10) if p == 2 else (s + 1e-10) ** (1.0 / p))


def _apply_filter_same(rt: ATOMRuntime, comp: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The reference's conv2d(mode='same'): models/dimp.py::apply_filter
    (its weight made contiguous, which the CPU's f64 convolution backward
    needs), an even kernel's trailing row and column dropped, so the
    response lives on the feat_sz grid."""
    fh, fw = f.shape[0], f.shape[1]
    resp = F.conv2d(comp.permute(0, 3, 1, 2), f.permute(2, 0, 1)[None].contiguous(),
                    padding=(fh // 2, fw // 2))[:, 0]
    if rt.kernel_size % 2 == 0:
        resp = resp[:, :-1, :-1]
    return resp


def _sigma(rt: ATOMRuntime, base_target_sz: torch.Tensor) -> torch.Tensor:
    """The label sigma in feature cells."""
    return div_const(rt.output_sigma_factor * torch.sqrt(torch.prod(base_target_sz)),
                     rt.feat_stride)


def _label(rt: ATOMRuntime, sigma, center_yx) -> torch.Tensor:
    S = rt.feat_sz
    return gauss_label_2d(S, S, sigma, sigma, center_yx[0], center_yx[1],
                          device=sigma.device)


def _kernel_offset(rt: ATOMRuntime) -> float:
    """The even kernel's half-cell label shift."""
    return 0.5 * ((rt.kernel_size + 1) % 2)


def _residuals_joint(rt: ATOMRuntime, fp, samples, y, sw):
    """The factorised-convolution residuals over (filter, projection)."""
    f, P = fp
    resp = mlu(_apply_filter_same(rt, samples @ P, f), rt.response_act_param)
    return {"data": torch.sqrt(sw)[:, None, None] * (resp - y),
            "f": math.sqrt(rt.filter_reg) * f,
            "P": math.sqrt(rt.projection_reg) * P}


def _residuals_filter(rt: ATOMRuntime, f, comp, y, sw):
    """The convolution residuals over the filter only."""
    resp = mlu(_apply_filter_same(rt, comp, f), rt.response_act_param)
    return {"data": torch.sqrt(sw)[:, None, None] * (resp - y),
            "f": math.sqrt(rt.filter_reg) * f}


def _interpolate_scores(rt: ATOMRuntime, raw: torch.Tensor) -> torch.Tensor:
    """The raw (N, N) response Fourier-interpolated to output_sz: the
    centred spectrum over N^2, shifted by pi (1 - (k % 2) / N), sampled
    and rolled so index G // 2 is zero displacement."""
    N, G = raw.shape[-1], rt.output_sz
    sf = div_const(cfft2(raw), N * N)
    shift = math.pi * (1.0 - (rt.kernel_size % 2) / N)
    sf = shift_spectrum(sf, _vec((shift, shift), raw.device))
    return torch.roll(sample_scores(sf, G), (G // 2, G // 2), dims=(-2, -1))


def _localize_atom(rt: ATOMRuntime, scores: torch.Tensor, state: dict, sample_scale):
    """ATOM's advanced localisation on the interpolated grid: unlike
    DiMP's, the displacement norms are absolute offsets from the crop
    centre. Returns (translation (y, x), flag, max score)."""
    G = rt.output_sz
    center = G // 2
    scale_fac = (rt.image_sample_size / G) * sample_scale
    dev = scores.device

    max1, disp1 = _max2d(scores)
    target_disp1 = disp1 - center
    trans1 = target_disp1 * scale_fac

    neigh = rt.target_neighborhood_scale * state["target_sz"] / sample_scale
    iy = torch.arange(G, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(G, dtype=torch.float32, device=dev)[None, :]
    top = torch.clamp(torch.round(disp1[0] - neigh[0] / 2), min=0.0)
    bottom = torch.clamp(torch.round(disp1[0] + neigh[0] / 2 + 1), max=float(G))
    left = torch.clamp(torch.round(disp1[1] - neigh[1] / 2), min=0.0)
    right = torch.clamp(torch.round(disp1[1] + neigh[1] / 2 + 1), max=float(G))
    inside = (iy >= top) & (iy < bottom) & (ix >= left) & (ix < right)
    max2, disp2 = _max2d(torch.where(inside, 0.0, scores))
    target_disp2 = disp2 - center
    trans2 = target_disp2 * scale_fac

    disp_norm1 = torch.sqrt((target_disp1 ** 2).sum())
    disp_norm2 = torch.sqrt((target_disp2 ** 2).sum())
    disp_thresh = rt.displacement_scale * math.sqrt(G * G) / 2

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


def _update_memory_atom(rt: ATOMRuntime, state: dict, comp: torch.Tensor, label: torch.Tensor,
                        lr: torch.Tensor, update_ok: Optional[torch.Tensor] = None) -> dict:
    """Min-weight replacement of (projected feature, label) pairs with the
    init samples protected (DiMP's scheme). The memory's row is written in
    place; with `update_ok` false every field stays as it was."""
    sw = state["sample_weights"]
    num, prev = state["num_stored"], state["prev_replace_ind"]
    M, num_init = rt.sample_memory_size, rt.num_init_samples
    slots = torch.arange(M, device=sw.device)
    cand = torch.where(slots >= num_init, sw, math.inf)
    r_ind = torch.where(num < M, num, torch.argmin(cand).to(torch.int32)).reshape(1)

    first = prev < 0
    sw1 = torch.where(first, sw / (1 - lr), sw)
    prev_w = sw1.gather(0, torch.clamp(prev, min=0).long().reshape(1))[0]
    new_w = torch.where(first, lr, prev_w / (1 - lr))
    sw1 = sw1.index_put((r_ind.long(),), new_w.reshape(1))
    sw1 = sw1 / sw1.sum()
    need = sw1[:num_init].sum() < rt.init_samples_minimum_weight
    rest = sw1[num_init:].sum()
    sw2 = sw1 / (rt.init_samples_minimum_weight + rest)
    sw2[:num_init] = rt.init_samples_minimum_weight / num_init
    sw1 = torch.where(need, sw2, sw1)
    new_num = torch.clamp(num + 1, max=M)

    idx, new_prev = r_ind.long(), r_ind[0]
    comp, label = comp[None], label[None]
    if update_ok is not None:
        comp = torch.where(update_ok, comp, state["memory_comp"].index_select(0, idx))
        label = torch.where(update_ok, label, state["memory_y"].index_select(0, idx))
        sw1 = torch.where(update_ok, sw1, sw)
        new_num = torch.where(update_ok, new_num, num)
        new_prev = torch.where(update_ok, new_prev, prev)
    state["memory_comp"].index_copy_(0, idx, comp)
    state["memory_y"].index_copy_(0, idx, label)
    return {**state, "sample_weights": sw1, "num_stored": new_num.to(torch.int32),
            "prev_replace_ind": new_prev.to(torch.int32)}


def atom_assemble_init_state(rt: ATOMRuntime, model: ATOMNet, clf_feats: torch.Tensor,
                             bfeat_id: dict, shifts: torch.Tensor, pos, target_sz, target_scale,
                             base_target_sz, draw: Callable) -> dict:
    """The state from extracted init features (atom_tracker.py:270-339):
    clf_feats (N, S, S, 256) normalised over the N augmented samples,
    bfeat_id the identity sample's raw {'layer2', 'layer3'}, shifts (N, 2)
    content shifts in sample pixels. The labels, the joint optimisation
    from the random inits, the IoU modulation and the memory."""
    N, dev = clf_feats.shape[0], clf_feats.device
    init_sample_pos = torch.round(pos)
    sigma = _sigma(rt, base_target_sz)
    tcn = (pos - init_sample_pos) / (target_scale * rt.feat_stride)
    centers = tcn[None] + _kernel_offset(rt) + div_const(shifts, rt.feat_stride)
    y0 = torch.stack([_label(rt, sigma, c) for c in centers])

    sw = torch.full((N,), 1.0 / N, device=dev)
    P0 = div_const(_to_device(draw("projection", (rt.feat_dim, rt.compressed_dim)), dev),
                   math.sqrt(rt.feat_dim))
    k = rt.kernel_size
    f0 = div_const(_to_device(draw("filter", (k, k, rt.compressed_dim)), dev),
                   k * k * rt.compressed_dim)
    inv_reg = (float(np.float32(1.0) / np.float32(rt.filter_reg)),
               float(np.float32(1.0) / np.float32(rt.projection_reg)))
    f, P = gauss_newton_cg(partial(_residuals_joint, rt, samples=clf_feats, y=y0, sw=sw),
                           (f0, P0), rt.init_gn_iter, rt.init_cg_per_gn,
                           precond=lambda t: (t[0] * inv_reg[0], t[1] * inv_reg[1]))

    box = _get_iounet_box(rt, pos, target_sz, init_sample_pos, target_scale)
    mod3, mod4 = model.bb_regressor.get_modulation([bfeat_id["layer2"][:1],
                                                    bfeat_id["layer3"][:1]], box[None])
    comp_init = clf_feats @ P
    M, S = rt.sample_memory_size, rt.feat_sz
    memory_comp = torch.zeros((M,) + comp_init.shape[1:], dtype=torch.float32, device=dev)
    memory_comp[:N] = comp_init
    memory_y = torch.zeros((M, S, S), dtype=torch.float32, device=dev)
    memory_y[:N] = y0
    sample_weights = torch.zeros((M,), dtype=torch.float32, device=dev)
    sample_weights[:N] = 1.0 / N
    i32 = dict(dtype=torch.int32, device=dev)
    return {"pos": pos, "target_sz": target_sz, "target_scale": target_scale,
            "base_target_sz": base_target_sz, "filter": f, "projection": P,
            "memory_comp": memory_comp, "memory_y": memory_y,
            "sample_weights": sample_weights, "num_stored": torch.tensor(N, **i32),
            "prev_replace_ind": torch.tensor(-1, **i32), "frame_num": 1,
            "iou_mod3": mod3[0], "iou_mod4": mod4[0]}


def atom_init_state(rt: ATOMRuntime, model: ATOMNet, frame: torch.Tensor,
                    init_box_xywh: torch.Tensor, draw: Callable) -> dict:
    """First-frame state (atom_tracker.py:342-382). frame (H, W, C) uint8
    on the model's device, the init box (4,) f32 on it."""
    x, y, w, h = init_box_xywh.unbind()
    pos = torch.stack([y + (h - 1) / 2, x + (w - 1) / 2])
    target_sz = torch.stack([h, w])
    search_area = torch.prod(target_sz * rt.search_area_scale)
    target_scale = div_const(torch.sqrt(search_area), rt.image_sample_size)
    base_target_sz = target_sz / target_scale

    S_im = rt.image_sample_size
    S_e = S_im * rt.augmentation_expansion_factor
    # the expanded crop centred at the unrounded position; labels and
    # boxes map through its rounding
    szl_e, tl_e, _, _ = _sample_geometry(rt, pos, target_scale, out_size=S_e)
    expanded = _normalize(crop_at(frame, pos, szl_e, S_e, origin_yx=tl_e))
    n_rand = num_random_shifts(blur_sigmas=rt.aug_blur, rotate_angles=rt.aug_rotate)
    patches, shifts = dimp_init_augmentations(
        expanded, S_im, draw("shift", (n_rand, 2)), random_shift_factor=rt.random_shift_factor,
        blur_sigmas=rt.aug_blur, rotate_angles=rt.aug_rotate)
    bfeat = model.extract_backbone(patches)
    clf = _normalize_feat(rt, bfeat["layer3"])
    if rt.aug_dropout_num > 0:
        u = draw("dropout", (rt.aug_dropout_num, 1, 1, clf.shape[-1]))
        drop = feature_dropout(clf[0], _to_device(u, clf.device), rt.aug_dropout_prob)
        clf = torch.cat([clf, drop])
        shifts = torch.cat([shifts, shifts.new_zeros((rt.aug_dropout_num, 2))])
    return atom_assemble_init_state(rt, model, clf, {k: v[:1] for k, v in bfeat.items()},
                                    shifts, pos, target_sz, target_scale, base_target_sz, draw)


def atom_step_from_patch(rt: ATOMRuntime, model: ATOMNet, state: dict, patch: torch.Tensor,
                         sample_pos, sample_scale, img_hw, jitter_u: Optional[torch.Tensor]):
    """A tracked frame from its raw (0..255) sample patch (S, S, C) and the
    forced geometry (sample_pos = round(pos), sample_scale = target_scale),
    up to the filter update (atom_tracker.py:401-456). Localisation runs
    on the raw response; mlu only shapes the training residuals. Returns
    (state, box (4,) xywh, max score, flag), all tensors."""
    H, W = img_hw
    state = {**state, "frame_num": state["frame_num"] + 1}
    bfeat = model.extract_backbone(_normalize(patch)[None])
    comp = _normalize_feat(rt, bfeat["layer3"]) @ state["projection"]
    raw = _apply_filter_same(rt, comp, state["filter"])
    scores = _interpolate_scores(rt, raw[0])

    translation, flag, max_score = _localize_atom(rt, scores, state, sample_scale)
    found = flag != FLAG_NOT_FOUND
    new_pos = sample_pos + translation
    inside_offset = (rt.target_inside_ratio - 0.5) * state["target_sz"]
    img_sz = _vec((float(H), float(W)), patch.device)
    new_pos = torch.maximum(torch.minimum(new_pos, img_sz - inside_offset), inside_offset)
    state = {**state, "pos": torch.where(found, new_pos, state["pos"])}

    ref_pos, ref_sz, ref_scale, ref_ok = _refine_box(rt, model, bfeat, state, sample_pos,
                                                     sample_scale, jitter_u)
    apply_ref = found & ref_ok
    state = {**state, "pos": torch.where(apply_ref, ref_pos, state["pos"]),
             "target_sz": torch.where(apply_ref, ref_sz, state["target_sz"]),
             "target_scale": torch.where(apply_ref, ref_scale, state["target_scale"])}

    update_ok = (flag != FLAG_NOT_FOUND) & (flag != FLAG_UNCERTAIN)
    lr = torch.where(flag == FLAG_HARD_NEG, rt.hard_negative_learning_rate,
                     rt.learning_rate).float()
    # the new sample's label: the refined position, the init sigma, the
    # even kernel's half-cell offset
    score_center = (state["pos"] - sample_pos) / (sample_scale * rt.feat_stride) \
        + _kernel_offset(rt)
    label = _label(rt, _sigma(rt, state["base_target_sz"]), score_center)
    state = _update_memory_atom(rt, state, comp[0], label, lr, update_ok)
    box = torch.cat([(state["pos"] - (state["target_sz"] - 1) / 2).flip(0),
                     state["target_sz"].flip(0)])
    return state, box, max_score, flag


def atom_track_step(rt: ATOMRuntime, model: ATOMNet, state: dict, frame: torch.Tensor,
                    jitter_u: Optional[torch.Tensor]):
    """One frame (H, W, C) uint8 up to the filter update: the sample crop at
    the unrounded position, then `atom_step_from_patch`. ATOM maps every
    coordinate through (round(pos), target_scale), not the crop's own
    rounded geometry, as the reference does."""
    crop_sz, tl, _, _ = _sample_geometry(rt, state["pos"], state["target_scale"])
    patch = crop_at(frame, state["pos"], crop_sz, rt.image_sample_size, origin_yx=tl)
    return atom_step_from_patch(rt, model, state, patch, torch.round(state["pos"]),
                                state["target_scale"], (frame.shape[0], frame.shape[1]),
                                jitter_u)


def atom_num_cg(rt: ATOMRuntime, frame_num: int, flag: int) -> int:
    """CG iterations of the frame's filter update: hard_negative_cg_iter on a
    hard negative, update_cg_iter every train_skipping-th frame, else 0.
    The cadence runs whatever the flag (the reference's periodic update
    sits outside its update_flag block)."""
    if flag == FLAG_HARD_NEG:
        return rt.hard_negative_cg_iter
    return rt.update_cg_iter if (frame_num - 1) % rt.train_skipping == 0 else 0


def atom_update_filter(rt: ATOMRuntime, state: dict, num_cg: int) -> dict:
    """The filter update: one Gauss-Newton linearisation over the memory,
    num_cg Polak-Ribiere CG iterations."""
    if num_cg == 0:
        return state
    f = gauss_newton_cg(partial(_residuals_filter, rt, comp=state["memory_comp"],
                                y=state["memory_y"], sw=state["sample_weights"]),
                        state["filter"], 1, num_cg, fletcher_reeves=False)
    return {**state, "filter": f}


class ATOMTracker:
    """Single-sequence facade (BaseTracker API). `model` must hold its
    weights; it is moved to `device` and frozen. `draws` is a factory of
    draw sources, called at every initialize (default ATOMDraws(seed)). A
    frame reads the card once, for its box, score and flag; `flags` counts
    the frames of each flag and `cg_iters` the update's CG iterations."""

    def __init__(self, model: ATOMNet, device, runtime: Optional[ATOMRuntime] = None,
                 seed: int = 0, draws: Optional[Callable[[], Callable]] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or ATOMRuntime()
        self.draws = draws or (lambda: ATOMDraws(seed))
        self.state = None
        self.flags = dict.fromkeys(FLAG_NAMES, 0)
        self.cg_iters = 0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        self._draw = self.draws()
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self.state = atom_init_state(self.rt, self.model, as_frames(image, self.device), box,
                                     self._draw)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        frame = as_frames(image, self.device)
        jitter = None
        if self.rt.num_init_random_boxes > 0:
            jitter = _to_device(self._draw("jitter", (self.rt.num_init_random_boxes, 4)),
                                self.device)
        self.state, box, score, flag = atom_track_step(self.rt, self.model, self.state, frame,
                                                       jitter)
        out = torch.cat([box, score.reshape(1), flag.reshape(1).float()]).cpu().numpy()
        name = FLAG_NAMES[int(out[5])]
        num_cg = atom_num_cg(self.rt, self.state["frame_num"], int(out[5]))
        self.state = atom_update_filter(self.rt, self.state, num_cg)
        self.flags[name] += 1
        self.cg_iters += num_cg
        return {"target_bbox": out[:4].tolist(), "best_score": float(out[4]), "flag": name,
                "cg_iters": num_cg}
