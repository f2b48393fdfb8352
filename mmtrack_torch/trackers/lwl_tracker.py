"""LWL segmentation tracker runtime, port of
mmtrack_tpu/trackers/lwl_tracker.py.

A tracked frame:

  1. the target model's update from the previous frame's full-image
     probabilities: cropped back to the previous search region (nearest,
     zero border), encoded, written into the sample memory (min-weight
     replacement, the init slot protected), and net_opt_update_iter
     Gauss-Newton steps of the few-shot learner over the stored samples;
  2. the box and search region from those probabilities: the centre of
     mass and 4 sqrt(variance), gated by min_mask_area, the scale change
     clipped;
  3. the crop, backbone, target-model features, the filter applied and the
     mask decoded (models/lwl.py);
  4. the crop's scores pasted into the image (-100 outside the search
     region), their sigmoid kept for the next frame's update, the mask
     (scores > 0) and its bounding box returned.

The update schedule depends on the frame count alone, so it is decided on
the host: JAX runs the encoder over all memory masks and the GN steps
every frame, masked by `jnp.where(can_update, ...)` and frozen past
`num_iter`; the port runs exactly the steps JAX keeps, encodes only the
new mask (the stored samples' encodings are kept, the same function of
the same masks) and solves over the stored samples only (the empty ones
carry zero weight, so their residuals are exact zeros in JAX). The
number stored, the update count and the frame number are host ints; the
replaced slot once the memory is full is the device argmin (the first
minimum, as jnp.argmin), so no step reads the card. JAX's jitted step
divides by constants as a product with the f32 reciprocal
(models/dimp.py::div_const); so does the port. A frame reads the card
once, for the box, the score and the mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.lwl import LWLNet
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.trackers.dimp_tracker import _normalize
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class LWLRuntime:
    """lwl_tracker.py:52-72, the same defaults."""
    image_sample_size: int = 30 * 16
    search_area_scale: float = 6.0
    feat_stride: int = 16
    sample_memory_size: int = 32
    learning_rate: float = 0.1
    init_samples_minimum_weight: float = 0.25
    train_skipping: int = 1
    net_opt_iter: int = 20
    net_opt_update_iter: int = 3
    min_mask_area: float = 100.0
    seg_to_bb_sz_factor: float = 4.0
    max_scale_change: tuple[float, float] = (0.95, 1.1)
    border_mode: str = "replicate"
    update_target_model: bool = True

    @property
    def feat_sz(self) -> int:
        return self.image_sample_size // self.feat_stride


def _rgb_normalized(patch: torch.Tensor) -> torch.Tensor:
    """The network is RGB-only: a composed frame's colour triplet,
    normalised."""
    return _normalize(patch[..., :3])


def _centered_pos(rt: LWLRuntime, model: LWLNet, pos, target_scale):
    """get_centered_sample_pos (lwl_tracker.py:81-84)."""
    off = (rt.feat_sz + model.filter_size) % 2
    return pos + div_const(off * target_scale * rt.image_sample_size, 2 * rt.feat_sz)


def _crop_geometry(rt, pos, target_scale):
    """sample_patch's geometry, replicate mode (lwl_tracker.py:87-96):
    (szl, tl (y, x), sample_pos, sample_scale)."""
    S = rt.image_sample_size
    posl = torch.trunc(pos)
    szl = torch.clamp(torch.round(target_scale * S), min=2.0)
    tl = posl - torch.floor((szl - 1.0) / 2.0)
    br = posl + torch.floor(szl / 2.0) + 1.0
    sample_pos = 0.5 * (tl + br - 1.0)
    return szl, tl, sample_pos, div_const(szl, S)


def _crop_mask_nearest(img: torch.Tensor, tl, szl, out_sz: int) -> torch.Tensor:
    """The mask crop of sample_patch(is_mask=True) (lwl_tracker.py:99-111):
    the integer crop with zero padding, nearest resize (src = floor(dst *
    in / out)). img (H, W) -> (S, S)."""
    H, W = img.shape
    dev = img.device
    idx = torch.floor(torch.arange(out_sz, dtype=torch.float32, device=dev)
                      * div_const(szl, out_sz)).long()
    ys = tl[0].long() + idx
    xs = tl[1].long() + idx
    vy = (ys >= 0) & (ys < H)
    vx = (xs >= 0) & (xs < W)
    g = img[ys.clamp(0, H - 1)][:, xs.clamp(0, W - 1)]
    return torch.where(vy[:, None] & vx[None, :], g, 0.0)


def _moments(prob_im: torch.Tensor):
    """(total, safe total, row sums, column sums, row and column indices,
    e_y, e_x) of an (H, W) map."""
    H, W = prob_im.shape
    dev = prob_im.device
    total = prob_im.sum()
    safe = torch.clamp(total, min=1e-6)
    row, col = prob_im.sum(dim=1), prob_im.sum(dim=0)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    return total, safe, row, col, ys, xs, (row * ys).sum() / safe, (col * xs).sum() / safe


def _seg_to_box(rt: LWLRuntime, prob_im: torch.Tensor, pos, target_sz):
    """get_target_state, 'var' mode (lwl_tracker.py:114-131): the centre of
    mass and seg_to_bb_sz_factor sqrt(variance); the old state below
    min_mask_area."""
    total, safe, row, col, ys, xs, e_y, e_x = _moments(prob_im)
    e_h = (row * (ys - e_y) ** 2).sum() / safe
    e_w = (col * (xs - e_x) ** 2).sum() / safe
    new_pos = torch.stack([e_y, e_x])
    new_sz = torch.stack([torch.sqrt(torch.clamp(e_h, min=0.0)),
                          torch.sqrt(torch.clamp(e_w, min=0.0))]) * rt.seg_to_bb_sz_factor
    ok = total >= rt.min_mask_area
    return torch.where(ok, new_pos, pos), torch.where(ok, new_sz, target_sz)


def paste_crop(S: int, crop: torch.Tensor, sample_pos, sample_scale, im_hw,
               fill: float) -> torch.Tensor:
    """The (S, S) crop map pasted into the image as an inverse-map bilinear
    gather (F.interpolate at the scale itself, then the integer paste),
    `fill` outside the pasted region (lwl_tracker.py:134-167,
    stm_tracker.py:92-121)."""
    H, W = im_hw
    dev = crop.device
    out_sz = torch.floor(S * sample_scale)
    r1 = torch.trunc(sample_pos[0] - 0.5 * out_sz)
    c1 = torch.trunc(sample_pos[1] - 0.5 * out_sz)

    def axis(n, origin):
        u = torch.arange(n, dtype=torch.float32, device=dev) - origin
        inside = (u >= 0) & (u < out_sz)
        return torch.clamp((u + 0.5) / sample_scale - 0.5, 0.0, S - 1.0), inside

    ys, in_y = axis(H, r1)
    xs, in_x = axis(W, c1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    y0, x0 = y0.long(), x0.long()

    def tap(yi, xi):
        return crop[yi.clamp(0, S - 1)][:, xi.clamp(0, S - 1)]

    v = ((1 - fy) * (1 - fx) * tap(y0, x0) + (1 - fy) * fx * tap(y0, x0 + 1)
         + fy * (1 - fx) * tap(y0 + 1, x0) + fy * fx * tap(y0 + 1, x0 + 1))
    return torch.where(in_y[:, None] & in_x[None, :], v, fill)


def _paste_scores(rt: LWLRuntime, scores, sample_pos, sample_scale, im_hw):
    """convert_scores_crop_to_image: -100 outside the search region."""
    return paste_crop(rt.image_sample_size, scores, sample_pos, sample_scale, im_hw, -100.0)


def _mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """masks_to_bboxes(fmt='t') (lwl_tracker.py:170-186): the tight (x, y,
    w, h) of the mask; an empty mask gives (0, 0, 1, 1)."""
    H, W = mask.shape
    dev = mask.device
    any_row, any_col = mask.any(dim=1), mask.any(dim=0)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    y0 = torch.where(any_row, ys, H).min()
    y1 = torch.where(any_row, ys, -1).max()
    x0 = torch.where(any_col, xs, W).min()
    x1 = torch.where(any_col, xs, -1).max()
    box = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1]).float()
    empty = torch.zeros(4, device=dev)
    empty[2:] = 1.0
    return torch.where(any_row.any(), box, empty)


def _update_memory(rt: LWLRuntime, state: dict, feat, mask_crop, label, sw_map,
                   lr: float) -> dict:
    """Min-weight replacement with the init slot protected
    (lwl_tracker.py:189-219). The slot is the next free one while the
    memory fills (host), then the device argmin over the weights."""
    sw = state["sample_weights"]
    num, M, num_init = state["num_stored"], rt.sample_memory_size, 1
    dev = sw.device
    if num < M:
        r_ind = torch.full((1,), num, dtype=torch.long, device=dev)
    else:
        slots = torch.arange(M, device=dev)
        r_ind = torch.argmin(torch.where(slots >= num_init, sw, torch.inf)).reshape(1)
    if state["updates"] == 0:
        sw1 = div_const(sw, 1 - lr)
        new_w = torch.full((1,), lr, dtype=torch.float32, device=dev)
    else:
        sw1 = sw
        new_w = div_const(sw[state["prev_replace_ind"]], 1 - lr)
    sw1 = sw1.index_copy(0, r_ind, new_w)
    sw1 = sw1 / sw1.sum()
    need = sw1[:num_init].sum() < rt.init_samples_minimum_weight
    sw2 = sw1 / (rt.init_samples_minimum_weight + sw1[num_init:].sum())
    sw2 = torch.cat([torch.full_like(sw2[:num_init], rt.init_samples_minimum_weight / num_init),
                     sw2[num_init:]])
    sw1 = torch.where(need, sw2, sw1)

    def put(mem, x):
        return mem.index_copy(0, r_ind, x[None])

    return {**state,
            "memory_feat": put(state["memory_feat"], feat),
            "memory_masks": put(state["memory_masks"], mask_crop),
            "memory_label": put(state["memory_label"], label),
            "memory_sw": put(state["memory_sw"], sw_map),
            "sample_weights": sw1,
            "num_stored": min(num + 1, M),
            "updates": state["updates"] + 1,
            "prev_replace_ind": r_ind}


def _rectangle(H: int, W: int, box: torch.Tensor) -> torch.Tensor:
    x, y, w, h = box
    dev = box.device
    iy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    return (((iy >= y) & (iy < y + h)) & ((ix >= x) & (ix < x + w))).float()


def lwl_init_state(rt: LWLRuntime, model: LWLNet, frame: torch.Tensor,
                   init_box_xywh: torch.Tensor, init_mask: Optional[torch.Tensor] = None) -> dict:
    """initialize (lwl_tracker.py:222-294): `init_mask` (H, W) in [0, 1];
    without it the box encoder on the full frame when the model has one,
    else the box as a rectangle mask."""
    H, W = frame.shape[0], frame.shape[1]
    x, y, w, h = init_box_xywh
    pos = torch.stack([y + (h - 1) / 2, x + (w - 1) / 2])
    target_sz = torch.stack([h, w])
    box_init_raw = None
    if init_mask is None and model.use_box_encoder:
        bf = model.extract_backbone(_rgb_normalized(frame.float())[None])
        tm = model.extract_target_model_features(bf)
        box_init_raw = model.mask_from_box(init_box_xywh[None], tm, bf, (H, W))[0]
        init_mask = torch.sigmoid(box_init_raw)
    elif init_mask is None:
        init_mask = _rectangle(H, W, init_box_xywh)

    target_scale = div_const(torch.sqrt(torch.prod(target_sz * rt.search_area_scale)),
                             rt.image_sample_size)
    base_target_sz = target_sz / target_scale
    S = rt.image_sample_size
    init_sample_pos = torch.round(pos)
    szl, tl, _, _ = _crop_geometry(rt, init_sample_pos, target_scale)
    patch = _rgb_normalized(crop_at(frame[..., :3], init_sample_pos, szl, S, origin_yx=tl))
    mask_crop = _crop_mask_nearest(init_mask, tl, szl, S)

    bfeat = model.extract_backbone(patch[None])
    feat = model.extract_target_model_features(bfeat)[0]
    label, sw = model.encode_labels(mask_crop[None])
    filt = model.get_filter(feat[None], label, sw, None, rt.net_opt_iter)

    M, fh = rt.sample_memory_size, rt.feat_sz

    def slot0(x):
        mem = torch.zeros((M,) + tuple(x.shape), dtype=torch.float32, device=x.device)
        mem[0] = x
        return mem

    sample_weights = torch.zeros(M, dtype=torch.float32, device=feat.device)
    sample_weights[0] = 1.0
    # the init frame's "previous segmentation": the box encoder's raw
    # logits, else the reference's +-100 scaling of the mask
    # (lwl_tracker.py:270-278), which the min_mask_area gate rejects
    seg_raw = box_init_raw if box_init_raw is not None else (init_mask - 0.5) * 200.0
    assert feat.shape[:2] == (fh, fh), (feat.shape, fh)
    return {"pos": pos, "target_sz": target_sz, "target_scale": target_scale,
            "base_target_sz": base_target_sz, "filter": filt,
            "memory_feat": slot0(feat), "memory_masks": slot0(mask_crop),
            "memory_label": slot0(label[0]), "memory_sw": slot0(sw[0]),
            "sample_weights": sample_weights, "num_stored": 1, "updates": 0,
            "prev_replace_ind": torch.full((1,), -1, dtype=torch.long, device=feat.device),
            "frame_num": 1, "prev_feat": feat,
            "prev_pos": _centered_pos(rt, model, pos, target_scale),
            "prev_scale": target_scale, "seg_prob_im": seg_raw}


def lwl_track_step(rt: LWLRuntime, model: LWLNet, state: dict, frame: torch.Tensor):
    """One tracked frame (lwl_tracker.py:297-364). Returns (state, box
    (4,) xywh, mask (H, W) bool, max probability, aux {'updated',
    'num_iter'} host values)."""
    H, W = frame.shape[0], frame.shape[1]
    S = rt.image_sample_size
    frame_num = state["frame_num"] + 1
    state = {**state, "frame_num": frame_num}
    prev_prob = state["seg_prob_im"]

    can_update = rt.update_target_model and frame_num > 2
    num_iter = rt.net_opt_update_iter if can_update and (frame_num - 1) % rt.train_skipping == 0 \
        else 0
    if can_update:
        szl_p, tl_p, _, _ = _crop_geometry(rt, state["prev_pos"], state["prev_scale"])
        mask_crop = _crop_mask_nearest(prev_prob, tl_p, szl_p, S)
        label, sw = model.encode_labels(mask_crop[None])
        state = _update_memory(rt, state, state["prev_feat"], mask_crop, label[0], sw[0],
                               rt.learning_rate)
        if num_iter:
            n = state["num_stored"]
            state = {**state, "filter": model.optimize_filter(
                state["filter"], state["memory_feat"][:n], state["memory_label"][:n],
                state["memory_sw"][:n], state["sample_weights"][:n], num_iter)}

    # the box and search region from the previous segmentation
    pos, target_sz = _seg_to_box(rt, prev_prob, state["pos"], state["target_sz"])
    new_scale = torch.sqrt(torch.prod(target_sz) / torch.prod(state["base_target_sz"]))
    change = new_scale / state["target_scale"]
    lo, hi = rt.max_scale_change
    new_scale = torch.where(change < lo, state["target_scale"] * lo,
                            torch.where(change > hi, state["target_scale"] * hi, new_scale))
    target_sz = state["base_target_sz"] * new_scale
    state = {**state, "pos": pos, "target_sz": target_sz, "target_scale": new_scale}

    # the current frame's segmentation
    c_pos = _centered_pos(rt, model, pos, new_scale)
    szl, tl, sample_pos, sample_scale = _crop_geometry(rt, c_pos, new_scale)
    patch = _rgb_normalized(crop_at(frame[..., :3], c_pos, szl, S, origin_yx=tl))
    bfeat = model.extract_backbone(patch[None])
    feat = model.extract_target_model_features(bfeat)
    scores = model.segment(state["filter"], feat, bfeat, (S, S))[0]
    scores_im = _paste_scores(rt, scores, sample_pos, sample_scale, (H, W))
    prob_im = torch.sigmoid(scores_im)
    mask_im = scores_im > 0.0
    box = _mask_to_box(mask_im)
    state = {**state, "prev_feat": feat[0], "prev_pos": c_pos, "prev_scale": new_scale,
             "seg_prob_im": prob_im}
    return state, box, mask_im, prob_im.max(), {"updated": can_update, "num_iter": num_iter}


def read_outputs(box: torch.Tensor, score: torch.Tensor, mask: torch.Tensor):
    """(box list, score, mask (H, W) bool) of a frame in one read of the
    card: the five floats' bytes and the mask's in one uint8 tensor."""
    head = torch.cat([box.float(), score.reshape(1).float()]).view(torch.uint8)
    host = torch.cat([head, mask.reshape(-1).view(torch.uint8)]).cpu().numpy()
    vals = host[:20].view(np.float32)
    return vals[:4].tolist(), float(vals[4]), host[20:].view(bool).reshape(mask.shape)


class LWLTracker:
    """Single-sequence facade (BaseTracker API) that predicts its own mask:
    `model` an LWLNet holding its weights, moved to `device`. `track`
    returns `target_bbox`, `segmentation` ((H, W) bool) and `best_score`
    (the largest pasted probability). `updates` counts the memory updates
    and `optimizer_iters` the GN steps they ran."""

    predicts_segmentation_mask = True

    def __init__(self, model: LWLNet, device, runtime: Optional[LWLRuntime] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or LWLRuntime()
        self.state = None
        self.updates = 0
        self.optimizer_iters = 0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        mask = info.get("init_mask")
        if mask is not None:
            mask = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
        self.state = lwl_init_state(self.rt, self.model, as_frames(image, self.device), box,
                                    mask)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, mask, score, aux = lwl_track_step(
            self.rt, self.model, self.state, as_frames(image, self.device))
        self.updates += int(aux["updated"])
        self.optimizer_iters += aux["num_iter"]
        box, score, mask = read_outputs(box, score, mask)
        return {"target_bbox": box, "segmentation": mask, "best_score": score}
