"""KeepTrack tracker runtime, port of mmtrack_tpu/trackers/keeptrack_tracker.py.

The DiMP runtime (trackers/dimp_tracker.py) with peak matching for the
target's identity. Every score-map peak becomes a candidate with a
learned descriptor and an image-coordinate keypoint; identities persist
across frames through the matcher (models/peak_matching.py), the
selected identity drives localisation, and ATOM's advanced localisation
serves when the score is low or the match memory has a gap. The
reference's three-way state machine:

  - low:   max score < peak_threshold -> advanced localisation, the
           collection kept stale, the match memory not refreshed;
  - fresh: a memory gap (frame 2 included) -> advanced localisation, the
           collection rebuilt from the current peaks, certain while
           frame_num < 10;
  - match: the matcher against the previous frame's peaks (its matches1
           consumed); one strong peak on each side is an identity match
           of probability 1 without the matcher (the 1-v-1 speedup).

While the target is lost the search area regrows from the recent scale
history, and the classifier memory is certainty-weighted, with the
reference's permanent zeroing of sub-threshold certainties.

The init takes DiMP's samples (`dimp_init_samples`), Gaussian labels per
sample, and the hinge optimiser on them (super_dimp, build_super_dimp50).

As in the port's DiMP step, every decision stays a tensor on the frames'
device and is selected with `torch.where`. JAX's `lax.cond(run_matcher)`
becomes an unconditional matcher pass and a select: the matcher's forward
(18 GNN layers and 50 Sinkhorn iterations over K peaks) runs on every
frame and its matches are taken only where the branch is `match`, so a
frame reads the card once, for its outputs and counters. The memory rows
are written in place (`index_copy_`), masked by the frame's update flag.
Random draws come from the DiMP tracker's draw seam (`TorchDraws`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mmtrack_torch.models.dimp import DiMPNet, div_const
from mmtrack_torch.models.peak_matching import PeakMatchingNetwork, init_peak_matching_weights
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.trackers.dimp_tracker import (
    FLAG_HARD_NEG,
    FLAG_NAMES,
    FLAG_NORMAL,
    FLAG_NOT_FOUND,
    DiMPRuntime,
    TorchDraws,
    _get_iounet_box,
    _localize_advanced,
    _normalize,
    _place_target,
    _sample_geometry,
    _to_device,
    dimp_init_samples,
)
from mmtrack_torch.trackers.keep_track import (
    NEG_ID,
    PeakMatchConfig,
    _at,
    extract_peaks,
    gather_descriptors,
    init_peak_state,
    match_peaks,
    peak_keypoints,
    update_peak_state,
)
from mmtrack_torch.trackers.vipt_tracker import as_frames

BRANCH_NAMES = ("low", "fresh", "match", "speedup")


@dataclass(frozen=True)
class KeepTrackRuntime(DiMPRuntime):
    """KeepTrack's release configuration (keeptrack_tracker.py:62-98):
    super_dimp_hinge's geometry and the certainty-weighted memory."""
    image_sample_size: int = 480          # 30 * 16
    search_area_scale: float = 8.0
    border_mode: str = "inside_major"
    patch_max_scale_change: float = 1.5
    box_refinement_space: str = "relative"
    box_refinement_iter: int = 10
    box_refinement_step_length: float = 2.5e-3
    output_sigma_factor: float = 0.25
    use_certainty_for_weight_computation: bool = True
    certainty_ths: float = 0.5
    id0_weight_increase: bool = True
    enable_search_area_rescaling_at_occlusion: bool = True
    peaks: PeakMatchConfig = PeakMatchConfig()
    scale_memory: int = 60                # the last 60 target scales
    skip_matching_single_peak: bool = True
    single_peak_score: float = 0.5
    use_learned_matcher: bool = True
    descriptor_dim: int = 256
    desc_feat_dim: int = 1024             # the raw layer3 features


def _label_spatial(rt: KeepTrackRuntime, sigma, center_yx):
    """Separable Gaussian on the (feat_sz + end_pad) score grid, origin at
    the map centre."""
    S = rt.feat_sz
    end_pad = (rt.kernel_size + 1) % 2
    k = torch.arange(S + end_pad, dtype=torch.float32, device=sigma.device) - (S - 1) / 2.0
    gy = torch.exp(-0.5 / sigma[0] ** 2 * (k - center_yx[0]) ** 2)
    gx = torch.exp(-0.5 / sigma[1] ** 2 * (k - center_yx[1]) ** 2)
    return gy[:, None] * gx[None, :]


def _frame_label(rt: KeepTrackRuntime, sigma, pos, sample_pos, sample_scale):
    """The frame's training label at the target's position."""
    end_pad = (rt.kernel_size + 1) % 2
    norm = (pos - sample_pos) / (sample_scale * rt.image_sample_size)
    return _label_spatial(rt, sigma, rt.feat_sz * norm + 0.5 * end_pad)


def _update_memory_keeptrack(rt: KeepTrackRuntime, state: dict, clf_feat, box_crop, label, lr,
                             certainty, update_ok: torch.Tensor) -> dict:
    """Certainty-weighted replacement (keeptrack_tracker.py:123-164): the
    slot of the lowest certainty x weight past the init slots, the
    previous slot's weight not carried when the same slot is replaced
    twice in a row, the label and certainty written beside the features
    and box. The rows are written in place; where `update_ok` is false
    every field keeps its value. Returns the new state."""
    M, num_init = rt.sample_memory_size, rt.num_init_samples
    sw, num, prev = state["sample_weights"], state["num_stored"], state["prev_replace_ind"]
    slots = torch.arange(M, device=sw.device)
    cand = torch.where(slots >= num_init, state["certainties"] * sw, float("inf"))
    r_ind = torch.where(num < M, num, torch.argmin(cand).to(torch.int32)).reshape(1)

    first = prev < 0
    same = ~first & (r_ind[0] == prev)
    prev_w = _at(sw, torch.clamp(prev, min=0))
    sw_first = (sw / (1 - lr)).index_put((r_ind.long(),), lr.reshape(1))
    sw_else = sw.index_put((r_ind.long(),), (prev_w / (1 - lr)).reshape(1))
    sw1 = torch.where(first, sw_first, torch.where(same, sw, sw_else))
    sw1 = sw1 / sw1.sum()
    need = sw1[:num_init].sum() < rt.init_samples_minimum_weight
    rest = sw1[num_init:].sum()
    sw2 = sw1 / (rt.init_samples_minimum_weight + rest)
    sw2[:num_init] = rt.init_samples_minimum_weight / num_init
    sw1 = torch.where(need, sw2, sw1)

    idx = r_ind.long()
    rows = {"memory_feat": clf_feat, "memory_boxes": box_crop, "memory_labels": label,
            "certainties": certainty}
    for k, v in rows.items():
        state[k].index_copy_(0, idx, torch.where(update_ok, v[None], state[k].index_select(0, idx)))
    return {**state, "sample_weights": torch.where(update_ok, sw1, sw),
            "num_stored": torch.where(update_ok, torch.clamp(num + 1, max=M), num).to(torch.int32),
            "prev_replace_ind": torch.where(update_ok, r_ind[0], prev).to(torch.int32)}


def _peak_descriptors(matcher: Optional[PeakMatchingNetwork], feat, coords):
    """The learned descriptors of the raw layer3 map, or the normalised
    feature gather without the learned matcher."""
    if matcher is None:
        return gather_descriptors(feat, coords)
    return matcher.descriptor_extractor(feat, coords)


def _occlusion_rescale(rt: KeepTrackRuntime, ring, count, counter):
    """Search-area regrowth while lost: of the last `scale_memory` stored
    scales, those >= the newest, the newest max(2, min(30, counter)) of
    them averaged."""
    Mr = rt.scale_memory
    dev = ring.device
    num_scales = torch.clamp(counter, 2, 30)
    ar = torch.arange(Mr, device=dev)
    ordered = ring[((count - 1) % Mr - ar) % Mr]          # [0] is the newest
    cand = (ar < torch.clamp(count, max=Mr)) & (ordered >= ordered[0])
    take = cand & (torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) <= num_scales)
    return (ordered * take).sum() / torch.clamp(take.sum(dtype=torch.int32), min=1)


def keeptrack_init_state(rt: KeepTrackRuntime, model: DiMPNet,
                         matcher: Optional[PeakMatchingNetwork], frame: torch.Tensor,
                         init_box_xywh: torch.Tensor, draw: Callable) -> dict:
    """First-frame state (keeptrack_tracker.py:195-320): DiMP's samples,
    a Gaussian label per sample (centres moved by its shift), the filter
    initialiser and the hinge optimiser on the labels; the memory seeded
    with certainty 1 and weight 1/N, the peak collection and the match
    memory empty."""
    s = dimp_init_samples(rt, model, frame, init_box_xywh, draw)
    clf_feat, boxes, bfeat0 = s["clf_feat"], s["boxes"], s["bfeat0"]
    pos, target_scale = s["pos"], s["target_scale"]
    dev = clf_feat.device
    sigma_v = torch.sqrt(torch.prod(rt.feat_sz / rt.image_sample_size * s["base_target_sz"])) \
        * rt.output_sigma_factor
    sigma = torch.stack([sigma_v, sigma_v])
    end_pad = (rt.kernel_size + 1) % 2
    norm = (pos - s["init_sample_pos"]) / (target_scale * rt.image_sample_size)
    center0 = rt.feat_sz * norm + 0.5 * end_pad
    centers = center0[None] + div_const(s["shifts"], rt.image_sample_size) * rt.feat_sz
    labels = torch.stack([_label_spatial(rt, sigma, c) for c in centers])

    N, Sf, _, C = clf_feat.shape
    w0 = model.get_filter(clf_feat, boxes)
    filt = model.optimize_filter(w0, clf_feat, labels, None, rt.net_opt_iter)
    mod3, mod4 = model.bb_regressor.get_modulation([bfeat0["layer2"], bfeat0["layer3"]],
                                                   s["box_crop"][None])
    M, So, K = rt.sample_memory_size, Sf + end_pad, rt.peaks.num_peaks
    f32 = dict(dtype=torch.float32, device=dev)
    memory_feat = torch.zeros((M, C, Sf, Sf), **f32).permute(0, 2, 3, 1)
    memory_feat[:N] = clf_feat
    memory_boxes = torch.zeros((M, 4), **f32)
    memory_boxes[:N] = boxes
    memory_labels = torch.zeros((M, So, So), **f32)
    memory_labels[:N] = labels
    certainties = torch.zeros((M,), **f32)
    certainties[:N] = 1.0
    sample_weights = torch.zeros((M,), **f32)
    sample_weights[:N] = 1.0 / N
    D = rt.descriptor_dim if matcher is not None else bfeat0["layer3"].shape[-1]
    i32 = dict(dtype=torch.int32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    cells = torch.zeros((K, 2), **f32)
    peaks = init_peak_state(rt.peaks, torch.zeros((K,), **f32), cells, cells, false.expand(K),
                            torch.zeros((K, D), **f32), certain=True)
    return {"pos": pos, "target_sz": s["target_sz"], "target_scale": target_scale,
            "base_target_sz": s["base_target_sz"], "sigma": sigma, "filter": filt,
            "memory_feat": memory_feat, "memory_boxes": memory_boxes,
            "memory_labels": memory_labels, "certainties": certainties,
            "sample_weights": sample_weights, "num_stored": torch.tensor(N, **i32),
            "prev_replace_ind": torch.tensor(-1, **i32), "frame_num": 1,
            "iou_mod3": mod3[0], "iou_mod4": mod4[0], "peaks": peaks, "mem_ok": false,
            "scale_ring": torch.zeros((rt.scale_memory,), **f32),
            "ring_count": torch.tensor(0, **i32), "nf_counter": torch.tensor(0, **i32),
            "last_flag": torch.tensor(FLAG_NORMAL, **i32), "last_use_match": false}


def keeptrack_track_step(rt: KeepTrackRuntime, model: DiMPNet,
                         matcher: Optional[PeakMatchingNetwork], state: dict,
                         frame: torch.Tensor, jitter_u: Optional[torch.Tensor]):
    """One frame (H, W, C) uint8: the sample crop at the reference's
    geometry, normalised, then `keeptrack_step_from_patch`."""
    H, W = frame.shape[0], frame.shape[1]
    crop_sz, tl, sample_pos, sample_scale = _sample_geometry(
        rt, state["pos"], state["target_scale"], im_hw=(H, W))
    patch = _normalize(crop_at(frame, state["pos"], crop_sz, rt.image_sample_size,
                               origin_yx=tl))
    return keeptrack_step_from_patch(rt, model, matcher, state, patch, tl, crop_sz, sample_pos,
                                     sample_scale, (float(H), float(W)), jitter_u)


def _trivial_match(K: int, dev):
    """The 1-v-1 speedup's identity match: peak 0 to peak 0, probability 1."""
    ar = torch.arange(K, device=dev)
    return torch.where(ar == 0, 0, NEG_ID), torch.where(ar == 0, 1.0, 0.0)


def keeptrack_step_from_patch(rt: KeepTrackRuntime, model: DiMPNet,
                              matcher: Optional[PeakMatchingNetwork], state: dict,
                              patch: torch.Tensor, tl, crop_side, sample_pos, sample_scale,
                              im_hw, jitter_u: Optional[torch.Tensor]):
    """A tracked frame from its normalised sample patch (S, S, C) and
    geometry (keeptrack_tracker.py:337-571). Returns (state, box (4,)
    xywh, presence score, aux {'flag', 'branch', 'selected_id',
    'num_iter'}), all tensors."""
    H, W = im_hw
    dev = patch.device
    state = {**state, "frame_num": state["frame_num"] + 1}
    pre_scale = state["target_scale"]
    bfeat = model.extract_backbone(patch[None])
    clf_feat = model.extract_classification_feat(bfeat)
    scores = model.classify(state["filter"], clf_feat)[0]
    max_score_raw = scores.max()

    low = max_score_raw < rt.peaks.peak_threshold
    use_match = ~low & state["mem_ok"]
    p_scores, p_coords, p_valid = extract_peaks(scores, rt.peaks)
    desc = _peak_descriptors(matcher, bfeat["layer3"][0], p_coords)
    S = rt.score_sz
    kpts = peak_keypoints(p_coords, S, tl, crop_side)
    adv_trans, adv_flag, _ = _localize_advanced(rt, scores, state, sample_pos, sample_scale)

    prev = state["peaks"]
    K = rt.peaks.num_peaks
    speedup = ((prev["peak_valid"].sum() == 1) & (p_valid.sum() == 1)
               & (prev["peak_scores"].max() > rt.single_peak_score)
               & (p_scores.max() > rt.single_peak_score))
    if not rt.skip_matching_single_peak:
        speedup = torch.zeros_like(speedup)
    run_matcher = use_match & ~speedup
    if matcher is None:
        m_idx, m_prob = match_peaks(prev["peak_desc"], prev["peak_coords"], prev["peak_valid"],
                                    desc, p_coords, p_valid, rt.peaks)
    else:
        # set 0 the previous frame, set 1 the current one, matches1 taken.
        # The keypoints are (y, x) image coordinates and the image size is
        # given as (W, H): the reference pairs y with w, and so does JAX
        out = matcher.matcher(prev["peak_desc"][None], prev["peak_kpts"][None],
                              prev["peak_scores"][None], prev["peak_valid"][None], desc[None],
                              kpts[None], p_scores[None], p_valid[None], image_size_wh=(W, H))
        m_idx, m_prob = out["matches1"][0], out["match_scores1"][0]
    t_idx, t_prob = _trivial_match(K, dev)
    match_idx = torch.where(run_matcher, m_idx, t_idx)
    match_prob = torch.where(run_matcher, m_prob, t_prob)

    matched, sel_peak, lost_m = update_peak_state(
        prev, rt.peaks, p_scores, p_coords, kpts, p_valid, desc,
        match_fn=lambda *_: (match_idx, match_prob))
    fresh = init_peak_state(rt.peaks, p_scores, p_coords, kpts, p_valid, desc,
                            certain=state["frame_num"] < 10)
    peaks = {k: torch.where(use_match, matched[k], torch.where(low, prev[k], fresh[k]))
             for k in prev}
    state = {**state, "peaks": peaks, "mem_ok": ~low}

    output_sz = float(S - (rt.kernel_size + 1) % 2)
    score_center = (S - 1) / 2.0
    sel_cell = _at(p_coords, torch.clamp(sel_peak, min=0))
    peak_trans = (sel_cell - score_center) * (rt.image_sample_size / output_sz) * sample_scale
    coll_flag = torch.where(lost_m, FLAG_NOT_FOUND, FLAG_NORMAL).to(torch.int32)
    flag = torch.where(use_match, coll_flag, adv_flag)
    translation = torch.where(use_match, peak_trans, adv_trans)
    found = flag != FLAG_NOT_FOUND
    state = {**state, "last_flag": flag, "last_use_match": use_match}

    # the presence score with the id0 square-root boost, on the updated
    # collection (the empty init collection carries id 0)
    id0 = peaks["selected_object_id"] == 0
    presence = max_score_raw
    if rt.id0_weight_increase:
        presence = torch.where(id0, torch.maximum(presence, torch.sqrt(torch.clamp(presence,
                                                                                  min=0.0))),
                               presence)
    state = _place_target(rt, model, bfeat, state, translation, found, sample_pos, sample_scale,
                          im_hw, jitter_u)

    # the scale history: the pre-refinement scale appended on found
    # frames; while lost the windowed mean overwrites target_scale
    count = state["ring_count"]
    ring_app = state["scale_ring"].index_put(((count % rt.scale_memory).long().reshape(1),),
                                             pre_scale.reshape(1))
    nf_counter = torch.where(found, 0, torch.where(count > 0, state["nf_counter"] + 1,
                                                   state["nf_counter"])).to(torch.int32)
    rescale_on = ~found & (count > 0) & rt.enable_search_area_rescaling_at_occlusion
    mean_scale = _occlusion_rescale(rt, state["scale_ring"], count, nf_counter)
    state = {**state, "scale_ring": torch.where(found, ring_app, state["scale_ring"]),
             "ring_count": torch.where(found, count + 1, count).to(torch.int32),
             "nf_counter": nf_counter,
             "target_scale": torch.where(rescale_on, mean_scale, state["target_scale"])}

    # the memory: the flag alone gates the update
    update_ok = (flag == FLAG_NORMAL) | (flag == FLAG_HARD_NEG)
    hard_neg = flag == FLAG_HARD_NEG
    lr = torch.where(hard_neg, rt.hard_negative_learning_rate, rt.learning_rate).float()
    box_crop = _get_iounet_box(rt, state["pos"], state["target_sz"], sample_pos, sample_scale)
    # the id0 boost applies to the stored certainty; the hard-negative
    # gate compares the unboosted one
    cert_raw = max_score_raw
    cert_store = cert_raw
    if rt.id0_weight_increase:
        cert_store = torch.where(id0, torch.maximum(cert_raw, torch.sqrt(torch.clamp(
            cert_raw, min=0.0))), cert_raw)
    train_y = _frame_label(rt, state["sigma"], state["pos"], sample_pos, sample_scale)
    state = _update_memory_keeptrack(rt, state, clf_feat[0], box_crop, train_y, lr, cert_store,
                                     update_ok)

    # the certainty-zeroing quirk: sub-threshold certainties are zeroed for
    # good on every update frame, the one stored now included
    if rt.use_certainty_for_weight_computation:
        certs = torch.where(update_ok & (state["certainties"] < rt.certainty_ths), 0.0,
                            state["certainties"])
        state = {**state, "certainties": certs}
        w_opt = state["sample_weights"] * certs
        hn_iter = torch.where(cert_raw < rt.certainty_ths, 0, rt.net_opt_hn_iter)
    else:
        w_opt = state["sample_weights"]
        hn_iter = rt.net_opt_hn_iter
    scheduled = rt.net_opt_update_iter if (state["frame_num"] - 1) % rt.train_skipping == 0 \
        else 0
    num_iter = torch.where(~update_ok, 0, torch.where(hard_neg, hn_iter, scheduled))
    new_filter = model.optimize_filter(state["filter"], state["memory_feat"],
                                       state["memory_labels"], w_opt, num_iter,
                                       rt.max_update_iter)
    state = {**state, "filter": new_filter}
    branch = torch.where(low, 0, torch.where(~use_match, 1, torch.where(speedup, 3, 2)))
    box = torch.cat([(state["pos"] - (state["target_sz"] - 1) / 2).flip(0),
                     state["target_sz"].flip(0)])
    return state, box, presence, {"flag": flag, "branch": branch,
                                  "selected_id": peaks["selected_object_id"],
                                  "num_iter": num_iter}


class KeepTrackTracker:
    """Single-sequence facade (BaseTracker API). `model` is the
    super_dimp DiMPNet (the hinge optimiser) and `matcher` the
    PeakMatchingNetwork (seeded from `seed + 1` when None; unused without
    rt.use_learned_matcher); both hold their weights and are moved to
    `device`. `draws` is a factory of draw sources, called at every
    initialize. A frame reads the card once. `flags` counts the frames of
    each localisation flag, `branches` those of each branch of the state
    machine (low, fresh, match, speedup), `matcher_passes` the frames whose
    matches the matcher decided, and `optimizer_iters` the filter-update
    iterations that ran."""

    def __init__(self, model: DiMPNet, device, runtime: Optional[KeepTrackRuntime] = None,
                 seed: int = 0, draws: Optional[Callable[[], Callable]] = None,
                 matcher: Optional[PeakMatchingNetwork] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or KeepTrackRuntime()
        if self.rt.use_learned_matcher:
            if matcher is None:
                matcher = init_peak_matching_weights(
                    PeakMatchingNetwork(self.rt.descriptor_dim, self.rt.desc_feat_dim), seed + 1)
            matcher = matcher.to(self.device).eval().requires_grad_(False)
        else:
            matcher = None
        self.matcher = matcher
        self.draws = draws or (lambda: TorchDraws(seed))
        self.state = None
        self.flags = dict.fromkeys(FLAG_NAMES, 0)
        self.branches = dict.fromkeys(BRANCH_NAMES, 0)
        self.matcher_passes = 0
        self.optimizer_iters = 0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        self._draw = self.draws()
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self.state = keeptrack_init_state(self.rt, self.model, self.matcher,
                                          as_frames(image, self.device), box, self._draw)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        frame = as_frames(image, self.device)
        jitter = None
        if self.rt.num_init_random_boxes > 0:
            jitter = _to_device(self._draw("jitter", (self.rt.num_init_random_boxes, 4)),
                                self.device)
        self.state, box, score, aux = keeptrack_track_step(self.rt, self.model, self.matcher,
                                                           self.state, frame, jitter)
        out = torch.cat([box, score.reshape(1)] + [aux[k].reshape(1).float() for k in
                                                   ("flag", "branch", "selected_id",
                                                    "num_iter")]).cpu().numpy()
        flag, branch = FLAG_NAMES[int(out[5])], BRANCH_NAMES[int(out[6])]
        self.flags[flag] += 1
        self.branches[branch] += 1
        self.matcher_passes += branch == "match"
        self.optimizer_iters += int(out[8])
        return {"target_bbox": out[:4].tolist(), "best_score": float(out[4]), "flag": flag,
                "branch": branch, "selected_id": int(out[7]), "optimizer_iters": int(out[8])}
