"""KeepTrack's peak identities, port of mmtrack_tpu/trackers/keep_track.py.

Per frame the top-K local maxima of the classifier's score map become
candidate peaks, with descriptors and keypoints in image coordinates. They
are matched to the previous frame's peaks (the learned matcher of
models/peak_matching.py, or the mutual-nearest cosine stand-in here), and
a fixed-size collection keeps their identities by the reference's rules:
the selected identity is kept while matched, low-probability matches of it
are dropped, a vanished target raises not_found, a strong new peak is
redetected, and the selection jumps to a stronger track whose identity
postdates the last occlusion. The release configuration pins the
occlusion markers to 0 (`disable_chrono`).

Plain functions on tensors of any device; every decision is a tensor
select, so nothing here reads the device. Ties go to the lower index as
in JAX: the top K by a stable descending sort (`lax.top_k`'s order, which
torch.topk does not promise on CUDA) and the first True of a mask by
`argmax` of its int32 cast.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mmtrack_torch.models.dimp import div_const

NEG_ID = -1


@dataclass(frozen=True)
class PeakMatchConfig:
    num_peaks: int = 8
    nms_radius: int = 2                   # local_max_ks=5 -> radius 2
    peak_threshold: float = 0.05
    match_sim_threshold: float = 0.5
    match_dist_threshold: float = 6.0     # score-map cells
    drop_prob_threshold: float = 0.6
    drop_prob_low_score: float = 0.85
    low_peak_score: float = 0.2
    certain_score: float = 0.75
    redetect_score: float = 0.25
    # disable_chronological_occlusion_redetection_logic: the occlusion
    # markers stay 0, so any identity qualifies for a jump or redetection
    disable_chrono: bool = True


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D mask (0 when there is none)."""
    return torch.argmax(mask.to(torch.int32))


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without a host read."""
    return x.index_select(0, i.reshape(1).long())[0]


def extract_peaks(score_map: torch.Tensor, cfg: PeakMatchConfig):
    """Top-K local maxima of a (H, W) score map after the (2r + 1)^2
    max-pool NMS, with score > peak_threshold, sorted descending. Returns
    (scores (K,), coords (K, 2) f32 (y, x), valid (K,)); invalid slots
    score 0 and keep the coordinates of their -inf cells."""
    H, W = score_map.shape
    r = cfg.nms_radius
    pooled = F.max_pool2d(score_map[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    cand = torch.where((score_map >= pooled) & (score_map > cfg.peak_threshold), score_map,
                       -math.inf)
    scores, idx = torch.sort(cand.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:cfg.num_peaks], idx[:cfg.num_peaks]
    coords = torch.stack([idx // W, idx % W], dim=1).float()
    valid = torch.isfinite(scores)
    return torch.where(valid, scores, 0.0), coords, valid


def gather_descriptors(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """L2-normalised feature vectors at peak cells: feat (H, W, C) on the
    score grid, coords (K, 2)."""
    H, W = feat.shape[0], feat.shape[1]
    ys = torch.clamp(coords[:, 0].long(), 0, H - 1)
    xs = torch.clamp(coords[:, 1].long(), 0, W - 1)
    d = feat[ys, xs]
    return d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-6)


def peak_keypoints(coords: torch.Tensor, score_sz: int, tl_yx: torch.Tensor,
                   crop_side: torch.Tensor) -> torch.Tensor:
    """Score-map cells -> image-coordinate keypoints (y, x): cell / (S - 1)
    of the search-area extent crop_side - 1, from its top-left."""
    scale = div_const(crop_side - 1.0, score_sz - 1.0)
    return coords * scale + tl_yx[None, :]


def match_peaks(desc_prev, coords_prev, valid_prev, desc_cur, coords_cur, valid_cur,
                cfg: PeakMatchConfig):
    """Mutual-nearest-neighbour matching with a positional gate, the
    stand-in for the learned matcher. Returns (match_idx (K,) int64, an
    index into the previous peaks or -1, match_prob (K,))."""
    sim = desc_cur @ desc_prev.T
    dist = torch.linalg.norm(coords_cur[:, None] - coords_prev[None], dim=-1)
    gate = (dist < cfg.match_dist_threshold) & valid_prev[None] & valid_cur[:, None]
    sim = torch.where(gate, sim, -math.inf)
    best_prev = torch.argmax(sim, dim=1)
    best_cur = torch.argmax(sim, dim=0)
    k = torch.arange(cfg.num_peaks, device=sim.device)
    best_sim = sim[k, best_prev]
    ok = (best_cur[best_prev] == k) & (best_sim > cfg.match_sim_threshold)
    prob = torch.sigmoid(4.0 * (best_sim - cfg.match_sim_threshold))
    return torch.where(ok, best_prev, NEG_ID), torch.where(ok, prob, 0.0)


def init_peak_state(cfg: PeakMatchConfig, scores, coords, kpts, valid, descriptors,
                    certain=True) -> dict:
    """A fresh collection. `certain` (a bool or a bool tensor) is
    frame_num < 10: when uncertain the id counter, the selected id and
    both occlusion markers start at 1; the highest peak carries the
    selected id either way."""
    dev = scores.device
    if not torch.is_tensor(certain):     # a fill, not a copy from the host
        certain = torch.full((), bool(certain), dtype=torch.bool, device=dev)
    base = torch.where(certain, 0, 1).to(torch.int32)
    ar = torch.arange(cfg.num_peaks, dtype=torch.int32, device=dev)
    return {
        "peak_scores": scores, "peak_coords": coords, "peak_kpts": kpts, "peak_valid": valid,
        "peak_desc": descriptors,
        "object_ids": torch.where(valid, base + ar, NEG_ID).to(torch.int32),
        "best_obj_score": torch.where(valid, scores, 0.0),
        "selected_object_id": base,
        "object_id_cntr": base + valid.sum(dtype=torch.int32),
        "occlusion_id_state": base,
        "occl_certain_state": base,
        "selection_certain": certain,
        "flag_not_found": torch.zeros((), dtype=torch.bool, device=dev),
    }


def update_peak_state(state: dict, cfg: PeakMatchConfig, scores, coords, kpts, valid,
                      descriptors, match_fn=None):
    """One frame of identity bookkeeping. Returns (new state, selected peak
    index (-1 if lost), flag_not_found). match_fn(prev state, scores,
    coords, kpts, valid, descriptors) -> (match_idx, match_prob) replaces
    the mutual-NN matcher."""
    if match_fn is not None:
        match_idx, match_prob = match_fn(state, scores, coords, kpts, valid, descriptors)
    else:
        match_idx, match_prob = match_peaks(state["peak_desc"], state["peak_coords"],
                                            state["peak_valid"], descriptors, coords, valid, cfg)
    matched = match_idx >= 0
    src = torch.clamp(match_idx, min=0).long()
    prev_obj = torch.where(matched, state["object_ids"][src], NEG_ID)
    prev_best = torch.where(matched, state["best_obj_score"][src], 0.0)

    # the selected object's low-probability matches are dropped
    is_selected = prev_obj == state["selected_object_id"]
    prob_too_low = (match_prob < cfg.drop_prob_threshold) | (
        (match_prob < cfg.drop_prob_low_score) & (scores < cfg.low_peak_score))
    keep_match = matched & ~(is_selected & prob_too_low)

    # fresh ids for the unmatched valid peaks, in peak order
    fresh = ~keep_match & valid
    fresh_ids = state["object_id_cntr"] + torch.cumsum(fresh.to(torch.int32), 0,
                                                       dtype=torch.int32) - 1
    object_ids = torch.where(keep_match, prev_obj, torch.where(valid, fresh_ids, NEG_ID))
    best_obj_score = torch.where(keep_match, torch.maximum(prev_best, scores),
                                 torch.where(valid, scores, 0.0))
    new_cntr = state["object_id_cntr"] + fresh.sum(dtype=torch.int32)

    sel = state["selected_object_id"]
    sel_mask = (object_ids == sel) & valid
    detected = sel_mask.any()
    sel_peak = _first(sel_mask)
    # certainty from the selected track's history, before any jump
    certain = state["selection_certain"] | (detected & (_at(best_obj_score, sel_peak)
                                                        > cfg.certain_score))
    # jump to the top peak's track if it is stronger and postdates the
    # last occlusion
    top_is_other = (detected & (sel_peak != 0) & valid[0]
                    & (best_obj_score[0] > _at(best_obj_score, sel_peak))
                    & (object_ids[0] >= state["occlusion_id_state"]))
    sel = torch.where(top_is_other, object_ids[0], sel)
    sel_peak = torch.where(top_is_other, 0, sel_peak)

    # lost: the occlusion markers advance (to the pre-frame counter) before
    # the redetection scan; disable_chrono pins them to 0
    lost_now = ~detected
    newly_lost = lost_now & ~state["flag_not_found"]
    occl_state = torch.where(
        newly_lost, torch.where(certain, state["object_id_cntr"], state["occl_certain_state"]),
        state["occlusion_id_state"])
    occl_certain = torch.where(newly_lost & certain, state["object_id_cntr"],
                               state["occl_certain_state"])
    if cfg.disable_chrono:
        occl_state = torch.where(newly_lost, 0, occl_state)
        occl_certain = torch.where(newly_lost, 0, occl_certain)
    redet_mask = valid & (scores > cfg.redetect_score) & (object_ids >= occl_state)
    can_redetect = lost_now & redet_mask.any()
    redet_peak = _first(redet_mask)
    sel = torch.where(can_redetect, _at(object_ids, redet_peak), sel)
    sel_peak_out = torch.where(detected, sel_peak, torch.where(can_redetect, redet_peak, NEG_ID))
    certain = torch.where(newly_lost, False, certain)

    lost = sel_peak_out < 0
    new_state = {
        "peak_scores": scores, "peak_coords": coords, "peak_kpts": kpts, "peak_valid": valid,
        "peak_desc": descriptors, "object_ids": object_ids.to(torch.int32),
        "best_obj_score": best_obj_score,
        "selected_object_id": sel.to(torch.int32),
        "object_id_cntr": new_cntr.to(torch.int32),
        "occlusion_id_state": occl_state.to(torch.int32),
        "occl_certain_state": occl_certain.to(torch.int32),
        "selection_certain": certain,
        "flag_not_found": lost,
    }
    return new_state, sel_peak_out, lost
