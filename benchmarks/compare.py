"""The numbers that decide `correct`, each against its limit.

Tracking (a frame's answer is a box and a score): the reference decodes
its own maps at every cell of the score grid; the candidate's answer is
matched to the cell c whose box and windowed score lie nearest to it
(box: the largest coordinate difference over the side of the frame's
search crop; score: the absolute difference; their sum), since boxes
clipped to the image can nearly coincide. Then per frame
  box_err   = that box difference,
  cell_gap  = the reference's best windowed score minus its score at c,
  score_err = |the candidate's score - the reference's windowed score at c|.
A bf16 rounding may move the argmax to a cell whose score ties the best
within rounding: its gap is that rounding, and its box is the reference's
own box at that cell. A wrong box or a wrong cell shows in one of them.
Each is compared at its 95th percentile over the sampled frames (the
sample takes as many frames of every lane): a rare frame whose candidate
elimination or argmax went the other way on a tie moves it little, a
wrong precision moves it far. A wrong lane is 1/B of the frames, under
the 5 % that a 95th percentile passes by at 32 lanes: box_err_lane, the
largest over lanes of a lane's median box_err, holds each lane.

Training (the first steps of prompt tuning), by leaf of the trainable
set: the first step's clipped gradient as AdamW got it, and the
parameters' change after the steps. Leaves whose reference gradient norm
is under 1e-3 of the median leaf's are left out (their updates are Adam's
response to rounding). The limits hold
  grad_dir_med = the median leaf's |g/|g| - r/|r||, the distance between
                 the directions of the program's and the reference's
                 gradient of that leaf, and
  delta_leaf   = the worst leaf's |norm of the program's change - norm of
                 the reference's| over the larger of the reference's norm
                 of that leaf and of the median leaf (a leaf left unmoved
                 or moved twice reads about 1).
The gradient is held against the nearest, by the median leaf, of the
reference's gradients for each choice of the box loss's cell in rows
whose best two score cells tie within rounding. Directions, not norms:
the global-norm clip scales every leaf by one factor, which the Fovea
gate's input weights (a softmax at temperature 10 that turns any rounding
into a tenth of their gradient) set; a norm gap of the median leaf reads
that factor. loss_rel, grad_leaf and grad_med are reported beside them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.reference import vipt as ref
from benchmarks.reference.quant import fp8

GRAD_FLOOR = 1e-3


def track_numbers(box, score, ref: dict, prev, factor: float) -> dict[str, np.ndarray]:
    """Per-frame box_err, cell_gap and score_err of candidate answers
    (N, 4) / (N,) against a reference's `track_step` output."""
    side = torch.clamp(torch.ceil(torch.sqrt(prev[:, 2] * prev[:, 3]) * factor), min=1.0)
    d = (ref["cell_boxes"] - box[:, None]).abs().amax(-1) / side[:, None]   # (N, cells)
    win = ref["windowed"]
    ds = (score[:, None] - win).abs()
    c = (d + ds).argmin(1)
    rows = torch.arange(box.shape[0], device=box.device)
    return {"box_err": d[rows, c].cpu().numpy(),
            "cell_gap": (win.amax(1) - win[rows, c]).cpu().numpy(),
            "score_err": ds[rows, c].cpu().numpy()}


QUANTILE = 0.95


def summary(per_frame: dict[str, list], lanes: np.ndarray) -> dict[str, float]:
    """Each per-frame number's 95th percentile over the compared frames,
    under the name `<number>_p95`, and box_err_lane: the largest over
    lanes of the median box_err of the lane's frames (`lanes`, one per
    frame)."""
    flat = {k: np.concatenate([np.atleast_1d(a) for a in v]) for k, v in per_frame.items()}
    out = {f"{k}_p95": float(np.quantile(a, QUANTILE)) for k, a in flat.items()}
    out["box_err_lane"] = max(float(np.median(flat["box_err"][lanes == lane]))
                              for lane in np.unique(lanes))
    return out


def judge_frames(params: dict, cfg: dict, blocks, lanes, control: bool = False) -> dict:
    """The track numbers of the program's answers, over `blocks` of
    (templates, frames, previous boxes, boxes, scores) tensors, against
    the reference; `lanes` gives each frame's lane, in the blocks' order.
    With `control` also the fp8 control's on the same frames. The blocks
    are made inside the reference's precision."""
    per = {"box_err": [], "cell_gap": [], "score_err": []}
    low = {k: [] for k in per}
    factor = cfg["search"]["factor"]
    with torch.no_grad(), ref.no_tf32():
        for z, frames, prev, box, score in blocks:
            out = ref.track_step(params, cfg, z, frames, prev)
            for k, v in track_numbers(box, score, out, prev, factor).items():
                per[k].append(v)
            if control:
                c = ref.track_step(params, cfg, z, frames, prev, q=fp8)
                for k, v in track_numbers(c["box"], c["score"], out, prev, factor).items():
                    low[k].append(v)
    lanes = np.asarray(lanes)
    result = {"numbers": summary(per, lanes),
              "per_frame": {k: np.concatenate(v) for k, v in per.items()}}
    if control:
        result["control"] = summary(low, lanes)
        result["control_per_frame"] = {k: np.concatenate(v) for k, v in low.items()}
    return result


def _norms(leaves: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _chords(prog: dict, ref: dict, keep: list[str]) -> dict[str, float]:
    """|a/|a| - b/|b|| by leaf: how far each leaf's direction lies from the
    reference's (2 where the candidate's leaf is zero)."""
    out = {}
    for k in keep:
        a, b = prog[k].double().flatten(), ref[k].double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        out[k] = 2.0 if na == 0 or nb == 0 else float((a / na - b / nb).norm())
    return out


def _leaf_gaps(prog: dict, ref: dict, keep: list[str]) -> dict[str, float]:
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    med = float(np.median([rn[k] for k in keep]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def train_numbers(prog: dict, ref: dict) -> tuple[dict[str, float], list[str], dict]:
    """Of a candidate's first steps (`losses`, `first_grad`, `delta` by
    leaf) against the reference's: grad_dir_med and delta_leaf, and beside
    them loss_rel (the worst step's loss, relative), grad_leaf and grad_med
    (the worst and the median leaf's gradient-norm gap). The gradient is
    held against the nearest, by the median leaf, of the reference's
    `first_grads`. Returns the numbers, the leaves left out, and the worst
    leaves of grad_leaf and delta_leaf."""
    rel = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
           for a, b in zip(prog["losses"], ref["losses"])]
    rg = _norms(ref["first_grad"])
    med = float(np.median(list(rg.values())))
    keep = [k for k in rg if rg[k] >= GRAD_FLOOR * med]
    med_of = lambda d: float(np.median(list(d.values())))  # noqa: E731
    chord = min((_chords(prog["first_grad"], g, keep) for g in ref["first_grads"]), key=med_of)
    grad = min((_leaf_gaps(prog["first_grad"], g, keep) for g in ref["first_grads"]),
               key=med_of)
    delta = _leaf_gaps(prog["delta"], ref["delta"], keep)
    out = {"grad_dir_med": med_of(chord), "delta_leaf": max(delta.values()),
           "loss_rel": max(rel), "grad_leaf": max(grad.values()), "grad_med": med_of(grad)}
    worst = {name: sorted(d, key=d.get, reverse=True)[:3] for name, d in
             (("grad_leaf", grad), ("delta_leaf", delta))}
    return out, sorted(set(rg) - set(keep)), worst


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(numbers[k] <= limits[k] for k in limits)


def lines(numbers: dict[str, float], limits: dict[str, float]) -> dict[str, dict]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
