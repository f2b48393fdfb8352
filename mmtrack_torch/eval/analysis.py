"""Result analysis suites: aggregate saved trajectories into metrics.

A copy of mmtrack_tpu/eval/analysis.py (numpy only) over the port's
eval/{datasets,metrics}.py; tests/test_torch_eval.py holds it equal to
the JAX module. It rebuilds the reference's two analysis stacks:
  - OSTrack-style OPE reporting (tracking/analysis_results.py): success /
    precision / normalized precision over a results directory,
  - the DepthTrack metric suite (RGBD/models/DeT/metric/{overall,attribute,
    depthQ,longterm,sequence,speed}_evaluation.py): confidence-thresholded
    Pr/Re/F overall, per-attribute, by depth-quality bin, long-term
    (pre/post first occlusion), per-sequence, and FPS summaries.
"""

from __future__ import annotations

import os

import numpy as np

from mmtrack_torch.eval.datasets import EvalSequence
from mmtrack_torch.eval.metrics import PrReFScore, evaluate_ope, iou_xywh


def load_result(results_root: str, dataset: str, config_name: str,
                seq_name: str) -> dict:
    base = os.path.join(results_root, dataset, config_name, seq_name)
    # result files are CSV for RGBD/RGBE and whitespace-separated for the
    # RGBT format (EvalSequence.save_delimiter) — sniff the delimiter
    with open(base + ".txt") as f:
        first = f.readline()
    delim = "," if "," in first else None
    # atleast_2d: np.loadtxt returns a 1-D (4,) array for a single-row
    # file, which would break row indexing (pred[0, :]) downstream
    out = {"boxes": np.atleast_2d(np.loadtxt(base + ".txt", delimiter=delim))}
    if os.path.exists(base + "_confidence.value"):
        out["confidences"] = np.loadtxt(base + "_confidence.value")
    if os.path.exists(base + "_time.value"):
        out["time_per_frame"] = float(np.mean(np.loadtxt(base + "_time.value")))
    return out


def analyze_ope(sequences: list[EvalSequence], results_root: str, dataset: str,
                config_name: str) -> dict:
    """Overall OPE report (print_results analog): SR / PR / NPR."""
    all_pred, all_gt = [], []
    per_seq = {}
    for seq in sequences:
        res = load_result(results_root, dataset, config_name, seq.name)
        # calc_seq_err_robust: frame 0's prediction is replaced by the GT
        # init box and INCLUDED (one guaranteed success per sequence)
        pred, gt = np.array(res["boxes"], np.float64), seq.gt
        n = min(len(pred), len(gt))
        pred[0, :] = gt[0]
        all_pred.append(pred[:n])
        all_gt.append(gt[:n])
        per_seq[seq.name] = evaluate_ope(pred[:n], gt[:n])
    overall = evaluate_ope(np.concatenate(all_pred), np.concatenate(all_gt))
    return {"overall": overall, "per_sequence": per_seq}


def analyze_fscore(sequences: list[EvalSequence], results_root: str,
                   dataset: str, config_name: str) -> dict:
    """DepthTrack long-term Pr/Re/F (overall_evaluation.py:12-43)."""
    m = PrReFScore()
    for seq in sequences:
        res = load_result(results_root, dataset, config_name, seq.name)
        conf = res.get("confidences")
        n = len(seq.gt)
        pred = res["boxes"][1:n]
        conf = (conf[1:n] if conf is not None else np.ones(len(pred)))
        visible = seq.visible if seq.visible is not None else np.ones(n, bool)
        m.add_sequence(pred, conf[:len(pred)], seq.gt[:len(pred) + 1],
                       visible[:len(pred) + 1])
    pr, re, f = m.fscore()
    return {"precision": pr, "recall": re, "fscore": f}


def analyze_attributes(sequences: list[EvalSequence], results_root: str,
                       dataset: str, config_name: str,
                       attributes: dict[str, dict[str, np.ndarray]]) -> dict:
    """Per-attribute F-scores (attribute_evaluation.py).

    attributes: {seq_name: {attr_name: (N,) 0/1 per-frame tags}}."""
    names = sorted({a for tags in attributes.values() for a in tags})
    out = {}
    for attr in names:
        m = PrReFScore()
        for seq in sequences:
            if seq.name not in attributes or attr not in attributes[seq.name]:
                continue
            res = load_result(results_root, dataset, config_name, seq.name)
            tags = np.asarray(attributes[seq.name][attr], bool)
            n = min(len(res["boxes"]), len(seq.gt), len(tags))
            sel = tags[1:n]
            if not sel.any():
                continue
            pred = res["boxes"][1:n][sel]
            gt = seq.gt[1:n][sel]
            conf = res.get("confidences", np.ones(n))[1:n][sel]
            vis = (seq.visible[1:n][sel] if seq.visible is not None
                   else np.ones(sel.sum(), bool))
            ious = iou_xywh(pred, gt)
            m.overlaps.append(ious)
            m.confidences.append(conf)
            m.visible.append(vis)
        if m.overlaps:
            pr, re, f = m.fscore()
            out[attr] = {"precision": pr, "recall": re, "fscore": f}
    return out


def analyze_depth_quality(sequences, results_root, dataset, config_name,
                          quality: dict[str, np.ndarray]) -> dict:
    """F-score by depth-quality bin (depthQ_evaluation.py: high < 0.4,
    medium 0.4-0.8, low > 0.8)."""
    bins = {"high": lambda q: q < 0.4,
            "medium": lambda q: (q >= 0.4) & (q <= 0.8),
            "low": lambda q: q > 0.8}
    out = {}
    for bname, sel_fn in bins.items():
        m = PrReFScore()
        found = False
        for seq in sequences:
            if seq.name not in quality:
                continue
            res = load_result(results_root, dataset, config_name, seq.name)
            q = np.asarray(quality[seq.name])
            n = min(len(res["boxes"]), len(seq.gt), len(q))
            sel = sel_fn(q[1:n])
            if not sel.any():
                continue
            found = True
            ious = iou_xywh(res["boxes"][1:n][sel], seq.gt[1:n][sel])
            m.overlaps.append(ious)
            m.confidences.append(res.get("confidences", np.ones(n))[1:n][sel])
            vis = (seq.visible[1:n][sel] if seq.visible is not None
                   else np.ones(int(sel.sum()), bool))
            m.visible.append(vis)
        if found:
            pr, re, f = m.fscore()
            out[bname] = {"precision": pr, "recall": re, "fscore": f}
    return out


def analyze_longterm(sequences, results_root, dataset, config_name) -> dict:
    """Pre/post first-occlusion F-scores (longterm_evaluation.py +
    PrRe.value_LT). Reference quirks preserved exactly:
    - never-occluded sequences are SKIPPED entirely
      (value_LT: `if invisible == 0: continue`) — they contribute to
      neither bucket;
    - the pre window is [0, first): frame 0 counts with overlap 1 and
      confidence 1 (the init-frame convention, compute_LT_curves:18-20);
    - the post window is [first, n-1): add_LT records
      end_frame = start + length - 1, so the final frame is excluded."""
    out = {}
    for phase in ("pre_occlusion", "post_occlusion"):
        m = PrReFScore()
        for seq in sequences:
            if seq.visible is None or seq.visible.all():
                continue  # never occluded -> skipped by the reference
            first = int(np.argmin(seq.visible))
            res = load_result(results_root, dataset, config_name, seq.name)
            n = min(len(res["boxes"]), len(seq.gt))
            # saved *_confidence.value files already carry the init frame's
            # 1.0 at index 0 (ope.py::save_result)
            conf = np.asarray(res.get("confidences", np.ones(n)),
                              np.float64)[:n]
            if phase == "pre_occlusion":
                sl = slice(1, min(first, n))
                if first <= 0:
                    continue
                ious = np.concatenate(
                    ([1.0], iou_xywh(res["boxes"][sl], seq.gt[sl])))
                cf = conf[0:sl.stop]
                vis = np.concatenate(([True], seq.visible[sl]))
            else:
                sl = slice(max(first, 1), n - 1)
                if sl.start >= sl.stop:
                    continue
                ious = iou_xywh(res["boxes"][sl], seq.gt[sl])
                cf = conf[sl]
                vis = seq.visible[sl]
            m.overlaps.append(ious)
            m.confidences.append(cf)
            m.visible.append(vis)
        if m.overlaps:
            pr, re, f = m.fscore()
            out[phase] = {"precision": pr, "recall": re, "fscore": f}
    return out


def analyze_speed(sequences, results_root, dataset, config_name) -> dict:
    """FPS summary from *_time.value files (speed_evaluation.py)."""
    fps = []
    for seq in sequences:
        res = load_result(results_root, dataset, config_name, seq.name)
        if "time_per_frame" in res and res["time_per_frame"] > 0:
            fps.append(1.0 / res["time_per_frame"])
    return {"mean_fps": float(np.mean(fps)) if fps else 0.0,
            "per_sequence_fps": fps}


def print_results(report: dict, config_name: str) -> str:
    """Human-readable summary (analysis_results.py print style)."""
    o = report["overall"]
    lines = [
        f"{config_name}: SR {o['success_auc'] * 100:.2f} | "
        f"PR {o['precision_20px'] * 100:.2f} | "
        f"NPR {o['norm_precision_auc'] * 100:.2f} | "
        f"frames {o['n_frames']}"]
    return "\n".join(lines)
