"""Evaluation metrics: OPE success/precision curves and DepthTrack Pr/Re/F.

A copy of mmtrack_tpu/eval/metrics.py (numpy only); tests/test_torch_eval.py
holds it equal to the JAX module. The reference metric surface:
  - success / precision / normalized-precision curves as used by
    OSTrack tracking/analysis_results.py and the RGBT/RGBE OPE protocol,
  - the DepthTrack long-term F-score suite
    (RGBD/models/DeT/metric/PrRe.py:57-87,242-254 and
    overall_evaluation.py:12-43): confidence-thresholded Pr/Re over 100
    thresholds, Pr = mean IoU of reported frames, Re = sum IoU / n_visible,
    F-score = max_theta 2*Pr*Re/(Pr+Re).

Metric evaluation is host-side bookkeeping.
"""

from __future__ import annotations

import numpy as np


def iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of xywh boxes, elementwise over leading dims; NaN-safe (-> 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    x1 = np.maximum(a[..., 0], b[..., 0])
    y1 = np.maximum(a[..., 1], b[..., 1])
    x2 = np.minimum(a[..., 0] + a[..., 2], b[..., 0] + b[..., 2])
    y2 = np.minimum(a[..., 1] + a[..., 3], b[..., 1] + b[..., 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = inter / union
    return np.nan_to_num(iou, nan=0.0)


def center_error(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    pc = pred[..., :2] + pred[..., 2:] / 2
    gc = gt[..., :2] + gt[..., 2:] / 2
    return np.sqrt(((pc - gc) ** 2).sum(-1))


def norm_center_error(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Center error normalized by GT box size (TrackingNet protocol)."""
    pc = pred[..., :2] + pred[..., 2:] / 2
    gc = gt[..., :2] + gt[..., 2:] / 2
    with np.errstate(invalid="ignore", divide="ignore"):
        d = (pc - gc) / np.maximum(gt[..., 2:], 1e-9)
    return np.sqrt((d ** 2).sum(-1))


def success_curve(ious: np.ndarray, n_bins: int = 21) -> np.ndarray:
    """Fraction of frames with IoU > t for t in linspace(0, 1, n_bins)."""
    thresholds = np.linspace(0, 1, n_bins)
    return (ious[None, :] > thresholds[:, None]).mean(axis=1)


def success_auc(ious: np.ndarray, n_bins: int = 21) -> float:
    """Success-plot AUC == mean of the success curve (the 'SR' headline)."""
    return float(success_curve(ious, n_bins).mean())


def precision_curve(errors: np.ndarray, max_threshold: float = 50.0,
                    n_bins: int = 51) -> np.ndarray:
    thresholds = np.linspace(0, max_threshold, n_bins)
    return (errors[None, :] <= thresholds[:, None]).mean(axis=1)


def precision_at(errors: np.ndarray, threshold: float = 20.0) -> float:
    """Precision at the OTB-standard 20px threshold (the 'PR' headline)."""
    return float((errors <= threshold).mean())


def norm_precision_curve(errors: np.ndarray, max_threshold: float = 0.5,
                         n_bins: int = 51) -> np.ndarray:
    thresholds = np.linspace(0, max_threshold, n_bins)
    return (errors[None, :] <= thresholds[:, None]).mean(axis=1)


def evaluate_ope(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
                 valid: np.ndarray | None = None) -> dict:
    """One-pass-evaluation summary for one or more concatenated sequences.

    Returns success AUC (SR), precision@20px (PR) and normalized precision
    at threshold 0.20 (NPR — the OSTrack/pytracking analysis stack reports
    norm_prec_curve[20] on linspace(0, 0.5, 51), NOT the curve mean) over
    frames where `valid` (gt present) holds.
    """
    pred = np.asarray(pred_boxes, np.float64)
    gt = np.asarray(gt_boxes, np.float64)
    if valid is None:
        valid = ~np.isnan(gt).any(-1) & (gt[..., 2] > 0) & (gt[..., 3] > 0)
    pred, gt = pred[valid], gt[valid]
    ious = iou_xywh(pred, gt)
    errs = center_error(pred, gt)
    nerrs = norm_center_error(pred, gt)
    return {
        "success_auc": success_auc(ious),
        "precision_20px": precision_at(errs),
        "norm_precision_auc": float(norm_precision_curve(nerrs)[20]),
        "success_curve": success_curve(ious),
        "precision_curve": precision_curve(errs),
        "n_frames": int(valid.sum()),
    }


class PrReFScore:
    """DepthTrack / VOT-LT confidence-thresholded Pr/Re/F accumulator.

    Protocol per compute_tpr_curves (overall_evaluation.py:12-43): for each
    sequence, frame 0 contributes overlap=1 and confidence=1 (the init
    frame), subsequent frames IoU(pred[t], gt[t]); NaN IoU -> 0; a frame is
    'visible' unless fully occluded.
    """

    def __init__(self, n_thresholds: int = 100):
        self.thresholds = np.linspace(1, 0, n_thresholds)
        self.overlaps: list[np.ndarray] = []
        self.confidences: list[np.ndarray] = []
        self.visible: list[np.ndarray] = []

    def add_sequence(self, pred_boxes: np.ndarray, confidences: np.ndarray,
                     gt_boxes: np.ndarray, visible: np.ndarray) -> None:
        """pred_boxes: (N-1, 4) predictions for frames 1..N-1;
        gt_boxes: (N, 4) ground truth incl. frame 0; visible: (N,) bool."""
        ious = iou_xywh(np.asarray(pred_boxes), np.asarray(gt_boxes)[1:])
        self.overlaps.append(np.concatenate(([1.0], ious)))
        self.confidences.append(np.concatenate(([1.0], np.asarray(confidences, np.float64))))
        self.visible.append(np.asarray(visible, bool))

    def value(self) -> tuple[np.ndarray, np.ndarray]:
        """(precision[100], recall[100]) over the confidence thresholds."""
        ov = np.concatenate(self.overlaps)
        conf = np.concatenate(self.confidences)
        vis = np.concatenate(self.visible)
        n_visible = int(vis.sum())
        pr = np.ones_like(self.thresholds)
        re = np.zeros_like(self.thresholds)
        for i, th in enumerate(self.thresholds):
            subset = conf >= th
            if subset.sum() > 0:
                pr[i] = ov[subset].mean()
                re[i] = ov[subset].sum() / max(n_visible, 1)
        return pr, re

    def fscore(self) -> tuple[float, float, float]:
        """(pr_score, re_score, fscore) like PrRe.fscore (PrRe.py:242-254)."""
        pr, re = self.value()
        f = 2 * pr * re / np.maximum(pr + re, 1e-12)
        return float(pr.mean()), float(re.max()), float(f.max())
