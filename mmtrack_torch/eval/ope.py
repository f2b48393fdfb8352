"""OPE (one-pass evaluation) driver: run a tracker over sequences, write
reference-format results, report FPS.

A copy of mmtrack_tpu/eval/ope.py over the port's data/composition.py and
eval/datasets.py; tests/test_torch_eval.py holds its result files
byte-identical to the JAX module's. It rebuilds the RGBT/RGBE OPE drivers
(ViPT/RGBT_workspace/test_rgbt_mgpus.py:66-117, RGBE variant) and
pytracking's run_dataset semantics: row 0 of the result is the GT init
box, skip-if-exists resume, per-sequence FPS. This is the sequential
driver; eval/batched_ope.py advances B sequences in lockstep on one card.
"""

from __future__ import annotations

import os
import time

import numpy as np

from mmtrack_torch.data.composition import get_x_frame
from mmtrack_torch.eval.datasets import EvalSequence


def run_sequence(tracker, seq: EvalSequence, frame_loader=None,
                 dashboard=None) -> dict:
    """Track one sequence. Returns dict with boxes (N,4), confidences (N-1,),
    fps, elapsed.

    frame_loader(i) -> (H, W, 6) overrides disk loading (tests/synthetic).
    dashboard: any object with register(data, kind, level, title) and
    wait_if_paused() (the JAX package's DebugDashboard has both) — per
    frame the tracking overlay, score map / segmentation (when the
    tracker reports them) and a status dict are registered and the loop
    honors pause/step (basetracker.py:59-83 debug-loop equivalent).
    """
    n = len(seq)

    def load(i):
        if frame_loader is not None:
            return frame_loader(i)
        return get_x_frame(seq.rgb_frames[i], seq.x_frames[i], seq.dtype,
                           depth_clip=seq.depth_clip)

    boxes = np.zeros((n, 4), np.float64)
    boxes[0] = seq.gt[0]
    confidences = np.zeros(n - 1, np.float64)

    t0 = time.perf_counter()
    tracker.initialize(load(0), {"init_bbox": list(map(float, seq.gt[0]))})
    for i in range(1, n):
        frame = load(i)
        out = tracker.track(frame)
        boxes[i] = out["target_bbox"]
        confidences[i - 1] = out.get("best_score", 1.0)
        if dashboard is not None:
            dashboard.register((frame, out["target_bbox"],
                                out.get("segmentation")), "tracking", 1,
                               "Tracking")
            if out.get("score_map") is not None:
                dashboard.register(out["score_map"], "heatmap", 1,
                                   "Score Map")
            dashboard.register({"frame": i, "sequence": seq.name,
                                "best_score": round(float(
                                    confidences[i - 1]), 4)},
                               "info_dict", 1, "Status")
            dashboard.wait_if_paused()
    elapsed = time.perf_counter() - t0
    return {
        "name": seq.name,
        "boxes": boxes,
        "confidences": confidences,
        "elapsed": elapsed,
        "fps": (n - 1) / max(elapsed, 1e-9),
    }


def result_path(results_root: str, dataset: str, config_name: str, seq_name: str) -> str:
    return os.path.join(results_root, dataset, config_name, f"{seq_name}.txt")


def save_result(path: str, result: dict, fmt: str = "%.14f", delimiter: str = ",",
                time_style: str = "value") -> None:
    """Write the reference result layout: one xywh row per frame, row 0 = GT
    init box, plus companion *_time.value and *_confidence.value files
    (pytracking running.py:77-113).

    time_style="txt" switches the timing companion to the pytracking
    save_time format — <seq>_time.txt, '%f' (OSTrack
    lib/test/evaluation/running.py:30-32) — which the GOT-10k/TrackingNet
    submission packagers (eval/submission.py) consume. Int box formats
    ("%d") truncate like the reference's astype(int) in save_bb
    (running.py:26-28).
    """
    os.makedirs(os.path.dirname(path), exist_ok=True)
    boxes = result["boxes"]
    if fmt == "%d":
        boxes = np.asarray(boxes).astype(int)
    np.savetxt(path, boxes, fmt=fmt, delimiter=delimiter)
    base = path[:-4]
    # reference format: ONE execution time PER FRAME (pytracking
    # running.py save_time writes the full exec_times vector); per-frame
    # times are reconstructed as the mean when only the total was timed
    n = max(len(result["boxes"]), 1)
    times = result.get("times", np.full(n, result["elapsed"] / n))
    if time_style == "txt":
        np.savetxt(base + "_time.txt", np.asarray(times, float),
                   delimiter="\t", fmt="%f")
    else:
        np.savetxt(base + "_time.value", times, fmt="%.8f")
    np.savetxt(base + "_confidence.value",
               np.concatenate(([1.0], result["confidences"])), fmt="%.8f")


def run_dataset(tracker_factory, sequences: list[EvalSequence], results_root: str,
                dataset: str, config_name: str, verbose: bool = True) -> list[dict]:
    """Evaluate all sequences with skip-if-exists resume
    (test_rgbt_mgpus.py:77-79)."""
    outputs = []
    for seq in sequences:
        path = result_path(results_root, dataset, config_name, seq.name)
        if os.path.exists(path):
            if verbose:
                print(f"-1 {seq.name}")
            continue
        tracker = tracker_factory()
        res = run_sequence(tracker, seq)
        save_result(path, res, fmt=seq.save_fmt, delimiter=seq.save_delimiter,
                    time_style=seq.time_style)
        if verbose:
            print(f"{seq.name} , fps:{res['fps']:.2f}")
        outputs.append(res)
    return outputs
