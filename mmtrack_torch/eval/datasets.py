"""Evaluation dataset adapters: sequence discovery, frame lists and ground
truth. A copy of mmtrack_tpu/eval/datasets.py (numpy only), kept here
because the port imports nothing of the JAX package;
tests/test_torch_eval.py holds it equal to the JAX module on every layout.

Rebuilds the genConfig per-dataset layout logic of
ViPT/RGBT_workspace/test_rgbt_mgpus.py:20-63 and
ViPT/RGBE_workspace/test_rgbe_mgpus.py:19-27, plus the DepthTrack/CDTB
color+depth layout used by the RGB-D OPE path
(ViPT/lib/test/evaluation/tracker.py `_read_rgbd_image`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class EvalSequence:
    name: str
    rgb_frames: list
    x_frames: list
    gt: np.ndarray                  # (N, 4) xywh
    dtype: str = "rgbrgb"           # composition mode for get_x_frame
    depth_clip: bool = False
    visible: np.ndarray | None = None  # (N,) bool; None = all visible
    # per-dataset result formats: the RGBT workspace driver writes
    # np.savetxt defaults (space-separated %.18e, test_rgbt_mgpus.py:116),
    # the RGBE/RGBD drivers write '%.14f' CSV (test_rgbe_mgpus.py:83),
    # and pytracking's running.py writes int boxes tab-delimited
    # (OSTrack lib/test/evaluation/running.py:26-32)
    save_fmt: str = "%.14f"
    save_delimiter: str = ","
    # "value" -> <seq>_time.value %.8f (this repo's RGBD/RGBT/RGBE drivers);
    # "txt" -> <seq>_time.txt %f (pytracking running.py:30-32 save_time,
    # the format the GOT-10k/TrackingNet submission packagers consume)
    time_style: str = "value"

    def __len__(self):
        return len(self.rgb_frames)


def _listdir_ext(d: str, ext: str) -> list[str]:
    return sorted(os.path.join(d, p) for p in os.listdir(d) if p.endswith(ext))


def _corners_to_xywh(gt: np.ndarray) -> np.ndarray:
    """GTOT ships 2-corner annotations; convert to xywh (test_rgbt_mgpus.py:37-48)."""
    x_min = gt[:, [0, 2]].min(axis=1)
    y_min = gt[:, [1, 3]].min(axis=1)
    x_max = gt[:, [0, 2]].max(axis=1)
    y_max = gt[:, [1, 3]].max(axis=1)
    return np.stack([x_min, y_min, x_max - x_min, y_max - y_min], axis=1)


def _load_text_tolerant(path: str) -> np.ndarray:
    """Annotation loader tolerant of mixed delimiters: try comma first, then
    any-whitespace — the (',', None) fallback chain of the reference's
    load_text (OSTrack lib/test/utils/load_text.py, used with
    delimiter=(',', None) for OTB's 'weird annos')."""
    for delim in (",", None):
        try:
            gt = np.loadtxt(path, delimiter=delim, dtype=np.float64)
            if gt.size:
                return gt
        except ValueError:
            continue
    raise ValueError(f"could not parse annotation file {path}")


def load_sequence(seq_path: str, dataset: str) -> EvalSequence:
    """Build an EvalSequence from one sequence directory of a known dataset."""
    name = os.path.basename(seq_path.rstrip("/"))
    d = dataset.lower()

    if d == "rgbt234":
        rgb = _listdir_ext(os.path.join(seq_path, "visible"), ".jpg")
        x = _listdir_ext(os.path.join(seq_path, "infrared"), ".jpg")
        gt = np.loadtxt(os.path.join(seq_path, "visible.txt"), delimiter=",")
        return EvalSequence(name, rgb, x, gt, dtype="rgbrgb",
                            save_fmt="%.18e", save_delimiter=" ")

    if d == "gtot":
        rgb = _listdir_ext(os.path.join(seq_path, "v"), ".png")
        x = _listdir_ext(os.path.join(seq_path, "i"), ".png")
        gt = _corners_to_xywh(np.loadtxt(os.path.join(seq_path, "groundTruth_v.txt"), delimiter=" "))
        return EvalSequence(name, rgb, x, gt, dtype="rgbrgb",
                            save_fmt="%.18e", save_delimiter=" ")

    if d == "lasher":
        rgb = _listdir_ext(os.path.join(seq_path, "visible"), ".jpg")
        x = _listdir_ext(os.path.join(seq_path, "infrared"), ".jpg")
        gt = np.loadtxt(os.path.join(seq_path, "visible.txt"), delimiter=",")
        return EvalSequence(name, rgb, x, gt, dtype="rgbrgb",
                            save_fmt="%.18e", save_delimiter=" ")

    if "vtuav" in d:
        rgb = _listdir_ext(os.path.join(seq_path, "rgb"), ".jpg")
        x = _listdir_ext(os.path.join(seq_path, "ir"), ".jpg")
        gt = np.loadtxt(os.path.join(seq_path, "rgb.txt"), delimiter=" ")
        return EvalSequence(name, rgb, x, gt, dtype="rgbrgb",
                            save_fmt="%.18e", save_delimiter=" ")

    if d == "visevent":
        rgb = _listdir_ext(os.path.join(seq_path, "vis_imgs"), ".bmp")
        x = _listdir_ext(os.path.join(seq_path, "event_imgs"), ".bmp")
        gt = np.loadtxt(os.path.join(seq_path, "groundtruth.txt"), delimiter=",")
        absent = np.loadtxt(os.path.join(seq_path, "absent_label.txt"))
        # trim leading absent frames (test_rgbe_mgpus.py:58-63)
        if absent.size and absent[0] == 0:
            first = int(absent.argmax())
            rgb, x, gt, absent = rgb[first:], x[first:], gt[first:], absent[first:]
        return EvalSequence(name, rgb, x, gt, dtype="rgbrgb",
                            visible=absent.astype(bool))

    if d in ("depthtrack", "cdtb"):
        rgb = _listdir_ext(os.path.join(seq_path, "color"), ".jpg")
        x = _listdir_ext(os.path.join(seq_path, "depth"), ".png")
        gt = np.loadtxt(os.path.join(seq_path, "groundtruth.txt"), delimiter=",")
        vis = ~np.isnan(gt).any(axis=1)
        return EvalSequence(name, rgb, x, gt, dtype="rgbcolormap",
                            depth_clip=True, visible=vis)

    # --- RGB eval layouts (the reference's lib/test/evaluation registry,
    # ViPT/lib/test/evaluation/datasets.py:9-31; pure-RGB trackers consume
    # these with dtype="color" -> 3-channel frames, no X plane) ---

    if d == "lasot":
        # <root>/<class>/<class-N>/{img/%08d.jpg, groundtruth.txt,
        # full_occlusion.txt, out_of_view.txt}
        # (OSTrack lib/test/evaluation/lasotdataset.py:44-68)
        gt = np.loadtxt(os.path.join(seq_path, "groundtruth.txt"),
                        delimiter=",").reshape(-1, 4)
        rgb = [os.path.join(seq_path, "img", f"{i:08d}.jpg")
               for i in range(1, gt.shape[0] + 1)]
        occ = np.loadtxt(os.path.join(seq_path, "full_occlusion.txt"),
                         delimiter=",")
        oov = np.loadtxt(os.path.join(seq_path, "out_of_view.txt"),
                         delimiter=",")
        vis = np.logical_and(occ == 0, oov == 0)
        return EvalSequence(name, rgb, [None] * len(rgb), gt, dtype="color",
                            visible=vis, save_fmt="%d", save_delimiter="\t",
                            time_style="txt")

    if d.startswith("got10k"):
        # <split>/<seq>/{NNNNNNNN.jpg..., groundtruth.txt}; frames sorted by
        # integer stem (got10kdataset.py:33-44); the test split's GT has a
        # single init row, so frame count may exceed GT rows
        gt = np.loadtxt(os.path.join(seq_path, "groundtruth.txt"),
                        delimiter=",").reshape(-1, 4)
        frames = [f for f in os.listdir(seq_path) if f.endswith(".jpg")]
        frames.sort(key=lambda f: int(f[:-4]))
        rgb = [os.path.join(seq_path, f) for f in frames]
        return EvalSequence(name, rgb, [None] * len(rgb), gt, dtype="color",
                            save_fmt="%d", save_delimiter="\t",
                            time_style="txt")

    if d == "trackingnet":
        # <root>/<SET>/frames/<seq>/N.jpg + <root>/<SET>/anno/<seq>.txt
        # (trackingnetdataset.py:33-44); seq_path points at the frames dir
        set_dir = os.path.dirname(os.path.dirname(seq_path.rstrip("/")))
        gt = np.loadtxt(os.path.join(set_dir, "anno", f"{name}.txt"),
                        delimiter=",").reshape(-1, 4)
        frames = [f for f in os.listdir(seq_path) if f.endswith(".jpg")]
        frames.sort(key=lambda f: int(f[:-4]))
        rgb = [os.path.join(seq_path, f) for f in frames]
        return EvalSequence(name, rgb, [None] * len(rgb), gt, dtype="color",
                            save_fmt="%d", save_delimiter="\t",
                            time_style="txt")

    if d == "otb":
        # <seq>/{img/%04d.jpg, groundtruth_rect.txt}; the reference pins
        # per-sequence start/end frames and zero-padding in a hardcoded
        # info list (otbdataset.py:254+) — here the img dir is globbed,
        # which matches for every sequence whose frames are all on disk
        gt = _load_text_tolerant(
            os.path.join(seq_path, "groundtruth_rect.txt")).reshape(-1, 4)
        rgb = _listdir_ext(os.path.join(seq_path, "img"), ".jpg")
        rgb = rgb[:gt.shape[0]]
        return EvalSequence(name, rgb, [None] * len(rgb), gt, dtype="color",
                            save_fmt="%d", save_delimiter="\t",
                            time_style="txt")

    raise ValueError(f"unknown eval dataset '{dataset}'")


def list_sequences(dataset_root: str, dataset: str) -> list[str]:
    """Sequence directories under a dataset root (the reference lists the
    testing-set dir, test_rgbt_mgpus.py:164-167)."""
    return sorted(
        os.path.join(dataset_root, s) for s in os.listdir(dataset_root)
        if os.path.isdir(os.path.join(dataset_root, s)))
