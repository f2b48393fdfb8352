"""Training video datasets, port of mmtrack_tpu/data/datasets.py: the
dataset protocol, the three ViPT training corpora on disk (DepthTrack,
LasHeR, VisEvent; ViPT lib/train/dataset/{depthtrack,lasher,visevent}.py),
the in-memory synthetic dataset and the name registry `names2datasets`,
which also reaches the RGB corpora of data/rgb_datasets.py. Frames are
composed H x W x 6 on the host by data/composition.py.
tests/test_torch_train_data.py holds every reader against the JAX one.
"""

from __future__ import annotations

import os

import numpy as np

from mmtrack_torch.data.composition import get_x_frame
from mmtrack_torch.data.synthetic import make_synthetic_sequence


class VideoDataset:
    """Protocol: a named, indexable dataset of multi-modal sequences."""

    name: str = "base"
    is_video: bool = True

    def num_sequences(self) -> int:
        raise NotImplementedError

    def seq_info(self, seq_id: int) -> dict:
        """-> {'bbox': (N,4) xywh, 'visible': (N,) bool, 'valid': (N,) bool}"""
        raise NotImplementedError

    def get_frames(self, seq_id: int, frame_ids: list[int]):
        """-> (list of (H,W,6) uint8 frames, (n,4) float32 boxes)"""
        raise NotImplementedError

    def __len__(self) -> int:
        return self.num_sequences()


def visibility_from_boxes(bbox: np.ndarray, min_px: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """(valid, visible): finite boxes wider and taller than `min_px`. The
    reference applies its size threshold to `valid` itself
    (depthtrack.py:102 w > 10 and h > 10, visevent.py:90 w > 5)."""
    valid = (np.isfinite(bbox).all(axis=1) & (bbox[:, 2] > min_px)
             & (bbox[:, 3] > min_px))
    return valid, valid.copy()


class _DirListDataset(VideoDataset):
    """root/<seq>/{rgb_dir, x_dir} frame directories and a ground-truth
    file per sequence."""

    rgb_dir: str
    x_dir: str
    rgb_ext: str
    x_ext: str
    gt_file: str
    gt_delim: str
    dtype: str
    depth_clip: bool = False
    min_visible_px: float = 0.0

    def __init__(self, root: str, sequences: list[str] | None = None):
        self.root = root
        if sequences is None:
            sequences = sorted(s for s in os.listdir(root)
                               if os.path.isdir(os.path.join(root, s)))
        self.sequences = sequences
        self._info_cache: dict[int, dict] = {}

    def num_sequences(self) -> int:
        return len(self.sequences)

    def _seq_path(self, seq_id: int) -> str:
        return os.path.join(self.root, self.sequences[seq_id])

    def seq_info(self, seq_id: int) -> dict:
        if seq_id not in self._info_cache:
            gt = np.atleast_2d(np.loadtxt(os.path.join(self._seq_path(seq_id), self.gt_file),
                                          delimiter=self.gt_delim))
            valid, visible = visibility_from_boxes(gt, self.min_visible_px)
            self._info_cache[seq_id] = {"bbox": gt, "valid": valid, "visible": visible}
        return self._info_cache[seq_id]

    def _list(self, seq_id: int, sub: str, ext: str) -> list[str]:
        d = os.path.join(self._seq_path(seq_id), sub)
        return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(ext))

    def _frame_paths(self, seq_id: int):
        return (self._list(seq_id, self.rgb_dir, self.rgb_ext),
                self._list(seq_id, self.x_dir, self.x_ext))

    def get_frames(self, seq_id: int, frame_ids: list[int]):
        rgb, x = self._frame_paths(seq_id)
        frames = [get_x_frame(rgb[i], x[i], self.dtype, depth_clip=self.depth_clip)
                  for i in frame_ids]
        return frames, self.seq_info(seq_id)["bbox"][frame_ids].astype(np.float32)


class DepthTrackTrain(_DirListDataset):
    """DepthTrack train split: color/*.jpg + 16-bit depth/*.png,
    rgbcolormap with the depth clip (depthtrack.py:13-158); targets of 10
    px or less are not valid."""
    name = "DepthTrack_train"
    rgb_dir, x_dir = "color", "depth"
    rgb_ext, x_ext = ".jpg", ".png"
    gt_file, gt_delim = "groundtruth.txt", ","
    dtype = "rgbcolormap"
    depth_clip = True
    min_visible_px = 10.0


class LasHeRTrain(_DirListDataset):
    """LasHeR: visible/*.jpg + infrared/*.jpg, rgbrgb (lasher.py:25-95)."""
    name = "LasHeR_all"
    rgb_dir, x_dir = "visible", "infrared"
    rgb_ext, x_ext = ".jpg", ".jpg"
    gt_file, gt_delim = "visible.txt", ","
    dtype = "rgbrgb"


class VisEventTrain(_DirListDataset):
    """VisEvent: vis_imgs/*.bmp + event_imgs/*.bmp, rgbrgb
    (visevent.py:19-118). `visible` also honours absent_label.txt
    (visevent.py:68-92), and targets of 5 px or less are not valid. Event
    paths come from the vis file names (visevent.py:107), not from a second
    directory listing, which can misalign where frames start irregularly."""
    name = "VisEvent_train"
    rgb_dir, x_dir = "vis_imgs", "event_imgs"
    rgb_ext, x_ext = ".bmp", ".bmp"
    gt_file, gt_delim = "groundtruth.txt", ","
    dtype = "rgbrgb"
    min_visible_px = 5.0

    def seq_info(self, seq_id: int) -> dict:
        info = super().seq_info(seq_id)
        if "absent_applied" not in info:
            f = os.path.join(self._seq_path(seq_id), "absent_label.txt")
            if os.path.exists(f):
                present = np.atleast_1d(np.loadtxt(f, dtype=np.int64)).astype(bool)
                n = min(len(present), len(info["visible"]))
                info["visible"] = info["visible"].copy()
                info["visible"][:n] &= present[:n]
            info["absent_applied"] = True
        return info

    def _frame_paths(self, seq_id: int):
        rgb = self._list(seq_id, self.rgb_dir, self.rgb_ext)
        return rgb, [q.replace(self.rgb_dir, self.x_dir) for q in rgb]


class SyntheticVideoDataset(VideoDataset):
    """In-memory moving-target sequences (data/synthetic.py)."""

    name = "Synthetic"

    def __init__(self, n_sequences: int = 4, n_frames: int = 30, height: int = 120,
                 width: int = 160, modality: str = "both", distractor: bool = False):
        # "both": the target is drawn in both triplets; "rgb_only": only in
        # RGB; "aux_only": only in the auxiliary modality. distractor: a
        # second square of the target's look crosses it in every sequence
        # (the KYS / KeepTrack training setting)
        kw = {"both": {}, "rgb_only": {"target_aux": None},
              "aux_only": {"target_rgb": None}}[modality]
        self._seqs = [make_synthetic_sequence(
            n_frames=n_frames, height=height, width=width,
            box0=(20.0 + 10 * i, 15.0 + 5 * i, 30.0, 24.0), velocity=(2.0 + i, 1.5),
            seed=i, distractor=distractor, **kw) for i in range(n_sequences)]

    def num_sequences(self) -> int:
        return len(self._seqs)

    def seq_info(self, seq_id: int) -> dict:
        gt = self._seqs[seq_id][1]
        valid, visible = visibility_from_boxes(gt)
        return {"bbox": gt, "valid": valid, "visible": visible}

    def get_frames(self, seq_id: int, frame_ids: list[int]):
        frames, gt = self._seqs[seq_id]
        return [frames[i] for i in frame_ids], gt[frame_ids].astype(np.float32)


def _rgb_registry() -> dict:
    from mmtrack_torch.data.rgb_datasets import (
        COCOSeq,
        COCOSeqDepth,
        GOT10k,
        Got10kDepth,
        ImageNetVID,
        LaSOT,
        LaSOTDepth,
        TrackingNet,
    )
    return {"LASOT": LaSOT, "GOT10K_vottrain": GOT10k, "GOT10K_votval": GOT10k,
            "GOT10K_train_full": GOT10k, "TRACKINGNET": TrackingNet, "COCO17": COCOSeq,
            "IMAGENETVID": ImageNetVID,
            # the depth twins of the MixFormer_RGBD training mix
            "GOT10K_Depth": Got10kDepth, "LASOT_Depth": LaSOTDepth,
            "COCO17_Depth": COCOSeqDepth}


TRAIN_DATASET_REGISTRY = {
    "DepthTrack_train": DepthTrackTrain,
    "DepthTrack_val": DepthTrackTrain,
    "LasHeR_all": LasHeRTrain,
    "LasHeR_val": LasHeRTrain,
    "VisEvent_train": VisEventTrain,
    "VisEvent_val": VisEventTrain,
    "Synthetic": SyntheticVideoDataset,
}


def names2datasets(names: list[str], roots: dict[str, str]) -> list[VideoDataset]:
    """The datasets of `names` (ViPT base_functions.py:29-96), each over its
    root in `roots` (name -> directory); "Synthetic" needs no root."""
    registry = {**TRAIN_DATASET_REGISTRY, **_rgb_registry()}
    out = []
    for n in names:
        if n == "Synthetic":
            out.append(SyntheticVideoDataset())
            continue
        if n not in registry:
            raise KeyError(f"unknown training dataset '{n}'")
        out.append(registry[n](roots[n]))
    return out
