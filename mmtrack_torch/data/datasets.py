"""Training video datasets, port of the dataset protocol and the in-memory
synthetic dataset of mmtrack_tpu/data/datasets.py (:20-48, :165-199). The
on-disk corpora (DepthTrack, LasHeR, VisEvent) are not ported yet."""

from __future__ import annotations

import numpy as np

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


def visibility_from_boxes(bbox: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(valid, visible): finite boxes of positive size."""
    valid = np.isfinite(bbox).all(axis=1) & (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
    return valid, valid.copy()


class SyntheticVideoDataset(VideoDataset):
    """In-memory moving-target sequences (data/synthetic.py)."""

    name = "Synthetic"

    def __init__(self, n_sequences: int = 4, n_frames: int = 30, height: int = 120,
                 width: int = 160, modality: str = "both"):
        # "both": the target is drawn in both triplets; "rgb_only": only in
        # RGB; "aux_only": only in the auxiliary modality
        kw = {"both": {}, "rgb_only": {"target_aux": None},
              "aux_only": {"target_rgb": None}}[modality]
        self._seqs = [make_synthetic_sequence(
            n_frames=n_frames, height=height, width=width,
            box0=(20.0 + 10 * i, 15.0 + 5 * i, 30.0, 24.0), velocity=(2.0 + i, 1.5),
            seed=i, **kw) for i in range(n_sequences)]

    def num_sequences(self) -> int:
        return len(self._seqs)

    def seq_info(self, seq_id: int) -> dict:
        gt = self._seqs[seq_id][1]
        valid, visible = visibility_from_boxes(gt)
        return {"bbox": gt, "valid": valid, "visible": visible}

    def get_frames(self, seq_id: int, frame_ids: list[int]):
        frames, gt = self._seqs[seq_id]
        return [frames[i] for i in frame_ids], gt[frame_ids].astype(np.float32)
