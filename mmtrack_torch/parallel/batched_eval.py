"""Batched multi-sequence inference on one device, port of
mmtrack_tpu/parallel/batched_eval.py:27-80.

B same-resolution sequences advance one frame per call through the
natively batched `vipt_track_step`. Sharding over several cards and the
streamed wire formats (`track_split`, `track_yuv`) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from mmtrack_torch.trackers.vipt_tracker import (
    ViPTRuntime,
    as_frames,
    vipt_init_state,
    vipt_track_step,
)


class BatchedViPTTracker:
    """Track B same-resolution sequences in lockstep on `device`.

    `model` must already hold its weights; it is moved to `device`. Frames
    may be numpy arrays or tensors (a tensor already on `device` is used
    in place)."""

    def __init__(self, model, device, runtime: ViPTRuntime | None = None):
        self.device = torch.device(device)
        self.rt = runtime or ViPTRuntime()
        self.model = model.to(self.device).eval()
        self.state = None

    @torch.inference_mode()
    def initialize(self, frames, boxes) -> None:
        boxes = torch.as_tensor(np.asarray(boxes, np.float32))
        self.state = vipt_init_state(self.rt, as_frames(frames, self.device), boxes)

    @torch.inference_mode()
    def track(self, frames) -> tuple[np.ndarray, np.ndarray]:
        self.state, boxes, scores = vipt_track_step(self.rt, self.model, self.state,
                                                    as_frames(frames, self.device))
        return boxes.cpu().numpy(), scores.cpu().numpy()
