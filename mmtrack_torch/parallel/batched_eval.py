"""Batched multi-sequence inference, port of
mmtrack_tpu/parallel/batched_eval.py.

B same-resolution sequences advance one frame per call through the
natively batched `vipt_track_step`. Three steps, as in the JAX package:
`track` takes composed (B, H, W, C) frames; `track_split` the streamed
rgb + JET-index planes (4 B/px) and `track_yuv` the raw 4:2:0 planes +
JET index (2.5 B/px), both uploaded and composed on the device
(ops/compose.py) and then tracked.

On the card every step replays through `make_track_scan` as a one-frame
chunk, one CUDA graph per frame shape: the counterpart of the JAX
package's jitted step with the state donated (:41-46). A scan may be
shared by several trackers of one model and runtime, so that a driver
that makes a tracker per batch (eval/batched_ope.py) captures each shape
once. On the CPU each step is the eager step loop
(`vipt_track_scan_batched` of one frame).

Data parallelism (the JAX package's `mesh` argument, :27, :54): with a
`shard` of a process group (parallel/mesh.py), each rank tracks its lanes
of the B sequences (B must divide over the ranks) and every step gathers
the (B, 4) boxes and (B,) scores to every rank, as the sharded JAX step
returns global arrays. Each rank's scan (and its CUDA graphs) is its own.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from mmtrack_torch.ops.compose import (
    compose_rgb_index_device,
    compose_yuv_index_device,
    jet_lut,
)
from mmtrack_torch.parallel.mesh import SINGLE, Shard
from mmtrack_torch.trackers.vipt_tracker import (
    ViPTRuntime,
    as_frames,
    make_track_scan,
    vipt_init_state,
    vipt_track_scan_batched,
)
from mmtrack_torch.utils import profiling


class BatchedViPTTracker:
    """Track B same-resolution sequences in lockstep on `device`.

    `model` must already hold its weights; it is moved to `device`. Frames
    and planes may be numpy arrays or tensors (a tensor already on
    `device` is used in place). `scan`: a `make_track_scan(runtime, model,
    device)` to share, or any function with its arguments and results
    (`partial(vipt_track_scan_batched, runtime, model)` runs the eager
    step loop on the card). When none is given: a new `make_track_scan` on
    a CUDA device, the eager step loop on the CPU. `shard`: this rank's
    share of a data-parallel group; every call takes the global batch of
    B sequences and returns the global boxes and scores."""

    def __init__(self, model, device, runtime: ViPTRuntime | None = None,
                 scan: Optional[Callable] = None, shard: Shard = SINGLE):
        self.device = torch.device(device)
        self.shard = shard
        self.rt = runtime or ViPTRuntime()
        self.model = model.to(self.device).eval()
        if scan is None:
            scan = (make_track_scan(self.rt, self.model, self.device)
                    if self.device.type == "cuda"
                    else partial(vipt_track_scan_batched, self.rt, self.model))
        self.scan = scan
        self.state = None
        self._lut = None

    def host_buffer(self, shape: tuple) -> np.ndarray:
        """A uint8 staging array for the planes of `track_split` /
        `track_yuv`: pinned host memory when the tracker runs on the card,
        so that the upload runs without a staging copy."""
        if self.device.type == "cuda":
            return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
        return np.zeros(shape, np.uint8)

    @torch.inference_mode()
    def initialize(self, frames, boxes) -> None:
        boxes = torch.as_tensor(self.shard.local(np.asarray(boxes, np.float32)))
        self.state = vipt_init_state(self.rt, as_frames(self.shard.local(frames), self.device),
                                     boxes)

    def _step(self, frames: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        with profiling.chunk():
            final, boxes, scores = self.scan(self.state, frames[None])
            # a graph's results live in its buffers, which the next replay of
            # this shape (by any tracker sharing the scan) overwrites
            self.state = {"box": final["box"].clone(), "template": self.state["template"]}
            with profiling.span("ope.read"):
                return (self.shard.gather(boxes[0]).cpu().numpy(),
                        self.shard.gather(scores[0]).cpu().numpy())

    def _upload(self, *planes) -> list[torch.Tensor]:
        with profiling.span("ope.upload", self.device):
            if self._lut is None:
                self._lut = torch.from_numpy(jet_lut()).to(self.device)
            return [torch.as_tensor(self.shard.local(p)).to(self.device, non_blocking=True)
                    for p in planes]

    def _composed_step(self, compose, *planes) -> tuple[np.ndarray, np.ndarray]:
        with profiling.chunk():
            planes = self._upload(*planes)
            with profiling.span("ope.compose", self.device):
                frames = compose(*planes, self._lut)
            return self._step(frames)

    @torch.inference_mode()
    def track(self, frames) -> tuple[np.ndarray, np.ndarray]:
        return self._step(as_frames(self.shard.local(frames), self.device))

    @torch.inference_mode()
    def track_yuv(self, y, cb, cr, idx) -> tuple[np.ndarray, np.ndarray]:
        """Minimum-byte streaming step (2.5 B/px wire): raw 4:2:0 planes
        (B, H, W) / (B, H/2, W/2) + JET index (B, H, W); chroma upsample +
        BT.601 + colormap run on the device. Decode-grade (≤1 LSB of cv2's
        decode), NOT bit-exact — opt-in via MMTRACK_STREAM=yuv420
        (eval/batched_ope.py)."""
        return self._composed_step(compose_yuv_index_device, y, cb, cr, idx)

    @torch.inference_mode()
    def track_split(self, rgb, idx) -> tuple[np.ndarray, np.ndarray]:
        """Streaming 'rgbcolormap' step at 4 B/px: the host ships RGB
        (B, H, W, 3) plus the 1-byte JET index plane (B, H, W)
        (data/composition.py::depth_index_u8) and the colormap gather +
        concat runs on the device — bit-identical to
        track(get_x_frame(...)) for 2/3 of the transfer bytes."""
        return self._composed_step(compose_rgb_index_device, rgb, idx)
