"""One sequence tracked in real time, closed loop: each frame's planes are
handed to the program when the previous box is back on the host.

A frame is the streamed RGB-D wire: an RGB plane (H, W, 3) and a JET
index plane (H, W) from a pool in pinned host memory, which the program
uploads, composes on the device and tracks through its one-frame graph
(`BatchedViPTTracker.track_split`). A frame's latency runs from the call
to its box on the host. The reference composes the frame itself, from the
same planes and its own colormap table.

The pool holds `sequences` clips of 1 + `sequence_frames` frames; each
sequence is initialised on its first frame (composed by the benchmark)
and tracked for `sequence_frames` frames, then the next starts (a random
tracker's box reaches the image's border and collapses within some fifty
frames; see modes/track.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks import compare, system, traffic, weights
from benchmarks.reference import vipt as ref
from benchmarks.seeds import rng


def jet_table(device) -> torch.Tensor:
    """cv2's JET colormap, (256, 3) uint8 in cv2's channel order: what the
    RGB-D frames of ViPT's reference append to the RGB (get_x_frame)."""
    import cv2

    idx = np.arange(256, dtype=np.uint8).reshape(256, 1)
    return torch.from_numpy(cv2.applyColorMap(idx, cv2.COLORMAP_JET).reshape(256, 3).copy()
                            ).to(device)


class Cell:
    unit = "frames"

    def __init__(self, cfg, traffic_p, seed, device):
        self.cfg, self.p, self.seed, self.device = cfg, traffic_p, seed, device

    def setup(self) -> None:
        from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker

        cfg, p, dev = self.cfg, self.p, self.device
        if dev.type == "cuda":
            system.load_kernels()
        self.params = weights.make(cfg, self.seed, dev)
        model = system.model(cfg, dev)
        system.load(model, self.params)
        frames, boxes = traffic.render(p, 4, self.seed, dev)           # RGB + depth index
        n = p["sequence_frames"] + 1
        self.rgb, self.idx = frames[:, 0, ..., :3].contiguous(), frames[:, 0, ..., 3].contiguous()
        self.init_boxes = boxes[::n, 0].cpu().numpy()                    # (sequences, 4)
        del frames
        self.lut = jet_table(dev)
        self.tracker = BatchedViPTTracker(model, dev, runtime=system.runtime(cfg))
        total, H, W = self.rgb.shape[:3]
        self.host_rgb = self.tracker.host_buffer((total, H, W, 3))
        self.host_idx = self.tracker.host_buffer((total, H, W))
        self.host_rgb[:] = self.rgb.cpu().numpy()
        self.host_idx[:] = self.idx.cpu().numpy()
        self.first = [self.compose(self.rgb[q * n:q * n + 1], self.idx[q * n:q * n + 1]).cpu().numpy()
                      for q in range(p["sequences"])]
        self.k = 0
        self.records = []
        for _ in range(p["warm_frames"]):
            self._frame(record=False)

    def compose(self, rgb, idx):
        return torch.cat([rgb, self.lut[idx.long()]], -1)

    def _frame(self, record: bool = True) -> float:
        L = self.p["sequence_frames"]
        seq, j = divmod(self.k, L)
        seq %= self.p["sequences"]
        if j == 0:                                   # the next sequence
            with torch.profiler.record_function("bench.init"):
                self.tracker.initialize(self.first[seq], self.init_boxes[seq][None])
            self.last_box = self.init_boxes[seq]
        i = seq * (L + 1) + 1 + j
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.track_split"):
            box, score = self.tracker.track_split(self.host_rgb[i][None], self.host_idx[i][None])
        dt = time.perf_counter() - t0
        if record:
            self.records.append((i, seq, self.last_box, box[0], float(score[0])))
        self.last_box = box[0]
        self.k += 1
        return dt

    def window(self, seconds: float) -> dict:
        self.records = []
        lat = []
        t0 = time.perf_counter()
        while True:
            lat.append(self._frame())
            if time.perf_counter() - t0 >= seconds:
                break
        return {"attempted": len(lat),
                "metrics": {"frame_ms_p95": float(np.percentile(np.array(lat) * 1e3, 95))}}

    def traced_work(self, share: float = 1.0) -> dict:
        n = max(1, round(self.p["trace"]["frames"] * share))
        for _ in range(n):
            self._frame()
        return {"attempted": n, "steps": n, "batch": 1, "frames": n}

    def release(self) -> None:
        del self.tracker
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        dev, n = self.device, self.p["sequence_frames"] + 1
        k = min(self.p["check"]["samples"], len(self.records))
        pick = sorted(rng(self.seed, "check").choice(len(self.records), k, replace=False))
        rows = [self.records[i] for i in pick]

        def blocks():
            z_all = torch.cat([ref.template(self.cfg, self.compose(self.rgb[q * n:q * n + 1],
                                                                   self.idx[q * n:q * n + 1]),
                                            torch.tensor(self.init_boxes[q:q + 1], device=dev))
                               for q in range(self.p["sequences"])])
            blk = self.p["check"]["block"]
            for j in range(0, len(rows), blk):
                part = rows[j:j + blk]
                ids = torch.tensor([r[0] for r in part], device=dev)
                yield (z_all[torch.tensor([r[1] for r in part], device=dev)],
                       self.compose(self.rgb[ids], self.idx[ids]),
                       torch.tensor(np.stack([r[2] for r in part]), device=dev),
                       torch.tensor(np.stack([r[3] for r in part]), device=dev),
                       torch.tensor([r[4] for r in part], device=dev))

        return dict(compare.judge_frames(self.params, self.cfg, blocks(), [0] * len(rows),
                                         control), compared=len(rows))
