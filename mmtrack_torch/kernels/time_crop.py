"""Time the crop kernel at the tracking paths' shapes on one card.

    PYTHONPATH=. python3 mmtrack_torch/kernels/time_crop.py
    PYTHONPATH=/path/to/other/checkout python3 mmtrack_torch/kernels/time_crop.py

It times `crop_resize_normalized` of the `mmtrack_torch` package that
comes first on the path, so two checkouts (a commit and its parent, say)
compare on one card when run in turns on it: A, B, B, A. The
inputs are the same in every run (seeded): B=16 sequences with boxes
inside the frame, across its edges and tiny. Prints one JSON line per
shape with the kernel's mean device time over 50 calls from
torch.profiler (`device_ms`, what the kernels take on the card) and from
CUDA events over back-to-back calls (`events_ms`, which the host's launch
rate bounds below ~0.05 ms), and the card from nvidia-smi.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mmtrack_torch.ops.crop import crop_resize_normalized
from mmtrack_torch.utils import optouts

B, ITERS = 16, 50
MEAN = np.array([0.485, 0.456, 0.406] * 2, np.float32)
STD = np.array([0.229, 0.224, 0.225] * 2, np.float32)
# (H, W, C, S, factor): ViPT's search and template crops, Alpha-Refine's search crop
SHAPES = ((240, 320, 6, 256, 4.0), (240, 320, 6, 128, 2.0), (480, 640, 6, 256, 4.0),
          (480, 640, 3, 256, 2.0))


def boxes_for(H: int, W: int, rng: np.random.RandomState) -> np.ndarray:
    u = rng.uniform(size=(B, 4))
    boxes = np.stack([u[:, 0] * (W - 60) + 10, u[:, 1] * (H - 60) + 10,
                      u[:, 2] * 40 + 8, u[:, 3] * 40 + 8], 1)
    boxes[0] = (-12.3, -7.6, 40.0, 30.0)                   # top-left edge
    boxes[1] = (W - 20.5, H - 15.2, 42.0, 33.0)            # bottom-right edge
    boxes[2] = (W * 0.5, H * 0.5, 0.6, 0.4)                # tiny
    return boxes.astype(np.float32)


def main() -> None:
    optouts.refuse("mmtrack_torch.kernels.time_crop")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    rng = np.random.RandomState(0)
    for H, W, C, S, factor in SHAPES:
        frames = torch.from_numpy(rng.randint(0, 256, (B, H, W, C)).astype(np.uint8)).to(dev)
        boxes = torch.from_numpy(boxes_for(H, W, rng)).to(dev)
        mean, std = torch.from_numpy(MEAN[:C]).to(dev), torch.from_numpy(STD[:C]).to(dev)

        def call():
            return crop_resize_normalized(frames, boxes, factor, S, mean, std)

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        for _ in range(3):     # a window now and then loses some of its device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    call()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            if sum(e.count for e in rows) == ITERS:
                break
        else:
            raise RuntimeError(f"torch.profiler did not record the {ITERS} launches")
        kernels = {e.key: e.self_device_time_total / ITERS / 1e3 for e in rows}
        print(json.dumps({"source": crop_resize_normalized.__code__.co_filename, "B": B,
                          "H": H, "W": W, "C": C, "S": S, "device_ms": sum(kernels.values()),
                          "kernels": kernels, "events_ms": start.elapsed_time(end) / ITERS,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
