"""The hand kernels against their plain versions, end to end on the card:
port of tools/ab_kernels.py.

    python -m mmtrack_torch.kernels.ab_kernels fwd fused|xla [B] [T]
    python -m mmtrack_torch.kernels.ab_kernels loop fused|xla
    python -m mmtrack_torch.kernels.ab_kernels crop gather|pallas

`fused` runs the kernels; `xla` builds the model as MMTRACK_ATTN=xla and
MMTRACK_MLP=xla would in the JAX package (utils/optouts.py: the plain
attention and JAX's unfused layers), as the JAX tool's `_setup` does. The
mode wins over those two variables in the environment; MMTRACK_CROP there
chooses the crop of `loop`, as in the JAX tool. This is the one entry
point of the port that reads the opt-outs.

  fwd   the deep_rgbt ViPT forward at bf16 (B=16, T=32 by default) on zero
        crops, chained T times with the `sum(pred_boxes) * 1e-6` feedback
        into the template and captured as one CUDA graph (the counterpart
        of the JAX tool's `lax.scan`); 8 replays, each ending in a host
        read; prints the median of the last 7 over T and forwards/s.
  loop  the device-resident tracking step of deep_rgbd at bf16: B=16
        sequences of 320x240 synthetic frames, chunks of T=16 steps through
        `trackers/vipt_tracker.py::make_track_scan`, 4 chunks a run, best of
        3 runs; prints frames/s per run and the best run's ms/step.
  crop  `loop` with the kernels and the crop as MMTRACK_CROP chooses it
        (`gather` the plain crop, `pallas` the kernel; `fused` reads as
        `gather`, as in the JAX tool); `mxu` is not ported and raises.

Each run prints one JSON line per result: the opt-outs in effect, the
kernel launches per forward or step counted at capture (the wrappers'
counters; a replay launches nothing through them) and the card's name and
power limit. Only the card: a CPU device raises.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from mmtrack_torch.config import vipt_experiment_config
from mmtrack_torch.data.synthetic import make_synthetic_sequence
from mmtrack_torch.models.vipt import build_viptrack
from mmtrack_torch.ops.crop import crop_resize_normalized, crop_resize_normalized_plain
from mmtrack_torch.ops.flash_attn import attn_block_fused, flash_mhsa_qkv
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused
from mmtrack_torch.trackers.vipt_tracker import (
    SCAN_WARMUP_STEPS,
    ViPTRuntime,
    make_track_scan,
    vipt_init_state,
)
from mmtrack_torch.utils import optouts, profiling
from mmtrack_torch.utils.device import capture_graph, card_line, require_cuda

COUNTERS = (attn_block_fused, mlp_block_fused, crop_resize_normalized, flash_mhsa_qkv)
MODES = ("fused", "xla")
FRAME_HW = (240, 320)


def counts() -> dict:
    return profiling.launches(COUNTERS)


def since(before: dict, per: int) -> dict:
    """Launches counted since `before`, per `per` forwards or steps."""
    return {k: (v - before[k]) / per for k, v in counts().items()}


def card_device(device=None) -> torch.device:
    device = torch.device(device) if device is not None else require_cuda()
    if device.type != "cuda":
        raise ValueError(f"ab_kernels times the card and needs a CUDA device, got {device}")
    return device


def mode_opt_outs(mode: str, crop: str | None = None,
                  device=None) -> tuple[dict, optouts.OptOuts]:
    """JAX's opt-outs of a mode (MMTRACK_ATTN and MMTRACK_MLP set to it,
    MMTRACK_CROP to `crop`, None for unset) and the port's switches for
    them on `device`."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {', '.join(MODES)}")
    env = {"attn": mode, "mlp": mode, "crop": crop}
    return env, optouts.resolve(**env, device=device)


def emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


@torch.inference_mode()
def run_fwd(mode: str, B: int = 16, T: int = 32, device=None, reps: int = 8) -> dict:
    """The chained bf16 forward of a seeded deep_rgbt ViPTrack, built in
    `mode` (module docstring). Returns the printed record, with the last
    forward's boxes (B, 4) under 'pred_boxes'."""
    device = card_device(device)
    cfg = vipt_experiment_config("deep_rgbt")
    rt = ViPTRuntime.from_config(cfg)
    env, opts = mode_opt_outs(mode, device=device)
    model = build_viptrack(cfg, dtype=torch.bfloat16, device=device, seed=0,
                           **opts.model_kwargs())
    z = torch.zeros((B, rt.template_size, rt.template_size, 6), device=device)
    x = torch.zeros((B, rt.search_size, rt.search_size, 6), device=device)

    def chain():
        carry = torch.zeros((), device=device)
        for _ in range(T):
            out = model(z + carry, x, None, rt.ce_keep_lens)
            carry = out["pred_boxes"].float().sum() * 1e-6
        return carry, out["pred_boxes"]

    before = counts()
    graph, (carry, boxes), _ = capture_graph(chain, device)   # an eager chain, then the capture
    launches = since(before, 2 * T)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        graph.replay()
        carry.item()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times[1:]) * 1e3 / T
    return emit({"tool": "ab_kernels", "which": "fwd", "mode": mode, "opt_outs": env,
                 "config": "deep_rgbt", "dtype": "bf16", "B": B, "T": T, "replays": reps,
                 "per_forward_ms": ms, "fwd_fps": B / (ms / 1e3),
                 "replay_ms": [t * 1e3 for t in times],
                 "launches_per_forward": launches,
                 "card": card_line()}) | {"pred_boxes": boxes.float().cpu().numpy()}


@torch.inference_mode()
def run_loop(mode: str, reps: int = 3, crop: str | None = None, device=None, B: int = 16,
             T: int = 16, chunks: int = 4) -> dict:
    """The resident tracking loop of a seeded deep_rgbd ViPTrack (bf16),
    built and captured in `mode` with the crop MMTRACK_CROP=`crop`
    chooses (module docstring). Prints a line per run and the best; returns the best
    line's record with the last run's boxes (chunks * T, B, 4) under
    'boxes'."""
    device = card_device(device)
    H, W = FRAME_HW
    cfg = vipt_experiment_config("deep_rgbd")
    rt = ViPTRuntime.from_config(cfg)
    env, opts = mode_opt_outs(mode, crop, device)
    crop_fn = crop_resize_normalized_plain if opts.plain_crop else crop_resize_normalized
    tag = {"tool": "ab_kernels", "which": "crop" if crop else "loop", "mode": mode,
           "opt_outs": env, "config": "deep_rgbd", "dtype": "bf16", "B": B, "T": T,
           "chunks": chunks, "frame": f"{W}x{H}"}
    model = build_viptrack(cfg, dtype=torch.bfloat16, device=device, seed=0,
                           **opts.model_kwargs())
    frames, gt = make_synthetic_sequence(n_frames=T + 1, height=H, width=W)
    f0 = torch.from_numpy(np.tile(frames[0], (B, 1, 1, 1))).to(device)
    b0 = torch.from_numpy(np.tile(gt[0].astype(np.float32), (B, 1)))
    chunk = torch.from_numpy(np.tile(frames[1:][:, None], (1, B, 1, 1, 1))).to(device)
    scan = make_track_scan(rt, model, device, crop=crop_fn)
    state = vipt_init_state(rt, f0, b0, crop_fn)
    before = counts()
    scan(state, chunk)                       # warm-up steps, capture, one replay
    launches = since(before, SCAN_WARMUP_STEPS + T)
    best, fps = float("inf"), []
    for rep in range(reps):
        state = vipt_init_state(rt, f0, b0, crop_fn)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = []
        for _ in range(chunks):
            state, boxes, _ = scan(state, chunk)
            out.append(boxes.clone())       # the graph's results alias its buffers
        last = torch.cat(out).cpu().numpy()
        elapsed = time.perf_counter() - t0
        best = min(best, elapsed)
        fps.append(B * T * chunks / elapsed)
        emit(tag | {"rep": rep, "fps": fps[-1], "ms_per_step": elapsed * 1e3 / (T * chunks)})
    return emit(tag | {"rep": "best", "fps": B * T * chunks / best,
                       "ms_per_step": best * 1e3 / (T * chunks), "fps_per_rep": fps,
                       "launches_per_step": launches, "card": card_line()}) | {"boxes": last}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "fwd"
    mode = argv[1] if len(argv) > 1 else "fused"
    if which == "fwd":
        run_fwd(mode, int(argv[2]) if len(argv) > 2 else 16, int(argv[3]) if len(argv) > 3 else 32)
    elif which == "crop":
        run_loop("fused", crop=mode if mode != "fused" else "gather")
    elif which == "loop":
        run_loop(mode, crop=os.environ.get(optouts.CROP))
    else:
        raise SystemExit(f"usage: ab_kernels fwd|loop|crop MODE [B] [T]; got {which!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
