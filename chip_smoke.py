#!/usr/bin/env python3
"""Drive the PyTorch port (mmtrack_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one result line each; any failure raises, so the exit code is
non-zero:

  0. card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and convolutions.
  1. build: compile the kernels of mmtrack_torch/csrc (nvcc, first use).
  2. kernels against their plain PyTorch versions at the main path's
     shapes: the attention and MLP half-blocks in bf16 at B=16 for every
     token count the path gives them (L = 320, 244, 190, 153), bar two bf16
     ulps of the largest |x|, |y - x| or |y| in the element's token row:
     kernel and plain sum in another f32 order, so a few bf16 roundings in
     the block flip by one ulp, and y = x + h then differs by at most one
     ulp of h plus one of y (near-zero outputs differ by many of their own
     ulps but not of their row's scale); the batched crop at S = 128 and 256
     on 320x240 and 640x480 frames, bar bit equality. Times from CUDA events.
  3. main path: BatchedViPTTracker with deep_rgbd in bf16 on seeded random
     weights, B=16 sequences of 320x240 6-channel synthetic frames,
     initialize + 16 tracked steps. The launch counters must show 9 x 16
     attention half-blocks, 12 x 16 MLP half-blocks and 1 + 16 crops; every
     box must be finite and inside its frame. Reports ms/step and frames/s.
  4. one full forward with the kernels against the same model on the plain
     versions (use_kernels=False), same inputs: without candidate
     elimination the score and size maps within MAP_BAR and the offset map
     within OFFSET_REL_BAR of its largest magnitude; with elimination (the
     main path) the CE agreement, map and box differences are printed.

The line before the last is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Without CUDA the script raises before any
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mmtrack_torch.config import vipt_experiment_config
from mmtrack_torch.kernels.build import load_library
from mmtrack_torch.models.vipt import build_viptrack, generate_ctr_mask
from mmtrack_torch.ops.crop import crop_resize_normalized, crop_resize_normalized_plain
from mmtrack_torch.ops.flash_attn import attn_block_fused, attn_block_fused_plain
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused, mlp_block_fused_plain
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
from mmtrack_torch.trackers.vipt_tracker import (
    MEAN_6CH,
    STD_6CH,
    ViPTRuntime,
    vipt_step_from_crop,
)
from mmtrack_torch.utils.device import require_cuda

B = 16
TOKENS = (320, 244, 190, 153)      # 64 template + 256 / 180 / 126 / 89 search tokens
STEPS = 16
FRAME_HW = (240, 320)
BLOCK_ULPS = 2
MAP_BAR = 0.05                     # score / size maps, values in (0, 1)
OFFSET_REL_BAR = 0.05              # offset map, relative to its largest magnitude


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    v = v.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def block_params(C: int, n1: int, k2: int, gen: torch.Generator, dev) -> dict:
    """LayerNorm parameters, w1 (n1, C) and w2 (C, k2) in bf16, f32 biases."""
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    bf = torch.bfloat16
    return dict(g=1 + r(C, scale=0.1), b=r(C, scale=0.1),
                w1=r(n1, C, scale=C ** -0.5).to(bf), b1=r(n1, scale=0.05),
                w2=r(C, k2, scale=k2 ** -0.5).to(bf), b2=r(C, scale=0.05))


def compare_blocks(name, kernel, plain, C, n1, k2, extra, dev, gen) -> list[dict]:
    p = block_params(C, n1, k2, gen, dev)
    args = (p["g"], p["b"], p["w1"], p["b1"], p["w2"], p["b2"])
    rows = []
    for L in TOKENS:
        x = torch.randn(B, L, C, generator=gen).to(dev, torch.bfloat16)
        got = kernel(x, *args, **extra)
        want = plain(x, *args, **extra)
        torch.cuda.synchronize()
        g, w, xf = got.float(), want.float(), x.float()
        err = (g - w).abs()
        scale = torch.stack([xf.abs(), g.abs(), w.abs(), (w - xf).abs()]).amax(0).amax(
            -1, keepdim=True)
        ulps = (err / bf16_ulp(scale)).max()
        row = dict(kernel=name, B=B, L=L, max_abs_err=err.max().item(),
                   max_row_ulps=ulps.item(), bar_row_ulps=BLOCK_ULPS,
                   frac_differ=(err > 0).float().mean().item(),
                   ms=cuda_ms(lambda: kernel(x, *args, **extra)),
                   plain_ms=cuda_ms(lambda: plain(x, *args, **extra)))
        log("kernels", **row)
        if not torch.isfinite(g).all() or row["max_row_ulps"] > BLOCK_ULPS:
            raise AssertionError(f"{name} L={L}: {row}")
        rows.append(row)
    return rows


def crop_boxes(H: int, W: int, gen: torch.Generator) -> torch.Tensor:
    """B boxes: inside the frame, across each edge, and tiny ones."""
    u = torch.rand(B, 4, generator=gen)
    boxes = torch.stack([u[:, 0] * (W - 60) + 10, u[:, 1] * (H - 60) + 10,
                         u[:, 2] * 40 + 8, u[:, 3] * 40 + 8], dim=1)
    boxes[0] = torch.tensor([-12.3, -7.6, 40.0, 30.0])                 # top-left edge
    boxes[1] = torch.tensor([W - 20.5, H - 15.2, 42.0, 33.0])          # bottom-right edge
    boxes[2] = torch.tensor([W * 0.5, H * 0.5, 0.6, 0.4])              # tiny: side 1-2 px
    boxes[3] = torch.tensor([W * 0.25 + 0.5, H * 0.25 + 0.5, 3.0, 5.0])  # half-pixel origin
    return boxes


def compare_crops(dev, gen) -> list[dict]:
    mean = torch.from_numpy(MEAN_6CH).to(dev)
    std = torch.from_numpy(STD_6CH).to(dev)
    rows = []
    for H, W in ((240, 320), (480, 640)):
        frames = torch.randint(0, 256, (B, H, W, 6), generator=gen,
                               dtype=torch.uint8).to(dev)
        boxes = crop_boxes(H, W, gen).to(dev)
        for S, factor in ((128, 2.0), (256, 4.0)):
            got, rf = crop_resize_normalized(frames, boxes, factor, S, mean, std)
            want, rf_w = crop_resize_normalized_plain(frames, boxes, factor, S, mean, std)
            torch.cuda.synchronize()
            row = dict(kernel="crop_resize_normalized", B=B, H=H, W=W, S=S,
                       max_abs_err=(got - want).abs().max().item(),
                       rf_equal=bool(torch.equal(rf, rf_w)), bar=0.0,
                       ms=cuda_ms(lambda: crop_resize_normalized(frames, boxes, factor, S,
                                                                 mean, std)),
                       plain_ms=cuda_ms(lambda: crop_resize_normalized_plain(
                           frames, boxes, factor, S, mean, std)))
            log("kernels", **row)
            if row["max_abs_err"] > 0 or not row["rf_equal"]:
                raise AssertionError(f"crop H={H} S={S}: {row}")
            rows.append(row)
    return rows


def synthetic_frames(n: int, gen: np.random.RandomState):
    """(n, B, H, W, 6) uint8 frames of B moving bright squares on texture,
    and the (B, 4) xywh boxes of frame 0."""
    H, W = FRAME_HW
    frames = np.empty((n, B, H, W, 6), np.uint8)
    bg = gen.randint(0, 80, (B, H, W, 6)).astype(np.uint8)
    pos = np.stack([gen.uniform(40, W - 90, B), gen.uniform(30, H - 70, B)], 1)
    vel = gen.uniform(-3, 3, (B, 2))
    size = np.stack([gen.uniform(24, 48, B), gen.uniform(20, 40, B)], 1)
    box0 = np.concatenate([pos, size], 1).astype(np.float32)
    for t in range(n):
        frames[t] = bg
        for s in range(B):
            x, y = (pos[s] + t * vel[s]).round().astype(int)
            w, h = size[s].astype(int)
            frames[t, s, max(y, 0):y + h, max(x, 0):x + w] = (220, 220, 220, 180, 180, 180)
    return frames, box0


def main_path(cfg, rt, dev, frames, box0):
    model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    tracker = BatchedViPTTracker(model, dev, rt)
    # warm-up (cuDNN algorithm choice, allocator), then the counted run
    tracker.initialize(frames[0], box0)
    tracker.track(frames[1])
    torch.cuda.synchronize()

    counters = (attn_block_fused, mlp_block_fused, crop_resize_normalized)
    for fn in counters:
        fn.launches = 0
    tracker.initialize(frames[0], box0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_boxes = [tracker.track(frames[t])[0] for t in range(1, STEPS + 1)]
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}

    expected = {"attn_block_fused": 9 * STEPS, "mlp_block_fused": 12 * STEPS,
                "crop_resize_normalized": STEPS + 1}
    boxes = np.stack(all_boxes)
    H, W = FRAME_HW
    inside = bool(np.isfinite(boxes).all() and (boxes[..., :2] >= 0).all()
                  and (boxes[..., 0] + boxes[..., 2] <= W + 1e-3).all()
                  and (boxes[..., 1] + boxes[..., 3] <= H + 1e-3).all())
    ms = elapsed / STEPS * 1e3
    log("main_path", config="deep_rgbd", dtype="bf16", B=B, steps=STEPS, frame=f"{W}x{H}",
        ms_per_step=ms, frames_per_s=B * STEPS / elapsed, launches=launches,
        expected=expected, boxes_inside=inside, card=card_line())
    if launches != expected or not inside:
        raise AssertionError(f"main path: launches {launches} (want {expected}), "
                             f"boxes inside: {inside}")
    return model, tracker, launches


def full_forward(cfg, rt, dev, model, tracker, frames):
    """The same forward with the kernels and with their plain versions.

    Without candidate elimination (every block through the attention
    kernel) the maps must agree within MAP_BAR / OFFSET_REL_BAR. With it,
    as on the main path, the kept sets can differ: with random weights the
    bf16 CE scores are nearly flat and full of ties, so a one-ulp change
    moves tokens across the cut. That run is printed, not asserted."""
    plain = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0, use_kernels=False)
    mean = torch.from_numpy(MEAN_6CH).to(dev)
    std = torch.from_numpy(STD_6CH).to(dev)
    state = tracker.state
    search, rf = crop_resize_normalized_plain(frames[STEPS], state["box"], rt.search_factor,
                                              rt.search_size, mean, std)
    mask = generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range, dev)
    H, W = FRAME_HW

    def run(m, keep):
        kept = {}
        hooks = [m.backbone.blocks[i].register_forward_hook(
            lambda mod, inp, out, i=i: kept.__setitem__(i, out[2].sort(1).values))
            for i in rt.ce_loc]
        with torch.inference_mode():
            out = m(state["template"], search, mask, keep)
        for h in hooks:
            h.remove()
        return out, kept

    def diffs(ok_, op):
        d = {k: (ok_[k] - op[k]).abs().max().item() for k in ("score_map", "size_map")}
        d["offset_map_rel"] = ((ok_["offset_map"] - op["offset_map"]).abs().max()
                               / op["offset_map"].abs().max()).item()
        return d

    (ok_, _), (op, _) = run(model, None), run(plain, None)
    no_ce = diffs(ok_, op)
    (ck, kk), (cp, kp) = run(model, rt.ce_keep_lens), run(plain, rt.ce_keep_lens)
    moved = {i: int(sum(len(set(a.tolist()) ^ set(b.tolist())) // 2
                        for a, b in zip(kk[i], kp[i]))) for i in rt.ce_loc}
    with torch.inference_mode():
        bk, _ = vipt_step_from_crop(rt, model, state["template"], state["box"], search, rf,
                                    float(H), float(W))
        bp, _ = vipt_step_from_crop(rt, plain, state["template"], state["box"], search, rf,
                                    float(H), float(W))
    log("full_forward", max_diff_without_ce=no_ce, map_bar=MAP_BAR,
        offset_rel_bar=OFFSET_REL_BAR, max_diff_with_ce=diffs(ck, cp),
        ce_sets_identical=[int((kk[i] == kp[i]).all(1).sum()) for i in rt.ce_loc], of=B,
        ce_tokens_moved_per_layer=moved, box_max_abs_diff_px=(bk - bp).abs().max().item())
    if (no_ce["score_map"] > MAP_BAR or no_ce["size_map"] > MAP_BAR
            or no_ce["offset_map_rel"] > OFFSET_REL_BAR):
        raise AssertionError(f"full forward: kernels vs plain beyond bar: {no_ce}")


def main() -> int:
    dev = require_cuda()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    lib = load_library()
    log_text = lib.path.with_suffix(".log").read_text() if lib.build_seconds else ""
    log("build", seconds=time.perf_counter() - t0, nvcc_seconds=lib.build_seconds,
        library=str(lib.path.name), attention_max_tokens=lib.attention_max_tokens,
        ptxas=[ln.strip() for ln in log_text.splitlines()
               if "registers" in ln or "spill" in ln])

    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        attn_rows = compare_blocks("attn_block_fused", attn_block_fused,
                                   attn_block_fused_plain, 768, 3 * 768, 768,
                                   dict(num_heads=12, scale=64 ** -0.5), dev, gen)
        mlp_rows = compare_blocks("mlp_block_fused", mlp_block_fused, mlp_block_fused_plain,
                                  768, 4 * 768, 4 * 768, {}, dev, gen)
        crop_rows = compare_crops(dev, gen)

    cfg = vipt_experiment_config("deep_rgbd")
    rt = ViPTRuntime.from_config(cfg)
    frames, box0 = synthetic_frames(STEPS + 1, np.random.RandomState(0))
    frames = torch.from_numpy(frames).to(dev)
    model, tracker, launches = main_path(cfg, rt, dev, frames, box0)
    full_forward(cfg, rt, dev, model, tracker, frames)

    def entry(name, source, replaces, rows):
        first = rows[0]      # L=320 for the blocks; S=256 on 320x240 frames for the crop
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": first["ms"], "plain_ms": first["plain_ms"]}

    search_row = next(r for r in crop_rows if r["H"] == FRAME_HW[0] and r["S"] == 256)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        entry("attn_block_fused", "mmtrack_torch/csrc/attention.cu",
              "mmtrack_tpu/ops/flash_attn.py:128", attn_rows),
        entry("mlp_block_fused", "mmtrack_torch/csrc/gemm.cu",
              "mmtrack_tpu/ops/mlp_fuse.py:74", mlp_rows),
        entry("crop_resize_normalized", "mmtrack_torch/csrc/crop.cu",
              "mmtrack_tpu/ops/pallas_preproc.py:21", [search_row] + crop_rows),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
