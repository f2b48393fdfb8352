#!/usr/bin/env python3
"""Drive the PyTorch port (mmtrack_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one result line each; any failure raises, so the exit code is
non-zero:

  0. card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and convolutions.
  1. build: compile the kernels of mmtrack_torch/csrc (nvcc, first use);
     every GEMM variant must contain wgmma (HGMMA) and TMA loads (UTMALDG)
     in its SASS (cuobjdump -sass) and show no spill in its ptxas report.
  2. kernels against their plain PyTorch versions at the main path's
     shapes: the attention and MLP half-blocks in bf16 at B=16 for every
     token count the path gives them (L = 320, 244, 190, 153), bar two bf16
     ulps of the largest |x|, |y - x| or |y| in the element's token row:
     kernel and plain sum in another f32 order, so a few bf16 roundings in
     the block flip by one ulp, and y = x + h then differs by at most one
     ulp of h plus one of y (near-zero outputs differ by many of their own
     ulps but not of their row's scale); the attention kernel alone
     (through flash_mhsa_qkv) at B=16 and the same L, as phase 5 measures
     it; the GEMM alone for the four products (qkv, proj, fc1, fc2) at
     M = 16 L and at the training block's 32 x 320, against its plain
     epilogue, same bar, with device TFLOP/s, the wrapper's host time,
     torch.matmul's device time and the tile plan; the LayerNorm kernel at
     M = 16 L against its byte bound; the batched crop at S = 128 and 256
     on 320x240 and 640x480 frames, bar bit equality. Times from CUDA
     events (and, for the attention, GEMM and LayerNorm, the profiler's
     device time).
  3. main path: BatchedViPTTracker with deep_rgbd in bf16 on seeded random
     weights, B=16 sequences of 320x240 6-channel synthetic frames,
     initialize + 16 tracked steps. The launch counters must show 9 x 16
     attention half-blocks, 12 x 16 MLP half-blocks and 1 + 16 crops; every
     box must be finite and inside its frame. Reports ms/step and frames/s.
     Then PROFILE_STEPS more steps under torch.profiler: the attention,
     GEMM and LayerNorm kernels' device ms and calls per step (9 attention
     and 42 GEMM calls asserted), the top kernels, all device work.
  4. one full forward with the kernels against the same model on the plain
     versions (use_kernels=False), same inputs: without candidate
     elimination the score and size maps within MAP_BAR and the offset map
     within OFFSET_REL_BAR of its largest magnitude; with elimination (the
     main path) the CE agreement, map and box differences are printed.
  5. training (mmtrack_torch.train): flash_mhsa_qkv against its plain
     version at B=32, L = 320 / 244 / 190 / 153, bar MHSA_ULPS bf16 ulps of
     the row's largest |output| (the two sum logits and probabilities in
     another f32 order, so a probability or an output rounds one ulp the
     other way), with the kernel's, the plain version's and
     F.scaled_dot_product_attention's device times from the profiler
     beside the CUDA-event times; forward + backward of each kernel's
     autograd Function against plain autograd (gradients equal: the
     backward is the plain version's, recomputed), times from CUDA events.
     Then prompt-only training of deep_rgbd at B=32, bf16 compute and f32
     parameters: one batch from the port's sampler, processing and loader
     on synthetic sequences, then device-resident random batches; 2
     warm-up + 8 counted steps in each of three modes, with exact launch
     counts per step
     (flash_mhsa_qkv / attn_block_fused / mlp_block_fused): drop path with
     CE keep 0.7, 8/1/1; drop path in the CE warm-up, 11/1/1; no drop path,
     0/9/12. Every loss finite, every prompt leaf moved, every frozen leaf
     bit-unchanged; ms/step, samples/s and peak memory.
  6. one training step's loss and prompt gradients with the kernels and
     with use_kernels=False (same weights, batch and drop-path generator):
     without CE within TRAIN_LOSS_REL_BAR and TRAIN_GRAD_REL_BAR (relative
     L2), with CE printed only. Every run decodes its boxes at the plain
     bf16 run's score-map argmax, so a near-tie that one ulp flips cannot
     move a box; printed beside the bars: the samples whose own argmax
     differs, and how close the plain map's top two scores come.
  7. xcorr: the depthwise-correlation kernel against its plain version,
     bar bit equality, at Alpha-Refine's shape (N = 1 and 16 search
     features of 32 x 32 x 64 padded by one in the kernel, per-sample 3 x 3
     filters) and at the Pallas test's (3, 22, 22, 256) x (6, 6, 256) with
     a shared filter; kernel, plain and F.conv2d(groups=C) times, from CUDA
     events over back-to-back calls and from the profiler's device time,
     and the bound.
  8. vot: the VOT entry's loop (mmtrack_torch.eval.vot.run_vot_exp) over
     in-memory TraX sessions on 20 synthetic 640x480 RGB-D frames written
     as PNG files: vipt_deep_rgbd at full width (f32, seeded weights, from
     the port's registry) and Alpha-Refine at input size 256, the mask
     protocol and then the rectangle protocol, after one short warm-up
     session. Launch counts must be exact: per mask session 2 x 20 crops
     (ViPT template + 19 searches, Alpha-Refine template + 19 searches) and
     19 correlations; per rectangle session 20 crops and none. Every state
     must decode to a frame-sized mask (or a finite rectangle). One refine
     on the card against the same model on the CPU (plain versions), same
     frame and box: probabilities within AR_PROB_BAR. Prints ms per frame
     split into read+compose, tracker step, refine and encode.

Every kernel in the `kernels` line carries bound_ms, the larger of its
bytes over 3.35 TB/s and its operations over the peak rate of their type
(989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 SIMT; NVIDIA's H100 SXM
data sheet), from the shapes of its row, and library_ms, one PyTorch call
that computes the same function where there is one
(F.scaled_dot_product_attention for flash_mhsa_qkv, F.conv2d(groups=C) for
the depthwise correlation, torch.matmul for the GEMM lines), timed here
and used nowhere in the port.

The line before the last is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Without CUDA the script raises before any
result.
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.config import vipt_experiment_config
from mmtrack_torch.data.datasets import SyntheticVideoDataset
from mmtrack_torch.data.loader import BatchLoader
from mmtrack_torch.data.processing import from_config as processing_from_config
from mmtrack_torch.data.sampler import TrackingSampler
from mmtrack_torch.eval.vot import Mask, Rectangle, _decode_region, _encode_region, run_vot_exp
from mmtrack_torch.eval.vot_entry import AR_INPUT_SIZE, refiner_factory
from mmtrack_torch.kernels.build import load_library, sass_by_kernel
from mmtrack_torch.models.heads import cal_bbox
from mmtrack_torch.models.vipt import build_viptrack, ce_keep_schedule, generate_ctr_mask
from mmtrack_torch.ops.crop import crop_resize_normalized, crop_resize_normalized_plain
from mmtrack_torch.ops.flash_attn import (
    attn_block_fused,
    attn_block_fused_plain,
    flash_mhsa_qkv,
    flash_mhsa_qkv_plain,
)
from mmtrack_torch.ops.mlp_fuse import (
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_BIAS_RESIDUAL,
    GEMM_BN,
    gemm_bf16,
    gemm_bf16_plain,
    gemm_plan,
    layer_norm_f32,
    layernorm_bf16,
    mlp_block_fused,
    mlp_block_fused_plain,
)
from mmtrack_torch.ops.xcorr import depthwise_xcorr, depthwise_xcorr_plain
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
from mmtrack_torch.registry import build_tracker
from mmtrack_torch.train.actor import vipt_loss
from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask
from mmtrack_torch.train.train_step import TrainState, drop_path_generator, make_train_step
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
PROFILE_STEPS = 3                  # tracking steps under torch.profiler, after the counted run
ATTENTION_KERNELS = ("attention_resident_kernel", "attention_streaming_kernel")
GEMM_KERNEL, LAYERNORM_KERNEL = "gemm_bf16_kernel", "layernorm_bf16_kernel"
GEMM_SHAPES = (("qkv", 2304, 768, EPI_BIAS), ("proj", 768, 768, EPI_BIAS_RESIDUAL),
               ("fc1", 3072, 768, EPI_BIAS_GELU), ("fc2", 768, 3072, EPI_BIAS_RESIDUAL))
GEMM_CALLS_PER_STEP = 2 * 9 + 2 * 12   # qkv + proj in 9 attention, fc1 + fc2 in 12 MLP half-blocks
FRAME_HW = (240, 320)
BLOCK_ULPS = 2
MAP_BAR = 0.05                     # score / size maps, values in (0, 1)
OFFSET_REL_BAR = 0.05              # offset map, relative to its largest magnitude
TRAIN_B = 32                       # TRAIN.BATCH_SIZE of deep_rgbd
TRAIN_WARMUP, TRAIN_STEPS = 2, 8   # per training mode
MHSA_ULPS = 2                      # flash_mhsa_qkv: bf16 ulps of the row's largest |output|
# one train step, kernels vs plain, CE off; measured on an H100 (700 W):
# loss 2.7e-5 relative, prompt gradients 0.0217 relative L2
TRAIN_LOSS_REL_BAR = 5e-4
TRAIN_GRAD_REL_BAR = 5e-2
VOT_FRAMES = 20
VOT_HW = (480, 640)
AR_PROB_BAR = 1e-3                 # Alpha-Refine probabilities, card (TF32 off) vs CPU
# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound(n_bytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def cuda_events(fn, iters: int) -> list:
    """The CUDA rows of torch.profiler's key_averages over `iters` calls of
    fn() (after one call outside the window), largest device time first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if rows:
            return sorted(rows, key=lambda e: -e.self_device_time_total)
    raise RuntimeError("torch.profiler recorded no device time")


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn()'s kernels in ms over `iters` calls, from
    torch.profiler: what the kernels take on the card, without the host's
    issue time between calls."""
    return sum(e.self_device_time_total for e in cuda_events(fn, iters)) / iters / 1e3


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    v = v.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def gemm_build_checks(lib) -> dict:
    """The GEMM kernels as compiled: each of the len(GEMM_BN) variants must
    contain wgmma (SASS HGMMA) and TMA loads (UTMALDG), by `cuobjdump
    -sass` of the library, and its ptxas report must show no spill."""
    log_path = lib.path.with_suffix(".log")
    text = log_path.read_text() if log_path.exists() else ""
    spills, name = {}, None
    for ln in text.splitlines():
        if "Function properties for " in ln:
            name = ln.split("Function properties for ", 1)[1].strip()
        elif name and "spill stores" in ln:
            spills[name] = ln.strip()
            name = None
    gemm_spills = {k: v for k, v in spills.items() if GEMM_KERNEL in k}
    opcodes = {k: {op: op in v for op in ("HGMMA", "UTMALDG")}
               for k, v in sass_by_kernel(lib.path).items() if GEMM_KERNEL in k}

    def no_spill(line):
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        return bool(m) and m.group(1) == "0" and m.group(2) == "0"

    ok = (len(opcodes) == len(GEMM_BN) and all(all(v.values()) for v in opcodes.values())
          and len(gemm_spills) == len(GEMM_BN) and all(map(no_spill, gemm_spills.values())))
    return dict(ok=ok, sass_opcodes=opcodes, ptxas_spills=gemm_spills,
                wgmma_notes=[ln.strip() for ln in text.splitlines() if "wgmma" in ln.lower()])


def host_us(fn, iters: int = 200) -> float:
    """Host time of one fn() call in microseconds, enqueue only (the card
    runs behind): what CUDA events do not see."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def row_ulps(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> dict:
    """The largest |got - want|, the same in bf16 ulps of the row's largest
    |x|, |got|, |want| or |want - x|, and the share of outputs that differ;
    raises if got is not finite."""
    g, w, xf = got.float(), want.float(), x.float()
    if not torch.isfinite(g).all():
        raise AssertionError("non-finite kernel output")
    err = (g - w).abs()
    scale = torch.stack([xf.abs(), g.abs(), w.abs(), (w - xf).abs()]).amax(0).amax(
        -1, keepdim=True)
    return dict(max_abs_err=err.max().item(), max_row_ulps=(err / bf16_ulp(scale)).max().item(),
                frac_differ=(err > 0).float().mean().item())


def compare_gemms(dev, gen) -> list[dict]:
    """The GEMM kernel alone against its plain version (its epilogue's
    rounding points), for the four products of the half-blocks at the
    tracking path's M = 16 L and the training block's 32 x 320, bar
    BLOCK_ULPS of the row's scale. Times: CUDA events, the profiler's
    device time (also with the bias epilogue alone), the wrapper's host
    time, and torch.matmul(a, w.t()) in bf16 (cuBLAS) as the library call;
    the block tile, its tiles and waves from gemm_plan."""
    rows = []
    for name, N, K, epi in GEMM_SHAPES:
        w = (torch.randn(N, K, generator=gen) * K ** -0.5).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=gen) * 0.05).to(dev)
        for M in [B * L for L in TOKENS] + [TRAIN_B * TOKENS[0]]:
            a = torch.randn(M, K, generator=gen).to(dev, torch.bfloat16)
            res = (torch.randn(M, N, generator=gen).to(dev, torch.bfloat16)
                   if epi == EPI_BIAS_RESIDUAL else None)
            got = gemm_bf16(a, w, b, epi, res)
            want = gemm_bf16_plain(a, w, b, epi, res)
            torch.cuda.synchronize()
            diff = row_ulps(got, want, torch.zeros_like(want) if res is None else res)
            plan = gemm_plan(M, N, K)

            def kernel():
                return gemm_bf16(a, w, b, epi, res)

            dev_ms = device_ms(kernel)
            flops = 2 * M * N * K
            row = dict(kernel="gemm_bf16", product=name, M=M, N=N, K=K, **diff,
                       bar_row_ulps=BLOCK_ULPS, ms=cuda_ms(kernel),
                       device_ms=dev_ms, tflops=flops / dev_ms / 1e9,
                       # the same product with the bias epilogue alone: what GELU or
                       # the residual add to the kernel
                       bias_only_device_ms=(device_ms(lambda: gemm_bf16(a, w, b, EPI_BIAS))
                                            if epi != EPI_BIAS else dev_ms),
                       host_us_per_call=host_us(kernel),
                       library_ms=device_ms(lambda: torch.matmul(a, w.t())),
                       # the same host's cost of one PyTorch call, for scale
                       library_host_us_per_call=host_us(lambda: torch.matmul(a, w.t())),
                       tile=[plan.bm, plan.bn], tiles=plan.tiles, waves=plan.waves,
                       tail_fill=plan.tail_fill,
                       **bound(nbytes(a, w, b, got, *(() if res is None else (res,))), flops,
                               "bf16"))
            log("kernels", **row, card=card_line())
            if row["max_row_ulps"] > BLOCK_ULPS:
                raise AssertionError(f"gemm {name} M={M}: {row}")
            rows.append(row)
    return rows


def compare_layernorm(dev, gen) -> list[dict]:
    """The LayerNorm row kernel against its plain version at the half-blocks'
    (16 L, 768), bar BLOCK_ULPS of the row's largest |output|; device time
    from the profiler beside the byte bound."""
    rows = []
    g = (1 + torch.randn(768, generator=gen) * 0.1).to(dev)
    b = (torch.randn(768, generator=gen) * 0.1).to(dev)
    for L in TOKENS:
        x = torch.randn(B * L, 768, generator=gen).to(dev, torch.bfloat16)
        got = layernorm_bf16(x, g, b, 1e-6)
        want = layer_norm_f32(x, g, b, 1e-6).to(torch.bfloat16)
        torch.cuda.synchronize()
        row = dict(kernel="layernorm_bf16", M=B * L, C=768,
                   **row_ulps(got, want, torch.zeros_like(want)), bar_row_ulps=BLOCK_ULPS,
                   ms=cuda_ms(lambda: layernorm_bf16(x, g, b, 1e-6)),
                   device_ms=device_ms(lambda: layernorm_bf16(x, g, b, 1e-6)),
                   # ~8 f32 operations per element: two sums, the normalisation
                   **bound(nbytes(x, g, b, got), 8 * x.numel(), "f32"))
        log("kernels", **row, card=card_line())
        if row["max_row_ulps"] > BLOCK_ULPS:
            raise AssertionError(f"layernorm L={L}: {row}")
        rows.append(row)
    return rows


def block_params(C: int, n1: int, k2: int, gen: torch.Generator, dev) -> dict:
    """LayerNorm parameters, w1 (n1, C) and w2 (C, k2) in bf16, f32 biases."""
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    bf = torch.bfloat16
    return dict(g=1 + r(C, scale=0.1), b=r(C, scale=0.1),
                w1=r(n1, C, scale=C ** -0.5).to(bf), b1=r(n1, scale=0.05),
                w2=r(C, k2, scale=k2 ** -0.5).to(bf), b2=r(C, scale=0.05))


def block_flops(name: str, L: int, C: int, n1: int, k2: int) -> float:
    """Matrix-product operations of one half-block: the two GEMMs, plus
    q k^T and p v for the attention."""
    gemms = 2 * B * L * (C * n1 + k2 * C)
    return gemms + (4 * B * L * L * C if name == "attn_block_fused" else 0)


def compare_blocks(name, kernel, plain, C, n1, k2, extra, dev, gen) -> list[dict]:
    p = block_params(C, n1, k2, gen, dev)
    args = (p["g"], p["b"], p["w1"], p["b1"], p["w2"], p["b2"])
    rows = []
    for L in TOKENS:
        x = torch.randn(B, L, C, generator=gen).to(dev, torch.bfloat16)
        got = kernel(x, *args, **extra)
        want = plain(x, *args, **extra)
        torch.cuda.synchronize()
        row = dict(kernel=name, B=B, L=L, **row_ulps(got, want, x), bar_row_ulps=BLOCK_ULPS,
                   ms=cuda_ms(lambda: kernel(x, *args, **extra)),
                   plain_ms=cuda_ms(lambda: plain(x, *args, **extra)), library_ms=None,
                   **bound(nbytes(x, *args, got), block_flops(name, L, C, n1, k2), "bf16"))
        log("kernels", **row)
        if row["max_row_ulps"] > BLOCK_ULPS:
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


def crop_read_bytes(boxes: torch.Tensor, factor: float, S: int, H: int, W: int,
                    C: int) -> int:
    """Frame bytes the crops must read: each box's square crop clipped to
    the pixels that can be sampled (rows < H - 1, columns < W - 1), and at
    most 2 S pixels a side (two bilinear taps per output pixel)."""
    total = 0
    for x, y, w, h in boxes.tolist():
        side = max(math.ceil(math.sqrt(w * h) * factor), 1)
        x1, y1 = round(x + 0.5 * w - side * 0.5), round(y + 0.5 * h - side * 0.5)
        nx = max(0, min(x1 + side, W - 1) - max(x1, 0))
        ny = max(0, min(y1 + side, H - 1) - max(y1, 0))
        total += min(nx, 2 * S) * min(ny, 2 * S) * C
    return total


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
                           frames, boxes, factor, S, mean, std)), library_ms=None,
                       # ~20 f32 operations per output element
                       **bound(crop_read_bytes(boxes, factor, S, H, W, 6)
                               + nbytes(boxes, mean, std, got, rf), 20 * got.numel(), "f32"))
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
    prof = profile_steps(tracker, frames[STEPS])
    log("main_path_profile", **prof, card=card_line())
    if (prof["attention_kernel_calls_per_step"] != 9
            or prof["gemm_kernel_calls_per_step"] != GEMM_CALLS_PER_STEP):
        raise AssertionError(f"profiled step: {prof}")
    return model, tracker, launches


def profile_steps(tracker, frame, steps: int = PROFILE_STEPS) -> dict:
    """Device time per tracking step by kernel, from torch.profiler over a
    short window of steps on one frame (after the counted run, so the
    launch counts are untouched): the attention kernel's share, the top
    kernels, and all device work."""
    rows = cuda_events(lambda: tracker.track(frame), steps)

    def per_step(names):
        sel = [e for e in rows if any(k in e.key for k in names)]
        return (sum(e.self_device_time_total for e in sel) / steps / 1e3,
                sum(e.count for e in sel) / steps)

    attn_ms, attn_calls = per_step(ATTENTION_KERNELS)
    gemm_ms, gemm_calls = per_step((GEMM_KERNEL,))
    ln_ms, ln_calls = per_step((LAYERNORM_KERNEL,))
    return dict(
        steps=steps,
        attention_kernel_ms_per_step=attn_ms, attention_kernel_calls_per_step=attn_calls,
        gemm_kernel_ms_per_step=gemm_ms, gemm_kernel_calls_per_step=gemm_calls,
        layernorm_kernel_ms_per_step=ln_ms, layernorm_kernel_calls_per_step=ln_calls,
        device_ms_per_step=sum(e.self_device_time_total for e in rows) / steps / 1e3,
        top_kernels_ms_per_step={e.key[:60]: e.self_device_time_total / steps / 1e3
                                 for e in rows[:8]})


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


def compare_mhsa(dev, gen, batch: int) -> list[dict]:
    """The attention kernel (through flash_mhsa_qkv) against its plain
    version at L = 320 / 244 / 190 / 153, 12 heads of 64: at B=32, the
    training path's shape, and at B=16, the tracking path's (where
    attn_block_fused runs the same kernel between its two GEMMs). Times
    from CUDA events and from the profiler's device time, for the kernel,
    the plain version and F.scaled_dot_product_attention."""
    rows = []
    for L in TOKENS:
        qkv = torch.randn(batch, L, 3 * 768, generator=gen).to(dev, torch.bfloat16)
        got = flash_mhsa_qkv(qkv, 12, 64 ** -0.5)
        want = flash_mhsa_qkv_plain(qkv, 12, 64 ** -0.5)
        # the library call on q, k, v laid out (B, heads, L, 64) beforehand
        q, k, v = qkv.reshape(batch, L, 3, 12, 64).permute(2, 0, 3, 1, 4).contiguous()
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        err = (g - w).abs()
        scale = torch.maximum(g.abs(), w.abs()).amax(-1, keepdim=True)

        def kernel():
            return flash_mhsa_qkv(qkv, 12, 64 ** -0.5)

        def plain():
            return flash_mhsa_qkv_plain(qkv, 12, 64 ** -0.5)

        def library():
            return F.scaled_dot_product_attention(q, k, v)

        row = dict(kernel="flash_mhsa_qkv", B=batch, L=L, max_abs_err=err.max().item(),
                   max_row_ulps=(err / bf16_ulp(scale)).max().item(), bar_row_ulps=MHSA_ULPS,
                   frac_differ=(err > 0).float().mean().item(),
                   ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                   device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
                   library_device_ms=device_ms(library),
                   **bound(nbytes(qkv, got), 4 * batch * L * L * 768, "bf16"))
        log("kernels", **row, card=card_line())
        if not torch.isfinite(g).all() or row["max_row_ulps"] > MHSA_ULPS:
            raise AssertionError(f"flash_mhsa_qkv B={batch} L={L}: {row}")
        rows.append(row)
    return rows


def time_functions(dev, gen) -> list[dict]:
    """Forward + backward of each kernel's autograd Function against plain
    autograd of its plain version, at B=32, L=320, the gradient taken for
    the activations only (the training path's frozen weights)."""
    L = TOKENS[0]
    heads = dict(num_heads=12, scale=64 ** -0.5)
    cases = [("flash_mhsa_qkv", flash_mhsa_qkv, flash_mhsa_qkv_plain, (3 * 768,), heads)]
    for name, kernel, plain, n1, k2, extra in (
            ("attn_block_fused", attn_block_fused, attn_block_fused_plain, 3 * 768, 768, heads),
            ("mlp_block_fused", mlp_block_fused, mlp_block_fused_plain, 4 * 768, 4 * 768, {})):
        p = block_params(768, n1, k2, gen, dev)
        cases.append((name, kernel, plain, (768, p["g"], p["b"], p["w1"], p["b1"], p["w2"],
                                            p["b2"]), extra))
    rows = []
    for name, kernel, plain, args, extra in cases:
        x = torch.randn(TRAIN_B, L, args[0], generator=gen).to(dev, torch.bfloat16)
        x.requires_grad_(True)
        rest = args[1:]
        g_out = torch.randn(TRAIN_B, L, 768, generator=gen).to(dev, torch.bfloat16)

        def fwd_bwd(fn):
            return torch.autograd.grad(fn(x, *rest, **extra), x, g_out)[0]

        before = kernel.launches
        got, want = fwd_bwd(kernel), fwd_bwd(plain)
        if kernel.launches != before + 1 or not torch.equal(got, want):
            raise AssertionError(f"{name}: the Function's gradient is not plain autograd's")
        row = dict(function=name, B=TRAIN_B, L=L, grad_equal=True,
                   fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(kernel), iters=10),
                   plain_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(plain), iters=10))
        log("functions", **row)
        rows.append(row)
    return rows


def synthetic_train_batch(cfg, dev) -> dict:
    """Device-resident random crops and boxes, as tools/bench_train.py:71-77."""
    rng = np.random.RandomState(0)
    Tz, Tx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    host = {"template": rng.randn(TRAIN_B, Tz, Tz, 6), "search": rng.randn(TRAIN_B, Tx, Tx, 6),
            "search_anno": rng.uniform(0.2, 0.4, (TRAIN_B, 4))}
    return {k: torch.from_numpy(v).to(dev, torch.float32) for k, v in host.items()}


def state_step(state, step, batch) -> torch.Tensor:
    """One train step; its loss, left on the device."""
    _, stats = step(state, batch)
    return stats["Loss/total"]


def train_path(cfg, dev) -> dict:
    """Prompt-only training of deep_rgbd at B=32, bf16 compute, f32
    parameters: one batch from the port's data pipeline, then device
    batches, in the three modes a training run goes through. Returns the
    counted launches of each kernel."""
    stride = cfg.MODEL.BACKBONE.STRIDE
    n_search = (cfg.DATA.SEARCH.SIZE // stride) ** 2
    ce_lens = ce_keep_schedule(n_search, cfg.MODEL.BACKBONE.CE_LOC,
                               cfg.MODEL.BACKBONE.CE_KEEP_RATIO)
    mask = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                             cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, dev)
    model = build_viptrack(cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev,
                           seed=0)
    opt, sched = build_optimizer(model, lr=cfg.TRAIN.LR, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                                 lr_drop_step=cfg.TRAIN.LR_DROP_EPOCH
                                 * (cfg.DATA.TRAIN.SAMPLE_PER_EPOCH // TRAIN_B),
                                 decay_rate=cfg.TRAIN.SCHEDULER.DECAY_RATE,
                                 grad_clip_norm=cfg.TRAIN.GRAD_CLIP_NORM,
                                 trainable_mask=prompt_only_mask(model))
    state = TrainState(model, opt, sched)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    weights = (cfg.TRAIN.GIOU_WEIGHT, cfg.TRAIN.L1_WEIGHT, cfg.TRAIN.FOCAL_WEIGHT)

    def step_fn(lens, use_drop_path):
        return make_train_step(box_mask_z=mask, ce_keep_lens=lens, weights=weights,
                               search_size=cfg.DATA.SEARCH.SIZE, stride=stride,
                               use_drop_path=use_drop_path, seed=0)

    # one batch through the port's sampler, processing and loader
    t0 = time.perf_counter()
    sampler = TrackingSampler([SyntheticVideoDataset(n_sequences=8, n_frames=60)], None,
                              samples_per_epoch=TRAIN_B,
                              max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
                              processing=processing_from_config(cfg), seed=0)
    loaded = next(iter(BatchLoader(sampler, TRAIN_B)))
    load_s = time.perf_counter() - t0
    shapes = {k: list(v.shape) for k, v in loaded.items()}
    Tz, Tx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    if (shapes["search"] != [TRAIN_B, Tx, Tx, 6] or shapes["template"] != [TRAIN_B, Tz, Tz, 6]
            or not all(np.isfinite(v).all() for v in loaded.values())):
        raise AssertionError(f"loader batch: {shapes}")
    losses = [state_step(state, step_fn(ce_lens, True), loaded)]

    batch = synthetic_train_batch(cfg, dev)
    counters = (flash_mhsa_qkv, attn_block_fused, mlp_block_fused)
    counted = dict.fromkeys((fn.__name__ for fn in counters), 0)
    rows = []
    for mode, lens, use_dp, per_step in (("drop_path+ce", ce_lens, True, (8, 1, 1)),
                                         ("drop_path, ce warm-up", None, True, (11, 1, 1)),
                                         ("no drop_path", ce_lens, False, (0, 9, 12))):
        step = step_fn(lens, use_dp)
        for _ in range(TRAIN_WARMUP):
            losses.append(state_step(state, step, batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(state_step(state, step, batch))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        expected = {fn.__name__: n * TRAIN_STEPS for fn, n in zip(counters, per_step)}
        row = dict(mode=mode, B=TRAIN_B, steps=TRAIN_STEPS, ms_per_step=elapsed / TRAIN_STEPS * 1e3,
                   samples_per_s=TRAIN_B * TRAIN_STEPS / elapsed,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   launches=launches, expected=expected, card=card_line())
        log("train", **row)
        if launches != expected:
            raise AssertionError(f"train {mode}: launches {launches}, want {expected}")
        for name, n in launches.items():
            counted[name] += n
        rows.append(row)

    losses = [float(v) for v in losses]
    after = model.state_dict()
    moved = [k for k in after if "prompt" in k and not torch.equal(after[k], start[k])]
    n_prompt = sum("prompt" in k for k in after)
    frozen_changed = [k for k in after if "prompt" not in k and not torch.equal(after[k], start[k])]
    log("train_check", config="deep_rgbd", dtype="bf16 compute, f32 params", B=TRAIN_B,
        loader_seconds=load_s, loader_shapes=shapes, steps=len(losses), loss_first=losses[0],
        loss_last=losses[-1], all_finite=bool(np.isfinite(losses).all()),
        prompt_leaves_moved=f"{len(moved)}/{n_prompt}", frozen_leaves_changed=frozen_changed)
    if (not np.isfinite(losses).all() or len(moved) != n_prompt or frozen_changed):
        raise AssertionError("train: non-finite loss, unmoved prompt leaf or changed frozen leaf")
    return counted


def train_kernels_vs_plain(cfg, dev) -> None:
    """One step's loss and prompt gradients with the kernels and with
    their plain versions (use_kernels=False): same weights, batch and
    drop-path generator. Asserted without candidate elimination, printed
    with it (tied bf16 CE scores on random weights move tokens). The same
    step at f32 compute gives the scale of bf16 rounding for comparison.

    The box loss is not continuous in the kernels' rounding: a box is
    decoded at its score map's argmax, and random weights give nearly flat
    maps, so a one-ulp change can move a sample's box to another peak.
    So every run decodes its boxes at the plain bf16 run's argmax cells
    (the size and offset maps read there, the focal loss on the whole
    score map, as in training): the bars then see the kernels' rounding
    and not the ties. Printed beside them: the samples whose own argmax
    differs between the two bf16 runs, and the smallest gap between the
    plain map's top two scores, against the largest difference between
    the two maps."""
    stride = cfg.MODEL.BACKBONE.STRIDE
    mask = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                             cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, dev)
    ce_lens = ce_keep_schedule((cfg.DATA.SEARCH.SIZE // stride) ** 2,
                               cfg.MODEL.BACKBONE.CE_LOC, cfg.MODEL.BACKBONE.CE_KEEP_RATIO)
    batch = synthetic_train_batch(cfg, dev)
    results, score_maps, cells = {}, {}, {}
    for name, dtype, use_kernels, runs in (("plain", torch.bfloat16, False, (None, ce_lens)),
                                           ("kernels", torch.bfloat16, True, (None, ce_lens)),
                                           ("f32", torch.float32, False, (None,))):
        model = build_viptrack(cfg, dtype=dtype, param_dtype=torch.float32, device=dev, seed=0,
                               use_kernels=use_kernels)
        trainable = prompt_only_mask(model)
        for pname, p in model.named_parameters():
            p.requires_grad_(trainable[pname])
        for lens in runs:
            out = model(batch["template"], batch["search"], mask, lens, deterministic=False,
                        generator=drop_path_generator(0, 0, dev))
            flat = out["score_map"].detach().float().flatten(1)
            at = cells.setdefault(lens is None, flat.argmax(1))     # the plain bf16 run's
            out["pred_boxes"], _ = cal_bbox(out["score_map"], out["size_map"],
                                            out["offset_map"], at)
            loss, _ = vipt_loss(out, batch["search_anno"], search_size=cfg.DATA.SEARCH.SIZE,
                                stride=stride)
            params = [p for p in model.parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, params)
            results[name, lens is None] = (loss.detach().float(),
                                           torch.cat([g.flatten() for g in grads]))
            if dtype == torch.bfloat16 and lens is None:
                score_maps[name] = flat
        del model

    def diff(a, b):
        (la, ga), (lb, gb) = results[a], results[b]
        return dict(loss_rel_diff=((la - lb).abs() / lb.abs()).item(),
                    grad_rel_l2=((ga - gb).norm() / gb.norm()).item())

    off = diff(("kernels", True), ("plain", True))
    sk, sp = score_maps["kernels"], score_maps["plain"]
    top2 = sp.topk(2, dim=1).values
    ties = dict(argmax_differs=(sk.argmax(1) != sp.argmax(1)).nonzero().flatten().tolist(),
                plain_min_top2_gap=(top2[:, 0] - top2[:, 1]).min().item(),
                score_map_max_abs_diff=(sk - sp).abs().max().item())
    log("train_kernels_vs_plain",
        ce_off=dict(loss_kernels=results["kernels", True][0].item(),
                    loss_plain=results["plain", True][0].item(), **off, **ties),
        ce_on=diff(("kernels", False), ("plain", False)),
        bf16_plain_vs_f32_ce_off=diff(("plain", True), ("f32", True)),
        loss_rel_bar=TRAIN_LOSS_REL_BAR, grad_rel_l2_bar=TRAIN_GRAD_REL_BAR, asserted="ce_off",
        boxes_decoded_at="the plain bf16 run's score-map argmax")
    if off["loss_rel_diff"] > TRAIN_LOSS_REL_BAR or off["grad_rel_l2"] > TRAIN_GRAD_REL_BAR:
        raise AssertionError(f"train step, kernels vs plain beyond bar: {off}")


XCORR_CASES = (  # (name, N, H, W, C, fh, fw, per-sample filter, pad)
    ("alpha_refine", 1, 32, 32, 64, 3, 3, True, 1),
    ("alpha_refine", 16, 32, 32, 64, 3, 3, True, 1),
    ("pallas_test", 3, 22, 22, 256, 6, 6, False, 0),
)


def compare_xcorr(dev, gen) -> list[dict]:
    """The depthwise-correlation kernel against its plain version (bit
    equality) and against F.conv2d(groups=C) on NCHW tensors laid out
    beforehand (the library call; cuDNN at f32, TF32 off)."""
    rows = []
    for name, N, H, W, C, fh, fw, per_sample, pad in XCORR_CASES:
        x = torch.randn(N, H, W, C, generator=gen).to(dev)
        z = torch.randn(*((N,) if per_sample else ()), fh, fw, C, generator=gen).to(dev)
        got = depthwise_xcorr(z, x, pad=pad)
        want = depthwise_xcorr_plain(z, x, pad=pad)
        groups = N * C if per_sample else C
        # per-sample filters: the N samples' channels side by side as N * C groups
        x_lib = x.permute(0, 3, 1, 2).reshape(-1, groups, H, W).contiguous()
        w_lib = z.permute(*((0, 3) if per_sample else (2,)), -3, -2)
        w_lib = w_lib.reshape(groups, 1, fh, fw).contiguous()

        def library():
            return F.conv2d(x_lib, w_lib, padding=pad, groups=groups)

        lib = library()
        lib = (lib.reshape(N, C, *lib.shape[2:]) if per_sample else lib).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        row = dict(kernel="depthwise_xcorr", case=name, N=N, x=[H, W, C], filter=[fh, fw],
                   per_sample=per_sample, pad=pad, max_abs_err=(got - want).abs().max().item(),
                   bar=0.0, library_max_abs_diff=(lib - want).abs().max().item(),
                   ms=cuda_ms(lambda: depthwise_xcorr(z, x, pad=pad)),
                   plain_ms=cuda_ms(lambda: depthwise_xcorr_plain(z, x, pad=pad)),
                   library_ms=cuda_ms(library),
                   **bound(nbytes(x, z, got), 2 * fh * fw * got.numel(), "f32"))
        # back-to-back calls of a microsecond kernel measure the host's
        # issue rate; the profiler gives the kernels' own device time
        row.update(device_ms=device_ms(lambda: depthwise_xcorr(z, x, pad=pad)),
                   plain_device_ms=device_ms(lambda: depthwise_xcorr_plain(z, x, pad=pad)),
                   library_device_ms=device_ms(library), bound_us=row["bound_ms"] * 1e3)
        log("xcorr", **row, card=card_line())
        if not torch.equal(got, want):
            raise AssertionError(f"depthwise_xcorr {name} N={N}: {row}")
        rows.append(row)
    return rows


def vot_sequence(root: str, n: int, seed: int = 0):
    """n synthetic 640x480 RGB-D frames as RGB PNG + 16-bit depth PNG
    files: a bright box drifting over texture, nearer than a sloped
    background. Returns (colour paths, depth paths, box of frame 0)."""
    rng = np.random.RandomState(seed)
    H, W = VOT_HW
    bg = rng.randint(0, 90, (H, W, 3)).astype(np.uint8)
    far = (3000 + 3000 * np.linspace(0, 1, H)[:, None]
           + rng.randint(0, 200, (H, W))).astype(np.uint16)
    x, y, w, h = 250.0, 180.0, 70.0, 55.0
    colors, depths = [], []
    for t in range(n):
        xi, yi = int(round(x + 3.0 * t)), int(round(y + 1.5 * t))
        rgb, depth = bg.copy(), far.copy()
        rgb[yi:yi + int(h), xi:xi + int(w)] = (230, 200, 60)
        depth[yi:yi + int(h), xi:xi + int(w)] = 1400
        c, d = os.path.join(root, f"color_{t:04d}.png"), os.path.join(root, f"depth_{t:04d}.png")
        cv2.imwrite(c, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(d, depth)
        colors.append(c)
        depths.append(d)
    return colors, depths, (x, y, w, h)


def trax_script(colors, depths, region: str) -> str:
    lines = [f'@@TRAX:initialize "file://{colors[0]}" "file://{depths[0]}" "{region}"']
    lines += [f'@@TRAX:frame "file://{c}" "file://{d}"' for c, d in zip(colors[1:], depths[1:])]
    return "\n".join(lines + ["@@TRAX:quit", ""])


def vot_path(dev) -> dict:
    """The VOT entry's loop, mask protocol then rectangle protocol, with
    exact launch counts. Returns the launches of each kernel."""
    counters = (crop_resize_normalized, depthwise_xcorr)
    tracker = build_tracker("vipt_deep_rgbd", device=dev)          # f32, seed 0
    refiner = refiner_factory(dev)()                                # AR at 256, seed 0
    H, W = VOT_HW
    counted = dict.fromkeys((fn.__name__ for fn in counters), 0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        colors, depths, (x, y, w, h) = vot_sequence(root, VOT_FRAMES)
        write_s = time.perf_counter() - t0
        init_mask = np.ones((int(h), int(w)), np.uint8)
        regions = {"mask": _encode_region(Mask(int(x), int(y), init_mask)),
                   "rectangle": _encode_region(Rectangle(x, y, w, h))}

        def session(protocol: str, n: int, timings=None) -> list:
            fout = io.StringIO()
            run_vot_exp(lambda: tracker, channels="rgbd", dtype="rgbcolormap",
                        fin=io.StringIO(trax_script(colors[:n], depths[:n], regions[protocol])),
                        fout=fout, mask=protocol == "mask", refine_factory=lambda: refiner,
                        timings=timings)
            return [_decode_region(ln.split('"')[1]) for ln in fout.getvalue().splitlines()
                    if ln.startswith("@@TRAX:state")]

        session("mask", 4)                                           # warm-up
        torch.cuda.synchronize()
        for protocol, per_session in (("mask", {"crop_resize_normalized": 2 * VOT_FRAMES,
                                                "depthwise_xcorr": VOT_FRAMES - 1}),
                                      ("rectangle", {"crop_resize_normalized": VOT_FRAMES,
                                                     "depthwise_xcorr": 0})):
            timings = {}
            for fn in counters:
                fn.launches = 0
            t0 = time.perf_counter()
            states = session(protocol, VOT_FRAMES, timings)
            elapsed = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            if protocol == "mask":
                ok = all(isinstance(s, Mask) and (s.x, s.y) == (0, 0) and s.mask.shape == (H, W)
                         for s in states[1:])
                covered = [float(s.mask.mean()) for s in states[1:]]
            else:
                ok = all(isinstance(s, Rectangle) and np.isfinite(list(s)).all()
                         for s in states[1:])
                covered = None
            frames = timings["frames"]
            log("vot", protocol=protocol, tracker="vipt_deep_rgbd", dtype="f32",
                ar_input_size=AR_INPUT_SIZE, frames=VOT_FRAMES, frame=f"{W}x{H}",
                png_write_s=write_s, states=len(states), states_ok=ok,
                mask_area_fraction=covered, launches=launches, expected=per_session,
                ms_per_frame=elapsed / VOT_FRAMES * 1e3,
                ms_per_frame_split={k: timings[k] / frames * 1e3
                                    for k in ("read_compose", "track", "refine", "encode")},
                card=card_line())
            if len(states) != VOT_FRAMES or not ok or launches != per_session:
                raise AssertionError(f"vot {protocol}: {len(states)} states, ok {ok}, "
                                     f"launches {launches} (want {per_session})")
            for name, k in launches.items():
                counted[name] += k

        # one refine on the card against the same model on the CPU
        frame = cv2.cvtColor(cv2.imread(colors[1]), cv2.COLOR_BGR2RGB)
        box = [x + 2.0, y + 1.0, w + 3.0, h - 2.0]
        cpu_ref = refiner_factory("cpu")()
        cpu_ref.model.load_state_dict(refiner.model.state_dict())
        for seg in (refiner, cpu_ref):
            seg.initialize(cv2.cvtColor(cv2.imread(colors[0]), cv2.COLOR_BGR2RGB), [x, y, w, h])
        (bg, pg), (bc, pc) = refiner.refine(frame, box), cpu_ref.refine(frame, box)
        diff = dict(prob_max_abs_diff=float(np.abs(pg - pc).max()),
                    box_max_abs_diff_px=float(np.abs(np.subtract(bg, bc)).max()),
                    binary_pixels_differ=int(((pg > 0.5) != (pc > 0.5)).sum()),
                    prob_bar=AR_PROB_BAR)
        log("vot_refine_card_vs_cpu", **diff)
        if not diff["prob_max_abs_diff"] <= AR_PROB_BAR:
            raise AssertionError(f"Alpha-Refine card vs CPU: {diff}")
    return counted


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
    checks = gemm_build_checks(lib)
    log("build", seconds=time.perf_counter() - t0, nvcc_seconds=lib.build_seconds,
        library=str(lib.path.name), ptxas=[ln.strip() for ln in log_text.splitlines()
               if "registers" in ln or "spill" in ln], gemm=checks)
    if not checks["ok"]:
        raise AssertionError(f"GEMM kernels: no HGMMA/UTMALDG in the SASS or a spill: {checks}")

    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        attn_rows = compare_blocks("attn_block_fused", attn_block_fused,
                                   attn_block_fused_plain, 768, 3 * 768, 768,
                                   dict(num_heads=12, scale=64 ** -0.5), dev, gen)
        mlp_rows = compare_blocks("mlp_block_fused", mlp_block_fused, mlp_block_fused_plain,
                                  768, 4 * 768, 4 * 768, {}, dev, gen)
        compare_mhsa(dev, gen, B)
        compare_gemms(dev, gen)
        compare_layernorm(dev, gen)
        crop_rows = compare_crops(dev, gen)
        xcorr_rows = compare_xcorr(dev, gen)

    cfg = vipt_experiment_config("deep_rgbd")
    rt = ViPTRuntime.from_config(cfg)
    frames, box0 = synthetic_frames(STEPS + 1, np.random.RandomState(0))
    frames = torch.from_numpy(frames).to(dev)
    model, tracker, launches = main_path(cfg, rt, dev, frames, box0)
    full_forward(cfg, rt, dev, model, tracker, frames)
    del model, tracker
    torch.cuda.empty_cache()

    with torch.inference_mode():
        mhsa_rows = compare_mhsa(dev, gen, TRAIN_B)
    time_functions(dev, gen)
    for name, n in train_path(cfg, dev).items():
        launches[name] = launches.get(name, 0) + n
    train_kernels_vs_plain(cfg, dev)
    for name, n in vot_path(dev).items():
        launches[name] = launches.get(name, 0) + n

    def entry(name, source, replaces, rows):
        # the first row is the main path's shape: L=320 for the attention,
        # S=256 on 320x240 frames for the crop, Alpha-Refine's N=1 for xcorr
        first = rows[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": first["ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": first["library_ms"]}

    search_row = next(r for r in crop_rows if r["H"] == FRAME_HW[0] and r["S"] == 256)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        entry("attn_block_fused", "mmtrack_torch/csrc/attention.cu",
              "mmtrack_tpu/ops/flash_attn.py:128", attn_rows),
        entry("mlp_block_fused", "mmtrack_torch/csrc/gemm.cu",
              "mmtrack_tpu/ops/mlp_fuse.py:74", mlp_rows),
        entry("crop_resize_normalized", "mmtrack_torch/csrc/crop.cu",
              "mmtrack_tpu/ops/pallas_preproc.py:21", [search_row] + crop_rows),
        entry("flash_mhsa_qkv", "mmtrack_torch/csrc/attention.cu",
              "mmtrack_tpu/ops/flash_attn.py:63", mhsa_rows),
        entry("depthwise_xcorr", "mmtrack_torch/csrc/xcorr.cu",
              "mmtrack_tpu/ops/xcorr.py:50", xcorr_rows),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
