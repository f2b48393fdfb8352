"""Training throughput of the prompt-only ViPT step on the card: port of
tools/bench_train.py.

    python -m mmtrack_torch.train.bench_train [--batches 16 32] [--steps 10]

One step is `train/train_step.py::make_train_step` on deep_rgbd (ViT-B,
128 / 256 crops, candidate elimination), bf16 compute over f32
parameters, only the prompt parameters trainable (`train/optim.py`), AdamW
at lr 4e-4 dropping at step 100. For each batch size: the same random
batch from RandomState(0) as the JAX tool, 2 warm steps, then the timed
steps with one synchronize at the end. Prints one JSON line per batch
size (ms_per_step, samples_per_s, model_tflops, mfu_vs_bf16_peak,
loss_first, loss_last, and the launches of the three kernels per timed
step) and a summary line with the card's name and power limit.

The MFU keeps the JAX tool's count, 44.3 GFLOP a frame forward x 3 for
fwd + bwd (tools/bench_train.py:31-32), over the H100's bf16 dense peak
of 989 TFLOP/s (NVIDIA's data sheet, SXM, 700 W). The summary also gives
the port's own count of one forward and of one prompt-only fwd + bwd at
B=1 (`utils/profiling.py::flops_estimate` over the model on the meta
device: shapes only, nothing runs).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mmtrack_torch.config import vipt_experiment_config
from mmtrack_torch.models.vipt import build_viptrack, ce_keep_schedule, generate_ctr_mask
from mmtrack_torch.ops.flash_attn import attn_block_fused, flash_mhsa_qkv
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused
from mmtrack_torch.train.actor import vipt_forward_and_loss
from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask
from mmtrack_torch.train.train_step import TrainState, make_train_step
from mmtrack_torch.utils import optouts, profiling
from mmtrack_torch.utils.device import card_line, require_cuda
from mmtrack_torch.utils.profiling import flops_estimate

JAX_FWD_GFLOP_PER_FRAME = 44.3   # the JAX tool's count (deep_rgbd, CE on)
JAX_BWD_FACTOR = 3.0             # fwd + ~2x fwd for the backward, as the JAX tool counts
PEAK_BF16_TFLOPS = 989.0         # one H100 SXM, bf16 dense
LR, LR_DROP_STEP, WARM_STEPS = 4e-4, 100, 2
COUNTERS = (flash_mhsa_qkv, attn_block_fused, mlp_block_fused)


def geometry(cfg, device):
    """(template size, search size, stride, CE keep lengths, CE template
    mask on `device`) of a config."""
    Tz, Tx, stride = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE, cfg.MODEL.BACKBONE.STRIDE
    keep = ce_keep_schedule((Tx // stride) ** 2, tuple(cfg.MODEL.BACKBONE.CE_LOC),
                            tuple(cfg.MODEL.BACKBONE.CE_KEEP_RATIO))
    return Tz, Tx, stride, keep, generate_ctr_mask(Tz // stride, "CTR_POINT", device=device)


def random_batch(B: int, Tz: int, Tx: int, device) -> dict:
    """The JAX tool's batch: RandomState(0) normals for the crops, boxes
    uniform in [0.2, 0.4), f32 on `device`."""
    rng = np.random.RandomState(0)
    host = {"template": rng.randn(B, Tz, Tz, 6), "search": rng.randn(B, Tx, Tx, 6),
            "search_anno": rng.uniform(0.2, 0.4, (B, 4))}
    return {k: torch.from_numpy(v).to(device, torch.float32) for k, v in host.items()}


def bench_train(cfg, batches=(16, 32), steps: int = 10, device=None) -> list[dict]:
    """Time the prompt-only step of `cfg` at each batch size on `device`
    (the card unless given), from the same seeded weights for each; print
    and return one record per batch size."""
    device = torch.device(device) if device is not None else require_cuda()
    Tz, Tx, stride, keep, mask_z = geometry(cfg, device)
    model = build_viptrack(cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=device,
                           seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(box_mask_z=mask_z, ce_keep_lens=keep, search_size=Tx, stride=stride)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows = []
    for B in batches:
        batch = random_batch(B, Tz, Tx, device)
        model.load_state_dict(start)
        opt, sched = build_optimizer(model, lr=LR, lr_drop_step=LR_DROP_STEP,
                                     trainable_mask=prompt_only_mask(model))
        state = TrainState(model, opt, sched)
        for _ in range(WARM_STEPS):
            state, stats = step(state, batch)
        loss_first = float(stats["Loss/total"])
        before = profiling.counters()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, stats = step(state, batch)
        sync()
        dt = (time.perf_counter() - t0) / steps
        loss_last = float(stats["Loss/total"])
        tflops = B * JAX_FWD_GFLOP_PER_FRAME * JAX_BWD_FACTOR / dt / 1e3
        row = {"metric": "vipt_train_step", "batch": B, "steps_timed": steps,
               "loss_first": loss_first, "loss_last": loss_last,
               "ms_per_step": dt * 1e3, "samples_per_s": B / dt, "model_tflops": tflops,
               "mfu_vs_bf16_peak": tflops / PEAK_BF16_TFLOPS,
               "launches_per_step": {k: n / steps for k, n in
                                     profiling.launches(COUNTERS, before).items()},
               "device": str(device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del state, batch, opt
    return rows


def port_gflop_per_frame(cfg) -> dict:
    """The port's own count at B=1: one forward with CE, and one
    prompt-only forward + loss + backward, on the meta device (f32; the
    kernels' products count alike)."""
    meta = torch.device("meta")
    Tz, Tx, stride, keep, mask_z = geometry(cfg, meta)
    model = build_viptrack(cfg, device=meta)
    batch = {"template": torch.zeros((1, Tz, Tz, 6), device=meta),
             "search": torch.zeros((1, Tx, Tx, 6), device=meta),
             "search_anno": torch.full((1, 4), 0.3, device=meta)}
    fwd = flops_estimate(lambda: model(batch["template"], batch["search"], mask_z, keep))
    build_optimizer(model, lr=LR, trainable_mask=prompt_only_mask(model))   # requires_grad

    def fwd_bwd():
        loss, _ = vipt_forward_and_loss(model, batch, box_mask_z=mask_z,
                                        ce_keep_lens=keep, search_size=Tx, stride=stride)
        loss.backward()

    return {"forward": fwd / 1e9, "prompt_only_fwd_bwd": flops_estimate(fwd_bwd) / 1e9}


def main(argv=None) -> int:
    optouts.refuse("mmtrack_torch.train.bench_train")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    cfg = vipt_experiment_config("deep_rgbd")
    rows = bench_train(cfg, args.batches, args.steps)
    best = max(rows, key=lambda r: r["samples_per_s"])
    print(json.dumps({"metric": "vipt_train_best", "samples_per_s": best["samples_per_s"],
                      "ms_per_step": best["ms_per_step"],
                      "mfu_vs_bf16_peak": best["mfu_vs_bf16_peak"],
                      "dtype": "bf16 compute, f32 params/opt",
                      "flop_basis": (f"JAX's count: {JAX_FWD_GFLOP_PER_FRAME} GFLOP/frame fwd x "
                                     f"{JAX_BWD_FACTOR} over {PEAK_BF16_TFLOPS} TFLOP/s"),
                      "port_gflop_per_frame": port_gflop_per_frame(cfg),
                      "note": ("fwd+bwd+adamw, prompt-only trainable mask, deep_rgbd "
                               "128/256 crops, one card"),
                      "card": card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
