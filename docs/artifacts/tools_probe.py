"""One-off card measurements behind chip_smoke.py's phase 21 and its depth
cut (not a test; one H100, ~4 min for all four):

    python3 docs/artifacts/tools_probe.py split     # phase 21 alone, then phases 3b and 16
                                                    # with the time of their parts
    python3 docs/artifacts/tools_probe.py tools     # phase 21 alone
    python3 docs/artifacts/tools_probe.py profile   # a phase-16 step profiled with and
                                                    # without the host's op events
    python3 docs/artifacts/tools_probe.py overfit   # the wire tool's head overfit at full
                                                    # width, bf16 and f32: clamped cells

`split` wraps chip_smoke's profile_window / profile_chunk / scan_reps and
phase 16's loader, builder and card-vs-CPU steps with timers. `profile`
times a window of the dimp and mixformer-bbox training steps of phase 16
three ways: CPU + CUDA activity and CUDA alone, each under
`profile_window`'s schedule (a warm-up step, then the active one), and
CUDA alone around the one step without a schedule; it prints the kernels
and device ms each saw. `overfit` runs
mmtrack_torch/eval/wire_metric_ab.py's overfit (8 of the 20 x 101
sequences, 600 steps) on deep_rgbd built at bf16 over f32 parameters
(the tool's) and at f32, and prints the share of size and score cells
at the sigmoid's 1e-4 clamp before and after, the losses and the
calibration delta."""
import functools
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
import numpy as np
import torch

import chip_smoke as cs

CLAMP = 1e-4 * (1 + 1e-6)


def out(**kw):
    print(json.dumps(kw), flush=True)


def timer(spent, name, fn):
    @functools.wraps(fn)
    def f(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
    return f


def split(dev):
    from mmtrack_torch.train import run as trun

    cfg = cs.vipt_experiment_config("deep_rgbd")
    rt = cs.ViPTRuntime.from_config(cfg)
    frames, box0 = cs.synthetic_frames(cs.STEPS + 1, np.random.RandomState(0))
    frames = torch.from_numpy(frames).to(dev)
    t0 = time.perf_counter()
    out(part="tools", launches=cs.tools_path(dev, rt, frames, box0),
        s=time.perf_counter() - t0)
    spent = {}
    for name in ("profile_window", "profile_chunk", "scan_reps", "zoo_train_batches",
                 "train_card_vs_cpu"):
        setattr(cs, name, timer(spent, name, getattr(cs, name)))
    trun.build_zoo_model = timer(spent, "build_zoo_model", trun.build_zoo_model)
    model = cs.build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    t0 = time.perf_counter()
    cs.scan_path(rt, dev, model, frames, box0)
    out(part="scan", s=time.perf_counter() - t0, spent=dict(spent))
    del model
    torch.cuda.empty_cache()
    spent.clear()
    t0 = time.perf_counter()
    cs.zoo_train_path(dev)
    out(part="zoo_train", s=time.perf_counter() - t0, spent=dict(spent))


def profile(dev):
    from torch.profiler import ProfilerActivity, profile as prof_, schedule

    from mmtrack_torch.train import run as trun

    cfg = cs.vipt_experiment_config("deep_rgbd")
    for script, stage, B in (("dimp", "", 16), ("mixformer", "bbox", 4)):
        batches = cs.zoo_train_batches(script, B, 2)
        model = trun.build_zoo_model(script, stage, 0, dev)
        state = trun.train_state(model, cfg, 1000, trun.zoo_trainable_mask(model, script, stage))
        step = trun.make_zoo_step(script, stage, 0, torch.float32)
        for batch in batches:
            step(state, batch)
        torch.cuda.synchronize()
        both = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
        for acts, scheduled in ((both, True), ((ProfilerActivity.CUDA,), True),
                                ((ProfilerActivity.CUDA,), False)):
            t0 = time.perf_counter()
            kept = []
            if scheduled:
                with prof_(activities=list(acts), schedule=schedule(wait=0, warmup=1, active=1),
                           on_trace_ready=lambda p: kept.extend(p.key_averages())) as p:
                    step(state, batches[-1])
                    torch.cuda.synchronize()
                    p.step()
                    cs.window_head()
                    t1 = time.perf_counter()
                    step(state, batches[-1])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                    p.step()
            else:
                with prof_(activities=list(acts)) as p:
                    cs.window_head()
                    t1 = time.perf_counter()
                    step(state, batches[-1])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                kept = p.key_averages()
            rows = cs.device_rows(kept)
            dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
            out(part="profile", script=script, stage=stage, B=B,
                activities=[a.name for a in acts], scheduled=scheduled,
                seconds=time.perf_counter() - t0,
                kernels=sum(e.count for e in rows), device_ms=dev_ms, wall_ms=wall * 1e3,
                head_markers=sum(e.count for e in kept if cs.HEAD_MARKER in e.key
                                 and e.self_device_time_total > 0),
                idle_share=1 - dev_ms / (wall * 1e3), card=cs.card_line())
        del model, state, step, batches
        torch.cuda.empty_cache()


def tools(dev):
    cfg = cs.vipt_experiment_config("deep_rgbd")
    rt = cs.ViPTRuntime.from_config(cfg)
    frames, box0 = cs.synthetic_frames(cs.STEPS + 1, np.random.RandomState(0))
    frames = torch.from_numpy(frames).to(dev)
    t0 = time.perf_counter()
    out(part="tools", launches=cs.tools_path(dev, rt, frames, box0),
        s=time.perf_counter() - t0)


def clamped(model, data, rt):
    """Shares of size and score cells at the clamp over every sample."""
    from mmtrack_torch.eval.wire_metric_ab import head_forward

    size, score = [], []
    with torch.no_grad():
        for i in range(data["z"].shape[0]):
            o = head_forward(model, data, i, rt)
            size.append(float((o["size_map"] <= CLAMP).float().mean()))
            score.append(float((o["score_map"] <= CLAMP).float().mean()))
    return float(np.mean(size)), float(np.mean(score))


def overfit(dev):
    from mmtrack_torch.eval import wire_metric_ab as wire

    rt = wire.ViPTRuntime()
    cfg = cs.vipt_experiment_config("deep_rgbd")
    with tempfile.TemporaryDirectory() as root:
        wire.ensure_fixtures(root, 20, 101)
        data = {k: torch.from_numpy(v).to(dev) for k, v in wire.head_crops(root, 8, 101).items()}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = cs.build_viptrack(cfg, dtype=dtype, param_dtype=torch.float32, device=dev,
                                  seed=0)
        before = clamped(model, data, rt)
        t0 = time.perf_counter()
        losses = wire.train_head(model, data, 600, log_every=0)
        train_s = time.perf_counter() - t0
        for p in model.parameters():
            p.requires_grad_(False)
        after = clamped(model, data, rt)
        delta = wire.calibrate_size_bias(model, data)
        out(part="overfit", dtype=name, samples=int(data["z"].shape[0]), steps=600,
            train_s=train_s, losses_every_100=losses[::100] + [losses[-1]],
            clamped_size_score_before=before, clamped_size_score_after=after,
            clamped_size_score_calibrated=clamped(model, data, rt),
            calibration_delta=delta.tolist(), card=cs.card_line())
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    dev = cs.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.load_library()
    for part in sys.argv[1:] or ("split", "profile", "overfit"):
        {"split": split, "tools": tools, "profile": profile, "overfit": overfit}[part](dev)
