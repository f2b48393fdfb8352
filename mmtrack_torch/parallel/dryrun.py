"""Data-parallel dry run, port of __graft_entry__.py:36-203
(`dryrun_multichip`):

    python -m mmtrack_torch.parallel.dryrun --n 2 [--toy] [--device cpu]

Spawns n ranks (one process each, joined over a file:// store; NCCL when
every rank has a card of its own, gloo when they share one or run on the
CPU) and runs one prompt-only ViPT training step sharded over them: the
full ViT-B deep_rgbd model by default (bf16 compute on the card, f32 on
the CPU, f32 parameters, drop path, CE keep 0.7) at a global batch of 32,
or with --toy the depth-2 dim-32 model at 2n. The parent then runs the
same step in one process on the same global batch and holds the ranks'
result to JAX's bars there (:148-155): the loss within 1e-3 relative, every
parameter within 1e-3 max |d|. Then it tracks the batch's sequences with
the sharded BatchedViPTTracker (each rank its lanes, the boxes gathered)
against the unsharded one, both holding the sharded step's parameters,
boxes within 1e-2 px (:177-184), and runs track_split over the shards.
Each rank reports the kernel launches of its step and of its tracking,
and its ms/step over a few more steps beside the one-process ms/step. Prints one JSON object; exits non-zero when a bar
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from mmtrack_torch.utils import profiling

LOSS_REL_BAR = 1e-3
PARAM_BAR = 1e-3
BOX_BAR = 1e-2
FULL_BATCH = 32
TIMED_STEPS = 3

TOY = {"MODEL": {"BACKBONE": {"EMBED_DIM": 32, "DEPTH": 2, "NUM_HEADS": 2, "CE_LOC": [1],
                              "CE_KEEP_RATIO": [0.7]},
                 "HEAD": {"NUM_CHANNELS": 16}},
       "DATA": {"TEMPLATE": {"SIZE": 32}, "SEARCH": {"SIZE": 64}},
       "TEST": {"TEMPLATE_SIZE": 32, "SEARCH_SIZE": 64}}


def kernel_counters() -> dict:
    from mmtrack_torch.ops.crop import crop_resize_normalized
    from mmtrack_torch.ops.flash_attn import attn_block_fused, flash_mhsa_qkv
    from mmtrack_torch.ops.mlp_fuse import mlp_block_fused

    return {f.__name__: f for f in (flash_mhsa_qkv, attn_block_fused, mlp_block_fused,
                                    crop_resize_normalized)}


def counted(fn, device) -> tuple[object, dict]:
    """(fn()'s result, the kernel launches counted in it)."""
    before = profiling.counters()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, profiling.launches(kernel_counters().values(), before)


def setup(toy: bool, n: int, device):
    """(cfg, global batch, frames, init boxes, runtime) of the run, the
    same in every process."""
    from mmtrack_torch.config import merge_overrides, vipt_experiment_config
    from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime

    cfg = vipt_experiment_config("deep_rgbd")
    if toy:
        cfg = merge_overrides(cfg, TOY)
    B = 2 * n if toy else FULL_BATCH
    Tz, Tx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    rng = np.random.RandomState(0)
    batch = {"template": rng.randn(B, Tz, Tz, 6).astype(np.float32),
             "search": rng.randn(B, Tx, Tx, 6).astype(np.float32),
             "search_anno": rng.uniform(0.2, 0.4, (B, 4)).astype(np.float32)}
    fh, fw = (96, 128) if toy else (320, 480)
    frames = rng.randint(0, 255, (B, fh, fw, 6)).astype(np.uint8)
    boxes0 = np.tile([fw * 0.25, fh * 0.2, fw * 0.2, fh * 0.18], (B, 1)).astype(np.float32)
    return cfg, batch, frames, boxes0, ViPTRuntime.from_config(cfg)


def compute_dtype(device) -> torch.dtype:
    """bf16 compute on the card (the half-block kernels' precision, as
    TRAIN.AMP), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def train_parts(cfg, device, shard=None):
    """(state, step) of prompt-only training from seed 0, sharded over
    `shard` when given."""
    from mmtrack_torch.models.vipt import build_viptrack, ce_keep_schedule, generate_ctr_mask
    from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask
    from mmtrack_torch.train.train_step import TrainState, make_train_step, shard_train_step

    model = build_viptrack(cfg, dtype=compute_dtype(device), param_dtype=torch.float32,
                           device=device, seed=0)
    opt, sched = build_optimizer(model, lr=4e-4, lr_drop_step=100,
                                 trainable_mask=prompt_only_mask(model))
    stride = cfg.MODEL.BACKBONE.STRIDE
    Tz, Tx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    keep = ce_keep_schedule((Tx // stride) ** 2, cfg.MODEL.BACKBONE.CE_LOC,
                            cfg.MODEL.BACKBONE.CE_KEEP_RATIO)
    mask_z = generate_ctr_mask(Tz // stride, cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, device)
    step = make_train_step(box_mask_z=mask_z, ce_keep_lens=keep, search_size=Tx,
                           stride=stride, seed=0)
    if shard is not None:
        step = shard_train_step(step, shard)
    return TrainState(model, opt, sched), step


def tracker_model(cfg, state_dict: dict, device):
    """A tracking model of the run's compute dtype holding `state_dict`."""
    from mmtrack_torch.models.vipt import build_viptrack

    model = build_viptrack(cfg, dtype=compute_dtype(device), device=device)
    model.load_state_dict(state_dict)
    return model.eval()


def timed_steps(state, step, batch, device) -> float:
    """ms per step over TIMED_STEPS more steps (each ending in a read of
    its loss)."""
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        _, stats = step(state, batch)
        float(stats["Loss/total"])
    return (time.perf_counter() - t0) * 1e3 / TIMED_STEPS


def rank_main(rank: int, n: int, toy: bool, device: str, tmp: str) -> None:
    """One rank: the sharded step, the sharded tracker, timed steps; rank 0
    writes the results for the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
    from mmtrack_torch.parallel.mesh import init_distributed, replicate

    shard, dev = init_distributed(device, init_method=f"file://{tmp}/store")
    cfg, batch, frames, boxes0, rt = setup(toy, n, dev)
    state, step = train_parts(cfg, dev, shard)
    replicate(state.model, shard)
    (state, stats), step_launches = counted(lambda: step(state, batch), dev)
    out = {"rank": rank, "backend": shard.backend, "device": str(dev),
           "stats": {k: float(v) for k, v in stats.items()}, "step_launches": step_launches}
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                   os.path.join(tmp, "params.pt"))
    tracker = BatchedViPTTracker(tracker_model(cfg, state.model.state_dict(), dev), dev, rt,
                                 shard=shard)

    def track():
        tracker.initialize(frames, boxes0)
        return tracker.track(frames)

    (boxes, scores), out["track_launches"] = counted(track, dev)
    boxes2, _ = tracker.track_split(frames[..., :3].copy(), frames[..., 3].copy())
    out.update(boxes=boxes.tolist(), scores=scores.tolist(), split_boxes=boxes2.tolist())
    del tracker
    out["ms_per_step"] = timed_steps(state, step, batch, dev)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    shard.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def run(n: int, toy: bool = False, device: str = "cuda") -> dict:
    """The dry run: n ranks, then the one-process reference in this
    process. Returns the summary; raises AssertionError when a bar fails."""
    import torch.multiprocessing as mp

    from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
    from mmtrack_torch.parallel.mesh import local_device

    dev = local_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(rank_main, args=(n, toy, device, tmp), nprocs=n, join=True,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        sharded_params = torch.load(os.path.join(tmp, "params.pt"), weights_only=True)

    cfg, batch, frames, boxes0, rt = setup(toy, n, dev)
    state, step = train_parts(cfg, dev)
    (state, stats), single_launches = counted(lambda: step(state, batch), dev)
    loss, loss_mesh = float(stats["Loss/total"]), ranks[0]["stats"]["Loss/total"]
    loss_dev = abs(loss_mesh - loss) / max(abs(loss), 1e-8)
    own = state.model.state_dict()
    param_dev = max(float((own[k].detach().cpu().float() - v.float()).abs().max())
                    for k, v in sharded_params.items())
    # the unsharded tracker holds the sharded step's parameters, as JAX's
    # dry run tracks both with the mesh-trained ones (:168-176)
    tracker = BatchedViPTTracker(tracker_model(cfg, sharded_params, dev), dev, rt)
    tracker.initialize(frames, boxes0)
    boxes, scores = tracker.track(frames)
    del tracker
    single_ms = timed_steps(state, step, batch, dev)

    rank_boxes = [np.asarray(r["boxes"]) for r in ranks]
    box_dev = float(np.max(np.abs(rank_boxes[0] - boxes)))
    score_dev = float(np.max(np.abs(np.asarray(ranks[0]["scores"]) - scores)))
    split = np.asarray(ranks[0]["split_boxes"])
    summary = {
        "n": n, "scale": "toy" if toy else "full ViT-B deep_rgbd", "batch": len(batch["search"]),
        "dtype": str(compute_dtype(dev)).replace("torch.", ""), "device": str(dev),
        "backend": ranks[0]["backend"], "loss_sharded": loss_mesh, "loss_single": loss,
        "loss_rel_dev": loss_dev, "params_max_abs_dev": param_dev,
        "eval_boxes_max_abs_dev": box_dev, "eval_scores_max_abs_dev": score_dev,
        "ranks_agree": all(r["stats"] == ranks[0]["stats"] and r["boxes"] == ranks[0]["boxes"]
                           for r in ranks),
        "split_ok": bool(split.shape == boxes.shape and np.isfinite(split).all()),
        "step_launches_per_rank": [r["step_launches"] for r in ranks],
        "track_launches_per_rank": [r["track_launches"] for r in ranks],
        "step_launches_single": single_launches,
        "ms_per_step_per_rank": [r["ms_per_step"] for r in ranks], "ms_per_step_single": single_ms,
        "ranks_seconds": ranks_s}
    failed = [name for name, ok in (
        ("loss", loss_dev < LOSS_REL_BAR), ("params", param_dev < PARAM_BAR),
        ("eval boxes", box_dev < BOX_BAR), ("ranks agree", summary["ranks_agree"]),
        ("track_split", summary["split_ok"]),
        ("finite", np.isfinite(loss_mesh) and np.isfinite(rank_boxes[0]).all())) if not ok]
    if failed:
        raise AssertionError(f"dry run over {n} ranks failed {failed}: {json.dumps(summary)}")
    return summary


def main(argv=None) -> int:
    from mmtrack_torch.utils.optouts import refuse

    refuse("mmtrack_torch.parallel.dryrun")
    p = argparse.ArgumentParser(description="data-parallel dry run of the port")
    p.add_argument("--n", type=int, default=2, help="ranks (processes)")
    p.add_argument("--toy", action="store_true", help="the depth-2 dim-32 model")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    print(json.dumps(run(args.n, args.toy, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
