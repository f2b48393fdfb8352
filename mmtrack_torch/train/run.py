"""ViPT prompt-tuning training entry point of the port: the vipt branch of
tools/train.py (:25-220) on one device.

    python -m mmtrack_torch.train.run --config deep_rgbd --synthetic \\
        [--epochs N --batch B --samples S] [--bf16] [--full_tune] [--device cpu]

--config is an experiment name (deep_rgbd, ...) or a JSON file of
overrides onto deep_rgbd (the yaml-free counterpart of tools/train.py's
YAML path), e.g. {"MODEL": {"BACKBONE": {"DEPTH": 2}}}. Prompt-only tuning
unless --full_tune; bf16 compute (f32 parameters) when TRAIN.AMP or
--bf16. The CE keep rate follows the quantized cosine anneal, with one
train step per quantized rate. Checkpoints and logs go under
<save_dir>/vipt-<config>/. OSTrack training and the other model families
are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train ViPT with the PyTorch port")
    p.add_argument("--config", default="deep_rgbd",
                   help="experiment name (e.g. deep_rgbd) or a JSON file of overrides")
    p.add_argument("--save_dir", default="./workspace")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=None, help="override cfg")
    p.add_argument("--batch", type=int, default=None, help="override cfg")
    p.add_argument("--samples", type=int, default=None,
                   help="override cfg samples per epoch (smoke runs)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (no dataset roots needed)")
    p.add_argument("--synthetic_modality", default="both",
                   choices=["both", "rgb_only", "aux_only"])
    p.add_argument("--full_tune", action="store_true",
                   help="train all parameters instead of prompt-only")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (as TRAIN.AMP)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from mmtrack_torch.config import merge_overrides, vipt_experiment_config
    from mmtrack_torch.data.datasets import SyntheticVideoDataset
    from mmtrack_torch.data.loader import BatchLoader
    from mmtrack_torch.data.processing import from_config as processing_from_config
    from mmtrack_torch.data.sampler import TrackingSampler
    from mmtrack_torch.models.vipt import build_viptrack, ce_keep_schedule, generate_ctr_mask
    from mmtrack_torch.train.actor import adjust_keep_rate, quantize_keep_rate
    from mmtrack_torch.train.optim import build_optimizer, count_trainable, prompt_only_mask
    from mmtrack_torch.train.train_step import TrainState, make_train_step
    from mmtrack_torch.train.trainer import CheckpointManager, Trainer
    from mmtrack_torch.utils.logging import MetricLogger

    if os.path.exists(args.config):
        with open(args.config) as f:
            cfg = merge_overrides(vipt_experiment_config("deep_rgbd"), json.load(f))
        cfg_name = os.path.splitext(os.path.basename(args.config))[0]
    else:
        cfg = vipt_experiment_config(args.config)
        cfg_name = args.config
    if args.epochs:
        cfg.TRAIN.EPOCH = args.epochs
    if args.batch:
        cfg.TRAIN.BATCH_SIZE = args.batch
    if args.samples:
        cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = args.samples
    if not args.synthetic:
        raise NotImplementedError("dataset roots are not wired into the port yet: "
                                  "pass --synthetic")

    device = torch.device(args.device)
    dtype = torch.bfloat16 if (cfg.TRAIN.AMP or args.bf16) else torch.float32
    save_dir = os.path.join(args.save_dir, f"vipt-{cfg_name}")
    logger = MetricLogger(os.path.join(save_dir, "logs"))

    sampler = TrackingSampler(
        [SyntheticVideoDataset(n_sequences=8, n_frames=60, modality=args.synthetic_modality)],
        None,
        samples_per_epoch=cfg.DATA.TRAIN.SAMPLE_PER_EPOCH,
        max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
        processing=processing_from_config(cfg, train_mode=True), seed=args.seed)
    loader = BatchLoader(sampler, cfg.TRAIN.BATCH_SIZE)

    model = build_viptrack(cfg, dtype=dtype, param_dtype=torch.float32, device=device,
                           seed=args.seed)
    stride = cfg.MODEL.BACKBONE.STRIDE
    n_search = (cfg.DATA.SEARCH.SIZE // stride) ** 2
    mask_z = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                               cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, device)

    steps_per_epoch = len(loader)
    trainable = None if args.full_tune else prompt_only_mask(model)
    if trainable is not None:
        n = count_trainable(model, trainable)
        print(f"prompt-only tuning: {n / 1e6:.2f}M trainable parameters")
    opt, sched = build_optimizer(model, lr=cfg.TRAIN.LR, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                                 lr_drop_step=cfg.TRAIN.LR_DROP_EPOCH * steps_per_epoch,
                                 decay_rate=cfg.TRAIN.SCHEDULER.DECAY_RATE,
                                 grad_clip_norm=cfg.TRAIN.GRAD_CLIP_NORM,
                                 trainable_mask=trainable)
    state = TrainState(model, opt, sched)

    steps: dict[float, object] = {}

    def step_for_epoch(epoch: int):
        rate = 1.0
        if cfg.MODEL.BACKBONE.CE_LOC:
            rate = quantize_keep_rate(adjust_keep_rate(
                epoch, cfg.TRAIN.CE_START_EPOCH,
                cfg.TRAIN.CE_START_EPOCH + cfg.TRAIN.CE_WARM_EPOCH,
                base_keep_rate=cfg.MODEL.BACKBONE.CE_KEEP_RATIO[0]))
        if rate not in steps:
            lens = (None if rate >= 1.0 else ce_keep_schedule(
                n_search, cfg.MODEL.BACKBONE.CE_LOC, [rate] * len(cfg.MODEL.BACKBONE.CE_LOC)))
            steps[rate] = make_train_step(
                box_mask_z=mask_z, ce_keep_lens=lens,
                weights=(cfg.TRAIN.GIOU_WEIGHT, cfg.TRAIN.L1_WEIGHT, cfg.TRAIN.FOCAL_WEIGHT),
                search_size=cfg.DATA.SEARCH.SIZE, stride=stride, seed=args.seed)
        return steps[rate]

    ckpts = CheckpointManager(os.path.join(save_dir, "checkpoints"),
                              save_interval=cfg.TRAIN.SAVE_EPOCH_INTERVAL,
                              keep_last=max(cfg.TRAIN.SAVE_LAST_N_EPOCH, 2))
    trainer = Trainer(step_for_epoch(1), state, loader, ckpts,
                      print_interval=cfg.TRAIN.PRINT_INTERVAL, step_for_epoch=step_for_epoch)
    epoch_fn = trainer.train_epoch

    def logged_epoch():
        stats = epoch_fn()
        logger.write(trainer.epoch * steps_per_epoch, stats, epoch=trainer.epoch)
        return stats

    trainer.train_epoch = logged_epoch
    trainer.train(cfg.TRAIN.EPOCH, load_latest=True, fail_safe=True)
    print(f"done: {trainer.epoch} epochs, checkpoints in {save_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
