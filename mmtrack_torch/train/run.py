"""Training entry point of the port: the vipt and ostrack branches of
tools/train.py (:25-240) on one device.

    python -m mmtrack_torch.train.run [--script vipt|ostrack] --config deep_rgbd \\
        [--synthetic] [--init prior.pt|prior.npz] [--epochs N --batch B --samples S] \\
        [--bf16] [--full_tune] [--device cpu]

--config is an experiment name (deep_rgbd, ...) or a JSON file of
overrides onto deep_rgbd (the yaml-free counterpart of tools/train.py's
YAML path), e.g. {"MODEL": {"BACKBONE": {"DEPTH": 2}}}; the RGB mix of the
OSTrack foundation training is {"DATA": {"TRAIN": {"DATASETS_NAME":
["LASOT", "GOT10K_vottrain"], "DATASETS_RATIO": [1, 1]}}}. Without
--synthetic the datasets are cfg.DATA.TRAIN.DATASETS_NAME, each under its
root in ~/.mmtrack_tpu/local.yaml (utils/env.py; a missing root raises
FileNotFoundError naming that file), sampled at DATASETS_RATIO.

--script vipt tunes the prompts only, unless --full_tune; --script ostrack
(prompt type none) trains every parameter. Both build the model for
6-channel input, as tools/train.py initialises both on 6-channel zeros, so
OSTrack on the 3-channel RGB corpora keeps the auxiliary patch embedding,
which only its weight decay moves. --init overlays a prior stage's
parameters (the trainer's .pt or a flax params .npz) onto the fresh model
by name and prints the missing and unexpected counts. bf16 compute (f32
parameters) when TRAIN.AMP or --bf16. The CE keep rate follows the
quantized cosine anneal, with one train step per quantized rate.
Checkpoints and logs go under <save_dir>/<script>-<config>/. The other
training scripts of tools/train.py (dimp, stark, mixformer, ...) are not
ported yet and are refused.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

SCRIPTS = ("vipt", "ostrack")
# tools/train.py's other scripts, refused by name
UNPORTED_SCRIPTS = ("dimp", "det_dimp", "stark", "mixformer", "siamfc", "mdnet", "apfnet",
                    "kys", "lwl", "lwl_box")


def load_init(model: torch.nn.Module, path: str, family: str) -> tuple[list, list]:
    """Overlay the parameters of `path` (the trainer's .pt or a flax params
    .npz of a `family` model) onto `model` by name, as tools/train.py's
    --init does through load_into: the names both hold are loaded (a shape
    that differs raises), the others stay as they are. Returns (missing,
    unexpected) names."""
    from mmtrack_torch.eval.run_ope import load_checkpoint

    src = load_checkpoint(path, family)
    own = model.state_dict()
    missing = [k for k in own if k not in src]
    unexpected = [k for k in src if k not in own]
    for k in own:
        if k in src and own[k].shape != src[k].shape:
            raise ValueError(f"--init {path}: shape mismatch at {k}: "
                             f"{tuple(own[k].shape)} vs {tuple(src[k].shape)}")
    model.load_state_dict({k: src[k] for k in own if k in src}, strict=False)
    print(f"--init {path}: loaded; missing={len(missing)} unexpected={len(unexpected)}")
    return missing, unexpected


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train ViPT or OSTrack with the PyTorch port")
    p.add_argument("--script", default="vipt", choices=SCRIPTS + UNPORTED_SCRIPTS)
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
    p.add_argument("--init", default=None, metavar="CHECKPOINT",
                   help="initialize the parameters from a prior stage's .pt or flax .npz")
    p.add_argument("--full_tune", action="store_true",
                   help="train all parameters instead of prompt-only")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (as TRAIN.AMP)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.script not in SCRIPTS:
        raise NotImplementedError(f"--script {args.script}: its training is not ported yet "
                                  "(ROADMAP.md queue 1, zoo training); the port trains "
                                  f"{' and '.join(SCRIPTS)}")

    from mmtrack_torch.config import merge_overrides, vipt_experiment_config
    from mmtrack_torch.data.datasets import SyntheticVideoDataset, names2datasets
    from mmtrack_torch.data.loader import BatchLoader
    from mmtrack_torch.data.processing import from_config as processing_from_config
    from mmtrack_torch.data.sampler import TrackingSampler
    from mmtrack_torch.models.vipt import (
        build_ostrack,
        build_viptrack,
        ce_keep_schedule,
        generate_ctr_mask,
    )
    from mmtrack_torch.train.actor import adjust_keep_rate, quantize_keep_rate
    from mmtrack_torch.train.optim import build_optimizer, count_trainable, prompt_only_mask
    from mmtrack_torch.train.train_step import TrainState, make_train_step
    from mmtrack_torch.train.trainer import CheckpointManager, Trainer
    from mmtrack_torch.utils.env import load_env_settings
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

    device = torch.device(args.device)
    dtype = torch.bfloat16 if (cfg.TRAIN.AMP or args.bf16) else torch.float32
    save_dir = os.path.join(args.save_dir, f"{args.script}-{cfg_name}")

    if args.synthetic:
        datasets = [SyntheticVideoDataset(n_sequences=8, n_frames=60,
                                          modality=args.synthetic_modality)]
        ratios = None
    else:
        env = load_env_settings()
        names = cfg.DATA.TRAIN.DATASETS_NAME
        datasets = names2datasets(names, {n: env.dataset_root(n) for n in names})
        ratios = cfg.DATA.TRAIN.DATASETS_RATIO
    logger = MetricLogger(os.path.join(save_dir, "logs"))
    sampler = TrackingSampler(datasets, ratios,
                              samples_per_epoch=cfg.DATA.TRAIN.SAMPLE_PER_EPOCH,
                              max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
                              processing=processing_from_config(cfg, train_mode=True),
                              seed=args.seed)
    loader = BatchLoader(sampler, cfg.TRAIN.BATCH_SIZE)

    build = build_viptrack if args.script == "vipt" else build_ostrack
    model = build(cfg, dtype=dtype, param_dtype=torch.float32, device=device, seed=args.seed)
    if args.init:
        load_init(model, args.init, args.script)
    stride = cfg.MODEL.BACKBONE.STRIDE
    n_search = (cfg.DATA.SEARCH.SIZE // stride) ** 2
    mask_z = generate_ctr_mask(cfg.DATA.TEMPLATE.SIZE // stride,
                               cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE, device)

    steps_per_epoch = len(loader)
    prompt_only = args.script == "vipt" and not args.full_tune
    trainable = prompt_only_mask(model) if prompt_only else None
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
