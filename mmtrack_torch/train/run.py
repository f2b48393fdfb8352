"""Training entry point of the port: the vipt, ostrack, dimp, det_dimp,
stark, mixformer and siamfc branches of tools/train.py (:25-240, :244-520)
on one device.

    python -m mmtrack_torch.train.run [--script vipt|ostrack|dimp|det_dimp|stark|mixformer|siamfc] \\
        [--stage bbox|score] --config deep_rgbd [--synthetic] [--init prior.pt|prior.npz] \\
        [--epochs N --batch B --samples S] [--bf16] [--full_tune] [--device cpu]

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
Checkpoints and logs go under <save_dir>/<script>-<config>/.

The zoo scripts take only the data settings of --config (datasets, ratios,
sample interval, samples per epoch) and its TRAIN settings; their crops
are tools/train.py's own. --script dimp / det_dimp train DiMP-50 / DeT-max
(two ResNet-50s) for 6-channel input on 288-px crops at a search area of
5 (centre jitter 0.25 / 3.0, scale jitter 0 / 0.25), with the IoU-MSE +
LBHinge objective (train/dimp_actor.py); checkpoints under
<save_dir>/<script>/. --script stark / mixformer (128 / 320 crops) and
siamfc (127 / 255) train the 6-channel models of train/zoo_actors.py;
--stage score (stark, mixformer; default bbox) trains only the score head
(STARK's cls_head, MixFormer's score_branch), usually from --init of the
bbox stage; checkpoints under <save_dir>/<script>-<stage or 'base'>/.
Weights are seeded from --seed. The other scripts of tools/train.py
(mdnet, apfnet, kys, lwl, lwl_box) are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

SCRIPTS = ("vipt", "ostrack", "dimp", "det_dimp", "stark", "mixformer", "siamfc")
# tools/train.py's other scripts, refused by name
UNPORTED_SCRIPTS = ("mdnet", "apfnet", "kys", "lwl", "lwl_box")

# the zoo's crops (tools/train.py:262-279): template / search size and
# search area factor
ZOO_SIZES = {"stark": dict(template=128, search=320, tf=2.0, sf=5.0),
             "mixformer": dict(template=128, search=320, tf=2.0, sf=5.0),
             "siamfc": dict(template=127, search=255, tf=2.0, sf=4.0)}
DIMP_IMAGE_SZ = 288
# the parameters a score stage trains (tools/train.py:321-347)
SCORE_HEADS = {"stark": "cls_head.", "mixformer": "score_branch."}


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
    p = argparse.ArgumentParser(description="Train a tracker with the PyTorch port")
    p.add_argument("--script", default="vipt", choices=SCRIPTS + UNPORTED_SCRIPTS)
    p.add_argument("--stage", default=None, choices=["bbox", "score"],
                   help="stark / mixformer: the box stage or the score-head stage")
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
                                  f"{', '.join(SCRIPTS)}")
    if args.stage is not None and args.script not in SCORE_HEADS:
        raise ValueError(f"--stage is for {' and '.join(SCORE_HEADS)}, not --script {args.script}")

    from mmtrack_torch.config import merge_overrides, vipt_experiment_config

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
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    dtype = torch.bfloat16 if (cfg.TRAIN.AMP or args.bf16) else torch.float32
    if args.script in ("vipt", "ostrack"):
        return _train_vipt(args, cfg, cfg_name, device, dtype)
    return _train_zoo(args, cfg, device, dtype)


def _datasets(args, cfg):
    """(datasets, ratios): the synthetic corpus, or cfg's corpora under
    their roots in ~/.mmtrack_tpu/local.yaml."""
    from mmtrack_torch.data.datasets import SyntheticVideoDataset, names2datasets
    from mmtrack_torch.utils.env import load_env_settings

    if args.synthetic:
        return [SyntheticVideoDataset(n_sequences=8, n_frames=60,
                                      modality=args.synthetic_modality)], None
    env = load_env_settings()
    names = cfg.DATA.TRAIN.DATASETS_NAME
    return (names2datasets(names, {n: env.dataset_root(n) for n in names}),
            cfg.DATA.TRAIN.DATASETS_RATIO)


def _run(cfg, save_dir: str, step, state, loader, step_for_epoch=None) -> int:
    """The epoch loop with checkpoints and a log under `save_dir`."""
    from mmtrack_torch.train.trainer import CheckpointManager, Trainer
    from mmtrack_torch.utils.logging import MetricLogger

    logger = MetricLogger(os.path.join(save_dir, "logs"))
    ckpts = CheckpointManager(os.path.join(save_dir, "checkpoints"),
                              save_interval=cfg.TRAIN.SAVE_EPOCH_INTERVAL,
                              keep_last=max(cfg.TRAIN.SAVE_LAST_N_EPOCH, 2))
    trainer = Trainer(step, state, loader, ckpts, print_interval=cfg.TRAIN.PRINT_INTERVAL,
                      step_for_epoch=step_for_epoch)
    epoch_fn = trainer.train_epoch
    steps_per_epoch = len(loader)

    def logged_epoch():
        stats = epoch_fn()
        logger.write(trainer.epoch * steps_per_epoch, stats, epoch=trainer.epoch)
        return stats

    trainer.train_epoch = logged_epoch
    trainer.train(cfg.TRAIN.EPOCH, load_latest=True, fail_safe=True)
    print(f"done: {trainer.epoch} epochs, checkpoints in {save_dir}")
    return 0


def train_state(model, cfg, steps_per_epoch: int, trainable=None):
    """TrainState of `model` with cfg.TRAIN's AdamW, clip and step
    schedule over the `trainable` mask (None: every parameter)."""
    from mmtrack_torch.train.optim import build_optimizer
    from mmtrack_torch.train.train_step import TrainState

    opt, sched = build_optimizer(model, lr=cfg.TRAIN.LR, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                                 lr_drop_step=cfg.TRAIN.LR_DROP_EPOCH * steps_per_epoch,
                                 decay_rate=cfg.TRAIN.SCHEDULER.DECAY_RATE,
                                 grad_clip_norm=cfg.TRAIN.GRAD_CLIP_NORM,
                                 trainable_mask=trainable)
    return TrainState(model, opt, sched)


def build_zoo_model(script: str, stage: str, seed: int, device) -> torch.nn.Module:
    """The seeded 6-channel model a zoo script trains (tools/train.py:
    300-352, :496-500)."""
    from mmtrack_torch.models.vipt import init_weights

    if script in ("dimp", "det_dimp"):
        from mmtrack_torch.models.dimp import DiMPNet, init_dimp_weights

        model = DiMPNet(merge_type="max" if script == "det_dimp" else None)
        return init_dimp_weights(model, seed).to(device)
    if script == "stark":
        from mmtrack_torch.models.stark import STARK

        model = STARK(six_channel=True, score_head=stage == "score", device=device)
    elif script == "mixformer":
        from mmtrack_torch.models.mixformer import build_mixformer_rgbd

        model = build_mixformer_rgbd(device=device)
    else:
        from mmtrack_torch.models.siamfc import SiamFC

        model = SiamFC(device=device)
    return init_weights(model, seed)


def zoo_trainable_mask(model: torch.nn.Module, script: str, stage: str):
    """The score stage's trainable set (None: every parameter trains)."""
    from mmtrack_torch.train.optim import prefix_mask

    if stage != "score":
        return None
    mask = prefix_mask(model, SCORE_HEADS[script])
    if not any(mask.values()):
        raise ValueError(f"{script} has no {SCORE_HEADS[script]}* parameters: "
                         "the score stage would freeze everything")
    return mask


def make_zoo_step(script: str, stage: str, seed: int, dtype: torch.dtype):
    from mmtrack_torch.train import zoo_actors
    from mmtrack_torch.train.dimp_actor import make_dimp_train_step

    if script in ("dimp", "det_dimp"):
        return make_dimp_train_step(image_sz=DIMP_IMAGE_SZ, seed=seed, dtype=dtype)
    if script == "stark":
        return zoo_actors.make_stark_train_step(stage, dtype=dtype)
    if script == "mixformer":
        return zoo_actors.make_mixformer_train_step(stage, dtype=dtype)
    return zoo_actors.make_siamfc_train_step(ZOO_SIZES["siamfc"]["search"], dtype=dtype)


def zoo_processing(script: str):
    """The crops of a zoo script (tools/train.py:262-297, :461-466)."""
    from mmtrack_torch.data.processing import ViPTProcessing

    if script in ("dimp", "det_dimp"):
        sizes = dict(template=DIMP_IMAGE_SZ, search=DIMP_IMAGE_SZ, tf=5.0, sf=5.0)
        jitter = (0.25, 3.0)
    else:
        sizes = ZOO_SIZES[script]
        jitter = (0.0, 0.5 if script == "siamfc" else 3.0)
    return ViPTProcessing(
        search_area_factor={"template": sizes["tf"], "search": sizes["sf"]},
        output_sz={"template": sizes["template"], "search": sizes["search"]},
        center_jitter_factor={"template": jitter[0], "search": jitter[1]},
        scale_jitter_factor={"template": 0.0, "search": 0.25})


def zoo_loader(script: str, datasets, ratios, cfg, seed: int):
    """Batches of cfg.TRAIN.BATCH_SIZE pairs of the datasets through the
    script's crops, cfg.DATA.TRAIN.SAMPLE_PER_EPOCH samples an epoch."""
    from mmtrack_torch.data.loader import BatchLoader
    from mmtrack_torch.data.sampler import TrackingSampler

    sampler = TrackingSampler(datasets, ratios,
                              samples_per_epoch=cfg.DATA.TRAIN.SAMPLE_PER_EPOCH,
                              max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
                              processing=zoo_processing(script), seed=seed)
    return BatchLoader(sampler, cfg.TRAIN.BATCH_SIZE)


def _train_zoo(args, cfg, device, dtype) -> int:
    """tools/train.py's _train_dimp (:454-520) and the stark / mixformer /
    siamfc branches of _train_zoo (:244-452)."""
    loader = zoo_loader(args.script, *_datasets(args, cfg), cfg, args.seed)
    dimp = args.script in ("dimp", "det_dimp")
    stage = args.stage or ("bbox" if args.script in SCORE_HEADS else "")
    model = build_zoo_model(args.script, stage, args.seed, device)
    if args.init:
        if dimp:
            raise ValueError("--init: tools/train.py's DiMP branch takes no prior stage")
        load_init(model, args.init, args.script)
    trainable = zoo_trainable_mask(model, args.script, stage)
    if trainable is not None:
        from mmtrack_torch.train.optim import count_trainable

        print(f"{args.script} {stage} stage: "
              f"{count_trainable(model, trainable) / 1e6:.2f}M trainable parameters")
    state = train_state(model, cfg, len(loader), trainable)
    save_dir = os.path.join(args.save_dir, args.script if dimp
                            else f"{args.script}-{stage or 'base'}")
    return _run(cfg, save_dir, make_zoo_step(args.script, stage, args.seed, dtype),
                state, loader)


def _train_vipt(args, cfg, cfg_name: str, device, dtype) -> int:
    """tools/train.py's vipt and ostrack branches (:25-240)."""
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
    from mmtrack_torch.train.optim import count_trainable, prompt_only_mask
    from mmtrack_torch.train.train_step import make_train_step

    save_dir = os.path.join(args.save_dir, f"{args.script}-{cfg_name}")
    datasets, ratios = _datasets(args, cfg)
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

    prompt_only = args.script == "vipt" and not args.full_tune
    trainable = prompt_only_mask(model) if prompt_only else None
    if trainable is not None:
        n = count_trainable(model, trainable)
        print(f"prompt-only tuning: {n / 1e6:.2f}M trainable parameters")
    state = train_state(model, cfg, len(loader), trainable)

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

    return _run(cfg, save_dir, step_for_epoch(1), state, loader, step_for_epoch)


if __name__ == "__main__":
    raise SystemExit(main())
