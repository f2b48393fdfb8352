"""Training entry point of the port: every script of tools/train.py (vipt,
ostrack, dimp, det_dimp, stark, mixformer, siamfc, mdnet, apfnet, kys, lwl,
lwl_box; :25-240, :244-520) on one device or data-parallel over several.

    python -m mmtrack_torch.train.run [--script vipt|ostrack|dimp|det_dimp|stark|mixformer|siamfc|mdnet|apfnet|kys|lwl|lwl_box] \\
        [--stage bbox|score|1|2|3] [--attribute 0-4] [--channels 3|6] --config deep_rgbd \\
        [--synthetic [--synthetic_distractor]] [--init prior.pt|prior.npz] \\
        [--epochs N --batch B --samples S] [--bf16] [--full_tune] [--device cpu] \\
        [--distributed]

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
--script mdnet (MDNet-dual) and apfnet train on 32 positive and 96
negative 107-px patches a sample, cut from 320-px search crops at a
search area of 3; apfnet's --stage 1 (one attribute's fusion branches,
--attribute 0-4), 2 (the aggregation) or 3 (everything, the default)
sets what trains, fc4-fc6 always. --script kys trains the KYS predictor
alone on pairs of consecutive search frames cropped at one box (288 px,
search area 5, at most 5 frames apart), the DiMP base frozen; --channels
6 passes the 6-channel crops, whose DiMP base reads the first three, as
JAX's does. --synthetic_distractor adds a crossing twin of the target to
every synthetic sequence. --script lwl trains LWL (ResNet-50, 16 filters
of size 3, label encoder (16, 32, 64), 5 Gauss-Newton steps) on pairs of
256-px crops at a search area of 6 (the template centred, the search
crop's centre jitter 3.0 and scale jitter 0.25), boxes rasterised to
masks, the Lovász hinge differentiated through the learner, every
parameter trained; --script lwl_box trains its box encoder alone on the
search crops. --channels 6 builds LWL for the 6-channel crops (a
6-channel conv1, as flax infers it from tools/train.py's init). --init
reads a flax .npz of these through the 'mdnet' (mdnet, apfnet), 'dimp'
(kys) and 'lwl' (lwl, lwl_box) bridges. Weights are seeded from --seed.

--distributed (tools/train.py:67-72) trains data-parallel over the
processes torchrun starts, one per card:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m mmtrack_torch.train.run --distributed --script ... [--device cpu]

Each rank joins the group (parallel/mesh.py::init_distributed: NCCL when
every rank has a card of its own, gloo when ranks share a card or run on
the CPU), builds the same seeded model, loader and optimizer, and runs
every script's step on its rows of each global batch, the gradients and
stats averaged over the ranks (train/train_step.py::shard_train_step):
the update is the one-process step's on the whole batch. The batch must
divide by the world size, or the entry refuses. Rank 0 alone prints,
writes checkpoints and the metric log; a resume or a fail-safe restart
reads them on every rank after a barrier.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

SCRIPTS = ("vipt", "ostrack", "dimp", "det_dimp", "stark", "mixformer", "siamfc", "mdnet",
           "apfnet", "kys", "lwl", "lwl_box")

# the zoo's crops (tools/train.py:262-279): template / search size and
# search area factor
ZOO_SIZES = {"stark": dict(template=128, search=320, tf=2.0, sf=5.0),
             "mixformer": dict(template=128, search=320, tf=2.0, sf=5.0),
             "siamfc": dict(template=127, search=255, tf=2.0, sf=4.0),
             "mdnet": dict(template=107, search=320, tf=1.2, sf=3.0),
             "apfnet": dict(template=107, search=320, tf=1.2, sf=3.0),
             "kys": dict(template=288, search=288, tf=5.0, sf=5.0),
             "lwl": dict(template=256, search=256, tf=6.0, sf=6.0),
             "lwl_box": dict(template=256, search=256, tf=6.0, sf=6.0)}
LWL = ("lwl", "lwl_box")
DIMP_IMAGE_SZ = 288
KYS_MAX_GAP = 5                     # frames between KYS's two search frames, at most
# the parameters a score stage trains (tools/train.py:321-347)
SCORE_HEADS = {"stark": "cls_head.", "mixformer": "score_branch."}
# each script's stages, the default first
STAGES = {"stark": ("bbox", "score"), "mixformer": ("bbox", "score"), "apfnet": ("3", "1", "2")}
# the flax bridge --init reads a .npz through (run_ope.FLAX_BRIDGES)
INIT_FAMILY = {"apfnet": "mdnet", "kys": "dimp", "lwl_box": "lwl"}


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
    from mmtrack_torch.utils.optouts import refuse

    refuse("mmtrack_torch.train.run")
    p = argparse.ArgumentParser(description="Train a tracker with the PyTorch port")
    p.add_argument("--script", default="vipt", choices=SCRIPTS)
    p.add_argument("--stage", default=None, choices=["bbox", "score", "1", "2", "3"],
                   help="stark / mixformer: the box stage or the score-head stage; "
                        "apfnet: training stage 1, 2 or 3")
    p.add_argument("--attribute", type=int, default=0, choices=range(5),
                   help="apfnet stage 1: the attribute branch that trains")
    p.add_argument("--channels", type=int, default=3, choices=[3, 6],
                   help="kys, lwl, lwl_box: the crops' channels passed to the network")
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
    p.add_argument("--synthetic_distractor", action="store_true",
                   help="synthetic corpus: a crossing twin of the target in every sequence")
    p.add_argument("--init", default=None, metavar="CHECKPOINT",
                   help="initialize the parameters from a prior stage's .pt or flax .npz")
    p.add_argument("--full_tune", action="store_true",
                   help="train all parameters instead of prompt-only")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (as TRAIN.AMP)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over torchrun's processes (one per card)")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic algorithms only: two runs of the same seeds train "
                        "the same parameters bit for bit")
    args = p.parse_args(argv)
    if args.deterministic:
        from mmtrack_torch.utils.device import set_deterministic

        set_deterministic()
    if args.stage is not None and args.stage not in STAGES.get(args.script, ()):
        raise ValueError(f"--stage {args.stage} is not a stage of --script {args.script} "
                         f"(stages: {STAGES})")

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

    from mmtrack_torch.parallel.mesh import SINGLE, init_distributed, launched_rank

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    shard = SINGLE
    if args.distributed:
        world = launched_rank()[1]
        if cfg.TRAIN.BATCH_SIZE % world:
            raise ValueError(f"--distributed: the batch of {cfg.TRAIN.BATCH_SIZE} does not "
                             f"divide over {world} ranks")
        shard, device = init_distributed(device)
    dtype = torch.bfloat16 if (cfg.TRAIN.AMP or args.bf16) else torch.float32
    try:
        if args.script in ("vipt", "ostrack"):
            return _train_vipt(args, cfg, cfg_name, device, dtype, shard)
        return _train_zoo(args, cfg, device, dtype, shard)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _datasets(args, cfg):
    """(datasets, ratios): the synthetic corpus, or cfg's corpora under
    their roots in ~/.mmtrack_tpu/local.yaml."""
    from mmtrack_torch.data.datasets import SyntheticVideoDataset, names2datasets
    from mmtrack_torch.utils.env import load_env_settings

    if args.synthetic:
        return [SyntheticVideoDataset(n_sequences=8, n_frames=60,
                                      modality=args.synthetic_modality,
                                      distractor=args.synthetic_distractor)], None
    env = load_env_settings()
    names = cfg.DATA.TRAIN.DATASETS_NAME
    return (names2datasets(names, {n: env.dataset_root(n) for n in names}),
            cfg.DATA.TRAIN.DATASETS_RATIO)


def _run(cfg, save_dir: str, step, state, loader, step_for_epoch=None, shard=None) -> int:
    """The epoch loop with checkpoints and a log under `save_dir`; each
    step sharded over `shard`'s ranks, rank 0 alone printing and writing."""
    from mmtrack_torch.parallel.mesh import SINGLE, replicate
    from mmtrack_torch.train.train_step import shard_train_step
    from mmtrack_torch.train.trainer import CheckpointManager, Trainer
    from mmtrack_torch.utils.logging import MetricLogger

    shard = shard or SINGLE
    lead = shard.rank == 0
    if shard.world > 1:
        replicate(state.model, shard)
        step = shard_train_step(step, shard)
        if step_for_epoch is not None:
            by_epoch = step_for_epoch

            def step_for_epoch(epoch):
                return shard_train_step(by_epoch(epoch), shard)
    logger = MetricLogger(os.path.join(save_dir, "logs")) if lead else None
    ckpts = CheckpointManager(os.path.join(save_dir, "checkpoints"),
                              save_interval=cfg.TRAIN.SAVE_EPOCH_INTERVAL,
                              keep_last=max(cfg.TRAIN.SAVE_LAST_N_EPOCH, 2), shard=shard)
    trainer = Trainer(step, state, loader, ckpts, print_interval=cfg.TRAIN.PRINT_INTERVAL,
                      step_for_epoch=step_for_epoch,
                      log_fn=print if lead else (lambda *a: None))
    epoch_fn = trainer.train_epoch
    steps_per_epoch = len(loader)

    def logged_epoch():
        stats = epoch_fn()
        if logger is not None:
            logger.write(trainer.epoch * steps_per_epoch, stats, epoch=trainer.epoch)
        return stats

    trainer.train_epoch = logged_epoch
    trainer.train(cfg.TRAIN.EPOCH, load_latest=True, fail_safe=True)
    if lead:
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


def build_zoo_model(script: str, stage: str, seed: int, device,
                    channels: int = 3) -> torch.nn.Module:
    """The seeded model a zoo script trains (tools/train.py:300-412,
    :413-428, :496-500): 6-channel, but KYS, whose DiMP base reads RGB, and
    LWL, built for `channels`."""
    from mmtrack_torch.models.vipt import init_weights

    if script in LWL:
        from mmtrack_torch.models.lwl import LWLNet, init_lwl_weights

        model = LWLNet(filter_size=3, num_filters=16, label_encoder_dims=(16, 32, 64),
                       optim_iter=5, use_box_encoder=script == "lwl_box", in_channels=channels)
        return init_lwl_weights(model, seed).to(device)
    if script in ("dimp", "det_dimp", "kys"):
        from mmtrack_torch.models.dimp import DiMPNet, init_dimp_weights
        from mmtrack_torch.models.kys import build_kysnet

        model = (build_kysnet() if script == "kys"
                 else DiMPNet(merge_type="max" if script == "det_dimp" else None))
        return init_dimp_weights(model, seed).to(device)
    if script in ("mdnet", "apfnet"):
        from mmtrack_torch.models.apfnet import APFNet
        from mmtrack_torch.models.mdnet import MDNet

        model = APFNet() if script == "apfnet" else MDNet(mode="dual")
        return init_weights(model, seed).to(device)
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


def zoo_trainable_mask(model: torch.nn.Module, script: str, stage: str, attribute: int = 0):
    """The trainable set of a script's stage (None: every parameter
    trains): a score stage's head, APFNet's stage (stage 1: `attribute`'s
    branches), KYS's predictor, LWL-box's box encoder."""
    from mmtrack_torch.train.optim import prefix_mask

    if script == "lwl_box":
        return prefix_mask(model, "box_label_encoder.")
    if script == "apfnet":
        from mmtrack_torch.models.apfnet import stage_mask

        return stage_mask(model, int(stage), attribute if stage == "1" else None)
    if script == "kys":
        return prefix_mask(model, "predictor.")
    if stage != "score":
        return None
    mask = prefix_mask(model, SCORE_HEADS[script])
    if not any(mask.values()):
        raise ValueError(f"{script} has no {SCORE_HEADS[script]}* parameters: "
                         "the score stage would freeze everything")
    return mask


def make_zoo_step(script: str, stage: str, seed: int, dtype: torch.dtype, channels: int = 3):
    from mmtrack_torch.train import zoo_actors
    from mmtrack_torch.train.dimp_actor import make_dimp_train_step

    if script in ("dimp", "det_dimp"):
        return make_dimp_train_step(image_sz=DIMP_IMAGE_SZ, seed=seed, dtype=dtype)
    if script in ("mdnet", "apfnet"):
        return zoo_actors.make_mdnet_train_step(seed=seed, dtype=dtype)
    if script == "kys":
        return zoo_actors.make_kys_train_step(ZOO_SIZES["kys"]["search"], channels=channels,
                                              dtype=dtype)
    if script in LWL:
        make = (zoo_actors.make_lwl_box_train_step if script == "lwl_box"
                else zoo_actors.make_lwl_train_step)
        return make(ZOO_SIZES[script]["search"], ZOO_SIZES[script]["tf"], channels=channels,
                    dtype=dtype)
    if script == "stark":
        return zoo_actors.make_stark_train_step(stage, dtype=dtype)
    if script == "mixformer":
        return zoo_actors.make_mixformer_train_step(stage, dtype=dtype)
    return zoo_actors.make_siamfc_train_step(ZOO_SIZES["siamfc"]["search"], dtype=dtype)


def zoo_processing(script: str):
    """The crops of a zoo script (tools/train.py:262-297, :461-466)."""
    from mmtrack_torch.data.processing import KYSPairProcessing, ViPTProcessing

    if script == "kys":
        return KYSPairProcessing(search_area_factor=ZOO_SIZES["kys"]["sf"],
                                 output_sz=ZOO_SIZES["kys"]["search"])
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
    script's crops, cfg.DATA.TRAIN.SAMPLE_PER_EPOCH samples an epoch;
    KYS's samples hold two search frames at most KYS_MAX_GAP apart."""
    from mmtrack_torch.data.loader import BatchLoader, collate, collate_pair
    from mmtrack_torch.data.sampler import TrackingSampler

    kys = script == "kys"
    max_gap = cfg.DATA.MAX_SAMPLE_INTERVAL
    sampler = TrackingSampler(datasets, ratios,
                              samples_per_epoch=cfg.DATA.TRAIN.SAMPLE_PER_EPOCH,
                              max_gap=min(max_gap, KYS_MAX_GAP) if kys else max_gap,
                              num_search_frames=2 if kys else 1,
                              processing=zoo_processing(script), seed=seed)
    return BatchLoader(sampler, cfg.TRAIN.BATCH_SIZE,
                       collate_fn=collate_pair if kys else collate)


def _train_zoo(args, cfg, device, dtype, shard) -> int:
    """tools/train.py's _train_dimp (:454-520) and the stark / mixformer /
    siamfc / kys / lwl / lwl_box / mdnet / apfnet branches of _train_zoo
    (:244-452)."""
    loader = zoo_loader(args.script, *_datasets(args, cfg), cfg, args.seed)
    dimp = args.script in ("dimp", "det_dimp")
    stage = args.stage or STAGES.get(args.script, ("",))[0]
    model = build_zoo_model(args.script, stage, args.seed, device, args.channels)
    if args.init:
        if dimp:
            raise ValueError("--init: tools/train.py's DiMP branch takes no prior stage")
        load_init(model, args.init, INIT_FAMILY.get(args.script, args.script))
    trainable = zoo_trainable_mask(model, args.script, stage, args.attribute)
    if trainable is not None:
        from mmtrack_torch.train.optim import count_trainable

        print(f"{args.script} {stage or 'base'} stage: "
              f"{count_trainable(model, trainable) / 1e6:.2f}M trainable parameters")
    state = train_state(model, cfg, len(loader), trainable)
    save_dir = os.path.join(args.save_dir, args.script if dimp
                            else f"{args.script}-{stage or 'base'}")
    return _run(cfg, save_dir, make_zoo_step(args.script, stage, args.seed, dtype,
                                             args.channels), state, loader, shard=shard)


def _train_vipt(args, cfg, cfg_name: str, device, dtype, shard) -> int:
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

    return _run(cfg, save_dir, step_for_epoch(1), state, loader, step_for_epoch, shard)


if __name__ == "__main__":
    raise SystemExit(main())
