"""OPE evaluation entry of the port for the RGBD/RGBT/RGBE suites, port of
tools/eval_ope.py:28-138:

    python -m mmtrack_torch.eval.run_ope --dataset DepthTrack \\
        --config deep_rgbd [--dataset_root /data/depthtrack] \\
        [--checkpoint ck.pt|params.npz] [--batched 8] [--analyze] [--device cpu]
    python -m mmtrack_torch.eval.run_ope --dataset SYNTH --config deep_rgbd --synthetic

--config is an experiment name (deep_rgbd, ...) or a JSON file of
overrides onto deep_rgbd, as in mmtrack_torch.train.run; the run is named
after the experiment or the file's stem. The precision comes from the
config, as in training: bf16 weights and compute when TRAIN.AMP is set
(`{"TRAIN": {"AMP": true}}`), which runs the attention and MLP
half-block kernels; f32 otherwise, as the experiments ship and as the
JAX entry evaluates, which runs the crop kernel and plain PyTorch for the
blocks. On the card TF32 is off, so f32 products and convolutions are
full f32 (as in the VOT entry). Seeded weights are the same values at
either precision. --checkpoint is the port trainer's file (its "model"
state_dict) or a flax params file (`np.savez(path, params=params)`,
models/convert.py::load_flax_npz), read through the weight bridge of the
model's family (`FLAX_BRIDGES`; OSTrack-online's file also holds the
score head's tree as `cls_params`); an orbax directory, a family
without a bridge and a checkpoint for MOSSE or SCSRDCF (which have no
learned weights) are refused. --tracker takes any of the 42 recipes
of mmtrack_torch/registry.py (`list_trackers()`); a recipe that names its
own composition (promixtrack's rgbd_blend, ostrack_online's color) composes
the dataset's frames so, the others as the dataset does. Without --dataset_root
the root comes from ~/.mmtrack_tpu/local.yaml (utils/env.py).

--batched B advances B sequences in lockstep (eval/batched_ope.py). Disk
'rgbcolormap' batches (DepthTrack, CDTB) stream RGB + the JET-index plane
at 4 B/px and compose on the card; MMTRACK_STREAM=yuv420 opts into raw
4:2:0 planes at 2.5 B/px (needs the native decoder). The entry prints the
decoder (native or cv2) and the wire that ran.

Results go to <results_root>/<dataset>/<run>/<seq>.txt (+ _time.value and
_confidence.value), and with --analyze SR/PR/NPR and the F-score are
printed and written to <results_root>/<dataset>/<run>_report.json, the
layout of the JAX entry. The device defaults to the card; without CUDA the
entry raises (pass --device cpu to run on the CPU).

Under torchrun (`python -m torch.distributed.run --nproc_per_node N -m
mmtrack_torch.eval.run_ope ...`) each process takes its slice of the
dataset's sequences (parallel/mesh.py::process_local_slice, as
tools/eval_ope.py:109 does) on cuda:{LOCAL_RANK % cards}, a card of its
own or a shared one; no process group is needed. --analyze then reports
over that process's sequences, as in JAX, into <run>_report.rank<r>.json.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def load_config(name: str):
    """(cfg, run name) of an experiment name or a JSON file of overrides."""
    from mmtrack_torch.config import merge_overrides, vipt_experiment_config

    if os.path.exists(name):
        with open(name) as f:
            cfg = merge_overrides(vipt_experiment_config("deep_rgbd"), json.load(f))
        return cfg, os.path.splitext(os.path.basename(name))[0]
    return vipt_experiment_config(name), name


# family -> the models/convert.py function that turns its flax params tree
# into the port's state_dict
FLAX_BRIDGES = {"vipt": "vipt_state_dict_from_flax", "ostrack": "vipt_state_dict_from_flax",
                "stark": "stark_state_dict_from_flax", "siamfc": "siamfc_state_dict_from_flax",
                "mixformer": "mixformer_state_dict_from_flax", "dimp": "dimp_state_dict_from_flax",
                "eco": "eco_state_dict_from_flax", "mdnet": "mdnet_state_dict_from_flax",
                "lwl": "lwl_state_dict_from_flax"}


def flax_state_dict(path: str, family: str) -> dict:
    """The port state_dict of a flax params .npz of a `family` model. For
    OSTrack a `cls_params` collection (OSTrack-online's ScoreTransformer)
    joins it under the reference's `cls_head.` prefix."""
    from mmtrack_torch.models import convert

    if family not in FLAX_BRIDGES:
        raise ValueError(f"no flax weight bridge for the '{family}' family "
                         f"(models/convert.py has {sorted(FLAX_BRIDGES)}); pass the port's "
                         ".pt state_dict instead")
    trees = convert.load_flax_collections(path)
    sd = getattr(convert, FLAX_BRIDGES[family])(trees["params"])
    if family == "ostrack" and "cls_params" in trees:
        head = convert.score_head_state_dict_from_flax(trees["cls_params"])
        sd.update({f"cls_head.{k}": v for k, v in head.items()})
    return sd


def load_checkpoint(path: str, family: str = "vipt") -> dict:
    """A state_dict of a `family` model from the port trainer's checkpoint
    or a flax params file."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint?): the port reads the "
                         "trainer's .pt file (mmtrack_torch.train) or a flax params .npz "
                         "written with np.savez(path, params=params)")
    if path.endswith(".npz"):
        return flax_state_dict(path, family)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["model"] if "model" in payload else payload


def compose_as_recipe(seqs, composition: str) -> None:
    """A recipe that names its own composition (ProMixTrack's rgbd_blend,
    OSTrack-online's color) composes the frames of sequences with an X
    plane so; the registry's default, rgbcolormap, keeps the dataset's own
    (the RGB-T and RGB-E suites compose rgbrgb)."""
    if composition == "rgbcolormap":
        return
    for seq in seqs:
        if seq.dtype != "color":
            seq.dtype = composition


def main(argv=None) -> int:
    from mmtrack_torch.utils.optouts import refuse

    refuse("mmtrack_torch.eval.run_ope")
    p = argparse.ArgumentParser(description="OPE evaluation with the PyTorch port")
    p.add_argument("--dataset", required=True,
                   help="LasHeR|RGBT234|GTOT|VTUAV|VisEvent|DepthTrack|CDTB|SYNTH")
    p.add_argument("--config", default="deep_rgbt",
                   help="experiment name (e.g. deep_rgbd) or a JSON file of overrides")
    p.add_argument("--tracker", default=None,
                   help="registry tracker name (overrides --config's ViPT); "
                        "see mmtrack_torch.registry.list_trackers()")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--results_root", default="./workspace/results")
    p.add_argument("--checkpoint", default=None,
                   help="the port trainer's .pt file or a flax params .npz")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batched", type=int, default=0, metavar="B",
                   help="lockstep-batch B sequences per device pass "
                        "(eval/batched_ope.py; ViPT configs only). "
                        "Disk rgbcolormap batches stream rgb+JET-index at "
                        "4 B/px; MMTRACK_STREAM=yuv420 opts into raw 4:2:0 "
                        "planes at 2.5 B/px")
    p.add_argument("--analyze", action="store_true",
                   help="also compute SR/PR/NPR and F-score from the results")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from mmtrack_torch.data.native_io import decoder, load_error
    from mmtrack_torch.data.synthetic import make_synthetic_sequence
    from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope, print_results
    from mmtrack_torch.eval.datasets import EvalSequence, list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_dataset, run_sequence, save_result
    from mmtrack_torch.models.vipt import build_viptrack
    from mmtrack_torch.registry import TRACKER_REGISTRY, WEIGHTLESS, build_tracker
    from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker, make_track_scan
    from mmtrack_torch.utils.device import require_cuda, set_f32_precision
    from mmtrack_torch.utils.env import load_env_settings

    from mmtrack_torch.parallel.mesh import launched_rank, local_device, process_local_slice

    rank, world = launched_rank()
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
        device = local_device(device)
        set_f32_precision()

    if args.tracker and args.tracker not in TRACKER_REGISTRY:
        p.error(f"unknown tracker '{args.tracker}'; options: {sorted(TRACKER_REGISTRY)}")
    if args.batched > 1 and args.tracker:
        p.error("--batched applies to ViPT configs (no --tracker)")

    if args.checkpoint and args.tracker in WEIGHTLESS:
        p.error(f"{args.tracker} has no learned weights; it takes no --checkpoint")
    params = None
    if args.checkpoint:
        family = TRACKER_REGISTRY[args.tracker].family if args.tracker else "vipt"
        params = load_checkpoint(args.checkpoint, family)
    elif args.tracker not in WEIGHTLESS:
        print("WARNING: no checkpoint given; using random init (pipeline check)")

    if args.tracker:
        def tracker_factory():
            return build_tracker(args.tracker, params=params, device=device)
        run_name = args.tracker
    else:
        cfg, run_name = load_config(args.config)
        model = build_viptrack(cfg, dtype=torch.bfloat16 if cfg.TRAIN.AMP else torch.float32,
                               seed=None if params is not None else 0)
        if params is not None:
            model.load_state_dict(params)
        rt = ViPTRuntime.from_config(cfg)

        def tracker_factory():
            return ViPTTracker(model, device, rt)

    if args.synthetic:
        frames, gt = make_synthetic_sequence(n_frames=12, height=240, width=320)
        seqs = [EvalSequence("synth_000", [None] * 12, [None] * 12, gt)]
        loaders = {"synth_000": lambda i: frames[i]}
        for seq in seqs:
            path = result_path(args.results_root, args.dataset, run_name, seq.name)
            if not os.path.exists(path):
                res = run_sequence(tracker_factory(), seq, frame_loader=loaders[seq.name])
                save_result(path, res)
                print(f"{seq.name} , fps:{res['fps']:.2f}")
    else:
        root = args.dataset_root or load_env_settings().dataset_root(args.dataset)
        seq_dirs = list_sequences(root, args.dataset)
        seqs = [load_sequence(d, args.dataset)
                for d in seq_dirs[process_local_slice(len(seq_dirs))]]
        if args.tracker:
            compose_as_recipe(seqs, TRACKER_REGISTRY[args.tracker].composition)
        if args.batched > 1:
            from mmtrack_torch.eval.batched_ope import run_dataset_batched
            from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker

            print(f"decoder: {decoder()}" + (f" ({load_error()})" if load_error() else ""))
            model = model.to(device)
            # one scan for every batch: each frame shape is captured once
            scan = make_track_scan(rt, model, device) if device.type == "cuda" else None
            outputs = run_dataset_batched(
                lambda: BatchedViPTTracker(model, device, rt, scan=scan), seqs,
                args.results_root, args.dataset, run_name, batch_size=args.batched)
            print(f"wire: {sorted({r['wire'] for r in outputs})}")
        else:
            run_dataset(tracker_factory, seqs, args.results_root, args.dataset, run_name)

    if args.analyze:
        report = analyze_ope(seqs, args.results_root, args.dataset, run_name)
        print(print_results(report, run_name))
        fs = analyze_fscore(seqs, args.results_root, args.dataset, run_name)
        print(f"F-score: {fs['fscore']:.4f} (Pr {fs['precision']:.4f} / "
              f"Re {fs['recall']:.4f})")
        out = {"ope": {k: v for k, v in report["overall"].items()
                       if np.isscalar(v)}, "fscore": fs}
        suffix = f".rank{rank}" if world > 1 else ""
        with open(os.path.join(args.results_root, args.dataset,
                               f"{run_name}_report{suffix}.json"), "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
