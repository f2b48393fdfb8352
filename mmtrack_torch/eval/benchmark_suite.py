"""Modality benchmark sweep: a suite of recipes over one dataset, port of
tools/benchmark_suite.py (the reference's top-level drivers,
RGBD/benchmark.py:6-62, RGBT/benchmark.py:5-39, RGBE/benchmark.py:5-49).

    python -m mmtrack_torch.eval.benchmark_suite --modality rgbt --dataset LasHeR
    python -m mmtrack_torch.eval.benchmark_suite --modality rgbe --synthetic
    python -m mmtrack_torch.eval.benchmark_suite --trackers siamfc,vipt_deep_rgbt --synthetic

Each recipe of the port's registry runs over the dataset's sequences
(skipping a sequence whose result file exists), then OPE and F-score
analysis; one consolidated <results_root>/<dataset>/suite_report.json
holds SR and PR (percent, 2 decimals) and F (4 decimals) per recipe, as
the JAX tool writes it. A disk sequence is composed as the recipe asks,
as run_ope --tracker composes it, so each recipe's line equals its own
`run_ope --tracker <name> --analyze` report. The device defaults to the
card (pass --device cpu to run on the CPU); recipes run on seeded weights.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(argv=None) -> int:
    from mmtrack_torch.utils.optouts import refuse

    refuse("mmtrack_torch.eval.benchmark_suite")
    p = argparse.ArgumentParser()
    p.add_argument("--modality", default=None, choices=["rgbd", "rgbt", "rgbe", "rgb"])
    p.add_argument("--trackers", default=None, help="comma-separated names")
    p.add_argument("--dataset", default="SYNTH")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--results_root", default="./workspace/results")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from mmtrack_torch.data.synthetic import make_synthetic_sequence
    from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope
    from mmtrack_torch.eval.datasets import EvalSequence, list_sequences, load_sequence
    from mmtrack_torch.eval.ope import result_path, run_sequence, save_result
    from mmtrack_torch.eval.run_ope import compose_as_recipe
    from mmtrack_torch.registry import TRACKER_REGISTRY, build_tracker, list_trackers
    from mmtrack_torch.utils.device import require_cuda, set_f32_precision
    from mmtrack_torch.utils.env import load_env_settings

    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
        set_f32_precision()
    names = args.trackers.split(",") if args.trackers else list_trackers(args.modality)
    print(f"benchmarking {len(names)} trackers: {names}")

    loaders = None
    if args.synthetic:
        frames, gt = make_synthetic_sequence(n_frames=args.frames, height=240, width=320)
        loaders = {"synth_000": lambda i: frames[i]}

        def sequences(name):
            return [EvalSequence("synth_000", [None] * args.frames, [None] * args.frames, gt)]
    else:
        root = args.dataset_root or load_env_settings().dataset_root(args.dataset)
        dirs = list_sequences(root, args.dataset)

        def sequences(name):
            seqs = [load_sequence(d, args.dataset) for d in dirs]
            compose_as_recipe(seqs, TRACKER_REGISTRY[name].composition)
            return seqs

    report = {}
    for name in names:
        seqs = sequences(name)
        for seq in seqs:
            path = result_path(args.results_root, args.dataset, name, seq.name)
            if os.path.exists(path):
                continue
            tracker = build_tracker(name, device=device)
            res = run_sequence(tracker, seq,
                               frame_loader=None if loaders is None else loaders[seq.name])
            save_result(path, res, fmt=seq.save_fmt, delimiter=seq.save_delimiter)
            print(f"[{name}] {seq.name} fps:{res['fps']:.2f}")
        ope = analyze_ope(seqs, args.results_root, args.dataset, name)
        fs = analyze_fscore(seqs, args.results_root, args.dataset, name)
        report[name] = {
            "SR": round(ope["overall"]["success_auc"] * 100, 2),
            "PR": round(ope["overall"]["precision_20px"] * 100, 2),
            "F": round(fs["fscore"], 4),
        }
        print(f"[{name}] SR {report[name]['SR']} | PR {report[name]['PR']} "
              f"| F {report[name]['F']}")

    out_path = os.path.join(args.results_root, args.dataset, "suite_report.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print("suite report:", out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
