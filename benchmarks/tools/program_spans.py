"""The program's spans and counters in a track cell, and what tracing
costs, in one process on the card:

    python3 -m benchmarks.tools.program_spans --workload <cell> --seed <n>
        [--seconds 20] [--rounds 1] [--out FILE]

After the cell's set-up: the profiler's window over the cell's traced
work (kernels and busy time per step, as `--trace 1` reads them), then
the program window (benchmarks/program.py) and the readers of
`metrics/` that read it, then `--rounds` rounds of four windows of
`--seconds`, tracing off, on, on, off, each giving `track_fps`. One JSON
line on standard output, appended to --out.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from benchmarks import program
from benchmarks import run as bench_run

METRICS = ("crop_ms.track", "embed_ms.track", "prompt_ms.track", "block_ms.track",
           "ce_block_ms.track", "head_ms.track", "decode_ms.track", "chunk_gap_ms.track",
           "replay_host_ms.track", "graph_nodes_per_step.track")


def measure(name: str, seed: int, seconds: float, rounds: int) -> dict:
    from mmtrack_torch.utils import profiling
    from mmtrack_torch.utils.device import card_line, require_cuda

    from benchmarks.trace import traced

    bench_run._cache_dirs()
    device = require_cuda()
    spec = bench_run.load_cell(name)
    mode = importlib.import_module(f"benchmarks.modes.{spec['traffic']['mode']}")
    run = mode.Cell(spec["cfg"], spec["traffic"], seed, device)
    run.setup()
    torch.cuda.synchronize(device)
    out = {"workload": name, "seed": seed, "card": card_line(), "setup_s": bench_run._since_start()}

    tr, work = traced(device, run.traced_work)
    steps = work["steps"]
    out["profiler"] = {"kernels_per_step": len(tr.kernels) / steps,
                       "busy_ms_per_step": 1e3 * tr.busy_s / steps,
                       "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s)}

    t0 = time.perf_counter()
    snap = program.program_window(run)
    out["program_window_s"] = time.perf_counter() - t0
    ctx = {"cfg": spec["cfg"], "traffic": spec["traffic"], "program": snap}
    out["metrics"] = {m: bench_run.read_metric(m, ctx) for m in METRICS}
    layers = [program.layer_ms(ctx, s) for s in program.LAYER_SPANS]
    out["step_ms"] = program.step_ms(ctx)
    out["layers_sum_ms"] = sum(v for v in layers if v is not None)
    out["captures"] = snap["captures"]
    out["counters"] = {k: v for k, v in snap["counters"].items() if not k.startswith("launches")}
    out["spans"] = len(snap["spans"])

    fps = {"off": [], "on": []}
    for _ in range(rounds):
        for on in (False, True, True, False):
            if on:
                with profiling.tracing():
                    fps["on"].append(run.window(seconds)["metrics"]["track_fps"])
            else:
                fps["off"].append(run.window(seconds)["metrics"]["track_fps"])
    out["track_fps"] = fps
    run.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    line = json.dumps(measure(args.workload, args.seed, args.seconds, args.rounds))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
