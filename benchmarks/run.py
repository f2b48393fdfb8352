"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration, traffic, limits and per-layer metrics are
files found by name (README.md). Set-up (the kernels' build on a
checkout's first run, weights and inputs from the seed, the warm-up and
captures) is timed from the process's start. With --trace 0 the window
runs for --seconds and gives the cell's end-to-end metrics; with --trace 1
a fixed amount of the same work runs under torch.profiler and gives its
per-layer metrics. Then the program's state is freed and the plain
reference recomputes a seeded sample of what the window produced; the
numbers compared, each with its limit, are the last lines on standard
error and the `checks` of the result, which is the last line on standard
output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mmtrack_tpu")
HOST_WINDOW = 0.25    # the share of the traced work run again with the host's ops recorded


def _since_start() -> float:
    """Seconds since this process started (the kernel's start time)."""
    stat = Path("/proc/self/stat").read_text()
    ticks = int(stat.rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - ticks / os.sysconf("SC_CLK_TCK")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The cell's entry, configuration, traffic and limits, and the
    BENCHMARK.json it came from."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"bench": bench, "cell": cell, "cfg": _json(ROOT / entry["file"]),
            "traffic": _json(HERE / "workloads" / f"{cell['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{name}.json")}


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports: the end-to-end ones that name it or
    name no cells; with trace, the per-layer ones that name it, or that
    name no cells and move an end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in moved else [])]


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    """One run of cell `name` on `device`: set-up, the window (or with
    `trace` the traced work), the look for JAX, then the program's state
    freed and the check. With `control` the check also computes the
    control's numbers (tools/readings.py). Returns the cell's spec, the
    metrics' values and units, `setup_s` (since the process started),
    the work, `memory`, `device` (busy_s, window_s), `breakdown`,
    `leaked` (forbidden modules loaded; the check is then not run) and
    `checked` (the check's numbers and what else it reports)."""
    import torch

    from benchmarks import roofline
    from benchmarks.trace import traced

    spec = load_cell(name)
    bench, cell = spec["bench"], spec["cell"]
    on_card = device.type == "cuda"
    if on_card and torch.cuda.is_initialized():      # a later run in one process
        torch.cuda.reset_peak_memory_stats(device)
    mode = importlib.import_module(f"benchmarks.modes.{spec['traffic']['mode']}")
    run = mode.Cell(spec["cfg"], spec["traffic"], seed, device)
    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
    out = {"spec": spec, "setup_s": _since_start(), "device": {}, "breakdown": None}
    wanted = cell_metrics(bench, cell, trace)
    out["units"] = {m["name"]: m["unit"] for m in wanted}
    values = {}
    if trace:
        # the same amount of work untimed by the profiler first: the
        # whole step's share of the peak is read from it, since tracing
        # slows a host-paced step
        t0 = time.perf_counter()
        run.traced_work()
        if on_card:
            torch.cuda.synchronize(device)
        untraced_s = time.perf_counter() - t0
        tr, work = traced(device, run.traced_work)
        ctx = {"cfg": spec["cfg"], "traffic": spec["traffic"], "kernels": tr.kernels,
               "busy_s": tr.busy_s, "window_s": tr.window_s, "untraced_s": untraced_s,
               "peaks": roofline.peaks(torch.cuda.get_device_name(device)), **work}
        for m in wanted:
            v = read_metric(m["name"], ctx)
            if v is not None:
                values[m["name"]] = v
        out["device"] = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        host, _ = traced(device, lambda: run.traced_work(HOST_WINDOW), host_ops=True)
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": host.idle_gaps}
    else:
        work = run.window(seconds)
        values = dict(work["metrics"], setup_s=out["setup_s"])
        missing = set(out["units"]) - set(values)
        if missing:
            raise RuntimeError(f"the window gave no {sorted(missing)}")
    out["values"], out["work"] = values, work
    out["memory"] = torch.cuda.max_memory_reserved(device) if on_card else 0
    out["leaked"] = forbidden_modules()
    run.release()
    if out["leaked"]:
        return out
    t0 = time.perf_counter()
    out["checked"] = run.check(control=control)
    out["check_s"] = time.perf_counter() - t0
    return out


def main(argv=None, require_chip: bool = True) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    cell = load_cell(args.workload)["cell"]

    import torch

    from benchmarks import compare

    if torch.cuda.is_available() and torch.cuda.device_count() >= cell["chips"]:
        device = torch.device("cuda", 0)
    elif require_chip:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    else:
        device = torch.device("cpu")
    on_card = device.type == "cuda"
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    if out["leaked"]:
        print(f"the run loaded {out['leaked']}: the benchmark may not load JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    checked, units, values = out["checked"], out["units"], out["values"]
    limits = out["spec"]["limits"]["limits"]
    correct = compare.verdict(checked["numbers"], limits)
    checks = compare.lines(checked["numbers"], limits)
    print(f"reference check: {checked['compared']} compared in {out['check_s']:.1f} s",
          file=sys.stderr)
    result = {
        "correct": bool(correct), "attempted": out["work"]["attempted"], "failed": 0,
        "metrics": {k: {"value": values[k], "unit": units[k]} for k in units if k in values},
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(out["memory"]),
                   **out["device"]},
    }
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
