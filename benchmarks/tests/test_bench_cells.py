"""A cell, a configuration and a traffic mix added as files and entries
alone, run through the harness on the CPU at a tiny size, in a copy of
the benchmark made in a temporary directory: each traffic mode gives a
result line with `correct` true, and `correct` comes out false when the
timed path is broken underneath (tools/readings.py MODE_FAULTS); the harness
refuses to run without the chips a cell asks for, and fails where the
program is missing.

These runs skip the harness's look for a chip (`run.main(...,
require_chip=False)`) and use float32, so the program and the reference
agree to rounding: the tiny cells' limits are 1e-4."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks.tools.readings import MODE_FAULTS

ROOT = Path(__file__).resolve().parents[2]
# mode: (traffic to copy, its end-to-end metric, the cell whose limits name the
# numbers, the metric's unit and direction where no cell reports it yet)
MODES = {"track": ("lockstep_b32_640x480", "track_fps", "vipt_rgbd.track_b32", "frames/s",
                   "higher"),
         "online": ("online_b1_640x480", "frame_ms_p95", "vipt_rgbd.online_b1", "ms", "lower"),
         "train": ("prompt_tune_b32", "train_samples_per_s", "vipt_rgbd.train_b32", "samples/s",
                   "higher")}


def _copy(dst: Path, with_program: bool = True) -> None:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmarks", dst / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if with_program:
        (dst / "mmtrack_torch").symlink_to(ROOT / "mmtrack_torch")


def _add_tiny_cells(dst: Path) -> None:
    """One tiny configuration and a cell per mode, as new files and new
    entries of BENCHMARK.json; no existing file of the benchmark changes."""
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    cfg = json.loads((dst / "benchmarks/configs/vipt_deep_rgbd.json").read_text())
    cfg["name"] = "tiny_vipt"
    cfg["model"].update(embed_dim=64, depth=4, num_heads=1, head_channel=16)
    cfg["template"]["size"], cfg["search"]["size"] = 32, 64
    cfg["ce"].update(loc=[1, 2], keep_ratio=[0.7, 0.7])
    cfg["dtype"] = {"inference": "float32", "train_compute": "float32",
                    "train_params": "float32"}
    (dst / "benchmarks/configs/tiny_vipt.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny_vipt", "source": "https://example.org/tiny",
                             "file": "benchmarks/configs/tiny_vipt.json", "reduced": [],
                             "why": "a throwaway test configuration"})
    for mode, (traffic, metric, real, unit, better) in MODES.items():
        t = json.loads((dst / f"benchmarks/workloads/{traffic}.json").read_text())
        if mode != "train":
            t.update(height=96, width=128, target_side_px=[10, 40], sequence_frames=4,
                     sequences=2, check={"samples": 8, "block": 4, "first_frames": 4})
        if mode == "track":
            t.update(lanes=4, chunk=2, warm_chunks=1)
        elif mode == "online":
            t.update(warm_frames=1)
        else:
            t.update(batch=4)
        (dst / f"benchmarks/workloads/tiny_{mode}.json").write_text(json.dumps(t))
        # float32 on both sides: rounding is all that may part them
        names = json.loads((dst / f"benchmarks/limits/{real}.json").read_text())["limits"]
        (dst / f"benchmarks/limits/tiny.{mode}.json").write_text(
            json.dumps({"limits": {k: 1e-4 for k in names}}))
        bench["workloads"].append({"name": f"tiny.{mode}", "config": "tiny_vipt",
                                   "traffic": f"tiny_{mode}", "chips": 1, "why": "a test"})
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        if metric not in e2e:              # a mode whose metric no cell reports yet
            e2e[metric] = {"name": metric, "unit": unit, "better": better, "bound": 0.25,
                           "source": "host_clock", "workloads": []}
            bench["end_to_end"].append(e2e[metric])
        e2e[metric]["workloads"].append(f"tiny.{mode}")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    dst = tmp_path_factory.mktemp("bench")
    _copy(dst)
    before = {p: p.read_bytes() for p in (dst / "benchmarks").rglob("*") if p.is_file()}
    _add_tiny_cells(dst)
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert not changed, changed
    return dst


def _run(cwd: Path, workload: str, fault: str | None = None, require_chip: bool = False,
         seed: int = 2 ** 31 + 7):
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmarks import run\n"
            "from benchmarks.tools.readings import FAULTS\n"
            f"{'FAULTS[%r]()' % fault if fault else 'pass'}\n"
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', '{seed}', "
            f"'--seconds', '1', '--trace', '0'], require_chip={require_chip}))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_added_cell_runs_correct(tree, mode):
    line = _result(_run(tree, f"tiny.{mode}"))
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"setup_s", MODES[mode][1]} == set(line["metrics"])
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("mode,fault", [(m, f) for m, fs in sorted(MODE_FAULTS.items())
                                        for f in fs])
def test_broken_timed_path_is_not_correct(tree, mode, fault):
    line = _result(_run(tree, f"tiny.{mode}", fault))
    assert line["correct"] is False, line["checks"]


def test_refuses_without_the_chips(tree):
    proc = _run(tree, "vipt_rgbd.track_b32", require_chip=True)
    if proc.returncode == 0:
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_fails_with_only_the_benchmark(tmp_path):
    _copy(tmp_path, with_program=False)
    proc = _run(tmp_path, "vipt_rgbd.track_b32")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
