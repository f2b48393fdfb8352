"""The prompt step kernels' roofline count (metrics/prompt_roofline.track.py):
bytes and operations a tracking step, one entry a launch, and the reader
on a made-up window."""

import importlib.util
import json
import math
from pathlib import Path

import pytest

from benchmarks import roofline

ROOT = Path(__file__).resolve().parents[2]
BATCH = 32


def _metric():
    path = ROOT / "benchmarks/metrics/prompt_roofline.track.py"
    spec = importlib.util.spec_from_file_location("_prompt_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(name):
    return json.loads((ROOT / "benchmarks/configs" / f"{name}.json").read_text())


def test_vipt_deep_step_moves_661_mb_in_24_launches():
    calls = _metric().step_calls(_cfg("vipt_deep_rgbd"), BATCH)
    assert len(calls) == 24                     # two launches a block, 12 blocks
    C, grid = 768, 320
    # tokens entering each block: 320 up to the first CE (block 3), then 244, 190, 153
    entering = [320] * 4 + [244] * 3 + [190] * 3 + [153] * 2
    rows = 4 * grid + sum(2 * la + 2 * grid for la in entering[1:])
    assert sum(b for _, b in calls) == BATCH * C * 2 * rows == 661_389_312
    assert sum(o for o, _ in calls) == 12 * 2 * BATCH * grid * (2 * 8 * C + 8 * C)
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert all(b / pk["hbm_bytes_per_s"] > o / pk["bf16_flops"] for o, b in calls)


def test_vipt_shaw_has_block_zero_alone():
    cfg = _cfg("vipt_deep_rgbd")
    cfg["model"]["prompt_type"] = "vipt_shaw"
    calls = _metric().step_calls(cfg, BATCH)
    assert len(calls) == 2 and sum(b for _, b in calls) == BATCH * 768 * 2 * 4 * 320


def _ctx(cfg, kernels, steps=16):
    return {"cfg": cfg, "batch": BATCH, "steps": steps, "kernels": kernels,
            "peaks": roofline.peaks("NVIDIA H100 80GB HBM3")}


def test_reader_gives_none_without_prompts():
    metric = _metric()
    cfg = _cfg("ostrack_vitb_384_ce")
    assert metric.step_calls(cfg, 16) == []
    assert metric.read(_ctx(cfg, [("void prompt_proj_kernel<3>", 0, 1000)])) is None
    assert metric.read(_ctx(_cfg("vipt_deep_rgbd"), [("gemm_bf16_kernel", 0, 1000)])) is None


@pytest.mark.parametrize("lost", [0, 3, 4])
def test_reader_share_over_the_launches_found(lost):
    """The calls' bound over the kernels' device time; None once more than
    1 % of the launches are missing."""
    metric = _metric()
    cfg, steps = _cfg("vipt_deep_rgbd"), 16
    calls = metric.step_calls(cfg, BATCH) * steps
    names = ["void prompt_proj_kernel<3>(Params, int)", "void prompt_out_kernel<3>(Params)"]
    kernels = [(names[k % 2], k, 40_000) for k in range(len(calls) - lost)]
    got = metric.read(_ctx(cfg, kernels, steps))
    if lost > 0.01 * len(calls):
        assert got is None
        return
    bound = sum(roofline.bound_s(o, b, roofline.peaks("NVIDIA H100 80GB HBM3")) for o, b in calls)
    device_s = len(kernels) * 40e-6
    assert math.isclose(got, 100.0 * bound / device_s * len(kernels) / len(calls))
