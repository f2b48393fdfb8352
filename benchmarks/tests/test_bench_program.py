"""The readers of the program's spans and counters (benchmarks/program.py
and the metric files over it) on a hand-made snapshot: each reads its
value, and returns None where its span or counter never ran, or where
the program has no tracer (a parent commit's); and the program window on
a tiny track cell on the CPU."""

import json
from pathlib import Path

import pytest

from benchmarks import program
from benchmarks import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000
SPAN_METRICS = ["crop_ms.track", "embed_ms.track", "prompt_ms.track", "block_ms.track",
                "ce_block_ms.track", "head_ms.track", "decode_ms.track", "chunk_gap_ms.track",
                "replay_host_ms.track"]


def _span(name, parent, chunk, step, dstart=None, dend=None, start=None, end=None):
    return {"name": name, "parent": parent, "chunk": chunk, "step": step, "start": start,
            "end": end, "dstart": dstart, "dend": dend}


def _snapshot():
    """Two chunks of two steps; a step is 10 ms: crop 1, embed 2, prompt
    3, block 4 (device ms). The second chunk loads 5 ms after the first
    ends, 2 of them in a track.init."""
    spans = []
    t = 0
    for c in range(2):
        if c == 1:
            spans.append(_span("track.init", None, None, None, t + 1 * MS, t + 3 * MS))
            t += 5 * MS
        spans.append(_span("track.load", None, c, None, t, t + MS))
        spans.append(_span("track.replay", None, c, None, start=0, end=(4 + c) * MS))
        replay = len(spans) - 1
        t += MS
        for s in range(2):
            step = len(spans)
            spans.append(_span("vipt.step", replay, c, s, t, t + 10 * MS))
            for name, ms in (("vipt.crop", 1), ("vipt.embed", 2), ("vipt.prompt", 3),
                             ("vipt.block", 4)):
                spans.append(_span(name, step, c, s, t, t + ms * MS))
                t += ms * MS
    return {"spans": spans, "counters": {}, "captures": []}


def _read(name, snap):
    return bench_run.read_metric(name, {"traffic": {"chunk": 16}, "program": snap})


def test_readers_on_a_hand_made_snapshot():
    snap = _snapshot()
    want = {"crop_ms.track": 1.0, "embed_ms.track": 2.0, "prompt_ms.track": 3.0,
            "block_ms.track": 4.0, "ce_block_ms.track": None, "head_ms.track": None,
            "decode_ms.track": None, "chunk_gap_ms.track": 3.0, "replay_host_ms.track": 4.5}
    got = {m: _read(m, snap) for m in SPAN_METRICS}
    assert got == pytest.approx(want)
    assert program.step_ms({"program": snap}) == pytest.approx(10.0)


@pytest.mark.parametrize("name", SPAN_METRICS + ["graph_nodes_per_step.track"])
def test_readers_find_nothing(name, monkeypatch):
    from mmtrack_torch.utils import profiling

    monkeypatch.setattr(profiling, "captures", lambda: [])
    for snap in (None, {"spans": [], "counters": {}, "captures": []}):
        assert _read(name, snap) is None
    monkeypatch.delattr(profiling, "captures")           # a program without the counter
    assert _read(name, None) is None


def test_graph_nodes_read_the_untraced_capture(monkeypatch):
    from mmtrack_torch.utils import profiling

    monkeypatch.setattr(profiling, "captures", lambda: [
        {"key": 1, "traced": False, "nodes": 1600, "kernels": 1590},
        {"key": 2, "traced": True, "nodes": 2000, "kernels": 1990}])
    assert _read("graph_nodes_per_step.track", None) == 100.0


def test_program_window_on_a_tiny_cell():
    import torch

    from benchmarks.modes import track

    cfg = json.loads((ROOT / "benchmarks/configs/vipt_deep_rgbd.json").read_text())
    cfg["model"].update(embed_dim=64, depth=4, num_heads=1, head_channel=16)
    cfg["template"]["size"], cfg["search"]["size"] = 32, 64
    cfg["ce"].update(loc=[1, 2], keep_ratio=[0.7, 0.7])
    cfg["dtype"] = {"inference": "float32", "train_compute": "float32",
                    "train_params": "float32"}
    t = json.loads((ROOT / "benchmarks/workloads/lockstep_b32_640x480.json").read_text())
    t.update(height=96, width=128, target_side_px=[10, 40], sequence_frames=4, sequences=2,
             lanes=4, chunk=2, warm_chunks=1, trace={"chunks": 3},
             check={"samples": 8, "block": 4, "first_frames": 4})
    run = track.Cell(cfg, t, 2 ** 31 + 7, torch.device("cpu"))
    run.setup()
    kept = len(run.records)
    snap = program.program_window(run)
    assert len(run.records) == kept                      # nothing kept for the check
    ctx = {"traffic": t, "program": snap}
    steps = [s for s in snap["spans"] if s["name"] == "vipt.step"]
    assert len(steps) == 3 * t["chunk"]
    layers = [program.layer_ms(ctx, s) for s in program.LAYER_SPANS]
    assert all(v is not None and v > 0 for v in layers)
    assert sum(layers) <= program.step_ms(ctx) * 1.0001
