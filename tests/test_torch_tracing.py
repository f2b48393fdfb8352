"""The port's tracer (mmtrack_torch/utils/profiling.py) on the CPU.

- Off (no tracing(), no profiler): `span` and `chunk` hand back one shared
  no-op context, and nothing is kept or stamped.
- On: spans nest, inherit their chunk and step, and abutting device spans
  share a stamp (the host's clock on the CPU); a tiny ViPT's eager chunk
  gives every step its seven layer spans in order under `vipt.step`, one
  chunk id, the layers covering the step within 2 %.
- Counters: the kernel wrappers count a launch at the call (a stand-in
  library takes the crop kernel's launch) and none for a CPU tensor.
- Under a torch profiler the spans are `record_function` ranges: they show
  in `trace_profile`'s Chrome trace, and every op of a step but views lies
  inside one of its layer ranges.

The stamps on the card, the graph replays and the node counts are in
tests/test_torch_cuda.py (marker cuda).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import statistics
import time

import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.models.vipt import ViPTrack, init_weights  # noqa: E402
from mmtrack_torch.ops import crop  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import (  # noqa: E402
    ViPTRuntime,
    vipt_init_state,
    vipt_track_scan_batched,
)
from mmtrack_torch.utils import profiling  # noqa: E402

LAYERS = ["vipt.crop", "vipt.embed", "vipt.block", "vipt.prompt", "vipt.ce_block", "vipt.head",
          "vipt.decode"]
TINY = dict(embed_dim=64, depth=4, num_heads=1, patch_size=16, template_size=32,
            search_size=64, ce_loc=(1, 2), head_channel=16)
RT = ViPTRuntime(template_size=32, search_size=64, stride=16, ce_loc=(1, 2),
                 ce_keep_ratio=(0.7, 0.7))
VIEWS = {"aten::select", "aten::slice", "aten::as_strided", "aten::view", "aten::expand",
         "aten::unsqueeze", "aten::reshape", "aten::alias", "aten::t", "aten::transpose",
         "aten::permute", "aten::squeeze", "aten::split", "aten::unbind", "aten::chunk",
         "aten::empty", "aten::detach", "aten::lift_fresh"}


@pytest.fixture(scope="module")
def tiny():
    """(model, first frames (2, 96, 128, 6), boxes, a chunk of 4 frames)."""
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (5, 2, 96, 128, 6), generator=g, dtype=torch.uint8)
    boxes = torch.tensor([[40.0, 30.0, 30.0, 24.0], [70.0, 50.0, 24.0, 20.0]])
    return init_weights(ViPTrack(**TINY), 3).eval(), frames[0], boxes, frames[1:]


def _chunk(tiny):
    model, first, boxes, chunk = tiny
    with torch.inference_mode():
        state = vipt_init_state(RT, first, boxes)
        return vipt_track_scan_batched(RT, model, state, chunk)


def test_off_keeps_and_stamps_nothing(tiny, monkeypatch):
    def no_stamp(*a):
        raise AssertionError("stamped with tracing off")

    monkeypatch.setattr(profiling, "_stamp", no_stamp)
    assert not profiling.tracing_on()
    assert profiling.span("vipt.step", torch.device("cuda")) is profiling._NULL
    assert profiling.span("track.replay") is profiling._NULL
    assert profiling.chunk() is profiling._NULL
    before = profiling.counters()
    _chunk(tiny)
    assert profiling.counters() == before
    with profiling.tracing() as tr:
        pass
    assert tr.snapshot()["spans"] == [] and tr.records == [] and tr.books == {}


def _host_tree():
    """Nested spans with sleeps; returns the snapshot."""
    with profiling.tracing() as tr:
        with profiling.chunk():
            with profiling.span("outer", step=3):
                with profiling.span("a", "cpu"):
                    time.sleep(0.002)
                with profiling.span("b", "cpu"):
                    time.sleep(0.001)
                with profiling.span("host"):
                    time.sleep(0.001)
                with profiling.span("c", "cpu"):
                    pass
        with profiling.chunk():
            with profiling.span("next"):
                with profiling.chunk():          # a chunk inside a chunk is the same chunk
                    with profiling.span("inner"):
                        pass
        with pytest.raises(RuntimeError):
            with profiling.tracing():
                pass
    return tr.snapshot()


@pytest.mark.parametrize("case", ["host", "vipt_chunk"])
def test_span_tree(tiny, case):
    if case == "host":
        spans = _host_tree()["spans"]
        by = {s["name"]: s for s in spans}
        assert [s["name"] for s in spans] == ["outer", "a", "b", "host", "c", "next", "inner"]
        assert [s["parent"] for s in spans] == [None, 0, 0, 0, 0, None, 5]
        assert [s["chunk"] for s in spans] == [0, 0, 0, 0, 0, 1, 1]
        assert {s["step"] for s in spans[:5]} == {3} and spans[5]["step"] is None
        assert by["a"]["end"] - by["a"]["start"] >= 2e6
        assert by["b"]["end"] - by["b"]["start"] >= 1e6
        assert by["a"]["dend"] == by["b"]["dstart"]           # abutting: one stamp
        assert by["host"]["dstart"] is None                     # a host span
        assert by["c"]["dstart"] > by["b"]["dend"]              # a host span between
        assert by["outer"]["dstart"] is None and by["outer"]["end"] >= by["c"]["end"]
        return
    _chunk(tiny)                                    # warm
    model, first, boxes, chunk = tiny
    with torch.inference_mode():
        state = vipt_init_state(RT, first, boxes)
        with profiling.tracing() as tr:
            vipt_track_scan_batched(RT, model, state, chunk)
    spans = tr.snapshot()["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "vipt.step"]
    assert [spans[i]["step"] for i in steps] == list(range(chunk.shape[0]))
    assert {s["chunk"] for s in spans} == {0}
    cover = []
    for i in steps:
        kids = [s for s in spans if s["parent"] == i]
        assert list(dict.fromkeys(s["name"] for s in kids)) == LAYERS
        assert all(s["step"] == spans[i]["step"] for s in kids)
        step = spans[i]["dend"] - spans[i]["dstart"]
        cover.append(sum(s["dend"] - s["dstart"] for s in kids) / step)
    assert all(c <= 1.0 for c in cover) and statistics.median(cover) >= 0.98


def test_wrappers_count_their_launches(monkeypatch):
    """A launch counts at the call (the kernel library stood in for, meta
    tensors for the card); a CPU tensor takes the plain version and
    counts nothing."""
    class Library:
        def launch(self, name, *args):
            pass

    monkeypatch.setattr(crop, "load_library", Library)
    monkeypatch.setattr(crop, "stream_handle", lambda dev: 0)
    meta = torch.device("meta")
    args = (torch.zeros(2, 4, dtype=torch.float32), 2.0, 16, torch.zeros(6), torch.ones(6))
    before = profiling.counters()
    for _ in range(3):
        crop.crop_resize_normalized(torch.zeros(2, 24, 32, 6, dtype=torch.uint8, device=meta),
                                    *(a.to(meta) if isinstance(a, torch.Tensor) else a
                                      for a in args))
    crop.crop_resize_normalized(torch.zeros(2, 24, 32, 6, dtype=torch.uint8), *args)
    assert profiling.launches([crop.crop_resize_normalized], before) == {
        "crop_resize_normalized": 3}
    assert profiling.launches([crop.crop_resize_normalized]) == {
        "crop_resize_normalized": profiling.counters()["launches.crop_resize_normalized"]}


def test_spans_are_profiler_ranges(tiny, tmp_path):
    _chunk(tiny)                                    # warm
    with profiling.trace_profile(str(tmp_path)) as prof:
        _chunk(tiny)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(LAYERS) | {"vipt.step", "track.init"} <= names
    events = list(prof.events())
    steps = [e for e in events if e.name == "vipt.step"]
    layers = [e for e in events if e.name in LAYERS]

    def inside(e, r):
        return r.time_range.start <= e.time_range.start and e.time_range.end <= r.time_range.end

    loose = {e.name for e in events if e.name.startswith("aten::")
             and any(inside(e, s) for s in steps) and not any(inside(e, r) for r in layers)}
    assert loose <= VIEWS, loose
    assert not profiling.tracing_on()
