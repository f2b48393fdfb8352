"""The program's own spans and counters (mmtrack_torch/utils/profiling.py)
over a window of a track cell, and the readers of the metrics that read
them.

`program_window(run)` runs, after everything else of a traced run, one
warm chunk under `profiling.tracing()` (it captures the graph with the
steps' device spans stamped in it; its own tracing block, not read), then
`trace.chunks` chunks under a second tracing block, and returns that
block's snapshot: {'spans', 'counters', 'captures'} (profiling.py's
`Tracing.snapshot`). None where the program has no tracer. The chunks
are not kept for the check.

A reader takes a context with `program`, that snapshot, and returns None
where the span or counter it reads never ran.
"""

from __future__ import annotations

LAYER_SPANS = ("vipt.crop", "vipt.embed", "vipt.prompt", "vipt.block", "vipt.ce_block",
               "vipt.head", "vipt.decode")


def program_window(run) -> dict | None:
    """The snapshot of `run`'s (a `modes.track.Cell` after its set-up)
    chunks under the program's tracer."""
    from mmtrack_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return None
    with profiling.tracing():
        run._chunk(record=False)
        run._drain(record=False)
    with profiling.tracing() as t:
        for _ in range(run.p["trace"]["chunks"]):
            run._chunk(record=False)
        run._drain(record=False)
        return t.snapshot()


def _spans(ctx, name: str) -> list[dict]:
    snap = ctx.get("program")
    if not snap:
        return []
    return [s for s in snap["spans"] if s["name"] == name]


def _device_ms(span: dict) -> float:
    return (span["dend"] - span["dstart"]) / 1e6


def layer_ms(ctx, name: str) -> float | None:
    """Device milliseconds of the spans `name` per tracked step (one
    `vipt.step` span each)."""
    steps = _spans(ctx, "vipt.step")
    found = [s for s in _spans(ctx, name) if s["dstart"] is not None]
    if not steps or not found:
        return None
    return sum(map(_device_ms, found)) / len(steps)


def step_ms(ctx) -> float | None:
    """The stamped device milliseconds of a step."""
    steps = [s for s in _spans(ctx, "vipt.step") if s["dstart"] is not None]
    if not steps:
        return None
    return sum(map(_device_ms, steps)) / len(steps)


def chunk_gap_ms(ctx) -> float | None:
    """Device milliseconds per chunk boundary from a chunk's last stamp to
    the next chunk's first `track.load` stamp, less the `track.init` spans
    that ran between them (a new batch of sequences)."""
    snap = ctx.get("program")
    if not snap:
        return None
    loads, ends = {}, {}
    for s in snap["spans"]:
        if s["chunk"] is None or s["dstart"] is None:
            continue
        if s["name"] == "track.load":
            loads.setdefault(s["chunk"], s["dstart"])
        ends[s["chunk"]] = max(ends.get(s["chunk"], s["dend"]), s["dend"])
    inits = [(s["dstart"], s["dend"]) for s in _spans(ctx, "track.init")
             if s["dstart"] is not None]
    order = sorted(loads, key=loads.get)
    gaps = []
    for a, b in zip(order, order[1:]):
        lo, hi = ends[a], loads[b]
        busy = sum(max(0, min(e, hi) - max(s, lo)) for s, e in inits)
        gaps.append((hi - lo - busy) / 1e6)
    if not gaps:
        return None
    return sum(gaps) / len(gaps)


def replay_host_ms(ctx) -> float | None:
    """Host milliseconds inside `track.replay` (the graph's submission) per
    chunk."""
    found = _spans(ctx, "track.replay")
    if not found:
        return None
    return sum((s["end"] - s["start"]) / 1e6 for s in found) / len(found)


def graph_nodes_per_step(ctx) -> float | None:
    """The nodes of the chunk graph captured with tracing off (the graph
    the untraced runs replay) over the chunk's steps, from the program's
    record of its captures."""
    try:
        from mmtrack_torch.utils.profiling import captures
    except ImportError:
        return None
    plain = [c["nodes"] for c in captures() if not c["traced"] and c["nodes"]]
    if not plain:
        return None
    return plain[-1] / ctx["traffic"]["chunk"]
