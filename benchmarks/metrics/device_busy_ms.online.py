"""Milliseconds the card was busy per frame in the traced window: upload,
compose and the one-frame graph's kernels, which the profiler's slowdown
of the host does not change (the idle share of a traced frame would read
it)."""

from benchmarks import readers


def read(ctx):
    return readers.busy_ms(ctx, ctx["frames"])
