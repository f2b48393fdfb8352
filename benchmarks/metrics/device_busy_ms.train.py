"""Milliseconds the card was busy per training step in the traced window:
the device's own work, which the profiler's slowdown of the host does
not change (the idle share of a traced eager step would read it)."""

from benchmarks import readers


def read(ctx):
    return readers.busy_ms(ctx, ctx["steps"])
