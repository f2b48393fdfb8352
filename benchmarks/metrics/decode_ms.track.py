"""Device milliseconds per tracked step in `vipt.decode` (the Hann window,
cal_bbox, the map back and the clip), from the program's stamped spans
in the program window (benchmarks/program.py)."""

from benchmarks import program


def read(ctx):
    return program.layer_ms(ctx, "vipt.decode")
