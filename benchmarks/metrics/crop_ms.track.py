"""Device milliseconds per tracked step in `vipt.crop` (the search crop),
from the program's stamped spans in the program window
(benchmarks/program.py)."""

from benchmarks import program


def read(ctx):
    return program.layer_ms(ctx, "vipt.crop")
