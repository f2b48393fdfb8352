"""Device milliseconds per tracked step in `vipt.embed` (both patch embeds
of template and search, the first prompt, the positions and the
concatenation), from the program's stamped spans in the program window
(benchmarks/program.py)."""

from benchmarks import program


def read(ctx):
    return program.layer_ms(ctx, "vipt.embed")
