"""Device milliseconds per tracked step in `vipt.head` (the final norm, the
recovery of the search tokens and the box head), from the program's
stamped spans in the program window (benchmarks/program.py)."""

from benchmarks import program


def read(ctx):
    return program.layer_ms(ctx, "vipt.head")
