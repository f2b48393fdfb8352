"""Device milliseconds per tracked step in `vipt.ce_block` (blocks 3, 6 and
9: plain attention and the candidate elimination), from the program's
stamped spans in the program window (benchmarks/program.py)."""

from benchmarks import program


def read(ctx):
    return program.layer_ms(ctx, "vipt.ce_block")
