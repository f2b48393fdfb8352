"""The whole tracking step's share of the card's bf16 peak: the traced
work's frames times one forward's model FLOPs (benchmarks/flops.py),
over the seconds the same work took untraced."""

from benchmarks import flops, readers


def read(ctx):
    return readers.mfu(ctx, ctx["frames"] * flops.forward_flops(ctx["cfg"]))
