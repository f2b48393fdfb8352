"""The whole training step's share of the card's bf16 peak: the traced
work's samples times one prompt-only sample's forward and backward model
FLOPs (benchmarks/flops.py; the program's recompute for its backward is
not model work), over the seconds the same work took untraced."""

from benchmarks import flops, readers


def read(ctx):
    return readers.mfu(ctx, ctx["samples"] * flops.train_flops(ctx["cfg"]))
