"""Device milliseconds per tracked step in `vipt.prompt` (the deep-prompt
re-injection before blocks 1-11, with its recover and gather; ViPT
only), from the program's stamped spans in the program window
(benchmarks/program.py)."""

from benchmarks import program


def read(ctx):
    return program.layer_ms(ctx, "vipt.prompt")
