"""Kernels the card ran per training step in the traced window: the
host's launches, which set the pace of the eager step."""


def read(ctx):
    if not ctx["steps"]:
        return None
    return len(ctx["kernels"]) / ctx["steps"]
