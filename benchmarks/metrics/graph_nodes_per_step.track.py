"""Nodes of the chunk graph that the untraced runs replay, per step: the
program's `graph.nodes` of its capture with tracing off, over the chunk's
steps (benchmarks/program.py)."""

from benchmarks.program import graph_nodes_per_step as read  # noqa: F401
