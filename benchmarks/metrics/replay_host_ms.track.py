"""Host milliseconds per chunk inside `track.replay`, the chunk graph's
submission, from the program window (benchmarks/program.py)."""

from benchmarks.program import replay_host_ms as read  # noqa: F401
