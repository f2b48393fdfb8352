"""Device milliseconds per chunk boundary between a chunk's last stamp and
the next chunk's first `track.load` stamp, from the program window
(benchmarks/program.py)."""

from benchmarks.program import chunk_gap_ms as read  # noqa: F401
