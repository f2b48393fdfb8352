"""The share of the traced window in which nothing ran on the card."""

from benchmarks.readers import idle_pct as read  # noqa: F401
