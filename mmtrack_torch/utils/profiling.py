"""Profiling helpers, port of mmtrack_tpu/utils/profiling.py.

`Timer` keeps the cheap wall-clock counters (the reference's
ltr_trainer.py:130-136 telemetry); `trace_profile` captures a
torch.profiler trace of the host and, when a card is present, of its
kernels, written as a Chrome trace (chrome://tracing, Perfetto) into
`log_dir`; `flops_estimate` counts the floating-point operations of one
call with torch's FlopCounterMode, the counterpart of XLA's cost
analysis (SPT's profile_model.py analog).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class Timer:
    """Accumulating wall-clock timer (AverageMeter for time)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Profile the body with torch.profiler (CPU, and CUDA when a card is
    present) and write its Chrome trace to `log_dir`/trace_<pid>_<ns>.json.
    Yields the profiler, whose `key_averages()` the caller may read after
    the body; the trace's path is its `trace_path` attribute then."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


def flops_estimate(fn, *args) -> float | None:
    """The floating-point operations of `fn(*args)` as FlopCounterMode
    counts them (2 per multiply-add of a product or a convolution; the
    elementwise work is not counted), or None when the call fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None
