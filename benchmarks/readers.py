"""What the per-layer metric files share: the device's idle share and
busy time, the whole step's share of the bf16 peak, and a kernel's share
of its roofline from the traced window (`trace.Trace`) and the calls the
window made.

Each reader takes the window's context: `cfg`, `traffic`, `kernels`
[(name, start_ns, dur_ns)], `busy_s`, `window_s`, `untraced_s` (the
host's clock over the same amount of work run just before, untraced),
`peaks`, and the work the mode did in the window (`steps`, `batch`,
`frames` or `samples`, `crops`). A reader with nothing to read returns
None.
"""

from __future__ import annotations

from benchmarks import roofline

# The share of the expected launches that may be missing from a window's
# records (the profiler drops the first records of a window now and then)
# before a kernel's share is left unread.
LOST_RECORDS = 0.01


def idle_pct(ctx) -> float | None:
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def busy_ms(ctx, count: int) -> float | None:
    """Milliseconds the card was busy per step or frame of the window."""
    if not count or ctx["busy_s"] <= 0:
        return None
    return 1e3 * ctx["busy_s"] / count


def mfu(ctx, model_flops: float) -> float | None:
    """100 x the window's model FLOPs over the seconds the same work took
    untraced and the bf16 peak: tracing slows a host-paced step, and the
    traced window's length would read the profiler's cost."""
    if ctx["untraced_s"] <= 0 or model_flops <= 0:
        return None
    return 100.0 * model_flops / ctx["untraced_s"] / ctx["peaks"]["bf16_flops"]


def kernel_share(ctx, names: tuple[str, ...], calls: list[tuple[float, float]]) -> float | None:
    """A kernel's share of its roofline: the bounds of the expected calls
    over the device time of the traced kernels whose name holds one of
    `names`. None when none ran, or when their count differs from the
    calls' by more than LOST_RECORDS (the calls would not be these)."""
    found = [k for k in ctx["kernels"] if any(n in k[0] for n in names)]
    if not found or not calls:
        return None
    ratio = len(found) / len(calls)
    if ratio > 1.0 or ratio < 1.0 - LOST_RECORDS:
        return None
    device_s = sum(k[2] for k in found) / 1e9
    return roofline.share(calls, device_s, ctx["peaks"]) * ratio
