"""A traced window: torch.profiler over a fixed amount of the cell's work,
read back into device intervals, kernels and the host's activity.

The window opens with a few tiny marker kernels (an in-place bitwise not,
which no path of the program runs) and a synchronise: a window on the
card's machine now and then comes back without the records of its first
kernels, and the markers lie before the window and are not counted. The
window's length is the host's clock from after the markers to the
synchronise that ends it; busy time is the union of the card's activity
(kernels, copies, fills) in it.

The metrics' window records the card's activity alone (`host_ops=False`):
recording every host op of an eager step slows the host several-fold and
would read as idle card time. A second, shorter window with the host's
ops (`host_ops=True`) attributes each idle gap to the innermost host event
running at its midpoint, under the benchmark's own span around the layer
it called (`bench.*`).
"""

from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict

import torch

MARKERS = 32
ATTEMPTS = 3


class MarkersLost(RuntimeError):
    """The profile came back without the window's marker kernels."""
MARKER = "bitwise_not"


def _ns(e, which):
    f = getattr(e, which + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, which + "_us")() * 1000)


def short(name: str) -> str:
    """A kernel or op name without its argument list and namespaces."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:120]


def traced(device, work, host_ops: bool = False):
    """(Trace, work()) of a window around `work`, opened again (up to
    ATTEMPTS times) when the profile lost the markers."""
    for attempt in range(ATTEMPTS):
        try:
            with Trace(device, host_ops) as tr:
                out = work()
            return tr, out
        except MarkersLost:
            if attempt == ATTEMPTS - 1:
                raise


class Trace:
    """Profile the body; afterwards `kernels` [(name, start_ns, dur_ns)],
    `busy_s`, `window_s`, `device_ops`, and with host_ops `idle_gaps`."""

    def __init__(self, device, host_ops: bool = False):
        self.device, self.host_ops = device, host_ops

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        head = torch.zeros(1, dtype=torch.uint8, device=self.device)
        torch.cuda.synchronize(self.device)
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host_ops else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        for _ in range(MARKERS):
            head.bitwise_not_()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        cpu, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", lambda: False)():
                    dev.append((e.name(), start, dur))
            else:
                cpu.append((e.name(), start, start + dur))
        marks = [s + d for n, s, d in dev if MARKER in n]
        if not marks:
            raise MarkersLost("the traced window's marker kernels are missing from the profile")
        t0 = max(marks)
        t1 = t0 + int(self.window_s * 1e9)
        dev = sorted((d for d in dev if d[1] >= t0 and MARKER not in d[0]), key=lambda r: r[1])
        self.kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
        merged = []
        for _, s, d in dev:
            e = min(s + d, t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(max(e - s, 0) for s, e in merged) / 1e9
        gaps, prev = [], t0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
        self.device_ops = self._top_ops()
        if self.host_ops:
            self.idle_gaps = self._gaps(cpu, gaps)

    def _top_ops(self):
        by = defaultdict(int)
        for name, _, d in self.kernels:
            by[short(name)] += d
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]

    @staticmethod
    def _gaps(cpu, gaps):
        """Idle seconds by 'outer bench span / innermost host event' at the
        gap's midpoint."""
        cpu = sorted(cpu, key=lambda c: c[1])
        mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
        active_all, active_bench, i = [], [], 0
        by = defaultdict(int)
        for m, length in mids:
            while i < len(cpu) and cpu[i][1] <= m:
                name, s, e = cpu[i]
                heapq.heappush(active_bench if name.startswith("bench.") else active_all,
                               (-s, e, name))
                i += 1
            for heap in (active_all, active_bench):
                while heap and heap[0][1] < m:
                    heapq.heappop(heap)
            inner = active_all[0][2] if active_all else "python"
            outer = active_bench[0][2] if active_bench else "bench"
            by[f"{outer}/{short(inner)}"] += length
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
