"""The port's one tracer, and its profiler and FLOP helpers.

Counters. `count(name, n)` adds to a count of the process, always on (a
dict add); `counters()` reads them all and `launches(fns, since)` the
kernel wrappers' `launches.<wrapper>`. A wrapper counts a launch at the
call: in an eager step, and at a CUDA graph's warm-up and capture. A
replay adds nothing, so the launches of replays are `graph.replays` x
`graph.nodes` (both counted by `capture_graph` and `Capture.replayed`).

Spans. `span(name, device=None, step=None)` marks a layer's boundary:
- with tracing off and no torch profiler running it does nothing after
  two flag checks;
- under any torch profiler it enters `record_function(name)`, so the
  span lies on the profiler's clock and in `trace_profile`'s Chrome
  trace;
- under `tracing()` it is kept in memory: its name, its host start and
  end (`time.perf_counter_ns`), its parent, the chunk it belongs to
  (`chunk()`: one request, B lanes x T frames) and its step inside the
  chunk (`step`, inherited from the parent). With `device` given it is
  also stamped on the device at its start and end. On a CUDA device a
  one-thread kernel (csrc/stamp.cu) stores the card's nanosecond
  timer into a slot of a device buffer. Where spans abut (one ends at
  the boundary just before the next one starts) they share one stamp. A stamp launched during
  a graph's capture is a node of the graph: every replay rewrites its
  slot, and `Capture.replayed` copies the slots to a pinned host ring
  right behind the replay. On the CPU a stamp is the host's clock at the
  boundary, since CPU ops are synchronous, and is shared in the same way.

`Tracing.snapshot()` decodes what was kept: the spans (device stamps laid
on the host's clock through one pair of readings of both clocks), the
counters and the graphs captured. `trace_profile` writes a torch.profiler
Chrome trace; `flops_estimate` counts a call's floating-point operations
with torch's FlopCounterMode (SPT's profile_model.py analog).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from mmtrack_torch.kernels.build import load_library, stream_handle

STAMP_SLOTS = 4096   # int64 slots of one device stamp buffer
RING = 4             # replays of one graph whose stamps may be on their way to the host
CLOCK_READINGS = 5   # pairs of clock readings, of which the tightest is kept

_COUNTS: dict[str, int] = defaultdict(int)
_CAPTURES: list["Capture"] = []
_TRACER: Optional["Tracing"] = None
_NULL = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] += n


def counters() -> dict[str, int]:
    """Every counter of the process."""
    return dict(_COUNTS)


def launches(fns, since: Optional[dict] = None) -> dict[str, int]:
    """The launches each kernel wrapper of `fns` counted, by its name:
    since `since` (an earlier `counters()`) when given."""
    base = since or {}
    return {f.__name__: _COUNTS.get(f"launches.{f.__name__}", 0)
            - base.get(f"launches.{f.__name__}", 0) for f in fns}


def captures() -> list[dict]:
    """Every CUDA graph the process captured: {'key', 'traced' (under
    tracing()), 'nodes', 'kernels' (the nodes that are kernels)}."""
    return [{"key": cap.key, "traced": cap.traced, "nodes": cap.nodes, "kernels": cap.kernels}
            for cap in _CAPTURES]


def tracing_on() -> bool:
    return _TRACER is not None


def span(name: str, device=None, step: Optional[int] = None):
    """A context manager around one layer's work (the module's docstring).
    `device`: the device its work runs on, to be stamped there; `step`: the
    step index inside the chunk, for this span and its children."""
    tr = _TRACER
    if tr is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(tr, name, device, step)


def chunk():
    """A context manager: the spans inside share one new chunk id (the
    request: B lanes x T frames), unless a chunk is open already."""
    tr = _TRACER
    if tr is None or tr.chunk is not None:
        return _NULL
    return _ChunkScope(tr)


@contextlib.contextmanager
def tracing():
    """Keep spans until the block ends; yields the `Tracing` handle, whose
    `snapshot()` may be read inside the block or after it."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("tracing() is on already")
    tr = Tracing()
    _TRACER = tr
    try:
        yield tr
    finally:
        _TRACER = None


@contextlib.contextmanager
def capturing(device, key):
    """The capture of one CUDA graph on `device` under `key`: yields its
    `Capture`, in whose own stamp buffer the device spans of the capture
    are stamped (under tracing()). Counts `graph.captures`."""
    tr = _TRACER
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cap = Capture(key, tr is not None, device)
    if tr is not None:
        tr.capture = cap
    try:
        yield cap
    finally:
        if tr is not None:
            tr.capture = None
        for sp in cap.template:          # a replay's spans hang under the replay's span
            sp.tr = None
            if sp.parent is not None and sp.parent.book is not cap.book:
                sp.parent = None
    count("graph.captures")
    _CAPTURES.append(cap)


def _stamp(buf: torch.Tensor, slot: int) -> None:
    load_library().launch("mmt_stamp", buf.data_ptr(), slot, stream_handle(buf.device))


class _Book:
    """The stamps of one device, in slots filled in order: on a card in
    device buffers of STAMP_SLOTS, elsewhere the host's clock in a list."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = device.type == "cuda"
        self.buffers: list[torch.Tensor] = []
        self.host: list[int] = []
        self.used = 0
        self.end = (-1, -1)       # (slot, next boundary) of the newest span end

    def stamp(self, boundary: int, start: bool) -> int:
        """The slot of a stamp at `boundary`, a span's start or end: a start
        that abuts the span that ended at the boundary just before (nothing
        ran between) shares that span's stamp."""
        slot, at = self.end
        if not start or at != boundary:
            slot = self.used
            if not self.card:
                self.host.append(time.perf_counter_ns())
            else:
                if slot == len(self.buffers) * STAMP_SLOTS:
                    self.buffers.append(torch.empty(STAMP_SLOTS, dtype=torch.int64,
                                                    device=self.device))
                _stamp(self.buffers[-1], slot % STAMP_SLOTS)
            self.used += 1
        self.end = (-1, -1) if start else (slot, boundary + 1)
        return slot

    def read(self) -> np.ndarray:
        """Every stamp, after the device has finished them."""
        if not self.card:
            return np.asarray(self.host, np.int64)
        if not self.used:
            return np.zeros(0, np.int64)
        torch.cuda.synchronize(self.device)
        return torch.cat(self.buffers)[:self.used].cpu().numpy()


class Capture:
    """One CUDA graph's capture (`utils/device.py::capture_graph`): its
    `key`, whether it was captured under tracing() (`traced`), its node
    count (`nodes`) and the device spans its replays stamp."""

    def __init__(self, key, traced: bool, device: torch.device):
        self.key, self.traced, self.nodes, self.kernels = key, traced, None, None
        self.book = _Book(device) if traced else None
        self.template: list[_Span] = []
        self.ring = None
        self.replays = 0
        self.in_ring: list[Optional[_Replay]] = [None] * RING

    def count_nodes(self, graph: "torch.cuda.CUDAGraph") -> None:
        """Read the nodes of `graph`, captured with keep_graph=True: all of
        them (`nodes`, counted as `graph.nodes`) and the kernels among them
        (`kernels`); the rest are copies and fills, which a profiler of a
        replay shows as kernels (`memcpy32_post`, `memset32`) or as copies."""
        get_nodes, node_type = _graph_api()
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        _check(get_nodes(handle, None, ctypes.byref(n)), "GraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _check(get_nodes(handle, nodes, ctypes.byref(n)), "GraphGetNodes")
        kind = ctypes.c_int()
        kernels = 0
        for node in nodes:
            _check(node_type(ctypes.c_void_p(node), ctypes.byref(kind)), "GraphNodeGetType")
            kernels += kind.value == 0          # cudaGraphNodeTypeKernel
        self.nodes, self.kernels = n.value, kernels
        count("graph.nodes", self.nodes)

    def replayed(self) -> None:
        """Call right after each replay, on its stream: counts
        `graph.replays` and, under tracing(), copies the replay's stamps to
        the host ring before the next replay can overwrite them."""
        count("graph.replays")
        tr = _TRACER
        if tr is None or not self.template:
            return
        if self.ring is None:
            self.ring = torch.empty((RING, self.book.used), dtype=torch.int64, pin_memory=True)
        r = self.replays % RING
        self.replays += 1
        if self.in_ring[r] is not None:
            self.in_ring[r].fetch()
        for i, buf in enumerate(self.book.buffers):
            lo = i * STAMP_SLOTS
            hi = min(lo + STAMP_SLOTS, self.book.used)
            self.ring[r, lo:hi].copy_(buf[:hi - lo], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        stack = tr.stack()
        rec = _Replay(self, r, done, tr.chunk, stack[-1] if stack else None)
        self.in_ring[r] = rec
        tr.records.append(rec)


def _graph_api():
    """cudaGraphGetNodes and cudaGraphNodeGetType of the CUDA runtime torch
    loaded (found by its soname), or libcuda's cuGraph* twins where
    torch holds the runtime statically; they take the same arguments."""
    try:
        lib, prefix = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}"), "cuda"
    except OSError:
        lib, prefix = ctypes.CDLL("libcuda.so.1"), "cu"
    get_nodes = getattr(lib, prefix + "GraphGetNodes")
    node_type = getattr(lib, prefix + "GraphNodeGetType")
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    node_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_nodes.restype = node_type.restype = ctypes.c_int
    return get_nodes, node_type


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class _Replay:
    """One replay of a traced capture: where its stamps are in the ring,
    the event after their copy, its chunk and the span it ran in."""

    def __init__(self, cap: Capture, r: int, done, chunk_id, parent):
        self.cap, self.r, self.done, self.chunk, self.parent = cap, r, done, chunk_id, parent
        self.stamps: Optional[np.ndarray] = None

    def fetch(self) -> None:
        """Take the stamps out of the ring (waiting for their copy)."""
        if self.stamps is None:
            self.done.synchronize()
            self.stamps = self.cap.ring[self.r].numpy().copy()
            self.cap.in_ring[self.r] = None


class _ChunkScope:
    def __init__(self, tr: "Tracing"):
        self.tr = tr

    def __enter__(self):
        self.tr.chunk = self.tr.chunks
        self.tr.chunks += 1

    def __exit__(self, *exc):
        self.tr.chunk = None
        return False


class _Span:
    __slots__ = ("tr", "name", "device", "step", "prof", "parent", "chunk", "start", "end",
                 "dstart", "dend", "book")

    def __init__(self, tr, name, device, step):
        self.tr, self.name, self.step = tr, name, step
        self.device = None if device is None else torch.device(device)
        self.prof = self.parent = self.chunk = self.book = None
        self.start = self.end = self.dstart = self.dend = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.prof = torch.profiler.record_function(self.name)
            self.prof.__enter__()
        tr = self.tr
        if tr is None:
            return self
        stack = tr.stack()
        self.parent = stack[-1] if stack else None
        self.chunk = tr.chunk
        if self.step is None and self.parent is not None:
            self.step = self.parent.step
        stack.append(self)
        cap = tr.capture
        if (self.device is not None and cap is not None and self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            self.book = cap.book
            cap.template.append(self)
        else:
            if self.device is not None:
                self.book = tr.book(self.device)
            tr.records.append(self)
        self.start = time.perf_counter_ns()
        if self.book is not None:
            self.dstart = self.book.stamp(tr.boundary, True)
        tr.boundary += 1
        return self

    def __exit__(self, *exc):
        tr = self.tr
        if tr is not None:
            if self.book is not None:
                self.dend = self.book.stamp(tr.boundary, False)
            self.end = time.perf_counter_ns()
            tr.stack().pop()
            tr.boundary += 1
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def _clock_pair(device: torch.device) -> tuple[int, int]:
    """(the card's timer, the host's perf_counter_ns) at one moment: a
    stamp between two host readings around synchronises, the midpoint of
    the tightest of CLOCK_READINGS pairs."""
    buf = torch.zeros(1, dtype=torch.int64, device=device)
    best = None
    for _ in range(CLOCK_READINGS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        _stamp(buf, 0)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, int(buf.item()), (t0 + t1) // 2)
    return best[1], best[2]


class Tracing:
    """What one tracing() block kept (`snapshot()`)."""

    def __init__(self):
        self.records: list = []           # host and eager spans, replays, in order
        self.books: dict[torch.device, _Book] = {}
        self.clocks: dict[torch.device, tuple[int, int]] = {}
        self.capture: Optional[Capture] = None
        self.chunk: Optional[int] = None
        self.chunks = 0
        self.boundary = 0
        self._local = threading.local()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            dev = torch.device("cuda", torch.cuda.current_device())
            self.clocks[dev] = _clock_pair(dev)

    def stack(self) -> list:
        """This thread's open spans."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def book(self, device: torch.device) -> _Book:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        b = self.books.get(device)
        if b is None:
            b = self.books[device] = _Book(device)
        return b

    def snapshot(self) -> dict:
        """{'spans': [...], 'counters': {...}, 'captures': [...]}.

        A span is {'name', 'parent' (its index or None), 'chunk', 'step',
        'start', 'end' (host ns, None for a span a graph replay ran),
        'dstart', 'dend' (device stamps in host ns, None for a host
        span)}; the captures are `captures()`. Waits for the
        devices' stamps."""
        eager = {dev: book.read() for dev, book in self.books.items()}

        def host_ns(dev, t):
            if dev.type != "cuda":
                return int(t)
            if dev not in self.clocks:
                self.clocks[dev] = _clock_pair(dev)
            d, h = self.clocks[dev]
            return int(t) - d + h

        spans, index = [], {}
        for rec in self.records:
            if isinstance(rec, _Replay):
                rec.fetch()
                dev, outer, local = rec.cap.book.device, index.get(id(rec.parent)), {}
                for sp in rec.cap.template:
                    local[id(sp)] = len(spans)
                    spans.append({"name": sp.name, "parent": local.get(id(sp.parent), outer),
                                  "chunk": rec.chunk, "step": sp.step, "start": None,
                                  "end": None, "dstart": host_ns(dev, rec.stamps[sp.dstart]),
                                  "dend": host_ns(dev, rec.stamps[sp.dend])})
                continue
            index[id(rec)] = len(spans)
            row = {"name": rec.name, "parent": index.get(id(rec.parent)), "chunk": rec.chunk,
                   "step": rec.step, "start": rec.start, "end": rec.end, "dstart": rec.dstart,
                   "dend": rec.dend}
            if rec.book is not None:
                stamps = eager[rec.book.device]
                row["dstart"] = host_ns(rec.book.device, stamps[rec.dstart])
                row["dend"] = host_ns(rec.book.device, stamps[rec.dend])
            spans.append(row)
        return {"spans": spans, "counters": counters(), "captures": captures()}


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
