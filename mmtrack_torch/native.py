"""ctypes bindings for the native region library (native/region.cc), port
of mmtrack_tpu/native.py.

Exact polygon overlap for rotated-box VOT annotations and a threaded batch
IoU for analysis sweeps (the reference vendors only a compiled leftover of
the VOT toolkit's region library, RGBD/models/SPT/build/.../region.o).
The library is built with g++ from `native/region.cc` into
`mmtrack_torch/kernels/_build/` (ignored by git) under a name that hashes
the source, at first use; nothing is written into `native/`. A failed
build raises with the compiler's message: there is no silent fallback.
`polygon_iou_plain` is the library's plain version in numpy (the same
sample grid, the same even-odd crossing test in the same f64 arithmetic),
which needs no toolchain and no matplotlib; the tests also hold the
library against the JAX module's matplotlib rasterisation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC_PATH = os.path.join(_ROOT, "native", "region.cc")
_BUILD_DIR = os.path.join(_ROOT, "mmtrack_torch", "kernels", "_build")

_lib = None
_lock = threading.Lock()
_D = ctypes.POINTER(ctypes.c_double)


def library_path() -> str:
    """Where the library of the current source is built."""
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libregion_{digest}.so")


def _build(out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC_PATH, "-lpthread"],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise OSError(f"g++ of {_SRC_PATH} failed: {proc.stderr.strip()[-400:]}")
    os.replace(tmp, out)


def load_region_lib() -> ctypes.CDLL:
    """The native library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.region_polygon_iou.restype = ctypes.c_double
            lib.region_polygon_iou.argtypes = [_D, _D, ctypes.c_int, _D, _D, ctypes.c_int,
                                               ctypes.c_int]
            lib.region_batch_iou_xywh.restype = None
            lib.region_batch_iou_xywh.argtypes = [_D, _D, _D, ctypes.c_int, ctypes.c_int]
            lib.region_polygon_bounds.restype = None
            lib.region_polygon_bounds.argtypes = [_D, _D, ctypes.c_int, _D]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _columns(poly) -> tuple[np.ndarray, np.ndarray]:
    p = np.ascontiguousarray(poly, np.float64)
    return np.ascontiguousarray(p[:, 0]), np.ascontiguousarray(p[:, 1])


def polygon_iou(poly1: np.ndarray, poly2: np.ndarray, samples: int = 512) -> float:
    """IoU of two polygons given as (N, 2) float arrays of (x, y) points,
    rasterised on a samples x samples grid over their joint bounding box."""
    lib = load_region_lib()
    xs1, ys1 = _columns(poly1)
    xs2, ys2 = _columns(poly2)
    return float(lib.region_polygon_iou(_ptr(xs1), _ptr(ys1), len(xs1), _ptr(xs2), _ptr(ys2),
                                        len(xs2), samples))


def _inside(xs: np.ndarray, ys: np.ndarray, px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """The even-odd rule of region.cc's `inside` for every point (px, py)."""
    inside = np.zeros(px.shape, bool)
    j = len(xs) - 1
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(len(xs)):
            crosses = (ys[i] > py) != (ys[j] > py)
            x_cross = (xs[j] - xs[i]) * (py - ys[i]) / (ys[j] - ys[i]) + xs[i]
            inside ^= crosses & (px < x_cross)
            j = i
    return inside


def polygon_iou_plain(poly1: np.ndarray, poly2: np.ndarray, samples: int = 512) -> float:
    """polygon_iou's plain version: region_polygon_iou in numpy."""
    xs1, ys1 = _columns(poly1)
    xs2, ys2 = _columns(poly2)
    xs, ys = np.concatenate([xs1, xs2]), np.concatenate([ys1, ys2])
    x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
    if x1 <= x0 or y1 <= y0:
        return 0.0
    S = samples if samples > 0 else 512
    px = x0 + (np.arange(S) + 0.5) * ((x1 - x0) / S)
    py = y0 + (np.arange(S) + 0.5) * ((y1 - y0) / S)
    gx, gy = np.meshgrid(px, py)
    a, b = _inside(xs1, ys1, gx, gy), _inside(xs2, ys2, gx, gy)
    union = int((a | b).sum())
    return 0.0 if union == 0 else int((a & b).sum()) / union


def batch_iou_xywh(a: np.ndarray, b: np.ndarray, num_threads: int | None = None) -> np.ndarray:
    """Elementwise IoU of (N, 4) xywh arrays, threaded in the library
    (eval/metrics.py::iou_xywh is its plain version)."""
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    lib = load_region_lib()
    out = np.empty(len(a), np.float64)
    nt = num_threads if num_threads is not None else (os.cpu_count() or 1)
    lib.region_batch_iou_xywh(_ptr(a), _ptr(b), _ptr(out), len(a), nt)
    return out


def polygon_to_xywh(poly: np.ndarray) -> np.ndarray:
    """Bounding xywh of a VOT polygon annotation."""
    lib = load_region_lib()
    xs, ys = _columns(poly)
    out = np.empty(4, np.float64)
    lib.region_polygon_bounds(_ptr(xs), _ptr(ys), len(xs), _ptr(out))
    return out
