"""ctypes bindings for the native image pipeline (native/imageio.cc), port
of mmtrack_tpu/data/native_io.py.

The per-frame host work of the streamed wire (JPEG decode, 16-bit PNG
depth decode, depth -> JET-index reduction) is fused into single C passes
that write straight into the caller's staging slices. ctypes releases the
GIL for the call, so a decode thread overlaps the main thread's issue of
the step.

Loading: the repo's built `native/libimageio.so` when it loads (it links
the system libjpeg and libpng); otherwise `native/imageio.cc` is built
with g++ into `mmtrack_torch/kernels/_build/` (ignored by git) under a
name that hashes the source. Nothing is written into `native/`.
`decoder()` says which decoder runs, and `load_error()` why the native
one does not.

Every rgb+index entry point falls back to the cv2/numpy path
(data/composition.py) with bit-identical output when the library is
unavailable; the raw 4:2:0 decode (`decode_pair_yuv_index`) has no
fallback and returns False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SO_PATH = os.path.join(_ROOT, "native", "libimageio.so")
_SRC_PATH = os.path.join(_ROOT, "native", "imageio.cc")
_BUILD_DIR = os.path.join(_ROOT, "mmtrack_torch", "kernels", "_build")

_lib = None
_lib_tried = False
_load_error: str | None = None
_load_lock = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_U16P = ctypes.POINTER(ctypes.c_ushort)


def _built_path() -> str:
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libimageio_{digest}.so")


def _build(out: str) -> None:
    """g++ the decoder into `out` (atomically); raises with the compiler's
    message on failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC_PATH,
                           "-ljpeg", "-lpng"], capture_output=True, text=True, timeout=180)
    if proc.returncode != 0:
        raise OSError(f"g++ failed: {proc.stderr.strip()[-400:]}")
    os.replace(tmp, out)


def _open() -> ctypes.CDLL:
    """The tracked library, else a build of the source; raises with both
    reasons when neither loads."""
    try:
        return ctypes.CDLL(_SO_PATH)
    except OSError as e:
        tracked = f"{os.path.relpath(_SO_PATH, _ROOT)}: {e}"
    try:
        path = _built_path()
        if not os.path.exists(path):
            _build(path)
        return ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError) as e:
        raise OSError(f"{tracked}; build of {os.path.relpath(_SRC_PATH, _ROOT)}: {e}") from e


def load_imageio_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_tried, _load_error
    with _load_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = _open()
        except OSError as e:
            _load_error = str(e)
            return None
        lib.mmt_decode_jpeg_rgb.restype = ctypes.c_int
        lib.mmt_decode_jpeg_rgb.argtypes = [
            _U8P, ctypes.c_long, _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mmt_decode_png_u16.restype = ctypes.c_int
        lib.mmt_decode_png_u16.argtypes = [
            _U8P, ctypes.c_long, _U16P, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mmt_depth_index_u8.restype = None
        lib.mmt_depth_index_u8.argtypes = [_U16P, ctypes.c_long, ctypes.c_int, _U8P]
        lib.mmt_decode_pair_rgb_index.restype = ctypes.c_int
        lib.mmt_decode_pair_rgb_index.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, _U8P, _U8P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def decoder() -> str:
    """'native' when the C decoder loads, else 'cv2' (the fallback)."""
    return "native" if load_imageio_lib() is not None else "cv2"


def load_error() -> str | None:
    """Why the native decoder did not load (None when it did, or before
    the first attempt)."""
    load_imageio_lib()
    return _load_error


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _check_buffer(name: str, a: np.ndarray, shape: tuple) -> None:
    """The C side writes prod(shape) bytes at a's address: refuse anything
    but a C-contiguous uint8 array of exactly that shape."""
    if a.dtype != np.uint8 or not a.flags.c_contiguous or a.shape != tuple(shape):
        raise ValueError(f"{name}: need a C-contiguous uint8 array of shape {tuple(shape)}, "
                         f"got {a.dtype} {a.shape} (contiguous: {a.flags.c_contiguous})")


def decode_pair_rgb_index(jpeg_path: str, png_path: str,
                          rgb_out: np.ndarray, idx_out: np.ndarray,
                          clip: bool = True) -> None:
    """Decode a color JPEG + 16-bit depth PNG frame pair into caller
    buffers: rgb_out (H, W, 3) uint8 RGB, idx_out (H, W) uint8 JET LUT
    index (depth_index_u8 semantics). Buffers must be C-contiguous slices
    of exactly the frame shape."""
    H, W = idx_out.shape
    _check_buffer("idx_out", idx_out, (H, W))
    _check_buffer("rgb_out", rgb_out, (H, W, 3))
    lib = load_imageio_lib()
    if lib is not None:
        rc = lib.mmt_decode_pair_rgb_index(
            jpeg_path.encode(), png_path.encode(),
            _as_u8p(rgb_out), _as_u8p(idx_out), H, W, int(clip))
        if rc == 0:
            return
        # fall through on any decode/shape error (cv2 handles exotic files)
    import cv2

    from mmtrack_torch.data.composition import depth_index_u8

    im = cv2.imread(jpeg_path)
    if im is None:
        raise IOError(f"could not read color frame {jpeg_path}")
    rgb_out[...] = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
    d = cv2.imread(png_path, -1)
    if d is None:
        raise IOError(f"could not read depth frame {png_path}")
    idx_out[...] = depth_index_u8(np.asarray(d, np.uint16), x_clip=clip)


def _decode_file(fn, path: str, out: np.ndarray, out_ptr) -> tuple[int, int] | None:
    """Run the C decoder `fn` over the bytes of `path` into `out` (at most
    its first two dims); the (h, w) it wrote, or None on any failure."""
    try:
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), np.uint8)
    except OSError:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if fn(_as_u8p(buf), len(buf), out_ptr, out.shape[0], out.shape[1],
          ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


# decode_jpeg_rgb, decode_png_u16 and depth_index_u8_native are the
# training image loader's decoders in the JAX package
# (mmtrack_tpu/data/image_loader.py); the port's copy of that loader, with
# the on-disk training datasets (ROADMAP, training's open parts), is their
# caller to come.

def decode_jpeg_rgb(path: str, out: np.ndarray | None = None,
                    max_hw: tuple[int, int] = (4096, 4096)) -> np.ndarray | None:
    """Decode a JPEG file to an (H, W, 3) uint8 RGB array, a view of `out`
    when it is given, else a new exact-size array (decoded into a
    `max_hw` buffer, whose untouched pages are never backed). Returns None
    on failure (callers chain to cv2)."""
    lib = load_imageio_lib()
    if lib is None:
        return None
    if out is not None:
        _check_buffer("out", out, (*out.shape[:2], 3))
    dst = out if out is not None else np.empty((*max_hw, 3), np.uint8)
    hw = _decode_file(lib.mmt_decode_jpeg_rgb, path, dst, _as_u8p(dst))
    if hw is None:
        return None
    img = dst.reshape(-1)[:hw[0] * hw[1] * 3].reshape(*hw, 3)
    return img if out is not None else img.copy()


def decode_png_u16(path: str,
                   max_hw: tuple[int, int] = (4096, 4096)) -> np.ndarray | None:
    """Decode a grayscale PNG to (H, W) uint16. Returns None on failure."""
    lib = load_imageio_lib()
    if lib is None:
        return None
    dst = np.empty(max_hw, np.uint16)
    hw = _decode_file(lib.mmt_decode_png_u16, path, dst, dst.ctypes.data_as(_U16P))
    if hw is None:
        return None
    return dst.reshape(-1)[:hw[0] * hw[1]].reshape(hw).copy()


def depth_index_u8_native(depth: np.ndarray, clip: bool = True,
                          out: np.ndarray | None = None) -> np.ndarray:
    """Native depth_index_u8; falls back to the numpy/cv2 implementation."""
    lib = load_imageio_lib()
    if out is None:
        out = np.empty(depth.shape, np.uint8)
    if lib is None:
        from mmtrack_torch.data.composition import depth_index_u8

        out[...] = depth_index_u8(depth, x_clip=clip)
        return out
    d = np.ascontiguousarray(depth, np.uint16)
    _check_buffer("out", out, d.shape)
    lib.mmt_depth_index_u8(d.ctypes.data_as(_U16P), d.size, int(clip), _as_u8p(out))
    return out


def bind_yuv(lib) -> None:
    if hasattr(lib, "_yuv_bound"):
        return
    lib.mmt_decode_pair_yuv_index.restype = ctypes.c_int
    lib.mmt_decode_pair_yuv_index.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, _U8P, _U8P, _U8P, _U8P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib._yuv_bound = True


def decode_pair_yuv_index(jpeg_path: str, png_path: str,
                          y_out: np.ndarray, cb_out: np.ndarray,
                          cr_out: np.ndarray, idx_out: np.ndarray,
                          clip: bool = True) -> bool:
    """Minimum-byte streaming decode (2.5 B/px on the wire): raw 4:2:0
    YCbCr planes + JET index plane, for ops/compose.py::
    compose_yuv_index_device. Requires a plain 4:2:0 JPEG with H, W
    multiples of 16 and the native library. Returns False when this
    source or machine does not qualify: callers fall back to
    decode_pair_rgb_index (the bit-exact path)."""
    lib = load_imageio_lib()
    if lib is None:
        return False
    bind_yuv(lib)
    H, W = y_out.shape
    for name, a, shape in (("y_out", y_out, (H, W)), ("cb_out", cb_out, (H // 2, W // 2)),
                           ("cr_out", cr_out, (H // 2, W // 2)), ("idx_out", idx_out, (H, W))):
        _check_buffer(name, a, shape)
    rc = lib.mmt_decode_pair_yuv_index(
        jpeg_path.encode(), png_path.encode(), _as_u8p(y_out),
        _as_u8p(cb_out), _as_u8p(cr_out), _as_u8p(idx_out), H, W, int(clip))
    return rc == 0
