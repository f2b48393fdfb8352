"""Image loading with failsafe fallbacks, a copy of
mmtrack_tpu/data/image_loader.py (ViPT lib/train/data/image_loader.py).

The reference prefers jpeg4py (libjpeg-turbo) and falls back to cv2
(jpeg4py_loader_w_failsafe). Here, as in the JAX package, the chain is the
native libjpeg decoder of data/native_io.py, then cv2, then PIL: the order
decides which decoder's output a training crop sees (the native decoder
and cv2's can differ in the last bits of RGB), and the later loaders keep
the reference's tolerance of files one decoder refuses.
"""

from __future__ import annotations

import cv2
import numpy as np


def opencv_loader(path: str) -> np.ndarray | None:
    """A BGR file as an RGB array (opencv_loader), None on failure."""
    try:
        im = cv2.imread(path, cv2.IMREAD_COLOR)
        if im is None:
            return None
        return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
    except Exception:
        return None


def pil_loader(path: str) -> np.ndarray | None:
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


def native_jpeg_loader(path: str) -> np.ndarray | None:
    """libjpeg straight to RGB (native/imageio.cc); None for other files,
    or when the library does not load or the decode fails."""
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    try:
        from mmtrack_torch.data.native_io import decode_jpeg_rgb

        return decode_jpeg_rgb(path)
    except Exception:
        return None


def default_image_loader(path: str) -> np.ndarray:
    """The native decoder, then cv2, then PIL."""
    for loader in (native_jpeg_loader, opencv_loader, pil_loader):
        im = loader(path)
        if im is not None:
            return im
    raise IOError(f"could not read image {path}")



def grayscale_loader(path: str) -> np.ndarray:
    """The file as stored (cv2.IMREAD_UNCHANGED): a 16-bit depth or a
    one-channel thermal image keeps its depth and channels."""
    im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if im is None:
        raise IOError(f"could not read image {path}")
    return im
