"""Multi-modal frame composition: RGB + X (depth / thermal / event) -> H x W x 6.

A copy of mmtrack_tpu/data/composition.py (ViPT
lib/train/dataset/depth_utils.py:71-132): the port imports nothing of the
JAX package, and the VOT entry (eval/vot.py) and the OPE drivers
(eval/ope.py, eval/batched_ope.py) compose their frames here.
tests/test_torch_vot.py holds it bit-equal to the JAX module. The streamed
wire of eval/batched_ope.py ships the RGB and `depth_index_u8`'s plane
instead of the composed frame and composes on the card (ops/compose.py).
"""

from __future__ import annotations

import cv2
import numpy as np

X_DTYPES = ("color", "raw_x", "colormap", "3x", "normalized_x",
            "rgbcolormap", "rgb3x", "rgbrgb", "rgbd_blend")


# ProMixTrack rgbd_blend defaults (promix_vot2022_rgbd.py:84-87)
RGBD_BLEND_DEPTH_MAX = 5000
RGBD_BLEND_ALPHA = 0.05


def _normalize_u8(x: np.ndarray) -> np.ndarray:
    x = cv2.normalize(x, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)
    return np.asarray(x, dtype=np.uint8)


def _median(x: np.ndarray) -> float:
    """np.median, but ~20x faster for unsigned-int maps (the DepthTrack
    uint16 depth case): exact order statistics from a bincount histogram
    instead of a 300k-element partition. Bit-identical to np.median —
    averages the two central values on even counts."""
    if x.dtype.kind != "u":
        return float(np.median(x))
    flat = np.ravel(x)
    cdf = np.cumsum(np.bincount(flat))
    n = flat.size
    lo = int(np.searchsorted(cdf, (n - 1) // 2 + 1))
    hi = lo if n % 2 else int(np.searchsorted(cdf, n // 2 + 1))
    return (lo + hi) / 2.0


def depth_index_u8(xmap: np.ndarray, x_clip: bool = True) -> np.ndarray:
    """The JET-LUT index plane of the 'rgbcolormap' composition: clip at
    min(3*median, 10m) then NORM_MINMAX to uint8 — exactly the value
    applyColorMap would look up. compose_x(rgb, d, 'rgbcolormap', clip)
    == concat(rgb, JET_LUT[depth_index_u8(d, clip)]).

    Serving hosts upload this 1-byte plane instead of the 3-byte colormap
    (4 B/px total vs 6) and gather the LUT on device
    (mmtrack_torch/ops/compose.py::compose_rgb_index_device) —
    bit-identical output for 2/3 of the transfer bytes."""
    if x_clip:
        xmap = xmap.copy()
        max_depth = min(_median(xmap) * 3, 10000)
        xmap[xmap > max_depth] = max_depth
    return _normalize_u8(xmap)


def compose_x(rgb: np.ndarray | None, xmap: np.ndarray | None,
              dtype: str = "rgbrgb", x_clip: bool = False) -> np.ndarray:
    """Compose already-decoded arrays. rgb: (H,W,3) RGB; xmap: raw X image.

    `x_clip` applies the DepthTrack depth clip: values above
    min(3*median, 10m) saturate (depth_utils.py:86-88).
    """
    if xmap is not None and x_clip:
        xmap = xmap.copy()
        max_depth = min(_median(xmap) * 3, 10000)
        xmap[xmap > max_depth] = max_depth

    if dtype == "color":
        return rgb
    if dtype == "raw_x":
        return xmap
    if dtype == "colormap":
        return cv2.applyColorMap(_normalize_u8(xmap), cv2.COLORMAP_JET)
    if dtype == "3x":
        d = _normalize_u8(xmap)
        return cv2.merge((d, d, d))
    if dtype == "normalized_x":
        return _normalize_u8(xmap)
    if dtype == "rgbcolormap":
        cm = cv2.applyColorMap(_normalize_u8(xmap), cv2.COLORMAP_JET)
        return cv2.merge((rgb, cm))
    if dtype == "rgb3x":
        d = _normalize_u8(xmap)
        return cv2.merge((rgb, cv2.merge((d, d, d))))
    if dtype == "rgbrgb":
        x3 = cv2.cvtColor(xmap, cv2.COLOR_BGR2RGB) if xmap.ndim == 3 else cv2.merge((xmap,) * 3)
        return cv2.merge((rgb, x3))
    if dtype == "rgbd_blend":
        # ProMixTrack composition (ProMixTrack/MixFormer/external/AR/
        # pytracking/VOT2020_super_only_mask_384_HP/rgbd_blend.py:21-52):
        # clip depth at a fixed threshold (default 5000mm), JET-colormap it,
        # alpha-blend 5% into the RGB frame -> a 3-channel input for the
        # plain RGB MixFormer-L.
        d = xmap.copy()
        d[d > RGBD_BLEND_DEPTH_MAX] = RGBD_BLEND_DEPTH_MAX
        cm = cv2.applyColorMap(_normalize_u8(d), cv2.COLORMAP_JET)
        cm = cv2.cvtColor(cm, cv2.COLOR_BGR2RGB)
        a = RGBD_BLEND_ALPHA
        return np.round((1.0 - a) * rgb.astype(np.float64)
                        + a * cm.astype(np.float64)).astype(np.uint8)
    raise ValueError(f"unknown composition dtype '{dtype}' (options: {X_DTYPES})")


def get_x_frame(color_path: str | None, x_path: str | None,
                dtype: str = "rgbrgb", depth_clip: bool = False) -> np.ndarray:
    """Read and compose a multi-modal frame from disk (get_x_frame analog)."""
    rgb = None
    if color_path:
        rgb = cv2.imread(color_path)
        rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
    xmap = cv2.imread(x_path, -1) if x_path else None
    return compose_x(rgb, xmap, dtype, x_clip=depth_clip)


def get_rgbd_frame(color_path: str | None, depth_path: str | None,
                   dtype: str = "rgbcolormap", depth_clip: bool = True) -> np.ndarray:
    """RGB-D convenience wrapper (get_rgbd_frame, depth_utils.py:7-68)."""
    return get_x_frame(color_path, depth_path, dtype, depth_clip)
