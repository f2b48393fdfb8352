"""Device-side frame composition, port of mmtrack_tpu/ops/compose.py.

`compose_rgbcolormap_device` composes the 'rgbcolormap' frame from the
decoded RGB and the raw 16-bit depth (clip, NORM_MINMAX and the JET LUT),
bit-equal to the host's compose_x. For the streamed wire the host decodes
and ships planes smaller than the 6-channel frame; the card composes the
frame the tracker reads:

- rgb + JET index (4 B/px): `compose_rgb_index_device` gathers the 3-byte
  colormap from the 1-byte index plane (data/composition.py::
  depth_index_u8) and appends it to the RGB, bit-identical to the host's
  compose_x(..., 'rgbcolormap');
- raw 4:2:0 planes + JET index (2.5 B/px): `compose_yuv_index_device`
  upsamples the chroma with libjpeg's triangular filter and converts
  BT.601 to RGB first, within one LSB of the decoder's own RGB.

Plain PyTorch on the tensors' device, over (..., H, W) planes with any
leading batch axes: a LUT gather and a concatenation, a separable
upsample and a few elementwise products. The order of operations is the
JAX package's, one rounding per operation (no fused multiply-add): the
rgb + index compose and the upsample equal JAX's bit for bit; in the
BT.601 products XLA's CPU backend contracts the G row into fused
multiply-adds and differs by 1 LSB on about 3 in a million values
(tests/test_torch_compose.py).
"""

from __future__ import annotations

import numpy as np
import torch


def jet_lut() -> np.ndarray:
    """cv2's 256-entry JET colormap as (256, 3) uint8, in cv2's own channel
    order — the host path (compose_x 'rgbcolormap', like the reference's
    get_rgbd_frame) appends applyColorMap output channels verbatim."""
    import cv2

    idx = np.arange(256, dtype=np.uint8).reshape(256, 1)
    return cv2.applyColorMap(idx, cv2.COLORMAP_JET).reshape(256, 3).copy()


def _median_i32(flat: torch.Tensor) -> torch.Tensor:
    """np.median of each row of (N, n) int32 values, as f32 (the mean of
    the two central order statistics when n is even: exact, both are
    integers below 2^16)."""
    n = flat.shape[-1]
    a = torch.kthvalue(flat, (n + 1) // 2, dim=-1).values
    if n % 2:
        return a.float()
    b = torch.kthvalue(flat, n // 2 + 1, dim=-1).values
    return (a + b).float() / 2.0


def compose_rgbcolormap_device(rgb_u8: torch.Tensor, depth_u16: torch.Tensor,
                               lut_rgb: torch.Tensor, depth_clip: bool = True) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB + (..., H, W) uint16 (or int32) depth ->
    (..., H, W, 6) uint8, bit-equal to compose_x(..., 'rgbcolormap',
    x_clip=depth_clip) (JAX ops/compose.py:31-151).

    Per frame: the DepthTrack clip at min(3 * median, 10000) with the
    median exact (kthvalue on int32) and clipped pixels taking the
    truncated clip value, as numpy's uint16 assignment does; then cv2's
    NORM_MINMAX to [0, 255]: scale = 255 * (1 / D) and shift = -lo * scale
    in f64, each cast to f32, and v * scale + shift in f64 cast to f32 once
    (the sum is exact in f64: a 16-bit v times a 24-bit scale has at most
    40 bits, and |shift| is below 2^17 of the scale's unit), which is the
    single rounding of cv2's f32 FMA; round half to even, the JET LUT. A
    constant map gets scale 0 (cv2's DBL_EPSILON guard)."""
    lead, (H, W) = rgb_u8.shape[:-3], rgb_u8.shape[-3:-1]
    d = depth_u16.reshape(-1, H * W).to(torch.int32)
    if depth_clip:
        mx = torch.minimum(_median_i32(d) * 3.0, torch.tensor(10000.0, device=d.device))
        d = torch.where(d.float() > mx[:, None], torch.trunc(mx).to(torch.int32)[:, None], d)
    lo = d.min(dim=-1, keepdim=True).values.double()
    D = d.max(dim=-1, keepdim=True).values.double() - lo
    scale = torch.where(D > 0, 255.0 * (1.0 / D.clamp(min=1.0)), torch.zeros_like(D))
    a = scale.float().double()
    b = (-(lo * scale)).float().double()
    v = (d.double() * a + b).float()
    idx = torch.round(v).clamp_(0, 255).to(torch.uint8).reshape(*lead, H, W)
    return torch.cat([rgb_u8, _gather_lut(lut_rgb, idx)], dim=-1)


def _gather_lut(lut_rgb: torch.Tensor, idx_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 index -> (..., H, W, 3) colormap."""
    return lut_rgb.index_select(0, idx_u8.reshape(-1).long()).view(*idx_u8.shape, 3)


def compose_rgb_index_device(rgb_u8: torch.Tensor, idx_u8: torch.Tensor,
                             lut_rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB + (..., H, W) uint8 JET index -> (..., H, W, 6).

    The streaming split of 'rgbcolormap': the host computes the 1-byte LUT
    index plane (data/composition.py::depth_index_u8 — the only part that
    needs the full uint16 depth), the device gathers the 3-byte colormap.
    Bit-identical to compose_x(..., 'rgbcolormap') at 4/6 the upload bytes.
    """
    return torch.cat([rgb_u8, _gather_lut(lut_rgb, idx_u8)], dim=-1)


def _upsample2x_triangular(c: torch.Tensor) -> torch.Tensor:
    """(..., h, w) chroma -> (..., 2h, 2w) f32 with libjpeg's 'fancy'
    triangular filter (separable 3:1 blend toward the nearer neighbour).
    Exact in f32 for uint8 planes: every value is a multiple of 1/16
    below 256."""
    c = c.float()
    left = torch.cat([c[..., :, :1], c[..., :, :-1]], dim=-1)
    right = torch.cat([c[..., :, 1:], c[..., :, -1:]], dim=-1)
    h0 = (3.0 * c + left) * 0.25
    h1 = (3.0 * c + right) * 0.25
    h = torch.stack([h0, h1], dim=-1).flatten(-2)                 # (..., h, 2w)
    up = torch.cat([h[..., :1, :], h[..., :-1, :]], dim=-2)
    dn = torch.cat([h[..., 1:, :], h[..., -1:, :]], dim=-2)
    v0 = (3.0 * h + up) * 0.25
    v1 = (3.0 * h + dn) * 0.25
    return torch.stack([v0, v1], dim=-2).flatten(-3, -2)          # (..., 2h, 2w)


def yuv420_to_rgb_device(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """(..., H, W) Y + (..., H/2, W/2) Cb/Cr raw JPEG planes -> (..., H, W, 3)
    RGB uint8.

    The 2.5-byte/px serving path: the host ships the decoder's raw 4:2:0
    planes (native/imageio.cc::mmt_decode_jpeg_yuv420) and the chroma
    upsample + BT.601 conversion run on the device. Decode-grade accurate
    (within a couple of LSB of libjpeg's own RGB output — JPEG is lossy;
    NOT the bit-exact path, which ships RGB at 3 B/px). Rounds half to
    even, then clamps, as jnp.round and jnp.clip."""
    cbu = _upsample2x_triangular(cb) - 128.0
    cru = _upsample2x_triangular(cr) - 128.0
    yf = y.float()
    r = yf + 1.402 * cru
    g = yf - 0.344136286 * cbu - 0.714136286 * cru
    b = yf + 1.772 * cbu
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp_(0, 255).to(torch.uint8)


def compose_yuv_index_device(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                             idx_u8: torch.Tensor, lut_rgb: torch.Tensor) -> torch.Tensor:
    """Raw 4:2:0 planes + JET index -> (..., H, W, 6) rgbcolormap frame.
    The minimum-byte streaming compose (2.5 B/px on the wire)."""
    return torch.cat([yuv420_to_rgb_device(y, cb, cr), _gather_lut(lut_rgb, idx_u8)], dim=-1)
