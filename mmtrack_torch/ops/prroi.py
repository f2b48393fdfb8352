"""Precise RoI Pooling (PrRoI), port of mmtrack_tpu/ops/prroi.py.

The exact integral of the bilinearly interpolated feature over each pooling
bin, in its separable form: with the hat basis hat(t) = max(0, 1 - |t|),

    avg over bin = (1/area) * sum_p f[py, px] * Wy(py) * Wx(px),
    Wx(p) = integral of hat(x - p) over [u1, u2]   (closed form),

so the op is two small weight matrices contracted with the feature map
(`einsum`). The JAX package has no Pallas kernel here; autograd gives the
feature and coordinate gradients.
"""

from __future__ import annotations

import torch


def _hat_integral_cdf(t: torch.Tensor) -> torch.Tensor:
    """H(t) = integral of max(0, 1 - |s|) from -inf to t; H(inf) = 1."""
    t = torch.clamp(t, -1.0, 1.0)
    neg = 0.5 * (t + 1.0) ** 2
    pos = 1.0 - 0.5 * (1.0 - t) ** 2
    return torch.where(t <= 0.0, neg, pos)


def _axis_weights(lo: torch.Tensor, hi: torch.Tensor, size: int) -> torch.Tensor:
    """Integral of each pixel's hat basis over [lo, hi]: (R, P) bounds ->
    (R, P, size). Pixels outside the feature extent contribute nothing."""
    p = torch.arange(size, dtype=torch.float32, device=lo.device)
    return (_hat_integral_cdf(hi[..., None] - p) - _hat_integral_cdf(lo[..., None] - p))


def prroi_pool(feat: torch.Tensor, rois: torch.Tensor, pooled_h: int, pooled_w: int,
               spatial_scale: float = 1.0) -> torch.Tensor:
    """Batched PrRoI pooling with the reference's RoI convention.

    feat (B, H, W, C); rois (R, 5) rows [batch_index, x1, y1, x2, y2] in
    image coordinates, scaled by `spatial_scale`. Returns (R, Ph, Pw, C)
    f32. An inverted RoI is clamped to zero width or height before binning
    (prroi_pooling_gpu_impl.cu:176-177), and a zero-area bin returns 0.
    """
    H, W = feat.shape[1], feat.shape[2]
    f = feat.float()[rois[:, 0].long()]                        # (R, H, W, C)
    x1, y1, x2, y2 = (rois[:, 1:5].float() * spatial_scale).unbind(1)
    bin_w = torch.clamp(x2 - x1, min=0.0) / pooled_w
    bin_h = torch.clamp(y2 - y1, min=0.0) / pooled_h
    jx = torch.arange(pooled_w, dtype=torch.float32, device=feat.device)
    iy = torch.arange(pooled_h, dtype=torch.float32, device=feat.device)
    u1 = x1[:, None] + jx * bin_w[:, None]
    u2 = u1 + bin_w[:, None]
    v1 = y1[:, None] + iy * bin_h[:, None]
    v2 = v1 + bin_h[:, None]

    wx = _axis_weights(u1, u2, W)                              # (R, Pw, W)
    wy = _axis_weights(v1, v2, H)                              # (R, Ph, H)
    acc = torch.einsum("rph,rqw,rhwc->rpqc", wy, wx, f)
    area = (bin_w * bin_h)[:, None, None, None]
    out = acc / torch.clamp(area, min=1e-12)
    return torch.where(area > 0, out, torch.zeros_like(out))
