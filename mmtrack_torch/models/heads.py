"""Box heads, port of mmtrack_tpu/models/heads.py (CENTER head only).

The conv towers run NCHW inside the module; its input and output maps are
NHWC like the JAX package's. Parameter names are the reference's
(`box_head.conv{k}_{ctr,offset,size}.{0,1}.*`, head.py:98-201).
CornerPredictor and MLPHead are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from mmtrack_torch.models.layers import Conv2d


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (frozen_bn.py), over dim 1 (NCHW).

    y = x * inv + (bias - mean * inv), inv = weight / sqrt(var + eps), in
    f32 whatever the input dtype (flax promotes the bf16 conv output to the
    f32 parameters here).
    """

    eps = 1e-5

    def __init__(self, ch: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("weight", torch.ones(ch, **f32))
        self.register_buffer("bias", torch.zeros(ch, **f32))
        self.register_buffer("running_mean", torch.zeros(ch, **f32))
        self.register_buffer("running_var", torch.ones(ch, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x.float() * inv[:, None, None] + shift[:, None, None]


class ConvBNRelu(nn.Sequential):
    """3x3 conv (SAME) + FrozenBatchNorm + ReLU; children named 0, 1, 2."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32, device=None,
                 param_dtype=None):
        super().__init__(Conv2d(in_ch, out_ch, 3, padding=1, dtype=dtype, device=device,
                                param_dtype=param_dtype),
                         FrozenBatchNorm(out_ch, device=device),
                         nn.ReLU())


class CenterPredictor(nn.Module):
    """Centre heatmap + size + offset head (head.py:98-201).

    forward((B, S, S, C) NHWC features) -> score (B, S, S), size
    (B, S, S, 2), offset (B, S, S, 2), all f32.
    """

    BRANCHES = {"ctr": 1, "offset": 2, "size": 2}

    def __init__(self, inplanes: int = 768, channel: int = 256, dtype=torch.float32,
                 device=None, param_dtype=None):
        super().__init__()
        widths = [inplanes, channel, channel // 2, channel // 4, channel // 8]
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        for branch, out_ch in self.BRANCHES.items():
            for k in range(1, 5):
                self.add_module(f"conv{k}_{branch}", ConvBNRelu(widths[k - 1], widths[k], **kw))
            self.add_module(f"conv5_{branch}", Conv2d(widths[4], out_ch, 1, **kw))

    def _conv_tower(self, branch: str, x: torch.Tensor) -> torch.Tensor:
        """conv1..conv4 (BN + ReLU) then the 1x1 projection of one branch."""
        for k in range(1, 6):
            x = getattr(self, f"conv{k}_{branch}")(x)
        return x

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        score = self._conv_tower("ctr", x)[:, 0]
        offset = self._conv_tower("offset", x).permute(0, 2, 3, 1)
        size = self._conv_tower("size", x).permute(0, 2, 3, 1)

        def clamp(v):
            return torch.clamp(torch.sigmoid(v.float()), 1e-4, 1 - 1e-4)

        return clamp(score), clamp(size), offset.float()


def cal_bbox(score_map: torch.Tensor, size_map: torch.Tensor, offset_map: torch.Tensor):
    """Decode (cx, cy, w, h) in [0, 1] crop coordinates from the head maps
    (head.py:142-160): first-index argmax cell + sub-cell offset, size at the
    argmax. Returns (bbox (B, 4), max_score (B,))."""
    B, S, _ = score_map.shape
    flat = score_map.reshape(B, S * S)
    idx = torch.argmax(flat, dim=1)
    max_score = torch.gather(flat, 1, idx[:, None])[:, 0]
    idx_y = torch.div(idx, S, rounding_mode="floor").float()
    idx_x = (idx % S).float()
    g = idx[:, None, None].expand(-1, 1, 2)
    size = torch.gather(size_map.reshape(B, S * S, 2), 1, g)[:, 0]
    offset = torch.gather(offset_map.reshape(B, S * S, 2), 1, g)[:, 0]
    bbox = torch.stack([(idx_x + offset[:, 0]) / S, (idx_y + offset[:, 1]) / S,
                        size[:, 0], size[:, 1]], dim=1)
    return bbox, max_score
