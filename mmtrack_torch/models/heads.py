"""Box heads, port of mmtrack_tpu/models/heads.py (the centre, corner and
MLP heads).

The conv towers run NCHW inside the module; its input and output maps are
NHWC like the JAX package's. Parameter names are the reference's
(`box_head.conv{k}_{ctr,offset,size}.{0,1}.*`, head.py:98-201; the corner
head's `conv{k}_{tl,br}`; the MLP head's `layers.{i}`, head.py:204-221).
"""

from __future__ import annotations

import torch
from torch import nn

from mmtrack_torch.models.layers import Conv2d, Dense


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (frozen_bn.py), over dim 1 (NCHW).

    y = x * inv + (bias - mean * inv), inv = weight / sqrt(var + eps), in
    f32 whatever the input dtype (flax promotes the bf16 conv output to the
    f32 parameters here).

    The four statistics are parameters, as they are `params` leaves of the
    JAX tree: a full fine-tune (no trainable mask) clips, decays and
    updates them like any other leaf; prompt tuning freezes them by name.
    """

    eps = 1e-5

    def __init__(self, ch: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(ch, **f32))
        self.bias = nn.Parameter(torch.zeros(ch, **f32))
        self.running_mean = nn.Parameter(torch.zeros(ch, **f32))
        self.running_var = nn.Parameter(torch.ones(ch, **f32))

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


def _add_tower(module: nn.Module, branch: str, in_ch: int, channel: int, out_ch: int,
               **kw) -> None:
    """conv1..conv4 (BN + ReLU, widths channel, /2, /4, /8) and a 1x1
    projection to `out_ch` (JAX heads.py::_ConvTower, :49-61)."""
    widths = [in_ch, channel, channel // 2, channel // 4, channel // 8]
    for k in range(1, 5):
        module.add_module(f"conv{k}_{branch}", ConvBNRelu(widths[k - 1], widths[k], **kw))
    module.add_module(f"conv5_{branch}", Conv2d(widths[4], out_ch, 1, **kw))


def _conv_tower(module: nn.Module, branch: str, x: torch.Tensor) -> torch.Tensor:
    """Run one branch built by `_add_tower` on NCHW features."""
    for k in range(1, 6):
        x = getattr(module, f"conv{k}_{branch}")(x)
    return x


class CenterPredictor(nn.Module):
    """Centre heatmap + size + offset head (head.py:98-201).

    forward((B, S, S, C) NHWC features) -> score (B, S, S), size
    (B, S, S, 2), offset (B, S, S, 2), all f32.
    """

    BRANCHES = {"ctr": 1, "offset": 2, "size": 2}

    def __init__(self, inplanes: int = 768, channel: int = 256, dtype=torch.float32,
                 device=None, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        for branch, out_ch in self.BRANCHES.items():
            _add_tower(self, branch, inplanes, channel, out_ch, **kw)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        score = _conv_tower(self, "ctr", x)[:, 0]
        offset = _conv_tower(self, "offset", x).permute(0, 2, 3, 1)
        size = _conv_tower(self, "size", x).permute(0, 2, 3, 1)

        def clamp(v):
            return torch.clamp(torch.sigmoid(v.float()), 1e-4, 1 - 1e-4)

        return clamp(score), clamp(size), offset.float()


class CornerPredictor(nn.Module):
    """Top-left / bottom-right corner heatmaps with a soft-argmax decode
    (head.py:24-95; JAX heads.py:137-168).

    forward((B, S, S, C) NHWC features) -> (B, 4) xyxy in [0, 1]; the
    softmax and the expected coordinates are computed in f32.
    """

    def __init__(self, inplanes: int = 256, channel: int = 256, feat_sz: int = 20,
                 stride: int = 16, dtype=torch.float32, device=None, param_dtype=None):
        super().__init__()
        self.feat_sz, self.stride = feat_sz, stride
        for branch in ("tl", "br"):
            _add_tower(self, branch, inplanes, channel, 1, dtype=dtype, device=device,
                       param_dtype=param_dtype)

    def forward(self, x: torch.Tensor, return_dist: bool = False):
        """With `return_dist`, (boxes, p_tl (B, S*S), p_br (B, S*S)): the
        corner probabilities as well (head.py:57-62)."""
        x = x.permute(0, 3, 1, 2)
        n = self.feat_sz
        coord = torch.arange(n, dtype=torch.float32, device=x.device) * self.stride
        cx = coord[None, :].expand(n, n).reshape(-1)
        cy = coord[:, None].expand(n, n).reshape(-1)

        def soft_argmax(score):
            prob = torch.softmax(score.reshape(score.shape[0], -1).float(), dim=1)
            return (prob * cx).sum(1), (prob * cy).sum(1), prob

        x_tl, y_tl, p_tl = soft_argmax(_conv_tower(self, "tl", x)[:, 0])
        x_br, y_br, p_br = soft_argmax(_conv_tower(self, "br", x)[:, 0])
        boxes = torch.stack([x_tl, y_tl, x_br, y_br], dim=1) / (n * self.stride)
        return (boxes, p_tl, p_br) if return_dist else boxes


class MLPHead(nn.Module):
    """N-layer perceptron box head (head.py:204-221, build_box_head's MLP
    branch: hidden = input dim, 4 outputs, 3 layers): ReLU between the
    layers, none after the last; `use_bn` puts a frozen BatchNorm after
    each layer (`bn.{i}`), as JAX's MLPHead(use_bn=True)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int = 4, num_layers: int = 3,
                 use_bn: bool = False, dtype=torch.float32, device=None, param_dtype=None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], dtype=dtype, device=device, param_dtype=param_dtype)
            for i in range(num_layers))
        self.bn = (nn.ModuleList(FrozenBatchNorm(d, device=device) for d in dims[1:])
                   if use_bn else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.bn is not None:
                x = self.bn[i](x[:, :, None, None])[:, :, 0, 0]
            if i < n - 1:
                x = torch.relu(x)
        return x



def cal_bbox(score_map: torch.Tensor, size_map: torch.Tensor, offset_map: torch.Tensor,
             idx: torch.Tensor | None = None):
    """Decode (cx, cy, w, h) in [0, 1] crop coordinates from the head maps
    (head.py:142-160): first-index argmax cell + sub-cell offset, size at the
    argmax. `idx` (B,) flat cells decode elsewhere than the argmax. Returns
    (bbox (B, 4), max_score (B,): the score at the decoded cell)."""
    B, S, _ = score_map.shape
    flat = score_map.reshape(B, S * S)
    if idx is None:
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
