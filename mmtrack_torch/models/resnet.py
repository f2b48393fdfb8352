"""ResNets with frozen batch norm, port of mmtrack_tpu/models/resnet.py
(BasicBlock, Bottleneck, ResNet, resnet18, resnet50).

The modules run NCHW; the public input and outputs are NHWC like the JAX
package's. Padding is explicit and symmetric (resnet.py:28-31, torch's
convention under stride 2), the max pool pads by one with -inf
(resnet.py:91, as `F.max_pool2d` does), and the 1x1 downsample has no
padding (flax's SAME pads nothing for a 1x1 kernel). Only the stages up to
the deepest requested layer are built: Alpha-Refine reads `layer2`, so
its trunk stops there, and the weight bridge leaves the JAX tree's
layer3/layer4 leaves out; STARK's ResNet-50 stops at `layer3`.

Parameter names follow torchvision (`layer1.0.conv1.weight`,
`layer2.0.downsample.{0,1}.*`). `forward`'s `conv1_add` is added to conv1's
output before bn1, as STM's memory encoder needs (resnet.py:80-90).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d

LAYERS = ("conv1", "layer1", "layer2", "layer3", "layer4")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, bias=False)
        self.conv1 = Conv2d(in_ch, planes, 3, stride=stride, padding=1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(Conv2d(in_ch, planes, 1, stride=stride, **kw),
                                            FrozenBatchNorm(planes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, explicit symmetric padding) -> 1x1 to 4 planes,
    each with FrozenBatchNorm (resnet.py:43-67)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, bias=False)
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv2d(planes, out_ch, 1, **kw)
        self.bn3 = FrozenBatchNorm(out_ch, device=device)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(Conv2d(in_ch, out_ch, 1, stride=stride, **kw),
                                            FrozenBatchNorm(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """ResNet of BasicBlocks or Bottlenecks returning a dict of NHWC feature
    maps.

    `last_layer` is the deepest stage built ('conv1', 'layer1'..'layer4');
    forward(x (B, H, W, in_channels), out_layers) selects among the built
    ones. Strides and widths match torchvision (layer2: stride 8, 128
    channels for BasicBlocks, 512 for Bottlenecks). `in_channels` is
    conv1's input width, which flax infers from the init's input (LWL's
    `--channels 6` builds a 6-channel stem).
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), last_layer: str = "layer4",
                 dtype=torch.float32, device=None, block: str = "basic", in_channels: int = 3):
        super().__init__()
        Block = Bottleneck if block == "bottleneck" else BasicBlock
        self.dtype = dtype
        self.n_stages = LAYERS.index(last_layer)
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, dtype=dtype, device=device,
                            bias=False)
        self.bn1 = FrozenBatchNorm(64, device=device)
        in_ch, planes = 64, 64
        for stage in range(self.n_stages):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(stage_sizes[stage]):
                blocks.append(Block(in_ch, planes, stride if b == 0 else 1, dtype=dtype,
                                    device=device))
                in_ch = planes * Block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x: torch.Tensor, out_layers: Sequence[str] = ("layer2",),
                conv1_add: torch.Tensor | None = None) -> dict:
        """x (B, H, W, in_channels); conv1_add, when given, (B, H/2, W/2, 64) NHWC
        like x, is added to conv1's output before bn1."""
        out = {}
        y = self.conv1(x.permute(0, 3, 1, 2))
        if conv1_add is not None:
            y = y + conv1_add.permute(0, 3, 1, 2)
        y = torch.relu(self.bn1(y))
        out["conv1"] = y
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for stage in range(self.n_stages):
            y = getattr(self, f"layer{stage + 1}")(y)
            out[f"layer{stage + 1}"] = y
        return {k: out[k].permute(0, 2, 3, 1) for k in out_layers}


def resnet18(last_layer: str = "layer4", dtype=torch.float32, device=None) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), last_layer=last_layer, dtype=dtype, device=device)


def resnet50(last_layer: str = "layer4", dtype=torch.float32, device=None,
             in_channels: int = 3) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), last_layer=last_layer, dtype=dtype, device=device,
                  block="bottleneck", in_channels=in_channels)
