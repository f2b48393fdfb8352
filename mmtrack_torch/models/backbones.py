"""ResNet-18 with the VGG-M conv1 tap, ECO's and C-COT's feature network,
port of mmtrack_tpu/models/backbones.py::ResNetVGGm1 (:130-175).

'vggconv1' is a 96-channel 7 x 7 / 2 convolution with a bias, a ReLU and
VGG-M's cross-channel LRN: x / (k + alpha * mean(x^2 over 5 channels))^beta
with k = 2, the window zero-padded at the channel ends and its five terms
added in JAX's order. The trunk is the port's ResNet-18 (BasicBlocks,
frozen batch norm), built up to the deepest requested stage. Public
tensors are NHWC. Parameter names are the reference's (`vggmconv1.*`,
`conv1`, `bn1`, `layer{i}.{b}.*`), those that
mmtrack_tpu/models/convert.py::convert_eco_backbone_checkpoint reads.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import ResNet


def vggm_lrn(x: torch.Tensor, size: int = 5, alpha: float = 0.0005, beta: float = 0.75,
             k: float = 2.0) -> torch.Tensor:
    """SpatialCrossMapLRN over the channels of NCHW x, the window averaged:
    x / (k + alpha * mean(x^2 over the window))^beta."""
    sq = x * x
    C, half = x.shape[1], (size - 1) // 2
    pad = F.pad(sq, (0, 0, 0, 0, half, half))
    win = div_const(sum(pad[:, i:i + C] for i in range(size)), size)
    return x / (k + alpha * win) ** beta


class ResNetVGGm1(ResNet):
    """ResNet-18 up to `last_layer` plus the 'vggconv1' tap; forward(x (B, H,
    W, 3), out_layers) returns the requested NHWC maps ('vggconv1', 'conv1',
    'layer1'..)."""

    def __init__(self, last_layer: str = "layer3", device=None):
        super().__init__(stage_sizes=(2, 2, 2, 2), last_layer=last_layer, device=device)
        self.vggmconv1 = Conv2d(3, 96, 7, stride=2, padding=3, device=device)

    def forward(self, x: torch.Tensor,
                out_layers: Sequence[str] = ("vggconv1", "layer3")) -> dict:
        trunk = [name for name in out_layers if name != "vggconv1"]
        out = super().forward(x, trunk) if trunk else {}
        if "vggconv1" in out_layers:
            c1 = torch.relu(self.vggmconv1(x.permute(0, 3, 1, 2)))
            out["vggconv1"] = vggm_lrn(c1).permute(0, 2, 3, 1)
        return {name: out[name] for name in out_layers}


def resnet18_vggmconv1(last_layer: str = "layer3", device=None) -> ResNetVGGm1:
    return ResNetVGGm1(last_layer=last_layer, device=device)
