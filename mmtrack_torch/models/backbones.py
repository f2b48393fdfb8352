"""The auxiliary backbones, port of mmtrack_tpu/models/backbones.py: the
MobileNetV3-Large feature pyramid (:27-127, 178-180) and ResNet-18 with the
VGG-M conv1 tap, ECO's and C-COT's feature network (:130-175).

MobileNetV3-Large (DeT's ltr/models/backbone/mobilenetv3.py): a stride-2
3x3 stem with hard swish, six stages of inverted-residual blocks (1x1
expand, depthwise k x k, optional squeeze-excite with a hard-sigmoid gate,
1x1 project; ReLU or hard swish; the residual where stride 1 keeps the
width) and a 960-wide 1x1 head, every BN frozen. No recipe builds it and
the JAX package has no torch converter for it, so its parameters keep the
flax names (`init_conv`, `init_bn`, `layer{s}.{b}.{expand,expand_bn,dw,
dw_bn,se.fc1,se.fc2,project,project_bn}`, `out_conv1`, `out_conv1_bn`);
models/convert.py::mobilenet_state_dict_from_flax carries a flax tree.

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

from torch import nn

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d, Dense
from mmtrack_torch.models.resnet import ResNet


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6 (mobilenetv3.py:31-37)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6 (mobilenetv3.py:40-47)."""
    return x * h_sigmoid(x)


class SqueezeExcite(nn.Module):
    """Squeeze-excite with a hard-sigmoid gate (SqueezeBlock,
    mobilenetv3.py:60-78) on NCHW maps."""

    def __init__(self, channels: int, divide: int = 4, device=None):
        super().__init__()
        self.fc1 = Dense(channels, channels // divide, device=device)
        self.fc2 = Dense(channels // divide, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean(dim=(2, 3))))
        return x * h_sigmoid(self.fc2(s))[:, :, None, None]


class MobileBlock(nn.Module):
    """Inverted residual (MobileBlock, mobilenetv3.py:80-130): 1x1 expand +
    BN + act, depthwise k x k + BN, squeeze-excite, 1x1 project + BN + act;
    `nonlinear` 'RE' (ReLU) or 'HS' (hard swish)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, nonlinear: str,
                 se: bool, exp_size: int, device=None):
        super().__init__()
        self.act = torch.relu if nonlinear == "RE" else h_swish
        self.use_connect = stride == 1 and in_ch == out_ch
        self.expand = Conv2d(in_ch, exp_size, 1, bias=False, device=device)
        self.expand_bn = FrozenBatchNorm(exp_size, device=device)
        self.dw = Conv2d(exp_size, exp_size, kernel, stride=stride, padding=(kernel - 1) // 2,
                         groups=exp_size, device=device)
        self.dw_bn = FrozenBatchNorm(exp_size, device=device)
        self.se = SqueezeExcite(exp_size, device=device) if se else None
        self.project = Conv2d(exp_size, out_ch, 1, device=device)
        self.project_bn = FrozenBatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.expand_bn(self.expand(x)))
        y = self.dw_bn(self.dw(y))
        if self.se is not None:
            y = self.se(y)
        y = self.act(self.project_bn(self.project(y)))
        return x + y if self.use_connect else y


# MobileNetV3-Large: (out, kernel, stride, nonlinear, SE, expansion) per block,
# grouped into layer1..layer6 as mobilenetv3.py:139-190 nests them
LARGE_STAGES = (
    ((16, 3, 1, "RE", False, 16),),
    ((24, 3, 2, "RE", False, 64), (24, 3, 1, "RE", False, 72)),
    ((40, 5, 2, "RE", True, 72), (40, 5, 1, "RE", True, 120), (40, 5, 1, "RE", True, 120)),
    ((80, 3, 2, "HS", False, 240), (80, 3, 1, "HS", False, 200),
     (80, 3, 1, "HS", False, 184), (80, 3, 1, "HS", False, 184)),
    ((112, 3, 1, "HS", True, 480), (112, 3, 1, "HS", True, 672)),
    ((160, 5, 1, "HS", True, 672), (160, 5, 2, "HS", True, 672),
     (160, 5, 1, "HS", True, 960)),
)
MOBILENET_LAYERS = ("init_conv",) + tuple(f"layer{i + 1}" for i in range(6)) + ("out_conv1",)


class MobileNetV3(nn.Module):
    """MobileNetV3-Large pyramid (mobilenetv3.py:133-210); forward(x (B, H,
    W, 3), out_layers) -> NHWC maps: 'init_conv' (stride 2, 16 ch),
    'layer1' (2), 'layer2' (4, 24), 'layer3' (8, 40), 'layer4' (16, 80),
    'layer5' (16, 112), 'layer6' (32, 160), 'out_conv1' (32, 960)."""

    def __init__(self, device=None):
        super().__init__()
        self.init_conv = Conv2d(3, 16, 3, stride=2, padding=1, device=device)
        self.init_bn = FrozenBatchNorm(16, device=device)
        ch = 16
        for s, blocks in enumerate(LARGE_STAGES):
            mods = []
            for oc, k, st, nl, se, exp in blocks:
                mods.append(MobileBlock(ch, oc, k, st, nl, se, exp, device=device))
                ch = oc
            self.add_module(f"layer{s + 1}", nn.Sequential(*mods))
        self.out_conv1 = Conv2d(ch, 960, 1, device=device)
        self.out_conv1_bn = FrozenBatchNorm(960, device=device)

    def forward(self, x: torch.Tensor, out_layers: Sequence[str] = ("layer3", "layer4")) -> dict:
        out = {}
        y = h_swish(self.init_bn(self.init_conv(x.permute(0, 3, 1, 2))))
        out["init_conv"] = y
        for s in range(len(LARGE_STAGES)):
            y = getattr(self, f"layer{s + 1}")(y)
            out[f"layer{s + 1}"] = y
        out["out_conv1"] = h_swish(self.out_conv1_bn(self.out_conv1(y)))
        return {k: out[k].permute(0, 2, 3, 1) for k in out_layers}


def mobilenetv3_large(device=None) -> MobileNetV3:
    return MobileNetV3(device=device)


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
