"""RepVGG trunk, port of mmtrack_tpu/models/repvgg.py (SPT's
lib/models/stark/repvgg.py), the STARK-lightning backbone.

A training-time block has three parallel branches: a 3x3 conv + BN, a 1x1
conv + BN and, where the shapes allow, an identity BN. Its deploy form is
one 3x3 conv with a bias; `fuse_repvgg_params` computes it from the
three-branch state_dict (the reference's `switch_to_deploy`), in f64 as the
JAX package's pytree function does.

The modules run NCHW; the public input and outputs are NHWC. BN is frozen
statistics. Parameter names are the reference's: `stage0.rbr_dense.conv.*`,
`stage0.rbr_dense.bn.*`, `rbr_1x1`, `rbr_identity` (a BatchNorm2d's four
leaves), `rbr_reparam` in the deploy form, and `stage{s}.{b}.*` for the
blocks of stages 1-4. Only the stages up to the deepest requested tap are
built (STARK reads `stage3`, stride 16).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d

A0_BLOCKS = (2, 4, 14, 1)           # RepVGG-A0 (repvgg.py:238-247)
A0_WIDTH = (0.75, 0.75, 0.75, 2.5)
BASE = (64, 128, 256, 512)
STAGES = ("stage0", "stage1", "stage2", "stage3", "stage4")


class ConvBN(nn.Module):
    """conv_bn (repvgg.py:47-56): a conv without bias (`conv`), a frozen BN (`bn`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1,
                 device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                           bias=False, groups=groups, device=device)
        self.bn = FrozenBatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class RepVGGBlock(nn.Module):
    """RepVGGBlock (repvgg.py:59-116): relu(3x3 + 1x1 + identity BN), or
    relu(rbr_reparam(x)) when `deploy`."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, groups: int = 1,
                 deploy: bool = False, device=None):
        super().__init__()
        if deploy:
            self.rbr_reparam = Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, groups=groups,
                                      device=device)
            return
        self.rbr_dense = ConvBN(in_ch, out_ch, 3, stride, groups, device=device)
        self.rbr_1x1 = ConvBN(in_ch, out_ch, 1, stride, groups, device=device)
        if stride == 1 and in_ch == out_ch:
            self.rbr_identity = FrozenBatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "rbr_reparam"):
            return torch.relu(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if hasattr(self, "rbr_identity"):
            y = y + self.rbr_identity(x)
        return torch.relu(y)


class RepVGG(nn.Module):
    """RepVGG trunk (repvgg.py:197-236) built to `last_layer` ('stage0' at
    stride 2 .. 'stage4' at stride 32); forward(x (B, H, W, 3), out_layers)
    -> {tap: (B, h, w, C)} NHWC."""

    def __init__(self, num_blocks: Sequence[int] = A0_BLOCKS,
                 width: Sequence[float] = A0_WIDTH, deploy: bool = False,
                 last_layer: str = "stage4", device=None):
        super().__init__()
        self.n_stages = STAGES.index(last_layer)
        kw = dict(deploy=deploy, device=device)
        ch = min(64, int(64 * width[0]))
        self.stage0 = RepVGGBlock(3, ch, stride=2, **kw)
        for s in range(self.n_stages):
            planes = int(BASE[s] * width[s])
            blocks = []
            for b in range(num_blocks[s]):
                blocks.append(RepVGGBlock(ch, planes, stride=2 if b == 0 else 1, **kw))
                ch = planes
            self.add_module(f"stage{s + 1}", nn.Sequential(*blocks))
        self.out_channels = ch

    def forward(self, x: torch.Tensor, out_layers: Sequence[str] = ("stage3",)) -> dict:
        out = {}
        y = self.stage0(x.permute(0, 3, 1, 2))
        out["stage0"] = y
        for s in range(self.n_stages):
            y = getattr(self, f"stage{s + 1}")(y)
            out[f"stage{s + 1}"] = y
        return {k: out[k].permute(0, 2, 3, 1) for k in out_layers}


def repvgg_a0(deploy: bool = False, last_layer: str = "stage4", device=None) -> RepVGG:
    return RepVGG(deploy=deploy, last_layer=last_layer, device=device)


def _fuse_convbn(sd: dict, prefix: str, kernel: int) -> tuple[np.ndarray, np.ndarray]:
    """One branch -> its equivalent (3x3 OIHW kernel, bias) in f64
    (get_equivalent_kernel_bias, repvgg.py:138-176)."""
    k = sd[f"{prefix}.conv.weight"].double().numpy()
    inv = sd[f"{prefix}.bn.weight"].double().numpy() / np.sqrt(
        sd[f"{prefix}.bn.running_var"].double().numpy() + 1e-5)
    if kernel == 1:
        k = np.pad(k, ((0, 0), (0, 0), (1, 1), (1, 1)))
    bias = (sd[f"{prefix}.bn.bias"].double().numpy()
            - sd[f"{prefix}.bn.running_mean"].double().numpy() * inv)
    return k * inv[:, None, None, None], bias


def fuse_repvgg_params(state_dict: dict) -> dict:
    """A three-branch RepVGG state_dict -> its deploy form (one
    `rbr_reparam` 3x3 conv with bias a block), for `RepVGG(deploy=True)`
    (repvgg.py switch_to_deploy, :178-195; JAX repvgg.py::fuse_repvgg_params).
    Keys outside the blocks, and blocks under any prefix, are kept as they
    are; the forward equals the three-branch one up to f32 rounding."""
    blocks = sorted({k[:-len(".rbr_dense.conv.weight")] for k in state_dict
                     if k.endswith(".rbr_dense.conv.weight")})
    out = {k: v for k, v in state_dict.items()
           if not any(k.startswith(b + ".rbr_") for b in blocks)}
    for b in blocks:
        k3, b3 = _fuse_convbn(state_dict, f"{b}.rbr_dense", 3)
        k1, b1 = _fuse_convbn(state_dict, f"{b}.rbr_1x1", 1)
        k, bias = k3 + k1, b3 + b1
        if f"{b}.rbr_identity.weight" in state_dict:
            ident = {n: state_dict[f"{b}.rbr_identity.{n}"].double().numpy()
                     for n in ("weight", "bias", "running_mean", "running_var")}
            inv = ident["weight"] / np.sqrt(ident["running_var"] + 1e-5)
            in_ch = k.shape[1]
            for c in range(k.shape[0]):
                k[c, c % in_ch, 1, 1] += inv[c]
            bias = bias + ident["bias"] - ident["running_mean"] * inv
        out[f"{b}.rbr_reparam.weight"] = torch.from_numpy(k.astype(np.float32))
        out[f"{b}.rbr_reparam.bias"] = torch.from_numpy(bias.astype(np.float32))
    return out
