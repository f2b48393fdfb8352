"""STM (Space-Time Memory network) for mask tracking, port of
mmtrack_tpu/models/stm.py.

A memory encoder (a ResNet-50 trunk to layer3 whose conv1 output gets 7x7
convs of the target mask and of the other objects' mask added before bn1),
a query encoder (a plain trunk), key / value heads on layer3, the
space-time memory read (a softmax over time x space of the query keys
against every valid memory position) and the refinement decoder
(ResBlock, two Refine stages, a 2-class head, a 4x bilinear upsample).

Single-object runtime form: the reference's K = 2 soft aggregation and
the tracker's softmax sharpen the object probability to
sigmoid(2 logit(p)), with its 1e-7 clamp (stm.py:149-157). The memory is
a fixed number of slots with a validity mask folded into the softmax as
-1e30 logits.

The modules run NCHW; frames in and key / value maps out are NHWC like
the JAX package's. Parameter names are the reference's that
mmtrack_tpu/models/convert.py::convert_stm_checkpoint (:695-752) reads:
`Encoder_M.{conv1_m,conv1_o}.weight`, the trunks `Encoder_{M,Q}.{conv1,
bn1,layer1..layer3}.*` (torchvision's stage names; the converter also
takes STM.pth's res2..res4 for them), `KV_{M,Q}_r4.{Key,Value}.*` and
`Decoder.{convFM,ResMM,RF3,RF2,pred2}.*`. The trunks stop at layer3, the
deepest stage STM reads; the weight bridge leaves the JAX trunks' layer4
leaves out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import ResNet

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _conv3(in_ch: int, out_ch: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, padding=1)


class ResBlock(nn.Module):
    """Pre-activation residual block with biased 3x3 convs (stm.py:37-51)."""

    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.conv1 = _conv3(in_ch, dim)
        self.conv2 = _conv3(dim, dim)
        self.downsample = _conv3(in_ch, dim) if in_ch != dim else None

    def forward(self, x):
        r = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return (x if self.downsample is None else self.downsample(x)) + r


class Refine(nn.Module):
    """Skip fusion and a 2x bilinear upsample (stm.py:54-67)."""

    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.convFS = _conv3(in_ch, dim)
        self.ResFS = ResBlock(dim, dim)
        self.ResMM = ResBlock(dim, dim)

    def forward(self, f, pm):
        s = self.ResFS(self.convFS(f))
        up = F.interpolate(pm, size=(2 * pm.shape[2], 2 * pm.shape[3]), mode="bilinear",
                           align_corners=False)
        return self.ResMM(s + up)


class STMEncoder(ResNet):
    """A ResNet-50 trunk to layer3; the memory encoder's also holds the
    mask and other-objects convs whose sum enters conv1_add."""

    def __init__(self, memory: bool):
        super().__init__(stage_sizes=(3, 4, 6, 3), last_layer="layer3", block="bottleneck")
        if memory:
            self.conv1_m = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
            self.conv1_o = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)


class _KV(nn.Module):
    def __init__(self, in_ch: int, keydim: int, valdim: int):
        super().__init__()
        self.Key = _conv3(in_ch, keydim)
        self.Value = _conv3(in_ch, valdim)

    def forward(self, x):
        return self.Key(x), self.Value(x)


class _Decoder(nn.Module):
    def __init__(self, valdim: int, mdim: int):
        super().__init__()
        self.convFM = _conv3(2 * valdim, mdim)
        self.ResMM = ResBlock(mdim, mdim)
        self.RF3 = Refine(512, mdim)
        self.RF2 = Refine(256, mdim)
        self.pred2 = _conv3(mdim, 2)


class STMNet(nn.Module):
    """stm.py:70-163, single object; keydim 128, valdim 512, mdim 256."""

    def __init__(self, keydim: int = 128, valdim: int = 512, mdim: int = 256):
        super().__init__()
        self.keydim, self.valdim = keydim, valdim
        self.Encoder_M = STMEncoder(memory=True)
        self.Encoder_Q = STMEncoder(memory=False)
        self.KV_M_r4 = _KV(1024, keydim, valdim)
        self.KV_Q_r4 = _KV(1024, keydim, valdim)
        self.Decoder = _Decoder(valdim, mdim)
        self.register_buffer("mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_STD), persistent=False)

    def _norm(self, frame: torch.Tensor) -> torch.Tensor:
        return (frame - self.mean) / self.std

    def memorize(self, frame: torch.Tensor, mask: torch.Tensor,
                 other: Optional[torch.Tensor] = None):
        """frame (B, H, W, 3) in [0, 1], mask / other (B, H, W) -> key
        (B, h, w, keydim) and value (B, h, w, valdim), NHWC, stride 16."""
        enc = self.Encoder_M
        add = enc.conv1_m(mask[:, None])
        if other is not None:   # without one, conv1_o of zeros adds nothing
            add = add + enc.conv1_o(other[:, None])
        r4 = enc(self._norm(frame), ("layer3",), conv1_add=add.permute(0, 2, 3, 1))["layer3"]
        k, v = self.KV_M_r4(r4.permute(0, 3, 1, 2))
        return k.permute(0, 2, 3, 1), v.permute(0, 2, 3, 1)

    def query_features(self, frame: torch.Tensor):
        r = self.Encoder_Q(self._norm(frame), ("layer1", "layer2", "layer3"))
        return r["layer3"], r["layer2"], r["layer1"]

    def segment(self, frame: torch.Tensor, mem_keys: torch.Tensor, mem_vals: torch.Tensor,
                mem_valid: torch.Tensor) -> torch.Tensor:
        """frame (1, H, W, 3); mem_keys (T, h, w, keydim), mem_vals (T, h, w,
        valdim), mem_valid (T,) in {0, 1} -> the aggregated object
        probability (H, W)."""
        r4, r3, r2 = (x.permute(0, 3, 1, 2) for x in self.query_features(frame))
        qk, qv = self.KV_Q_r4(r4)
        T, h, w, kd = mem_keys.shape
        mk = mem_keys.reshape(T * h * w, kd)
        mv = mem_vals.reshape(T * h * w, self.valdim)
        # (query position, memory position): the softmax runs along rows
        logits = div_const(qk[0].reshape(kd, h * w).t() @ mk.t(), math.sqrt(kd))
        valid = mem_valid[:, None].expand(T, h * w).reshape(1, -1)
        logits = torch.where(valid > 0, logits, -1e30)
        p = torch.softmax(logits, dim=1)                        # over time x space
        mem = (p @ mv).t().reshape(1, self.valdim, h, w)
        dec = self.Decoder
        m4 = dec.ResMM(dec.convFM(torch.cat([mem, qv], dim=1)))
        m3 = dec.RF3(r3, m4)
        m2 = dec.RF2(r2, m3)
        logit = dec.pred2(torch.relu(m2))
        H, W = frame.shape[1:3]
        logit = F.interpolate(logit, size=(H, W), mode="bilinear", align_corners=False)
        ps = torch.softmax(logit, dim=1)[0, 1]
        em1 = torch.clamp(ps, 1e-7, 1 - 1e-7)
        em0 = torch.clamp(1.0 - ps, 1e-7, 1 - 1e-7)
        l1 = torch.log(em1 / (1.0 - em1))
        l0 = torch.log(em0 / (1.0 - em0))
        return torch.exp(l1 - torch.logaddexp(l0, l1))

    def forward(self, frame, mask):
        k, v = self.memorize(frame, mask)
        return self.segment(frame, k, v, torch.ones((1,), device=frame.device))


def build_stm() -> STMNet:
    return STMNet()
