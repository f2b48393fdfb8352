"""DAFNet and MaCNet, RGB-T fusion trackers on the MDNet chassis, port of
mmtrack_tpu/models/rgbt_fusion.py (built there from the papers; the
reference repo holds both as empty submodules).

  DAFNet  per-stage adaptive fusion: gates from the pooled statistics of
          both streams blend them, and both streams continue from the blend
  MaCNet  per-modality channel attention per stage, plus a cross-layer
          aggregation of the stage-1 and stage-2 features into the feature

NCHW; the conv3 flattens are CHW (the weight bridge permutes fc4's rows
of the two conv blocks from the JAX package's HWC; MaCNet's cross-layer
features c1 / c2 keep their order). With no reference torch names, the
parameters are named after the flax modules (`layers_{v,i}` share
models/mdnet.py's `conv{i}.0`; `fuse{s}.{squeeze,excite}`,
`att_{v,i}{s}`, `cross{1,2}`, `fc4`, `fc5`, `fc6`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.mdnet import MDNetHead, SharedConvs, dropout


class AdaptiveFusionGate(nn.Module):
    """DAFNet's fusion: gates from the pooled joint statistics blend the
    streams; returns (fused, gate_v, gate_i)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.squeeze = nn.Linear(2 * channels, channels // 2)
        self.excite = nn.Linear(channels // 2, 2 * channels)

    def forward(self, fv, fi):
        stats = torch.cat([fv.mean((2, 3)), fi.mean((2, 3))], -1)
        g = torch.sigmoid(self.excite(F.relu(self.squeeze(stats))))
        gv = g[:, :self.channels, None, None]
        gi = g[:, self.channels:, None, None]
        return gv * fv + gi * fi, gv, gi


class _FusionHead(MDNetHead):
    """fc4 / fc5 / fc6 scoring with dropout keys fold_in(key, 5) and
    fold_in(key, 6), as both JAX models take them."""

    @staticmethod
    def _is_fc(name):
        return name.split(".")[0].startswith("fc")

    @staticmethod
    def _fc_layer(name):
        return name.split(".")[0]

    def score(self, feats, branch: int = 0, keep=None, fc=None) -> torch.Tensor:
        k4, k6 = keep if keep is not None else (None, None)
        h = dropout(F.relu(self._linear(feats, fc, "fc4")), k4)
        h = F.relu(self._linear(h, fc, "fc5")).flatten(1)
        return self._linear(dropout(h, k6), fc, "fc6")

    def dropout_masks(self, draws, key, n: int):
        return (draws.bernoulli(draws.fold_in(key, 5), 0.5, (n, 1, 512)),
                draws.bernoulli(draws.fold_in(key, 6), 0.5, (n, 512)))

    def forward(self, patches, branch: int = 0):
        return self.score(self.extract_features(patches), branch)


class DAFNet(_FusionHead):
    """Recursive adaptive fusion: (N, 6, 107, 107) -> (N, 1, 4608)."""

    def __init__(self):
        super().__init__()
        self.layers_v = SharedConvs()
        self.layers_i = SharedConvs()
        self.fuse1 = AdaptiveFusionGate(96)
        self.fuse2 = AdaptiveFusionGate(256)
        self.fuse3 = AdaptiveFusionGate(512)
        self.fc4 = nn.Linear(512 * 9, 512)
        self.fc5 = nn.Linear(512, 512)
        self.fc6 = nn.Linear(512, 2)

    def extract_features(self, patches: torch.Tensor) -> torch.Tensor:
        fv, fi = self.layers_v.stage1(patches[:, :3]), self.layers_i.stage1(patches[:, 3:6])
        fused = self.fuse1(fv, fi)[0]
        fv, fi = self.layers_v.stage2(fused), self.layers_i.stage2(fused)
        fused = self.fuse2(fv, fi)[0]
        fv, fi = self.layers_v.stage3(fused), self.layers_i.stage3(fused)
        return self.fuse3(fv, fi)[0].flatten(1)[:, None]


class MaCNet(_FusionHead):
    """Channel attention per stream and stage + cross-layer aggregation:
    (N, 6, 107, 107) -> (N, 1, 2 * 4608 + 256)."""

    def __init__(self):
        super().__init__()
        self.layers_v = SharedConvs()
        self.layers_i = SharedConvs()
        for s, c in enumerate((96, 256, 512)):
            setattr(self, f"att_v{s}", nn.Linear(c, c))
            setattr(self, f"att_i{s}", nn.Linear(c, c))
        self.cross1 = nn.Linear(2 * 96, 128)
        self.cross2 = nn.Linear(2 * 256, 128)
        self.fc4 = nn.Linear(2 * 512 * 9 + 256, 512)
        self.fc5 = nn.Linear(512, 512)
        self.fc6 = nn.Linear(512, 2)

    def _attend(self, f, s, which):
        att = torch.sigmoid(getattr(self, f"att_{which}{s}")(f.mean((2, 3))))
        return f * att[:, :, None, None]

    def extract_features(self, patches: torch.Tensor) -> torch.Tensor:
        fv = self._attend(self.layers_v.stage1(patches[:, :3]), 0, "v")
        fi = self._attend(self.layers_i.stage1(patches[:, 3:6]), 0, "i")
        # flax's avg_pool(8, 8) is VALID: the 25 x 25 map loses its last row and column
        c1 = self.cross1(torch.cat([F.avg_pool2d(fv, 8, 8).mean((2, 3)),
                                    F.avg_pool2d(fi, 8, 8).mean((2, 3))], -1))
        fv = self._attend(self.layers_v.stage2(fv), 1, "v")
        fi = self._attend(self.layers_i.stage2(fi), 1, "i")
        c2 = self.cross2(torch.cat([fv.mean((2, 3)), fi.mean((2, 3))], -1))
        fv = self._attend(self.layers_v.stage3(fv), 2, "v")
        fi = self._attend(self.layers_i.stage3(fi), 2, "i")
        return torch.cat([fv.flatten(1), fi.flatten(1), c1, c2], -1)[:, None]
