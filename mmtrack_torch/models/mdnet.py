"""The MDNet family's network, port of mmtrack_tpu/models/mdnet.py: VGG-M
candidate scoring with its multi-modal topologies.

  single   RGB only (canonical MDNet)
  dual     one shared trunk + fc4/fc5 applied to each modality, fc6 on the
           concatenation (pyMDNet RGB-E) or on the sum (pyVITAL)
  adapter  MANet: the shared trunk with per-modality adapter branches
           summed into each stage, the conv3 streams concatenated before fc4

107x107 input -> conv1 7x7/2 + LRN + pool 3/2 -> conv2 5x5/2 + LRN + pool
3/2 -> conv3 3x3 -> (512, 3, 3). The port is NCHW, so the conv3 flatten
is CHW, as the reference torch models' is (the JAX package's is HWC; the
weight bridge permutes fc4's input rows).

Parameter names are the reference's torch ones, which the JAX package's
converters read: `layers.conv{1,2,3}.0`, `layers.fc4.0` (MANet:
`layers.fc4.1`), `layers.fc5.1`, `branches.{k}.1`, and MANet's adapters
`{RGB,T}_para{s}_{k}x{k}.{R,T}conv{s}.{0,2}`. The Sequentials hold an
identity where the reference holds a ReLU, an LRN or a Dropout, so the
indices match; the forward calls the layers themselves.

Dropout in `score` takes its keep masks from the caller (`dropout_masks`
draws them through the tracker's draw source, with the JAX model's keys),
never from torch's global generator. The fully connected layers can run
on explicit tensors (`fc=`), which the online fine-tuning trains.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.heads import FrozenBatchNorm

FEAT_HW = 3          # conv3's spatial side on 107 px crops
FEAT_DIM = 512       # conv3's channels per stream


def lrn(x: torch.Tensor, size: int = 2, style: str = "torch") -> torch.Tensor:
    """Local response normalisation across the channels of an NCHW map.

    style 'torch': nn.LocalResponseNorm's defaults (pyMDNet), the trailing
    window [c-size+1, c], k=1, alpha=1e-4/size, beta=0.75; 'manet':
    MANet's centred window of 5, k=2, alpha=1e-4."""
    if style == "torch":
        k, alpha, beta = 1.0, 1e-4 / size, 0.75
        lo, hi = size - 1, 0
    elif style == "manet":
        size, k, alpha, beta = 5, 2.0, 1e-4, 0.75
        lo = hi = 2
    else:
        raise ValueError(style)
    C = x.shape[1]
    pad = F.pad(x * x, (0, 0, 0, 0, lo, hi))
    win = sum(pad[:, i:i + C] for i in range(size))
    return x / (k + alpha * win) ** beta


def _seq(index: int, layer: nn.Module) -> nn.Sequential:
    """A Sequential with `layer` at `index`, identities before it (the
    reference's ReLU / Dropout slots), so the parameter names match."""
    return nn.Sequential(*[nn.Identity() for _ in range(index)], layer)


class SharedConvs(nn.Module):
    """The VGG-M trunk stage by stage, so adapters and fusions can interleave;
    `conv{i}.0` as the reference's `layers.conv{i}.0`."""

    def __init__(self, lrn_style: str = "torch"):
        super().__init__()
        self.lrn_style = lrn_style
        self.conv1 = _seq(0, nn.Conv2d(3, 96, 7, stride=2))
        self.conv2 = _seq(0, nn.Conv2d(96, 256, 5, stride=2))
        self.conv3 = _seq(0, nn.Conv2d(256, 512, 3))

    def stage1(self, x):
        return F.max_pool2d(lrn(F.relu(self.conv1[0](x)), style=self.lrn_style), 3, 2)

    def stage2(self, x):
        return F.max_pool2d(lrn(F.relu(self.conv2[0](x)), style=self.lrn_style), 3, 2)

    def stage3(self, x):
        return F.relu(self.conv3[0](x))

    def forward(self, x):
        return self.stage3(self.stage2(self.stage1(x)))


class Adapter(nn.Module):
    """MANet's modality adapter: a stride-2 conv, ReLU, frozen BatchNorm,
    then max-pool 5/2 in the first two adapters (`{R,T}conv{s}.{0,2}`)."""

    def __init__(self, prefix: str, in_ch: int, out_ch: int, kernel: int, pool: bool):
        super().__init__()
        self.prefix, self.pool = prefix, pool
        setattr(self, prefix, nn.Sequential(nn.Conv2d(in_ch, out_ch, kernel, stride=2),
                                            nn.Identity(), FrozenBatchNorm(out_ch)))

    def forward(self, x):
        conv, _, bn = getattr(self, self.prefix)
        y = bn(F.relu(conv(x)))
        return F.max_pool2d(y, 5, 2) if self.pool else y


def dropout(h: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverted dropout at rate 0.5 with a given keep mask (None: off)."""
    return h if keep is None else torch.where(keep, h / 0.5, 0.0)


class MDNetHead(nn.Module):
    """The scoring interface the tracker drives, shared by the MDNet family's
    models: `extract_features(patches NCHW) -> (N, streams, D)`,
    `score(feats, branch, keep, fc) -> (N, 2)`, the trainable leaves
    (`fc_leaves`, the ones whose flax name starts with fc) and the keep
    masks of the training forward (`dropout_masks`)."""

    streams = 1
    in_channels = 6

    def fc_names(self) -> list[str]:
        """The trainable leaves in the JAX tree's order (fc4, fc5, fc6; bias
        before kernel)."""
        names = [n for n, _ in self.named_parameters() if self._is_fc(n)]
        return sorted(names, key=lambda n: (self._fc_layer(n), n.endswith("weight")))

    def fc_leaves(self) -> dict[str, torch.Tensor]:
        params = dict(self.named_parameters())
        return {n: params[n] for n in self.fc_names()}

    def is_fc6(self, name: str) -> bool:
        return self._fc_layer(name).startswith("fc6")

    def _fc(self, fc, name):
        return fc[name] if fc is not None and name in fc else self.get_parameter(name)

    def _linear(self, x, fc, prefix):
        return F.linear(x, self._fc(fc, f"{prefix}.weight"), self._fc(fc, f"{prefix}.bias"))


class MDNet(MDNetHead):
    """MDNet with a selectable multi-modal topology (module docstring)."""

    def __init__(self, mode: str = "dual", num_branches: int = 1, fc6_merge: str = "concat"):
        super().__init__()
        if mode not in ("single", "dual", "adapter"):
            raise ValueError(mode)
        self.mode, self.fc6_merge = mode, fc6_merge
        self.streams = 2 if mode == "dual" else 1
        self.in_channels = 3 if mode == "single" else 6
        self.layers = SharedConvs(lrn_style="manet" if mode == "adapter" else "torch")
        width = 2 * FEAT_DIM if mode == "adapter" else FEAT_DIM
        self.layers.fc4 = _seq(1 if mode == "adapter" else 0,
                               nn.Linear(width * FEAT_HW * FEAT_HW, 512))
        self.layers.fc5 = _seq(1, nn.Linear(512, 512))
        fc6_in = 512 * (2 if mode == "dual" and fc6_merge == "concat" else 1)
        self.branches = nn.ModuleList(_seq(1, nn.Linear(fc6_in, 2)) for _ in range(num_branches))
        if mode == "adapter":
            for tag, m in (("RGB", "R"), ("T", "T")):
                setattr(self, f"{tag}_para1_3x3", Adapter(f"{m}conv1", 3, 96, 3, True))
                setattr(self, f"{tag}_para2_1x1", Adapter(f"{m}conv2", 96, 256, 1, True))
                setattr(self, f"{tag}_para3_1x1", Adapter(f"{m}conv3", 256, 512, 1, False))

    @staticmethod
    def _is_fc(name):
        return name.startswith(("layers.fc", "branches."))

    @staticmethod
    def _fc_layer(name):
        return f"fc6_{name.split('.')[1]}" if name.startswith("branches.") else name.split(".")[1]

    def _adapter_stream(self, x, tag):
        f = self.layers
        a1, a2, a3 = (getattr(self, f"{tag}_para{s}_{k}x{k}") for s, k in ((1, 3), (2, 1), (3, 1)))
        h = f.stage1(x) + a1(x)
        h = f.stage2(h) + a2(h)
        return f.stage3(h) + a3(h)

    def extract_features(self, patches: torch.Tensor) -> torch.Tensor:
        """(N, C, 107, 107) -> (N, streams, D) conv features, CHW flattened."""
        rgb = patches[:, :3]
        if self.mode == "single":
            return self.layers(rgb).flatten(1)[:, None]
        x = patches[:, 3:6]
        if self.mode == "dual":
            return torch.stack([self.layers(rgb).flatten(1), self.layers(x).flatten(1)], 1)
        f = torch.cat([self._adapter_stream(rgb, "RGB"), self._adapter_stream(x, "T")], 1)
        return f.flatten(1)[:, None]

    def fc4_name(self) -> str:
        return f"layers.fc4.{1 if self.mode == 'adapter' else 0}"

    def score(self, feats, branch: int = 0, keep=None, fc=None) -> torch.Tensor:
        """(N, streams, D) -> (N, 2) background / target logits; `keep` the
        two dropout masks of a training forward (None: off)."""
        k4, k6 = keep if keep is not None else (None, None)
        h = dropout(F.relu(self._linear(feats, fc, self.fc4_name())), k4)
        h = F.relu(self._linear(h, fc, "layers.fc5.1"))
        h = h.sum(1) if self.fc6_merge == "sum" else h.flatten(1)
        return self._linear(dropout(h, k6), fc, f"branches.{branch}.1")

    def dropout_masks(self, draws, key, n: int):
        """The keep masks of `n` samples: JAX's bernoulli(key) after fc4 and
        bernoulli(fold_in(key, 6)) before fc6."""
        s6 = 512 if self.fc6_merge == "sum" else 512 * self.streams
        return (draws.bernoulli(key, 0.5, (n, self.streams, 512)),
                draws.bernoulli(draws.fold_in(key, 6), 0.5, (n, s6)))

    def forward(self, patches, branch: int = 0):
        return self.score(self.extract_features(patches), branch)
