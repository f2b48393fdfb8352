"""The ATOM network, port of mmtrack_tpu/models/atom.py: ResNet-18 to
layer3 (twice for DeT's RGB-D variants, merged per layer by max, mean, mul
or two 1x1 convolutions) and the ATOM IoUNet over layer2 / layer3 (128 /
256 channels). ATOM has no learned classifier: its filter is optimised
online (trackers/atom_tracker.py).

Parameter names are the reference torch ones that
mmtrack_tpu/models/convert.py::convert_atom_checkpoint reads (a subset of
DiMPnet's: `feature_extractor.*`, `feature_extractor_depth.*`,
`merge_layer{2,3}`, `bb_regressor.*`), so `dimp_state_dict_from_flax`
bridges a flax ATOMNet tree too. Public tensors are NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmtrack_torch.models.dimp import AtomIoUNet, _nchw, _nhwc
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import resnet18

ATOM_MERGES = ("max", "mean", "mul", "conv")


class ATOMNet(nn.Module):
    """Backbone (x2 for DeT) + IoUNet; the classification features are the
    raw layer3 activations (256 channels)."""

    def __init__(self, merge_type: Optional[str] = None):
        super().__init__()
        if merge_type is not None and merge_type not in ATOM_MERGES:
            raise ValueError(f"unknown merge type {merge_type}")
        self.merge_type = merge_type
        self.feature_extractor = resnet18("layer3")
        if merge_type is not None:
            self.feature_extractor_depth = resnet18("layer3")
            if merge_type == "conv":
                self.merge_layer2 = Conv2d(2 * 128, 128, 1)
                self.merge_layer3 = Conv2d(2 * 256, 256, 1)
        self.bb_regressor = AtomIoUNet(input_dim=(128, 256))

    def _merge(self, a: torch.Tensor, b: torch.Tensor, layer: str) -> torch.Tensor:
        m = self.merge_type
        if m == "max":
            return torch.maximum(a, b)
        if m == "mean":
            return 0.5 * (a + b)
        if m == "mul":
            return a * b
        conv = self.merge_layer2 if layer == "layer2" else self.merge_layer3
        return _nhwc(conv(torch.cat([_nchw(a), _nchw(b)], dim=1)))

    def extract_backbone(self, im: torch.Tensor) -> dict:
        """im (N, H, W, 3 | 6) normalised -> {'layer2', 'layer3'} NHWC."""
        layers = ("layer2", "layer3")
        f_rgb = self.feature_extractor(im[..., :3], layers)
        if self.merge_type is None:
            return f_rgb
        f_x = self.feature_extractor_depth(im[..., 3:6], layers)
        return {k: self._merge(f_rgb[k], f_x[k], k) for k in f_rgb}

    def forward(self, train_im: torch.Tensor, train_bb: torch.Tensor,
                test_proposals: torch.Tensor) -> torch.Tensor:
        """IoU of proposals (N, P, 4) on the image's own features, with the
        modulation of its box (N, 4) (ATOMnet.forward)."""
        feat = self.extract_backbone(train_im)
        feats = [feat["layer2"], feat["layer3"]]
        iou = self.bb_regressor
        return iou.predict_iou(iou.get_modulation(feats, train_bb), iou.get_iou_feat(feats),
                               test_proposals)


def build_atom() -> ATOMNet:
    """Plain RGB ATOM (atom_resnet18)."""
    return ATOMNet(merge_type=None)


def build_det_atom(merge_type: str = "max") -> ATOMNet:
    """DeT's RGB-D ATOM variants (DeT_ATOM_{Max,Mean,MC})."""
    return ATOMNet(merge_type=merge_type)
