"""VITAL's adversarial feature masks on the MDNet chassis, port of
mmtrack_tpu/models/vital.py: a generator G maps conv3 features to a (3, 3)
spatial mask; the classifier trains against G's hardest masks and G
against the classifier (trackers/mdnet_tracker.py runs both online).

The port's conv3 features are CHW flattened (models/mdnet.py), so a mask
cell (h, w) scales channels c at offset c * 9 + h * 3 + w, the same cell
and channels as the JAX package's HWC offset (h * 3 + w) * 512 + c. G's
fc1 takes the CHW flatten (the weight bridge permutes its input rows).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.mdnet import FEAT_DIM, FEAT_HW


class GNet(nn.Module):
    """Mask generator: (N, 512 * 3 * 3) conv3 features -> (N, 3, 3) mask in
    (0, 1) (g_init.py). `forward(x, g)` runs on explicit tensors `g`
    (named as the parameters), which the online G steps train."""

    def __init__(self, feat_hw: int = FEAT_HW, feat_dim: int = FEAT_DIM):
        super().__init__()
        self.feat_hw = feat_hw
        self.fc1 = nn.Linear(feat_hw * feat_hw * feat_dim, 256)
        self.fc2 = nn.Linear(256, feat_hw * feat_hw)

    def forward(self, feat_flat: torch.Tensor, g: dict | None = None) -> torch.Tensor:
        g = g if g is not None else dict(self.named_parameters())
        h = F.relu(F.linear(feat_flat, g["fc1.weight"], g["fc1.bias"]))
        m = F.linear(h, g["fc2.weight"], g["fc2.bias"])
        return torch.sigmoid(m).reshape(-1, self.feat_hw, self.feat_hw)

    def init_from(self, draws, key) -> dict:
        """Fresh G tensors from the draw source: flax's default init, a
        LeCun normal of the fan in (clipped at two deviations, the
        truncation's scale) and zero biases."""
        k1, k2 = draws.split(key)
        out = {}
        for k, name in ((k1, "fc1"), (k2, "fc2")):
            w = getattr(self, name).weight
            std = 1.0 / math.sqrt(w.shape[1]) / 0.87962566103423978
            out[f"{name}.weight"] = draws.normal(k, tuple(w.shape)).clamp(-2.0, 2.0) * std
            out[f"{name}.bias"] = torch.zeros(w.shape[0])
        return out


def apply_mask(feat_flat: torch.Tensor, mask: torch.Tensor, feat_hw: int = FEAT_HW,
               feat_dim: int = FEAT_DIM) -> torch.Tensor:
    """Broadcast (N, 3, 3) masks over the channels of CHW-flattened conv3
    features (N, 512 * 9)."""
    n = feat_flat.shape[0]
    f = feat_flat.reshape(n, feat_dim, feat_hw, feat_hw)
    return (f * mask[:, None]).reshape(n, -1)


def one_cell_masks(feat_hw: int = FEAT_HW, device=None) -> torch.Tensor:
    """The feat_hw^2 masks that each drop one cell, (cells, hw, hw)."""
    n = feat_hw * feat_hw
    return (1.0 - torch.eye(n, device=device)).reshape(n, feat_hw, feat_hw)


def hardest_fixed_mask(score_fn, feat_flat: torch.Tensor, feat_hw: int = FEAT_HW,
                       feat_dim: int = FEAT_DIM) -> torch.Tensor:
    """g_pretrain's trick: of the one-cell-dropped masks, the one that lowers
    the mean softmax positive probability most (g_pretrain.py:44); the
    lower cell index on a tie, as jnp.argmin."""
    masks = one_cell_masks(feat_hw, feat_flat.device)
    n = feat_flat.shape[0]
    scores = torch.stack([
        torch.softmax(score_fn(apply_mask(feat_flat, m.expand(n, -1, -1), feat_hw, feat_dim)),
                      -1)[:, 1].mean() for m in masks])
    return masks[torch.argmin(scores)]


def g_loss(gnet: GNet, g: dict | None, score_fn, pos_feats: torch.Tensor) -> torch.Tensor:
    """G's objective: the classifier's mean positive logit on the features
    G masks (G minimises it)."""
    return score_fn(apply_mask(pos_feats, gnet(pos_feats, g)))[:, 1].mean()
