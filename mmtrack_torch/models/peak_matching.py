"""KeepTrack's learned peak matcher (SuperGlue's GNN + Sinkhorn), port of
mmtrack_tpu/models/peak_matching.py.

  - DescriptorExtractor: a 4x4 conv (pad 2) over the raw layer3 features,
    read at the peak cells;
  - KeypointEncoder: an MLP over (x, y, score);
  - AttentionalGNN: 9 self / cross pairs of 4-head attentional message
    passing at width 256, one module for both sides of a layer;
  - log-domain Sinkhorn with a learned dustbin score, then mutual-max
    filtering.

The peak sets are fixed K slots with a validity mask. Invalid slots get a
finite -1e4 (NEG) marginal and score, not -inf, so their mass drains to
the dustbin and the log-sum-exps stay finite.

The layout is the reference's: channels first (B, C, K), every layer a
k=1 Conv1d, the MLPs Conv1d / eval-mode BatchNorm1d (eps 1e-5) / ReLU,
and the attention's channels split d-major (`view(b, head_dim, heads,
n)`). Parameter names are those of the reference's PeakMatchingNetwork,
which mmtrack_tpu/models/convert.py::convert_peak_matching_checkpoint
(:1201) reads: `descriptor_extractor.conv`, `matcher.kenc.encoder.{i}`,
`matcher.gnn.layers.{l}.update.attn.{proj.{0,1,2},merge}`,
`matcher.gnn.layers.{l}.update.mlp.{i}`, `matcher.final_proj`,
`matcher.bin_score`. The descriptors enter the matcher at its own width
(the tracker builds it so), so there is no input projection.
`matcher_nll_loss` (training) is not ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.vipt import init_weights

NEG = -1e4
HEADS = 4
KENC_LAYERS = (32, 64, 128, 256)
GNN_BLOCKS = 9                     # self / cross pairs
SINKHORN_ITERS = 50
FILTER_THRESHOLD = 0.2             # a set-0 peak's match probability must pass it


class MLP(nn.Sequential):
    """Conv1d-k1 layers with BatchNorm1d + ReLU between them: children
    0, 3, 6, ... are the convs, 1, 4, ... the norms."""

    def __init__(self, channels: Sequence[int]):
        layers = []
        for i in range(1, len(channels)):
            layers.append(nn.Conv1d(channels[i - 1], channels[i], 1))
            if i < len(channels) - 1:
                layers += [nn.BatchNorm1d(channels[i], eps=1e-5), nn.ReLU()]
        super().__init__(*layers)


def normalize_keypoints(kpts: torch.Tensor, size_wh) -> torch.Tensor:
    """(kpts - size / 2) / (0.7 * max(size)) for constant sizes, the
    division a product with the f32 reciprocal as in JAX's jitted step."""
    w, h = float(size_wh[0]), float(size_wh[1])
    f = float(np.float32(max(w, h)) * np.float32(0.7))
    centred = torch.stack([kpts[..., 0] - w / 2, kpts[..., 1] - h / 2], dim=-1)
    return div_const(centred, f)


class KeypointEncoder(nn.Module):
    def __init__(self, out_dim: int = 256):
        super().__init__()
        self.encoder = MLP([3, *KENC_LAYERS, out_dim])

    def forward(self, kpts: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        """kpts (B, K, 2), scores (B, K) -> (B, out_dim, K)."""
        return self.encoder(torch.cat([kpts.transpose(1, 2), scores[:, None]], dim=1))


class MultiHeadedAttention(nn.Module):
    def __init__(self, dim: int = 256):
        super().__init__()
        self.heads, self.head_dim = HEADS, dim // HEADS
        self.merge = nn.Conv1d(dim, dim, 1)
        self.proj = nn.ModuleList(nn.Conv1d(dim, dim, 1) for _ in range(3))

    def forward(self, q, k, v, kv_valid=None):
        """(B, dim, N) each; kv_valid (B, M) bool."""
        B = q.shape[0]
        q, k, v = (p(x).view(B, self.head_dim, self.heads, -1)
                   for p, x in zip(self.proj, (q, k, v)))
        logits = torch.einsum("bdhn,bdhm->bhnm", q, k) * self.head_dim ** -0.5
        if kv_valid is not None:
            logits = torch.where(kv_valid[:, None, None, :], logits, NEG)
        a = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhnm,bdhm->bdhn", a, v)
        return self.merge(out.reshape(B, self.head_dim * self.heads, -1))


class AttentionalPropagation(nn.Module):
    def __init__(self, dim: int = 256):
        super().__init__()
        self.attn = MultiHeadedAttention(dim)
        self.mlp = MLP([2 * dim, 2 * dim, dim])

    def forward(self, x, source, source_valid):
        return self.mlp(torch.cat([x, self.attn(x, source, source, source_valid)], dim=1))


class _GNNLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.update = AttentionalPropagation(dim)


class AttentionalGNN(nn.Module):
    """Alternating self / cross layers; both sides of a layer go through
    its module as one batch of 2B."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.layers = nn.ModuleList(_GNNLayer(dim) for _ in range(2 * GNN_BLOCKS))

    def forward(self, d0, d1, v0, v1):
        B = d0.shape[0]
        x = torch.cat([d0, d1])
        v_self, v_cross = torch.cat([v0, v1]), torch.cat([v1, v0])
        for i, layer in enumerate(self.layers):
            if i % 2 == 0:
                src, valid = x, v_self
            else:
                src, valid = torch.cat([x[B:], x[:B]]), v_cross
            x = x + layer.update(x, src, valid)
        return x[:B], x[B:]


def log_sinkhorn(couplings, log_mu, log_nu, iters: int):
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores, bin_score, valid0, valid1, iters: int = SINKHORN_ITERS):
    """Optimal transport with a dustbin row and column; invalid slots get
    a NEG marginal, so they drain into the dustbin."""
    B, m, n = scores.shape
    bins0 = bin_score.expand(B, m, 1)
    bins1 = bin_score.expand(B, 1, n)
    alpha = bin_score.expand(B, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], 2), torch.cat([bins1, alpha], 2)], 1)
    ms = valid0.sum(1).float()
    ns = valid1.sum(1).float()
    norm = -torch.log(torch.clamp(ms + ns, min=1.0))
    log_mu = torch.cat([torch.where(valid0, norm[:, None], NEG),
                        (torch.log(torch.clamp(ns, min=1e-6)) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(valid1, norm[:, None], NEG),
                        (torch.log(torch.clamp(ms, min=1e-6)) + norm)[:, None]], 1)
    return log_sinkhorn(couplings, log_mu, log_nu, iters) - norm[:, None, None]


class DescriptorExtractor(nn.Module):
    """A 4x4 conv with pad 2 over the feature map, read at the peak cells.
    The even kernel makes its output (H + 1, W + 1), the score grid the
    peaks live on, so the cells are clipped to H and W, not H - 1."""

    def __init__(self, descriptor_dim: int = 256, feat_dim: int = 1024):
        super().__init__()
        self.conv = Conv2d(feat_dim, descriptor_dim, 4, padding=2)

    def forward(self, feat: torch.Tensor, coords_yx: torch.Tensor) -> torch.Tensor:
        """feat (H, W, C); coords (K, 2) (y, x) -> (K, D)."""
        H, W = feat.shape[0], feat.shape[1]
        f = self.conv(feat.permute(2, 0, 1)[None])[0]
        ys = torch.clamp(coords_yx[:, 0].long(), 0, H)
        xs = torch.clamp(coords_yx[:, 1].long(), 0, W)
        return f[:, ys, xs].T


class PeakMatcher(nn.Module):
    """SuperGlue over two fixed-K peak sets."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        self.descriptor_dim = descriptor_dim
        self.kenc = KeypointEncoder(descriptor_dim)
        self.gnn = AttentionalGNN(descriptor_dim)
        self.final_proj = nn.Conv1d(descriptor_dim, descriptor_dim, 1)
        self.bin_score = nn.Parameter(torch.zeros(()))

    def forward(self, desc0, kpts0, scores0, valid0, desc1, kpts1, scores1, valid1,
                image_size_wh=(288.0, 288.0)) -> dict:
        """desc (B, K, D), kpts (B, K, 2) (x, y), scores (B, K), valid (B, K)
        bool. Returns log_assignment (B, K0 + 1, K1 + 1), matches0/1 (an
        index into the other set or -1) and match_scores0/1."""
        kenc = self.kenc
        d0 = desc0.transpose(1, 2) + kenc(normalize_keypoints(kpts0, image_size_wh), scores0)
        d1 = desc1.transpose(1, 2) + kenc(normalize_keypoints(kpts1, image_size_wh), scores1)
        d0, d1 = self.gnn(d0, d1, valid0, valid1)
        m0, m1 = self.final_proj(d0), self.final_proj(d1)
        scores = div_const(torch.einsum("bdn,bdm->bnm", m0, m1), self.descriptor_dim ** 0.5)
        scores = torch.where(valid0[:, :, None] & valid1[:, None, :], scores, NEG)
        Z = log_optimal_transport(scores, self.bin_score, valid0, valid1)

        inner = Z[:, :-1, :-1]
        max0, m0_idx = inner.max(2).values, inner.argmax(2)
        m1_idx = inner.argmax(1)
        K0, K1 = inner.shape[1], inner.shape[2]
        mutual0 = torch.arange(K0, device=Z.device)[None] == m1_idx.gather(1, m0_idx)
        mutual1 = torch.arange(K1, device=Z.device)[None] == m0_idx.gather(1, m1_idx)
        mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
        # a set-1 peak inherits its mutual partner's probability and is
        # matched only if that partner passed the set-0 filter
        mscores1 = torch.where(mutual1, mscores0.gather(1, m1_idx), 0.0)
        valid_match0 = mutual0 & (mscores0 > FILTER_THRESHOLD) & valid0
        valid_match1 = mutual1 & valid_match0.gather(1, m1_idx) & valid1
        return {"log_assignment": Z, "matches0": torch.where(valid_match0, m0_idx, -1),
                "match_scores0": mscores0, "matches1": torch.where(valid_match1, m1_idx, -1),
                "match_scores1": mscores1}


class PeakMatchingNetwork(nn.Module):
    """The descriptor extractor and the matcher under the reference's names."""

    def __init__(self, descriptor_dim: int = 256, feat_dim: int = 1024):
        super().__init__()
        self.descriptor_extractor = DescriptorExtractor(descriptor_dim, feat_dim)
        self.matcher = PeakMatcher(descriptor_dim)


def init_peak_matching_weights(net: PeakMatchingNetwork, seed: int) -> PeakMatchingNetwork:
    """Seeded random weights (models/vipt.py::init_weights: LeCun-normal
    kernels, zero biases), unit BatchNorm statistics, bin_score 0 as JAX's
    init makes it."""
    init_weights(net, seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv1d):
                m.bias.zero_()
    return net


def matcher_nll_loss(log_assignment: torch.Tensor, gt_matches0: torch.Tensor,
                     valid0: torch.Tensor, valid1: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of the ground-truth assignment, SuperGlue's
    nll loss (peak_matching.py:251-263): a matched peak of set 0 reads its
    coupling entry, an unmatched one its dustbin column; averaged over the
    valid peaks of set 0 (at least 1). log_assignment (B, M + 1, N + 1),
    gt_matches0 (B, M) with -1 for unmatched; `valid1` is unread, as in
    the JAX package."""
    m = log_assignment.shape[1] - 1
    col = torch.where(gt_matches0 >= 0, gt_matches0,
                      torch.full_like(gt_matches0, log_assignment.shape[2] - 1))
    rows = torch.gather(log_assignment[:, :m, :], 2, col[:, :, None].long())[..., 0]
    weights = valid0.float()
    return -(rows * weights).sum() / torch.clamp(weights.sum(), min=1.0)
