"""KYS ("Know Your Surroundings"), port of mmtrack_tpu/models/kys.py.

A DiMP-50 base (backbone to layer3, the Gauss-Newton classifier, ATOM's
IoUNet) and a scene-propagation predictor carrying an 8-channel state per
search-region cell across frames:

  1. a local cost volume between the previous and current frame's layer3
     features (kernel 3, displacement up to 9, indexed by the previous
     cell);
  2. two softmaxes of the processed volume: where each previous cell went
     and where each current cell came from;
  3. the state propagated along them and updated by a ConvGRU;
  4. a small CNN fusing the propagated state, the DiMP score and the
     propagation confidence into the response.

The cost volume is one batched f32 product over flattened positions and a
9-tap diagonal box sum; it expects TF32 off (the entries turn it off), as
JAX asks for Precision.HIGHEST. The feature shift is a four-tap bilinear
gather with zeros outside, `map_coordinates(order=1, mode='constant')`'s
taps in its order. Public maps are NHWC like the JAX package's.

Parameter names are the upstream kys.pth's, which
mmtrack_tpu/models/convert.py::convert_kys_checkpoint (:498) reads:
`backbone_feature_extractor.*`, `dimp_classifier.*`, `bb_regressor.*` and
`predictor.predictor.*`, the conv blocks as Sequentials `.N.0` (conv) /
`.N.1` (BatchNorm). KYSNet presents DiMPNet's interface, so the DiMP
runtime's init, refinement and memory take it unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmtrack_torch.models.dimp import (
    AtomIoUNet,
    DiMPNet,
    LinearFilter,
    SteepestDescentGN,
    _nchw,
    _nhwc,
    div_const,
)
from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import resnet50


def local_cost_volume(feat_cur: torch.Tensor, feat_prev: torch.Tensor, max_disp: int = 9,
                      kernel: int = 3) -> torch.Tensor:
    """corr[b, q, p] = sum over the k x k window of <f_cur[p + k],
    f_prev[q + k]> for |q - p| <= max_disp per axis, else 0. feat (B, H, W,
    C) -> (B, H * W (previous cell), H, W (current cell))."""
    B, H, W, C = feat_cur.shape
    h = torch.bmm(feat_cur.reshape(B, H * W, C), feat_prev.reshape(B, H * W, C).transpose(1, 2))
    r = kernel // 2
    hp = nn.functional.pad(h.reshape(B, H, W, H, W), (r, r, r, r, r, r, r, r))
    out = torch.zeros_like(h).reshape(B, H, W, H, W)
    for ky in range(kernel):
        for kx in range(kernel):
            out = out + hp[:, ky:ky + H, kx:kx + W, ky:ky + H, kx:kx + W]
    iy = torch.arange(H, device=h.device)
    ix = torch.arange(W, device=h.device)
    mask_y = (iy[:, None] - iy[None, :]).abs() <= max_disp
    mask_x = (ix[:, None] - ix[None, :]).abs() <= max_disp
    out = torch.where(mask_y[:, None, :, None] & mask_x[None, :, None, :], out, 0.0)
    return out.permute(0, 3, 4, 1, 2).reshape(B, H * W, H, W)


def shift_features(feat: torch.Tensor, t_norm: torch.Tensor) -> torch.Tensor:
    """output[y, x] = input[y + t_y H / 2, x + t_x W / 2], bilinear, zero
    outside (affine_grid + grid_sample(zeros, align_corners=False) with T =
    [I | t]). feat (H, W, C) or (B, H, W, C); t_norm (2,) (t_x, t_y) in
    normalised [-1, 1] units."""
    squeeze = feat.dim() == 3
    if squeeze:
        feat = feat[None]
    B, H, W, C = feat.shape
    dev = feat.device
    yy = torch.arange(H, dtype=torch.float32, device=dev) + t_norm[1] * H / 2.0
    xx = torch.arange(W, dtype=torch.float32, device=dev) + t_norm[0] * W / 2.0

    def taps(c):
        lo = torch.floor(c)
        w_hi = c - lo
        return (lo.long(), 1.0 - w_hi), (lo.long() + 1, w_hi)

    def read(iy, ix):
        valid = ((iy >= 0) & (iy < H))[:, None] & ((ix >= 0) & (ix < W))[None, :]
        v = feat[:, iy.clamp(0, H - 1)][:, :, ix.clamp(0, W - 1)]
        return torch.where(valid[None, :, :, None], v, 0.0)

    out = None
    for iy, wy in taps(yy):
        for ix, wx in taps(xx):
            term = (wy[:, None] * wx[None, :])[None, :, :, None] * read(iy, ix)
            out = term if out is None else out + term
    return out[0] if squeeze else out


def center_shift_translation(box_xywh: torch.Tensor, feat_hw: tuple[int, int],
                             feature_stride: int = 16) -> torch.Tensor:
    """The normalised (t_x, t_y) that centres `box` (crop coordinates) in
    the feature map."""
    H, W = feat_hw
    c_x = (box_xywh[0] + box_xywh[2] * 0.5) / feature_stride
    c_y = (box_xywh[1] + box_xywh[3] * 0.5) / feature_stride
    return torch.stack([div_const(2.0 * (c_x - W * 0.5), W), div_const(2.0 * (c_y - H * 0.5), H)])


class _ConvBN(nn.Sequential):
    """conv_block: a 3x3 'same' conv (child 0), FrozenBatchNorm (child 1)
    if asked, ReLU if asked."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, batch_norm: bool = True,
                 relu: bool = True, bias: bool = True):
        layers = [Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, bias=bias)]
        if batch_norm:
            layers.append(FrozenBatchNorm(out_ch))
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class ConvGRUCell(nn.Module):
    """Convolutional GRU on NCHW maps."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        c = input_dim + hidden_dim
        self.conv_reset = Conv2d(c, hidden_dim, kernel, padding=kernel // 2)
        self.conv_update = Conv2d(c, hidden_dim, kernel, padding=kernel // 2)
        self.conv_state_new = Conv2d(c, hidden_dim, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        xh = torch.cat([x, h], dim=1)
        reset = torch.sigmoid(self.conv_reset(xh))
        update = torch.sigmoid(self.conv_update(xh))
        h_new = torch.tanh(self.conv_state_new(torch.cat([x, reset * h], dim=1)))
        return (1.0 - update) * h + update * h_new


class ResponsePredictor(nn.Module):
    """The scene-propagation response predictor (kys.py:177-281) at
    kysnet_res50's settings: the 'max' propagation confidence, the GRU
    kernel 3, representation widths 64 and 32."""

    def __init__(self, state_dim: int = 8):
        super().__init__()
        self.state_dim = state_dim
        self.cost_volume_proc1 = nn.Sequential(_ConvBN(1, 8), _ConvBN(8, 1, relu=False))
        self.cost_volume_proc2 = nn.Sequential(_ConvBN(1, 8), _ConvBN(8, 1, relu=False))
        self.representation_predictor = nn.Sequential(
            _ConvBN(state_dim + 2, 64, batch_norm=False), _ConvBN(64, 32, batch_norm=False))
        self.response_predictor = nn.Sequential(_ConvBN(32, 1, batch_norm=False, relu=False))
        self.state_predictor = ConvGRUCell(4, state_dim)
        self.init_hidden_state_predictor = nn.Sequential(
            _ConvBN(1, state_dim, batch_norm=False, relu=False, bias=False))
        self.is_target_predictor = nn.Sequential(
            _ConvBN(state_dim, 4, batch_norm=False), _ConvBN(4, 1, batch_norm=False, relu=False))

    def init_state(self, init_label: torch.Tensor) -> torch.Tensor:
        """(B, H, W) label -> (B, H, W, state_dim) initial state."""
        return _nhwc(torch.tanh(self.init_hidden_state_predictor(init_label[:, None])))

    def is_target(self, state: torch.Tensor) -> torch.Tensor:
        """The target-presence map (B, H, W) of a state (B, H, W, state_dim)."""
        return self.is_target_predictor(_nchw(state))[:, 0]

    def forward(self, cost_volume: torch.Tensor, state_prev: torch.Tensor,
                dimp_score_cur: torch.Tensor, dimp_thresh: Optional[float] = None,
                output_window: Optional[torch.Tensor] = None):
        """cost_volume (B, HW_prev, H, W), state_prev (B, H, W, state_dim),
        dimp_score_cur (B, H, W). Returns (fused (B, H, W), new state (B, H,
        W, state_dim), aux {'cost_volume_processed', 'propagated_h',
        'propagation_conf', 'fused_score_orig'})."""
        B, P, H, W = cost_volume.shape
        aux = {}
        # where each previous cell went: a softmax over the current cells
        p1 = self.cost_volume_proc1(cost_volume.reshape(B * P, 1, H, W)).reshape(B * P, H * W)
        p1 = torch.softmax(p1, dim=-1)
        # where each current cell came from: a softmax over the previous ones
        p2 = self.cost_volume_proc2(p1.reshape(B * P, 1, H, W)).reshape(B, P, H, W)
        p2 = torch.softmax(p2, dim=1)
        aux["cost_volume_processed"] = p2

        w = p2.reshape(B, P, H * W)
        propagated = torch.einsum("bpq,bpd->bqd", w, state_prev.reshape(B, P, self.state_dim))
        propagated = propagated.reshape(B, H, W, self.state_dim)
        aux["propagated_h"] = propagated

        score = dimp_score_cur[:, None]                              # (B, 1, H, W)
        conf = w.max(dim=1).values.reshape(B, 1, H, W)
        aux["propagation_conf"] = conf[:, 0]
        rep = self.representation_predictor(torch.cat([_nchw(propagated), score, conf], dim=1))
        fused = torch.sigmoid(self.response_predictor(rep))            # (B, 1, H, W)
        aux["fused_score_orig"] = fused[:, 0]
        if dimp_thresh is not None:
            fused = fused * (score > dimp_thresh).to(fused.dtype)
        if output_window is not None:
            fused = fused * output_window[None, None]

        # the GRU on the two scores and their global maxima
        scores_cat = torch.cat([score, fused], dim=1)
        pooled = scores_cat.amax(dim=(2, 3), keepdim=True).expand_as(scores_cat)
        state_new = self.state_predictor(torch.cat([scores_cat, pooled], dim=1),
                                         _nchw(propagated))
        return fused[:, 0], _nhwc(state_new), aux


class PredictorWrapper(nn.Module):
    """Holds the response predictor as `predictor.predictor`, the
    reference's nesting."""

    def __init__(self, predictor: ResponsePredictor):
        super().__init__()
        self.predictor = predictor


class KYSNet(nn.Module):
    """KYSNet (kysnet.py:17-110): DiMP-50 under the upstream names and the
    response predictor. The DiMP methods are DiMPNet's, reading the
    backbone and classifier through the `feature_extractor` and
    `classifier` properties; the motion features are the raw layer3 map."""

    merge_type = None
    extract_backbone = DiMPNet.extract_backbone
    extract_classification_feat = DiMPNet.extract_classification_feat
    get_filter = DiMPNet.get_filter
    optimize_filter = DiMPNet.optimize_filter
    classify = DiMPNet.classify

    def __init__(self):
        super().__init__()
        self.state_dim = 8
        self.backbone_feature_extractor = resnet50("layer3")
        self.dimp_classifier = LinearFilter(SteepestDescentGN(num_iter=5), 1024, 512, 4, 16)
        self.bb_regressor = AtomIoUNet()
        self.predictor = PredictorWrapper(ResponsePredictor(self.state_dim))

    @property
    def feature_extractor(self):
        return self.backbone_feature_extractor

    @property
    def classifier(self):
        return self.dimp_classifier

    def motion_feat(self, bfeat: dict) -> torch.Tensor:
        return bfeat["layer3"]

    def init_motion_state(self, init_label: torch.Tensor) -> torch.Tensor:
        return self.predictor.predictor.init_state(init_label)

    def predict_response(self, feat_prev, feat_cur, state_prev, dimp_score_cur,
                         dimp_thresh=None, output_window=None):
        """The cost volume and the response predictor (the coordinate shifts
        are the tracker's)."""
        cv = local_cost_volume(feat_cur, feat_prev)
        return self.predictor.predictor(cv, state_prev, dimp_score_cur, dimp_thresh,
                                        output_window)


def build_kysnet() -> KYSNet:
    """kysnet_res50's constructor defaults (kys.py:365-367)."""
    return KYSNet()
