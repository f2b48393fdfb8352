"""DiMP / DeT / PrDiMP networks, port of mmtrack_tpu/models/dimp.py.

  - the classifier: classification features (Conv3x3 + InstanceL2Norm),
    the filter initializer (Conv3x3 + PrRoI pooling to the filter size)
    and the steepest-descent filter optimizers: DiMP's Gauss-Newton over
    learned label / target-mask / spatial-weight maps, PrDiMP's Newton
    step on the KL divergence to a Gaussian label density, and the hinge
    residual of super_dimp;
  - the ATOM IoUNet box regressor over PrRoI pooling;
  - DiMPNet: one ResNet-50 to layer3, or DeT's two (RGB and the depth
    colormap triplet), merged per layer by max, mul, mean, weightedSum
    (0.6 / 0.4) or a 1x1 conv.

The public tensors are NHWC like the JAX package's (feature maps are NHWC
views of NCHW memory, so the convolutions take them back for free); a
filter is (fh, fw, C). The filter gradient the JAX optimizers take as
`jax.vjp(apply_filter)` is written out here (`apply_feat_transpose`, the
reference's filter.py:57-168) as one `F.conv2d` of the features with the
residuals; no autograd runs inside an optimizer. `num_iter` is an int (a
plain loop) or a tensor: then `max_iter` iterations run and each is kept
only where its index is below `num_iter`, so the weights stay bit-equal
where an iteration is masked and no host read decides the cadence.

Parameter names are the reference torch ones that
mmtrack_tpu/models/convert.py::convert_dimp_checkpoint (:356-465) reads:
`feature_extractor.*`, `feature_extractor_depth.*`, `merge_layer{2,3}`,
`classifier.feature_extractor.0`, `classifier.filter_initializer.filter_conv`,
`classifier.filter_optimizer.{log_step_length, filter_reg,
label_map_predictor, target_mask_predictor.0, spatial_weight_predictor}`
(the hinge's `residual_module.filter_reg`) and `bb_regressor.*`. The
backbones stop at layer3, the deepest stage DiMP reads; the weight bridge
leaves the JAX tree's layer4 leaves out. The IoUNet's LinearBlocks
flatten their pooled maps in the reference's CHW order (the JAX package
flattens NHWC and permutes the converted weight instead).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import resnet50
from mmtrack_torch.models.vipt import init_weights
from mmtrack_torch.ops.prroi import prroi_pool

MERGE_MODES = ("max", "mul", "mean", "weightedSum", "conv")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- primitives

def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as the jitted JAX functions compute it: XLA turns a division by
    a constant into a product with its reciprocal rounded to f32 (PyTorch's
    CUDA division by a scalar does the same; its CPU one divides). The JAX
    trackers run jitted, so the port takes the product on every device."""
    return x * float(np.float32(1.0) / np.float32(c))


def instance_l2_norm(x: torch.Tensor, scale: float, eps: float = 1e-5) -> torch.Tensor:
    """x * scale * sqrt(numel / sum(x^2)) per sample (dimp.py:37-42); any
    layout, the sum runs over every axis but the first."""
    ss = (x * x).sum(dim=(1, 2, 3), keepdim=True)
    n = torch.full_like(ss, float(x[0].numel()))     # a tensor: `int / tensor` is a reciprocal
    return x * (scale * torch.sqrt(n / (ss + eps)))


def apply_filter(feat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Correlate the filter over the features (dimp.py:45-58): feat
    (N, H, W, C), weights (fh, fw, C) -> (N, H', W'), H' = H + (fh + 1) % 2
    (padding fh // 2, so an even kernel gives one row and column more)."""
    fh, fw = weights.shape[0], weights.shape[1]
    out = F.conv2d(_nchw(feat), weights.permute(2, 0, 1)[None], padding=(fh // 2, fw // 2))
    return out[:, 0]


def _transposed(feat: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (C, N, H, W) contiguous: the features as a batch of
    C one-channel-per-sample images, the layout `apply_feat_transpose` convolves."""
    return feat.permute(3, 0, 1, 2).contiguous()


def _feat_transpose(feat_t: torch.Tensor, residuals: torch.Tensor, filter_hw) -> torch.Tensor:
    fh, fw = filter_hw
    g = F.conv2d(feat_t, residuals[None], padding=(fh // 2, fw // 2))   # (C, 1, fh, fw)
    return g[:, 0].permute(1, 2, 0)


def apply_feat_transpose(feat: torch.Tensor, residuals: torch.Tensor, filter_hw) -> torch.Tensor:
    """The filter gradient of sum(residuals * apply_filter(feat, w)): the
    transpose of `apply_filter` applied to residuals (N, H', W') ->
    (fh, fw, C), what jax.vjp of apply_filter gives (dimp.py:203-212).

    g[a, b, c] = sum_{n, i, j} r[n, i, j] * pad(feat)[n, i + a, j + b, c]
    with the forward's padding fh // 2: one convolution of the padded
    features, channels as the batch and samples as the input channels,
    with the residuals as the kernel. Its output is exactly fh x fw, so
    the even kernel's extra row and column of the forward's output have
    nothing to crop here (the reference pads by (fh - 1) // 2 and crops)."""
    return _feat_transpose(_transposed(feat), residuals, filter_hw)


def distance_map(center_yx: torch.Tensor, output_sz: tuple[int, int], num_bins: int,
                 bin_displacement: float = 1.0) -> torch.Tensor:
    """Radial distance bins (dimp.py:61-76): center_yx (N, 2) ->
    (N, H, W, num_bins), triangular in the distance, the last bin open."""
    H, W = output_sz
    dev = center_yx.device
    k0 = torch.arange(H, dtype=torch.float32, device=dev).reshape(1, -1, 1)
    k1 = torch.arange(W, dtype=torch.float32, device=dev).reshape(1, 1, -1)
    d0 = k0 - center_yx[:, 0].reshape(-1, 1, 1)
    d1 = k1 - center_yx[:, 1].reshape(-1, 1, 1)
    dist = torch.sqrt(d0 * d0 + d1 * d1)[..., None]
    bins = torch.arange(num_bins, dtype=torch.float32, device=dev).reshape(1, 1, 1, -1)
    diff = div_const(dist, bin_displacement) - bins
    main = torch.relu(1.0 - torch.abs(diff[..., :-1]))
    last = torch.clamp(1.0 + diff[..., -1:], 0.0, 1.0)
    return torch.cat([main, last], dim=-1)


def leaky_relu_par(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(1 - a) / 2 |x| + (1 + a) / 2 x (dimp.py:79-82)."""
    return (1.0 - a) / 2.0 * torch.abs(x) + (1.0 + a) / 2.0 * x


def leaky_relu_par_deriv(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return (1.0 - a) / 2.0 * torch.sign(x) + (1.0 + a) / 2.0


def _iterate(step, weights: torch.Tensor, num_iter, max_iter: int) -> torch.Tensor:
    """`num_iter` steps of `step`: an int runs a plain loop; a tensor runs
    `max_iter` steps, each kept only where its index is below num_iter."""
    if not torch.is_tensor(num_iter):
        for _ in range(int(num_iter)):
            weights = step(weights)
        return weights
    for i in range(max_iter):
        weights = torch.where(num_iter > i, step(weights), weights)
    return weights


def _bb_center_yx(bb_xywh: torch.Tensor, feat_stride: int, fh: int, fw: int) -> torch.Tensor:
    """Box centres on the score grid, (y, x), shifted by half a cell for an
    odd kernel (dimp.py:189-190)."""
    c = ((bb_xywh[:, :2] + bb_xywh[:, 2:] / 2) / feat_stride).flip(1)
    return torch.stack([c[:, 0] - (fh % 2) / 2.0, c[:, 1] - (fw % 2) / 2.0], dim=1)


def _rois(bb_xywh: torch.Tensor) -> torch.Tensor:
    """(R, 4) xywh -> (R, 5) PrRoI rows [index, x1, y1, x2, y2]."""
    idx = torch.arange(bb_xywh.shape[0], dtype=torch.float32, device=bb_xywh.device)
    return torch.cat([idx[:, None], bb_xywh[:, :2], bb_xywh[:, :2] + bb_xywh[:, 2:]], dim=1)


# ---------------------------------------------------------------- classifier

class InstanceL2Norm(nn.Module):
    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_l2_norm(x, self.scale)


class FilterInitializer(nn.Module):
    """Conv3x3, then PrRoI-pool the target box to the filter size and
    average over the samples (dimp.py:106-129)."""

    def __init__(self, feat_dim: int = 512, filter_size: int = 4, feature_stride: int = 16):
        super().__init__()
        self.filter_size, self.feature_stride = filter_size, feature_stride
        self.filter_conv = Conv2d(feat_dim, feat_dim, 3, padding=1)

    def forward(self, feat: torch.Tensor, bb_xywh: torch.Tensor) -> torch.Tensor:
        """feat (N, H, W, C), bb (N, 4) crop coordinates -> (fh, fw, C)."""
        y = _nhwc(self.filter_conv(_nchw(feat)))
        pooled = prroi_pool(y, _rois(bb_xywh), self.filter_size, self.filter_size,
                            1.0 / self.feature_stride)
        return pooled.mean(dim=0)


class _BinKernel(nn.Module):
    """A 1x1 convolution over the distance bins, kept as the reference's
    (1, bins, 1, 1) weight."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(value.reshape(1, -1, 1, 1).clone())

    def vector(self) -> torch.Tensor:
        return self.weight.reshape(-1)


class SteepestDescentGN(nn.Module):
    """DiMP's unrolled steepest-descent Gauss-Newton filter optimizer
    (dimp.py:132-222; DeT_DiMP50_Max's constants)."""

    def __init__(self, num_iter: int = 5, feat_stride: int = 16, init_step_length: float = 0.9,
                 init_filter_reg: float = 0.1, init_gauss_sigma: float = 0.9,
                 num_dist_bins: int = 100, bin_displacement: float = 0.1,
                 mask_init_factor: float = 3.0, min_filter_reg: float = 1e-3,
                 alpha_eps: float = 0.0):
        super().__init__()
        self.num_iter, self.feat_stride = num_iter, feat_stride
        self.num_dist_bins, self.bin_displacement = num_dist_bins, bin_displacement
        self.min_filter_reg, self.alpha_eps = min_filter_reg, alpha_eps
        self.log_step_length = nn.Parameter(torch.full((1,), math.log(init_step_length)))
        self.filter_reg = nn.Parameter(torch.full((1,), init_filter_reg))
        d = torch.arange(num_dist_bins, dtype=torch.float32) * bin_displacement
        if init_gauss_sigma == 0:
            init_gauss = torch.zeros_like(d)
            init_gauss[0] = 1.0
        else:
            init_gauss = torch.exp(-0.5 * (d / init_gauss_sigma) ** 2)
        self.label_map_predictor = _BinKernel(init_gauss - init_gauss.min())
        self.target_mask_predictor = nn.Sequential(
            _BinKernel(mask_init_factor * torch.tanh(2.0 - d)))
        self.spatial_weight_predictor = _BinKernel(torch.ones(num_dist_bins))

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb_xywh: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None, num_iter=None,
                max_iter: Optional[int] = None) -> torch.Tensor:
        """weights (fh, fw, C); feat (N, H, W, C); bb (N, 4) crop coordinates;
        sample_weight (N,) or None. Returns the optimized weights."""
        num_iter = self.num_iter if num_iter is None else num_iter
        N, H, W, _ = feat.shape
        fh, fw = weights.shape[0], weights.shape[1]
        out_h, out_w = H + (fh + 1) % 2, W + (fw + 1) % 2
        step_length = torch.exp(self.log_step_length)[0]
        reg = torch.clamp(self.filter_reg * self.filter_reg, min=self.min_filter_reg ** 2)[0]

        dmap = distance_map(_bb_center_yx(bb_xywh, self.feat_stride, fh, fw), (out_h, out_w),
                            self.num_dist_bins, self.bin_displacement)
        label = dmap @ self.label_map_predictor.vector()
        target_mask = torch.sigmoid(dmap @ self.target_mask_predictor[0].vector())
        spatial_weight = dmap @ self.spatial_weight_predictor.vector()
        if sample_weight is None:
            sw = math.sqrt(1.0 / N) * spatial_weight
        else:
            sw = torch.sqrt(sample_weight).reshape(-1, 1, 1) * spatial_weight
        feat_t = _transposed(feat)

        def step(w):
            scores = apply_filter(feat, w)
            scores_act = leaky_relu_par(scores, target_mask)
            deriv = leaky_relu_par_deriv(scores, target_mask)
            residuals = sw * (scores_act - label)
            residuals_mapped = deriv * (sw * residuals)
            w_grad = _feat_transpose(feat_t, residuals_mapped, (fh, fw)) + reg * w
            scores_grad = sw * (deriv * apply_filter(feat, w_grad))
            alpha_num = (w_grad * w_grad).sum()
            alpha_den = torch.clamp((scores_grad * scores_grad).sum()
                                    + (reg + self.alpha_eps) * alpha_num, min=1e-8)
            alpha = alpha_num / alpha_den
            return w - step_length * alpha * w_grad

        return _iterate(step, weights, num_iter, self.num_iter if max_iter is None else max_iter)


class _HingeResidual(nn.Module):
    """LinearFilterHinge's only parameter (residual_modules.py:93)."""

    def __init__(self, init_filter_reg: float):
        super().__init__()
        self.filter_reg = nn.Parameter(torch.full((1,), init_filter_reg))


class SteepestDescentHinge(nn.Module):
    """super_dimp's GN steepest descent over the hinge residual
    (dimp.py:225-279). Labels come from the tracker. Per iteration
    g = J^T r and h = J g, written out: the data part of h is
    sw * deriv * apply_filter(feat, g) and the regulariser's filter_reg * g;
    alpha = |g|^2 / |h|^2, w <- w - alpha g."""

    def __init__(self, num_iter: int = 5, init_filter_reg: float = 1e-2,
                 hinge_threshold: float = 0.05, activation_leak: float = 0.0):
        super().__init__()
        self.num_iter = num_iter
        self.hinge_threshold, self.activation_leak = hinge_threshold, activation_leak
        self.residual_module = _HingeResidual(init_filter_reg)

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, label: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None, num_iter=None,
                max_iter: Optional[int] = None) -> torch.Tensor:
        """weights (fh, fw, C); feat (N, H, W, C); label (N, H', W');
        sample_weight (N,) or None."""
        num_iter = self.num_iter if num_iter is None else num_iter
        N = feat.shape[0]
        fh, fw = weights.shape[0], weights.shape[1]
        filter_reg = self.residual_module.filter_reg[0]
        if sample_weight is None:
            sw = torch.full((), math.sqrt(1.0 / N), dtype=feat.dtype, device=feat.device)
        else:
            sw = torch.sqrt(sample_weight).reshape(-1, 1, 1)
        target_mask = torch.clamp((label > self.hinge_threshold).to(feat.dtype)
                                  + self.activation_leak, max=1.0)
        feat_t = _transposed(feat)

        def step(w):
            scores = apply_filter(feat, w)
            deriv = leaky_relu_par_deriv(scores, target_mask)
            data_res = sw * (leaky_relu_par(scores, target_mask) - target_mask * label)
            reg_res = filter_reg * w
            g = (_feat_transpose(feat_t, deriv * (sw * data_res), (fh, fw))
                 + filter_reg * reg_res)
            h_data = sw * (deriv * apply_filter(feat, g))
            h_reg = filter_reg * g
            ip_gg = (g * g).sum()
            ip_hh = (h_data * h_data).sum() + (h_reg * h_reg).sum()
            alpha = ip_gg / torch.clamp(ip_hh, min=1e-8)
            return w - alpha * g

        return _iterate(step, weights, num_iter, self.num_iter if max_iter is None else max_iter)


class SteepestDescentNewtonKL(nn.Module):
    """PrDiMP's Newton steepest descent on the KL divergence between the
    softmax over the score map and a Gaussian label density
    (dimp.py:282-375, the prdimp50 train settings)."""

    def __init__(self, num_iter: int = 5, feat_stride: int = 16, init_step_length: float = 1.0,
                 init_filter_reg: float = 0.05, min_filter_reg: float = 0.05,
                 gauss_sigma: float = 0.9, alpha_eps: float = 0.05, uni_weight: float = 0.0,
                 normalize_label: bool = True, label_shrink: float = 0.0,
                 label_threshold: float = 0.0):
        super().__init__()
        self.num_iter, self.feat_stride = num_iter, feat_stride
        self.min_filter_reg, self.gauss_sigma = min_filter_reg, gauss_sigma
        self.alpha_eps = alpha_eps
        self.uni_weight, self.normalize_label = uni_weight, normalize_label
        self.label_shrink, self.label_threshold = label_shrink, label_threshold
        self.log_step_length = nn.Parameter(torch.full((1,), math.log(init_step_length)))
        self.filter_reg = nn.Parameter(torch.full((1,), init_filter_reg))

    def label_density(self, bb_xywh: torch.Tensor, fh: int, fw: int, out_h: int,
                      out_w: int) -> torch.Tensor:
        """The Gaussian label density (N, out_h, out_w) (dimp.py:328-345)."""
        center = _bb_center_yx(bb_xywh, self.feat_stride, fh, fw)
        dev = bb_xywh.device
        k0 = torch.arange(out_h, dtype=torch.float32, device=dev)
        k1 = torch.arange(out_w, dtype=torch.float32, device=dev)
        d0 = (k0[None, :] - center[:, 0:1]) ** 2
        d1 = (k1[None, :] - center[:, 1:2]) ** 2
        s2 = 2 * self.gauss_sigma ** 2
        g0 = div_const(torch.exp(div_const(-d0, s2)), math.pi * s2)
        g1 = torch.exp(div_const(-d1, s2))
        gauss = g0[:, :, None] * g1[:, None, :]
        gauss = gauss * (gauss > self.label_threshold)
        if self.normalize_label:
            gauss = gauss / (gauss.sum(dim=(-2, -1), keepdim=True) + 1e-8)
        return (1.0 - self.label_shrink) * ((1.0 - self.uni_weight) * gauss
                                            + self.uni_weight / (out_h * out_w))

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb_xywh: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None, num_iter=None,
                max_iter: Optional[int] = None) -> torch.Tensor:
        num_iter = self.num_iter if num_iter is None else num_iter
        N, H, W, _ = feat.shape
        fh, fw = weights.shape[0], weights.shape[1]
        out_h, out_w = H + (fh + 1) % 2, W + (fw + 1) % 2
        step_length = torch.exp(self.log_step_length)[0]
        reg = torch.clamp(self.filter_reg * self.filter_reg, min=self.min_filter_reg ** 2)[0]
        label_density = self.label_density(bb_xywh, fh, fw, out_h, out_w)
        if sample_weight is None:
            sw = torch.full((N, 1, 1), 1.0 / N, dtype=feat.dtype, device=feat.device)
        else:
            sw = sample_weight.reshape(N, 1, 1)
        feat_t = _transposed(feat)

        def step(w):
            scores = apply_filter(feat, w)
            sm = torch.softmax(scores.reshape(N, -1), dim=-1).reshape(scores.shape)
            res = sw * (sm - label_density)
            w_grad = _feat_transpose(feat_t, res, (fh, fw)) + reg * w
            scores_grad = apply_filter(feat, w_grad)
            sm_sg = sm * scores_grad
            hes_sg = sm_sg - sm * sm_sg.sum(dim=(-2, -1), keepdim=True)
            ghg = torch.clamp((scores_grad * hes_sg).reshape(N, -1).sum(dim=1), min=0.0)
            ghg = (sw.reshape(N) * ghg).sum()
            alpha_num = (w_grad * w_grad).sum()
            alpha_den = torch.clamp(ghg + (reg + self.alpha_eps) * alpha_num, min=1e-8)
            alpha = alpha_num / alpha_den
            return w - (step_length * alpha) * w_grad

        return _iterate(step, weights, num_iter, self.num_iter if max_iter is None else max_iter)


class LinearFilter(nn.Module):
    """The reference's `classifier`: classification features, the filter
    initializer and the filter optimizer under their torch names."""

    def __init__(self, optimizer: nn.Module, in_dim: int = 1024, out_dim: int = 512,
                 filter_size: int = 4, feat_stride: int = 16):
        super().__init__()
        norm_scale = math.sqrt(1.0 / (out_dim * filter_size ** 2))
        self.feature_extractor = nn.Sequential(
            Conv2d(in_dim, out_dim, 3, padding=1, bias=False), InstanceL2Norm(norm_scale))
        self.filter_initializer = FilterInitializer(out_dim, filter_size, feat_stride)
        self.filter_optimizer = optimizer


# ---------------------------------------------------------------- IoU net

class ConvBlock(nn.Sequential):
    """Conv (with bias) + FrozenBatchNorm + ReLU, children 0, 1, 2
    (dimp.py:380-392); padding 1 for a 3x3 kernel unless given."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, padding: Optional[int] = None):
        super().__init__(Conv2d(in_ch, out_ch, kernel,
                                padding=kernel // 2 if padding is None else padding),
                         FrozenBatchNorm(out_ch), nn.ReLU())


class LinearBlock(nn.Module):
    """Flatten (CHW, the reference's order) + Linear + BN + ReLU
    (dimp.py:396-406)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)
        self.bn = FrozenBatchNorm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (R, sz, sz, C) NHWC -> (R, out_dim)."""
        y = self.linear(_nchw(x).reshape(x.shape[0], -1))
        return torch.relu(self.bn(y[:, :, None, None]))[:, :, 0, 0]


class AtomIoUNet(nn.Module):
    """ATOM's IoU predictor (dimp.py:409-483): get_modulation from the
    reference features and box, get_iou_feat of the test features,
    predict_iou of proposals (differentiable in the proposals)."""

    def __init__(self, input_dim: tuple[int, int] = (512, 1024),
                 pred_input_dim: tuple[int, int] = (256, 256),
                 pred_inter_dim: tuple[int, int] = (256, 256)):
        super().__init__()
        d2, d3 = input_dim
        self.conv3_1r = ConvBlock(d2, 128)
        self.conv3_1t = ConvBlock(d2, 256)
        self.conv3_2t = ConvBlock(256, pred_input_dim[0])
        self.fc3_1r = ConvBlock(128, 256, padding=0)
        self.conv4_1r = ConvBlock(d3, 256)
        self.conv4_1t = ConvBlock(d3, 256)
        self.conv4_2t = ConvBlock(256, pred_input_dim[1])
        self.fc34_3r = ConvBlock(256 + 256, pred_input_dim[0], kernel=1, padding=0)
        self.fc34_4r = ConvBlock(256 + 256, pred_input_dim[1], kernel=1, padding=0)
        self.fc3_rt = LinearBlock(pred_input_dim[0] * 5 * 5, pred_inter_dim[0])
        self.fc4_rt = LinearBlock(pred_input_dim[1] * 3 * 3, pred_inter_dim[1])
        self.iou_predictor = nn.Linear(pred_inter_dim[0] + pred_inter_dim[1], 1)

    def get_modulation(self, feats: Sequence[torch.Tensor], bb_xywh: torch.Tensor):
        """feats [layer2 (N, H, W, 512), layer3 (N, H, W, 1024)], bb (N, 4)
        -> two (N, 256) modulation vectors."""
        f2, f3 = feats
        N = f2.shape[0]
        rois = _rois(bb_xywh)
        roi3r = prroi_pool(_nhwc(self.conv3_1r(_nchw(f2))), rois, 3, 3, 1 / 8)
        roi4r = prroi_pool(_nhwc(self.conv4_1r(_nchw(f3))), rois, 1, 1, 1 / 16)
        fc3_r = self.fc3_1r(_nchw(roi3r))                            # (N, 256, 1, 1)
        fc34_r = torch.cat([fc3_r, _nchw(roi4r)], dim=1)
        return (self.fc34_3r(fc34_r).reshape(N, -1), self.fc34_4r(fc34_r).reshape(N, -1))

    def get_iou_feat(self, feats: Sequence[torch.Tensor]):
        f2, f3 = feats
        return (_nhwc(self.conv3_2t(self.conv3_1t(_nchw(f2)))),
                _nhwc(self.conv4_2t(self.conv4_1t(_nchw(f3)))))

    @staticmethod
    def modulate(modulation, feats):
        """The test features scaled channel-wise by the modulation vectors."""
        (mod3, mod4), (c3_t, c4_t) = modulation, feats
        return c3_t * mod3[:, None, None, :], c4_t * mod4[:, None, None, :]

    def predict_modulated(self, att_feats, proposals_xywh: torch.Tensor) -> torch.Tensor:
        """IoU (N, P) of proposals (N, P, 4) xywh on modulated features."""
        c3_att, c4_att = att_feats
        N, P = proposals_xywh.shape[0], proposals_xywh.shape[1]
        xyxy = torch.cat([proposals_xywh[..., :2],
                          proposals_xywh[..., :2] + proposals_xywh[..., 2:]], dim=-1)
        bidx = torch.arange(N, dtype=torch.float32, device=xyxy.device)[:, None, None]
        rois = torch.cat([bidx.expand(N, P, 1), xyxy], dim=-1).reshape(N * P, 5)
        fc3 = self.fc3_rt(prroi_pool(c3_att, rois, 5, 5, 1 / 8))
        fc4 = self.fc4_rt(prroi_pool(c4_att, rois, 3, 3, 1 / 16))
        return self.iou_predictor(torch.cat([fc3, fc4], dim=-1)).reshape(N, P)

    def predict_iou(self, modulation, feats, proposals_xywh: torch.Tensor) -> torch.Tensor:
        """modulation 2x (N, C); feats 2x (N, H, W, C); proposals (N, P, 4)
        xywh crop coordinates -> IoU (N, P)."""
        return self.predict_modulated(self.modulate(modulation, feats), proposals_xywh)

    def forward(self, ref_feats, test_feats, bb_xywh: torch.Tensor,
                proposals_xywh: torch.Tensor) -> torch.Tensor:
        """The training forward (dimp.py:474-478, one reference frame per
        sequence): reference features and boxes (N, 4), test features and
        their proposals (N, P, 4) -> IoU (N, P)."""
        return self.predict_iou(self.get_modulation(ref_feats, bb_xywh),
                                self.get_iou_feat(test_feats), proposals_xywh)


# ---------------------------------------------------------------- full nets

class DiMPNet(nn.Module):
    """DiMP-50; a `merge_type` adds DeT's second backbone (dimp.py:486-616):
    the 6-channel input splits into the RGB and the X triplet, each through
    its own ResNet-50, merged per layer. `optimizer_type` 'dimp' (GN),
    'prdimp' (Newton KL) or 'hinge' (super_dimp).

    Methods as the JAX model's: extract_backbone, extract_classification_feat,
    get_filter, optimize_filter (also the hinge's optimize_filter_hinge),
    classify, the IoUNet under `bb_regressor`, and the training-style
    `forward`. Autograd runs through all of them: the training step
    differentiates through the unrolled filter optimizer and PrRoI."""

    def __init__(self, filter_size: int = 4, out_feature_dim: int = 512, optim_iter: int = 5,
                 feat_stride: int = 16, merge_type: Optional[str] = None,
                 merge_weights: tuple[float, float] = (0.6, 0.4),
                 optimizer_type: str = "dimp"):
        super().__init__()
        if merge_type is not None and merge_type not in MERGE_MODES:
            raise ValueError(f"unknown merge type {merge_type}")
        self.merge_type, self.merge_weights = merge_type, merge_weights
        self.optimizer_type = optimizer_type
        self.feature_extractor = resnet50("layer3")
        if merge_type is not None:
            self.feature_extractor_depth = resnet50("layer3")
            if merge_type == "conv":
                self.merge_layer2 = Conv2d(2 * 512, 512, 1)
                self.merge_layer3 = Conv2d(2 * 1024, 1024, 1)
        if optimizer_type == "hinge":
            opt = SteepestDescentHinge(num_iter=optim_iter)
        elif optimizer_type == "prdimp":
            opt = SteepestDescentNewtonKL(num_iter=optim_iter, feat_stride=feat_stride)
        else:
            opt = SteepestDescentGN(num_iter=optim_iter, feat_stride=feat_stride)
        self.classifier = LinearFilter(opt, 1024, out_feature_dim, filter_size, feat_stride)
        self.bb_regressor = AtomIoUNet()

    def _merge(self, a: torch.Tensor, b: torch.Tensor, layer: str) -> torch.Tensor:
        """Per-layer RGB / X merge of NHWC maps (dimp.py:532-547)."""
        m = self.merge_type
        if m == "max":
            return torch.maximum(a, b)
        if m == "mul":
            return a * b
        if m == "mean":
            return 0.5 * (a + b)
        if m == "weightedSum":
            wa, wb = self.merge_weights
            return wa * a + wb * b
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

    def extract_classification_feat(self, backbone_feat: dict) -> torch.Tensor:
        return _nhwc(self.classifier.feature_extractor(_nchw(backbone_feat["layer3"])))

    def get_filter(self, clf_feat: torch.Tensor, bb_xywh: torch.Tensor) -> torch.Tensor:
        return self.classifier.filter_initializer(clf_feat, bb_xywh)

    def optimize_filter(self, weights, clf_feat, target, sample_weight=None, num_iter=None,
                        max_iter=None):
        """The filter optimizer's step: `target` is the boxes (N, 4), or
        for the hinge optimizer the tracker's labels (N, H', W')."""
        return self.classifier.filter_optimizer(weights, clf_feat, target, sample_weight,
                                                num_iter, max_iter)

    def classify(self, weights: torch.Tensor, clf_feat: torch.Tensor) -> torch.Tensor:
        return apply_filter(clf_feat, weights)

    def _train_labels(self, clf_feat: torch.Tensor, bb_xywh: torch.Tensor) -> torch.Tensor:
        """Gaussian labels (N, H', W') on the score grid for the hinge
        optimizer in the training forward (dimp.py:575-593): sigma a
        quarter of the target size, the grid end-padded for an even
        kernel and measured from the map's centre."""
        N, H, W, _ = clf_feat.shape
        fs = self.classifier.filter_initializer.filter_size
        stride = self.classifier.filter_initializer.feature_stride
        end_pad = (fs + 1) % 2
        dev = clf_feat.device
        ky = torch.arange(H + end_pad, dtype=torch.float32, device=dev) - (H - 1) / 2
        kx = torch.arange(W + end_pad, dtype=torch.float32, device=dev) - (W - 1) / 2
        center = (div_const(bb_xywh[:, :2] + bb_xywh[:, 2:] / 2, stride).flip(1)
                  - torch.tensor([(H - 1) / 2, (W - 1) / 2], device=dev) + 0.5 * end_pad)
        sigma = div_const(0.25 * torch.sqrt(bb_xywh[:, 2] * bb_xywh[:, 3]), stride)
        gy = torch.exp(-0.5 * ((ky[None, :] - center[:, 0:1]) / sigma[:, None]) ** 2)
        gx = torch.exp(-0.5 * ((kx[None, :] - center[:, 1:2]) / sigma[:, None]) ** 2)
        return gy[:, :, None] * gx[:, None, :]

    def forward(self, train_im, test_im, train_bb, test_proposals) -> dict:
        """The training-style forward (dimp.py:598-616): the filter learned
        on all train frames as one sequence, its scores on the test frames
        and the IoUs of the test proposals. train_bb (N, 4), test_proposals
        (N, P, 4) in crop pixels -> {'target_scores', 'iou_pred'}."""
        train_feat = self.extract_backbone(train_im)
        test_feat = self.extract_backbone(test_im)
        train_clf = self.extract_classification_feat(train_feat)
        test_clf = self.extract_classification_feat(test_feat)
        target = (self._train_labels(train_clf, train_bb) if self.optimizer_type == "hinge"
                  else train_bb)
        w = self.optimize_filter(self.get_filter(train_clf, train_bb), train_clf, target)
        iou_pred = self.bb_regressor([train_feat["layer2"], train_feat["layer3"]],
                                     [test_feat["layer2"], test_feat["layer3"]],
                                     train_bb, test_proposals)
        return {"target_scores": self.classify(w, test_clf), "iou_pred": iou_pred}


def build_dimp50() -> DiMPNet:
    """Plain RGB DiMP-50 (dimp.py:619-621)."""
    return DiMPNet(merge_type=None)


def build_prdimp50() -> DiMPNet:
    """PrDiMP-50: DiMP-50 with the KL Newton optimizer (dimp.py:624-630)."""
    return DiMPNet(merge_type=None, optimizer_type="prdimp")


def build_super_dimp50() -> DiMPNet:
    """super_dimp_hinge, KeepTrack's base network (dimp.py:633-638)."""
    return DiMPNet(merge_type=None, optimizer_type="hinge")


def build_det_dimp50(merge_type: str = "max") -> DiMPNet:
    """DeT's dual-backbone RGB-D tracker (dimp.py:641-644)."""
    return DiMPNet(merge_type=merge_type)


def init_dimp_weights(model: DiMPNet, seed: int) -> DiMPNet:
    """Seeded random weights (models/vipt.py::init_weights: LeCun-normal
    kernels, zero biases, unit FrozenBatchNorm statistics); the filter
    optimizer keeps its constructor values, the learned initial step,
    regularisation and bin maps, as the JAX init does."""
    opt = model.classifier.filter_optimizer
    keep = {k: v.clone() for k, v in opt.state_dict().items()}
    init_weights(model, seed)
    opt.load_state_dict(keep)
    return model
