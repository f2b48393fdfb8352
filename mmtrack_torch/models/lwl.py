"""LWL ("Learning What to Learn") segmentation network, port of
mmtrack_tpu/models/lwl.py.

A ResNet-50 backbone; a target model that is one convolution whose weights
(the filter) a few-shot learner fits per sequence by Gauss-Newton
steepest descent on || W(y) (f * x - E(y)) ||^2 + lambda ||f||^2
(ops/optimization.py::steepest_descent_gn, torch.func's vjp / jvp through
the convolution); a label encoder that turns a mask into the few-shot
label and its spatial weights; and a U-Net decoder (TSE, CAB, RRB, the
bicubic upsampler) that turns the target model's mask encoding into a
full-resolution segmentation. The LWL-box variant's box encoder
(`BoxLabelEncoder`) maps a box to a mask encoding.

The modules run NCHW; the public maps are NHWC like the JAX package's
(views of NCHW memory, so the convolutions take them back for free); a
filter is (num_filters, fh, fw, C). `interpolate` is JAX's bilinear
`jax.image.resize`, which antialiases when it shrinks (the decoder's
30 -> 15 onto layer4, the box encoder's image -> feature grid), so the
port passes `antialias=True` there; the reference's F.interpolate does
not. `resize_bicubic` is F.interpolate's bicubic (a = -0.75, border
clamp), the kernel JAX's copy writes out.

Parameter names are the reference torch ones that
mmtrack_tpu/models/convert.py::convert_lwl_checkpoint (:579-692) reads:
`feature_extractor.*` (torchvision ResNet-50, to layer4),
`target_model.feature_extractor.0.weight`,
`target_model.filter_optimizer.residual_module.filter_reg`,
`label_encoder.{conv_block,res1,res2,label_pred,samp_w_pred}.*` and
`decoder.{TSE,RRB1,RRB2,CAB,proj}.<layer>.*`, `decoder.project.conv{1,2}.*`.
The box encoder, which the converter does not read, sits under
`box_label_encoder.{res_<i>,label_pred}.*`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.dimp import instance_l2_norm
from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import resnet50
from mmtrack_torch.ops.optimization import steepest_descent_gn
from mmtrack_torch.parallel.mesh import SINGLE, Shard

LAYER_CHANNELS = {"layer1": 256, "layer2": 512, "layer3": 1024, "layer4": 2048}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ resize

def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) bicubic resize, half-pixel centres, a = -0.75, the taps
    clamped at the border (lwl.py:49-83)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bicubic", align_corners=False)


def interpolate(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) bilinear resize, half-pixel centres, as
    jax.image.resize(..., 'bilinear') (lwl.py:86-92): antialiased along an
    axis it shrinks."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=out_hw[0] < h or out_hw[1] < w)


# ----------------------------------------------------------------- modules

def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=bias)


class ConvBN(nn.Sequential):
    """conv_block (ltr/models/layers/blocks.py): a biased conv (`0`), a
    frozen BN (`1`) and a ReLU (lwl.py:98-116)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__(_conv(in_ch, out_ch, 3, stride), FrozenBatchNorm(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(super().forward(x))


class EncBasicBlock(nn.Module):
    """The label encoder's BasicBlock (lwl.py:119-143): its downsample is a
    plain biased 3x3 conv, always present."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, 3, stride, bias=False)
        self.bn1 = FrozenBatchNorm(out_ch)
        self.conv2 = _conv(out_ch, out_ch, 3, bias=False)
        self.bn2 = FrozenBatchNorm(out_ch)
        self.downsample = _conv(in_ch, out_ch, 3, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(y + self.downsample(x))


class LabelEncoder(nn.Module):
    """ResidualDS16SW (lwl.py:146-173): masks (N, H, W) -> the few-shot
    label and its spatial weights, each (N, H/16, W/16, num_filters)
    NHWC. layer_dims = (d0, d1, d2, num_filters)."""

    def __init__(self, layer_dims: Sequence[int] = (16, 32, 64, 1)):
        super().__init__()
        d0, d1, d2, nf = layer_dims
        self.conv_block = ConvBN(1, d0, stride=2)
        self.res1 = EncBasicBlock(d0, d1, stride=2)
        self.res2 = EncBasicBlock(d1, d2, stride=2)
        self.label_pred = ConvBN(d2, nf)
        self.samp_w_pred = _conv(d2, nf, 3)

    def forward(self, mask: torch.Tensor):
        x = self.conv_block(mask[:, None])
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.res2(self.res1(x))
        return _nhwc(self.label_pred(x)), _nhwc(self.samp_w_pred(x))


class BoxLabelEncoder(nn.Module):
    """ResidualDS16FeatSWBoxCatMultiBlock (lwl.py:176-215): the box as a
    Gaussian at image resolution (the reference's int() of x, y, w, h),
    resized onto the feature grid, concatenated with the target-model
    features, a chain of stride-1 EncBasicBlocks and a final conv_block.
    layer_dims = (d0, ..., num_filters)."""

    gauss_scale = 0.25

    def __init__(self, feat_dim: int, layer_dims: Sequence[int] = (64, 32, 16)):
        super().__init__()
        dims = [feat_dim + 1] + list(layer_dims[:-1])
        self.n_res = len(dims) - 1
        for i in range(self.n_res):
            self.add_module(f"res_{i}", EncBasicBlock(dims[i], dims[i + 1]))
        self.label_pred = ConvBN(dims[-1], layer_dims[-1])

    def forward(self, bb_xywh: torch.Tensor, feat: torch.Tensor,
                image_hw: tuple[int, int]) -> torch.Tensor:
        """bb (N, 4) image xywh, feat (N, h, w, C) NHWC -> (N, h, w, nf)."""
        H, W = image_hw
        dev = feat.device
        bb = torch.trunc(bb_xywh)
        cx = bb[:, 0] + bb[:, 2] / 2
        cy = bb[:, 1] + bb[:, 3] / 2
        xs = torch.arange(W, dtype=torch.float32, device=dev)
        ys = torch.arange(H, dtype=torch.float32, device=dev)
        dx = (xs[None, :] - cx[:, None]) / (self.gauss_scale * bb[:, 2:3])
        dy = (ys[None, :] - cy[:, None]) / (self.gauss_scale * bb[:, 3:4])
        gauss = torch.exp(-0.5 * (dy[:, :, None] ** 2 + dx[:, None, :] ** 2))
        g = interpolate(gauss[:, None], feat.shape[1:3])
        x = torch.cat([_nchw(feat), g], dim=1)
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x)
        return _nhwc(self.label_pred(x))


class TSE(nn.Module):
    """Target scale estimation (lwl.py:218-238): reduce (1x1, ReLU, 1x1),
    the mask encoding concatenated, transform (three 3x3 + ReLU)."""

    def __init__(self, ft_ch: int, oc: int, score_ch: int):
        super().__init__()
        nc = oc + score_ch
        self.reduce = nn.Sequential(_conv(ft_ch, oc, 1), nn.ReLU(), _conv(oc, oc, 1))
        self.transform = nn.Sequential(_conv(nc, nc, 3), nn.ReLU(), _conv(nc, nc, 3), nn.ReLU(),
                                       _conv(nc, oc, 3), nn.ReLU())

    def forward(self, ft, score, x=None):
        h = self.reduce(ft)
        hpool = h.mean(dim=(2, 3), keepdim=True) if x is None else x
        h = torch.cat([h, interpolate(score, h.shape[-2:])], dim=1)
        return self.transform(h), hpool


class CAB(nn.Module):
    """Channel attention (lwl.py:241-257)."""

    def __init__(self, oc: int, deepest: bool):
        super().__init__()
        self.deepest = deepest
        self.convreluconv = nn.Sequential(_conv(2 * oc, oc, 1), nn.ReLU(), _conv(oc, oc, 1))

    def forward(self, deeper, shallower):
        shallow_pool = shallower.mean(dim=(2, 3), keepdim=True)
        deeper_pool = deeper if self.deepest else deeper.mean(dim=(2, 3), keepdim=True)
        g = self.convreluconv(torch.cat([shallow_pool, deeper_pool], dim=1))
        inputs = shallower * torch.sigmoid(g)
        return inputs + interpolate(deeper, inputs.shape[-2:])


class RRB(nn.Module):
    """Residual refinement (lwl.py:260-275), as the decoder builds it:
    conv1x1, then bblock = 3x3 (biased), BN, ReLU, 3x3 (no bias)."""

    def __init__(self, oc: int):
        super().__init__()
        self.conv1x1 = _conv(oc, oc, 1)
        self.bblock = nn.Sequential(_conv(oc, oc, 3), FrozenBatchNorm(oc), nn.ReLU(),
                                    _conv(oc, oc, 3, bias=False))

    def forward(self, x):
        h = self.conv1x1(x)
        return torch.relu(h + self.bblock(h))


class _Upsampler(nn.Module):
    def __init__(self, mdim: int):
        super().__init__()
        self.conv1 = _conv(mdim, mdim // 2, 3)
        self.conv2 = _conv(mdim // 2, 1, 3)


class LWTLDecoder(nn.Module):
    """The segmentation decoder (lwl.py:278-329), deepest layer first; the
    upsampler: 2x bicubic, conv, ReLU, bicubic to the image, conv."""

    OC = {"layer1": 1, "layer2": 2, "layer3": 2, "layer4": 4}
    ft_channels = ("layer4", "layer3", "layer2", "layer1")

    def __init__(self, in_channels: int = 1, mdim: int = 64):
        super().__init__()
        oc = {L: self.OC[L] * mdim for L in self.ft_channels}
        self.TSE = nn.ModuleDict({L: TSE(LAYER_CHANNELS[L], oc[L], in_channels)
                                  for L in self.ft_channels})
        self.RRB1 = nn.ModuleDict({L: RRB(oc[L]) for L in self.ft_channels})
        self.CAB = nn.ModuleDict({L: CAB(oc[L], L == self.ft_channels[0])
                                  for L in self.ft_channels})
        self.RRB2 = nn.ModuleDict({L: RRB(oc[L]) for L in self.ft_channels})
        self.proj = nn.ModuleDict({L: nn.Sequential(_conv(oc[P], oc[L], 1), nn.ReLU())
                                   for P, L in zip(self.ft_channels, self.ft_channels[1:])})
        self.project = _Upsampler(mdim)

    def forward(self, scores: torch.Tensor, features: dict,
                image_hw: tuple[int, int]) -> torch.Tensor:
        """scores (N, h, w, nf) NHWC, features a dict of NHWC backbone maps
        -> (N, H, W) raw segmentation scores."""
        scores = _nchw(scores)
        x = None
        for L in self.ft_channels:
            ft = _nchw(features[L])
            s = interpolate(scores, ft.shape[-2:])
            if x is not None:
                x = self.proj[L](x)
            h, hpool = self.TSE[L](ft, s, x)
            h = self.RRB1[L](h)
            h = self.CAB[L](hpool, h)
            x = self.RRB2[L](h)
        x = resize_bicubic(x, (2 * x.shape[2], 2 * x.shape[3]))
        x = torch.relu(self.project.conv1(x))
        x = resize_bicubic(x, image_hw)
        return self.project.conv2(x)[:, 0]


class TargetModelFeatures(nn.Sequential):
    """residual_basic_block (lwl.py:332-356) at LWLNet's configuration, no
    BasicBlocks: a 3x3 conv without bias (`0`) and InstanceL2Norm; NHWC in
    and out."""

    def __init__(self, in_dim: int = 1024, out_dim: int = 512, filter_size: int = 1):
        super().__init__(Conv2d(in_dim, out_dim, 3, padding=1, bias=False))
        self.scale = math.sqrt(1.0 / (out_dim * filter_size ** 2))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return _nhwc(instance_l2_norm(super().forward(_nchw(feat)), self.scale))


def apply_target_model(feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """The mask encoding: the filter (nf, fh, fw, C) convolved over the
    features (N, H, W, C), SAME padding -> (N, H, W, nf) (lwl.py:359-366)."""
    fh = filt.shape[1]
    return _nhwc(F.conv2d(_nchw(feat), filt.permute(0, 3, 1, 2), padding=fh // 2))


def lwl_filter_residual(filt, feat, label, spatial_weight, sample_weight, filter_reg):
    """LWTLResidual (lwl.py:369-379): (W (f * x - E(y)), lambda f)."""
    scores = apply_target_model(feat, filt)
    w = spatial_weight
    if sample_weight is not None:
        w = w * sample_weight.reshape(-1, 1, 1, 1)
    return (w * (scores - label), filter_reg * filt.reshape(-1))


def optimize_lwl_filter(filt, feat, label, spatial_weight, sample_weight, filter_reg,
                        num_iter: int, shard: Shard = SINGLE):
    """num_iter Gauss-Newton steepest-descent steps on the LWL residual
    (lwl.py:382-404). num_iter is an int: the tracker knows its update
    schedule on the host, so it runs exactly the steps JAX keeps. The
    filter is one for the whole batch: under a data-parallel `shard` the
    learner's sums run over the global batch and each rank's regulariser
    is scaled by 1 / sqrt(world), so the ranks' terms add up to it once."""
    if shard.world > 1:
        filter_reg = filter_reg / math.sqrt(shard.world)

    def res_fn(f):
        return lwl_filter_residual(f, feat, label, spatial_weight, sample_weight, filter_reg)
    return steepest_descent_gn(res_fn, filt, int(num_iter), shard=shard)


class _Residual(nn.Module):
    def __init__(self, init_reg: float):
        super().__init__()
        self.filter_reg = nn.Parameter(torch.full((1,), init_reg))


class _FilterOptimizer(nn.Module):
    def __init__(self, init_reg: float):
        super().__init__()
        self.residual_module = _Residual(init_reg)


class _TargetModel(nn.Module):
    def __init__(self, feature_extractor: TargetModelFeatures, init_reg: float):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.filter_optimizer = _FilterOptimizer(init_reg)


class LWLNet(nn.Module):
    """LWTLNet (lwl.py:407-513) at the JAX package's configuration: the
    DiMP clf-feature pattern (a 3x3 conv to 512, no blocks) on layer3, the
    decoder over layer4..layer1, filter_reg from 0.01. Public maps are
    NHWC. `in_channels` is the backbone's input width: flax infers it from
    the init's images, so tools/train.py's `--script lwl --channels 6`
    builds a 6-channel conv1."""

    out_feature_dim = 512
    target_model_input_layer = "layer3"

    def __init__(self, filter_size: int = 1, num_filters: int = 1, optim_iter: int = 3,
                 label_encoder_dims: Sequence[int] = (16, 32, 64), decoder_mdim: int = 64,
                 use_box_encoder: bool = False, box_label_encoder_dims: Sequence[int] = (64, 32),
                 in_channels: int = 3):
        super().__init__()
        self.filter_size, self.num_filters, self.optim_iter = filter_size, num_filters, optim_iter
        self.use_box_encoder = use_box_encoder
        self.feature_extractor = resnet50("layer4", in_channels=in_channels)
        self.target_model = _TargetModel(
            TargetModelFeatures(LAYER_CHANNELS["layer3"], self.out_feature_dim, filter_size),
            0.01)
        self.label_encoder = LabelEncoder(tuple(label_encoder_dims) + (num_filters,))
        self.decoder = LWTLDecoder(num_filters, decoder_mdim)
        if use_box_encoder:
            self.box_label_encoder = BoxLabelEncoder(
                self.out_feature_dim, tuple(box_label_encoder_dims) + (num_filters,))

    @property
    def filter_reg(self) -> torch.Tensor:
        return self.target_model.filter_optimizer.residual_module.filter_reg

    def extract_backbone(self, im: torch.Tensor) -> dict:
        """im (N, H, W, in_channels) normalised -> layer1..layer4, NHWC."""
        return self.feature_extractor(im, ("layer1", "layer2", "layer3", "layer4"))

    def extract_target_model_features(self, bfeat: dict) -> torch.Tensor:
        return self.target_model.feature_extractor(bfeat[self.target_model_input_layer])

    def encode_labels(self, masks: torch.Tensor):
        return self.label_encoder(masks)

    def get_filter(self, feat, label, spatial_weight, sample_weight=None,
                   num_iter: Optional[int] = None, shard: Shard = SINGLE) -> torch.Tensor:
        """FilterInitializerZero + GN steepest descent (lwl.py:471-480), one
        filter for the (global) batch."""
        filt = torch.zeros((self.num_filters, self.filter_size, self.filter_size,
                            self.out_feature_dim), dtype=feat.dtype, device=feat.device)
        return optimize_lwl_filter(filt, feat, label, spatial_weight, sample_weight,
                                   self.filter_reg, self.optim_iter if num_iter is None
                                   else num_iter, shard)

    def optimize_filter(self, filt, feat, label, spatial_weight, sample_weight,
                        num_iter: int) -> torch.Tensor:
        return optimize_lwl_filter(filt, feat, label, spatial_weight, sample_weight,
                                   self.filter_reg, num_iter)

    def segment(self, filt, tm_feat, bfeat, image_hw) -> torch.Tensor:
        """The mask encoding and the decoder (lwl.py:488-491) -> (N, H, W)."""
        return self.decoder(apply_target_model(tm_feat, filt), bfeat, image_hw)

    def mask_from_box(self, bb_xywh, tm_feat, bfeat, image_hw) -> torch.Tensor:
        """The LWL-box init (lwl.py:493-499): raw logits (N, H, W)."""
        enc = self.box_label_encoder(bb_xywh, tm_feat, image_hw)
        return self.decoder(enc, bfeat, image_hw)

    def forward(self, train_im, test_im, train_masks, shard: Shard = SINGLE):
        """The one-shot training forward (lwl.py:501-513): one filter learned
        from the batch's train frames (on `shard`'s rows, from the global
        batch's), each test frame segmented."""
        bfeat_te = self.extract_backbone(test_im)
        feat_tr = self.extract_target_model_features(self.extract_backbone(train_im))
        feat_te = self.extract_target_model_features(bfeat_te)
        label, sw = self.encode_labels(train_masks)
        filt = self.get_filter(feat_tr, label, sw, shard=shard)
        return self.segment(filt, feat_te, bfeat_te, test_im.shape[1:3])


def build_lwl(**overrides) -> LWLNet:
    return LWLNet(**overrides)


def build_lwl_paper() -> LWLNet:
    """The published configuration (lwl.py:520-525): 16 filters of size 3,
    label encoder (16, 32, 64), 5 optimizer steps."""
    return LWLNet(filter_size=3, num_filters=16, label_encoder_dims=(16, 32, 64), optim_iter=5)


def init_lwl_weights(model: LWLNet, seed: int) -> LWLNet:
    """Seeded random weights (models/vipt.py::init_weights: LeCun-normal
    kernels, zero biases, unit FrozenBatchNorm statistics), with flax's
    special inits: samp_w_pred's zero kernel and bias of one
    (lwl.py:168-172) and filter_reg at its constructor value."""
    from mmtrack_torch.models.vipt import init_weights

    reg = model.filter_reg.detach().clone()
    init_weights(model, seed)
    with torch.no_grad():
        model.filter_reg.copy_(reg)
        model.label_encoder.samp_w_pred.weight.zero_()
        model.label_encoder.samp_w_pred.bias.fill_(1.0)
    return model
