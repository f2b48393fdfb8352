"""MixFormer-RGBD: dual CvT backbones with mixed attention and the SPM score
head, port of mmtrack_tpu/models/mixformer.py (:40-411).

MixFormer-L at the reference's published scale (baseline_large.yaml):
three CvT stages per backbone with conv token embeddings (7/4/2, 3/2/1,
3/2/1 padding), dims 192/768/1024, depths 2/2/12, heads 3/12/16, QuickGELU
MLPs and LayerNorm eps 1e-5; depthwise-conv + frozen-BN q/k/v projections
(stride 1 for q, 2 for k and v) before the linear ones; template and
online-template queries attend the template keys only, search queries
attend everything; logits scaled by dim**-0.5, not head_dim**-0.5, as the
reference does. Six channels run an RGB and a depth backbone merged by
elementwise max, three channels one backbone. The corner head decodes the
search map; the ScoreDecoder pools the predicted box (PrRoI, 4 x 4) and
cross-attends it, then the template map, from a learned score token.

Layout: the template and the K online templates travel as one
(B, 1 + K, H, W, C) map, the template first, so every per-token layer and
every convolution runs once over all of them; its token order per sample
is the JAX package's concatenation [t, ot_0, ..., ot_{K-1}]. Maps are NHWC
at the module boundary and NCHW inside the convolutions. The models run
in f32; convolutions are F.conv2d and products torch.matmul, as the JAX
package computes all of it outside Pallas.

Module and parameter names are the reference's, the ones
mmtrack_tpu/models/convert.py::convert_mixformer_checkpoint reads:
`backbone[_depth].stage{i}.patch_embed.{proj,norm}`,
`backbone[_depth].stage{i}.blocks.{j}.{norm1,norm2}`,
`...attn.conv_proj_{q,k,v}.{conv,bn}`, `...attn.proj[_{q,k,v}]`,
`...mlp.fc{1,2}`, `box_head.conv{1-5}_{tl,br}`, and under `score_branch`
`score_token`, `norm1`, `norm2.{i}`, `proj[_{q,k,v}].{i}` and
`score_head.layers.{i}`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmtrack_torch.models.heads import CornerPredictor, FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d, Dense, LayerNorm
from mmtrack_torch.models.vipt import _MLPStack
from mmtrack_torch.ops.prroi import prroi_pool

LN_EPS = 1e-5

# Reference scale: baseline_large.yaml MODEL.BACKBONE (its drop path rates
# serve training, which this path does not run).
CVT_LARGE = dict(
    stage_dims=(192, 768, 1024),
    stage_depths=(2, 2, 12),
    stage_heads=(3, 12, 16),
    patch_kernels=(7, 3, 3),
    patch_strides=(4, 2, 2),
    patch_paddings=(2, 1, 1),
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvEmbed(nn.Module):
    """Conv token embedding with symmetric padding, then LayerNorm
    (ConvEmbed, JAX :56-72). (N, H, W, I) -> (N, H', W', dim)."""

    def __init__(self, in_ch: int, dim: int, kernel: int, stride: int, pad: int, device=None):
        super().__init__()
        self.proj = Conv2d(in_ch, dim, kernel, stride, pad, device=device)
        self.norm = LayerNorm(dim, device=device, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_nhwc(self.proj(_nchw(x))))


class DWConvProj(nn.Module):
    """3x3 depthwise conv without bias, then FrozenBatchNorm (JAX :75-88).
    NCHW in and out."""

    def __init__(self, dim: int, stride: int, device=None):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride, 1, device=device, bias=False, groups=dim)
        self.bn = FrozenBatchNorm(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


def _tokens(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n * m, C, h, w) NCHW maps -> (n, m * h * w, C) tokens, map by map."""
    return x.flatten(2).transpose(1, 2).reshape(n, -1, x.shape[1])


def _attend(q, k, v, heads: int, scale: float, key_mask: Optional[torch.Tensor] = None):
    """Multi-head attention of (B, Lq, C) queries over (B, Lk, C) keys and
    values, f32 logits times `scale`; keys where key_mask (B, Lk) is False
    get -inf logits."""
    B, Lq, C = q.shape
    hd = C // heads
    qh = q.reshape(B, Lq, heads, hd).transpose(1, 2)
    kh = k.reshape(B, -1, heads, hd).transpose(1, 2)
    vh = v.reshape(B, -1, heads, hd).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    a = torch.softmax(logits, dim=-1)
    return torch.matmul(a, vh).transpose(1, 2).reshape(B, Lq, C)


class MixedAttention(nn.Module):
    """Asymmetric mixed attention (JAX :91-170). The template and
    online-template queries attend [k_t, k_ot]; the search queries attend
    [k_t, k_ot, k_s]; both share `proj`."""

    def __init__(self, dim: int, heads: int, stride_kv: int = 2, device=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.scale = dim ** -0.5                      # the reference's, not head_dim's
        self.conv_proj_q = DWConvProj(dim, 1, device=device)
        self.conv_proj_k = DWConvProj(dim, stride_kv, device=device)
        self.conv_proj_v = DWConvProj(dim, stride_kv, device=device)
        self.proj_q = Dense(dim, dim, device=device)
        self.proj_k = Dense(dim, dim, device=device)
        self.proj_v = Dense(dim, dim, device=device)
        self.proj = Dense(dim, dim, device=device)

    def forward(self, mt: torch.Tensor, s: torch.Tensor,
                ot_mask: Optional[torch.Tensor] = None):
        """mt (B, 1 + K, H, W, C): the template, then K online templates;
        s (B, Hs, Ws, C). ot_mask (B, K) bool: the online-template slots
        that hold a template. The keys and values of the others are left
        out of both attention calls by -inf logits, so the result is the
        attention over the valid slots alone; their own query rows come out
        as garbage that stays in those slots."""
        B, M, H, W, C = mt.shape
        mt_c = _nchw(mt.reshape(B * M, H, W, C))
        s_c = _nchw(s)
        q_mt = self.proj_q(_tokens(self.conv_proj_q(mt_c), B))
        k_mt = self.proj_k(_tokens(self.conv_proj_k(mt_c), B))
        v_mt = self.proj_v(_tokens(self.conv_proj_v(mt_c), B))
        q_s = self.proj_q(_tokens(self.conv_proj_q(s_c), B))
        k_s = self.proj_k(_tokens(self.conv_proj_k(s_c), B))
        v_s = self.proj_v(_tokens(self.conv_proj_v(s_c), B))

        mask_mt = mask_s = None
        if ot_mask is not None:
            per_map = k_mt.shape[1] // M
            slots = torch.cat([torch.ones_like(ot_mask[:, :1]), ot_mask], dim=1).bool()
            mask_mt = slots.repeat_interleave(per_map, dim=1)
            mask_s = torch.cat([mask_mt, torch.ones(B, k_s.shape[1], dtype=torch.bool,
                                                    device=mask_mt.device)], dim=1)
        out_mt = _attend(q_mt, k_mt, v_mt, self.heads, self.scale, mask_mt)
        out_s = _attend(q_s, torch.cat([k_mt, k_s], dim=1), torch.cat([v_mt, v_s], dim=1),
                        self.heads, self.scale, mask_s)
        return (self.proj(out_mt).reshape(B, M, H, W, C),
                self.proj(out_s).reshape(s.shape))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device)
        self.fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CvtBlock(nn.Module):
    """Pre-norm block with mixed attention and a QuickGELU MLP (JAX
    :191-226), its norms and MLP shared by the template and search maps."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device=device, eps=LN_EPS)
        self.attn = MixedAttention(dim, heads, device=device)
        self.norm2 = LayerNorm(dim, device=device, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, mt, s, ot_mask=None):
        a_mt, a_s = self.attn(self.norm1(mt), self.norm1(s), ot_mask)
        mt, s = mt + a_mt, s + a_s
        return mt + self.mlp(self.norm2(mt)), s + self.mlp(self.norm2(s))


class CvtStage(nn.Module):
    """Conv embedding and `depth` blocks (JAX :229-252)."""

    def __init__(self, in_ch: int, dim: int, depth: int, heads: int, kernel: int, stride: int,
                 pad: int, device=None):
        super().__init__()
        self.patch_embed = ConvEmbed(in_ch, dim, kernel, stride, pad, device=device)
        self.blocks = nn.ModuleList(CvtBlock(dim, heads, device=device) for _ in range(depth))

    def forward(self, mt, s, ot_mask=None):
        B, M = mt.shape[:2]
        mt = self.patch_embed(mt.reshape((B * M,) + mt.shape[2:]))
        mt = mt.reshape((B, M) + mt.shape[1:])
        s = self.patch_embed(s)
        for blk in self.blocks:
            mt, s = blk(mt, s, ot_mask)
        return mt, s


class CvT(nn.Module):
    """One CvT backbone (JAX :255-278): three stages over the template and
    search maps; returns the (B, 1 + K, ...) template maps and the search
    map (the classifier's norm and head are not built)."""

    def __init__(self, in_ch: int = 3, stage_dims=CVT_LARGE["stage_dims"],
                 stage_depths=CVT_LARGE["stage_depths"], stage_heads=CVT_LARGE["stage_heads"],
                 patch_kernels=CVT_LARGE["patch_kernels"],
                 patch_strides=CVT_LARGE["patch_strides"],
                 patch_paddings=CVT_LARGE["patch_paddings"], device=None):
        super().__init__()
        ins = (in_ch,) + tuple(stage_dims[:-1])
        for i in range(len(stage_dims)):
            self.add_module(f"stage{i}", CvtStage(
                ins[i], stage_dims[i], stage_depths[i], stage_heads[i], patch_kernels[i],
                patch_strides[i], patch_paddings[i], device=device))
        self.num_stages = len(stage_dims)

    def forward(self, mt, s, ot_mask=None):
        for i in range(self.num_stages):
            mt, s = getattr(self, f"stage{i}")(mt, s, ot_mask)
        return mt, s


class ScoreDecoder(nn.Module):
    """SPM confidence decoder (JAX :281-329): a learned score token, two
    cross-attention rounds (the PrRoI-pooled 4 x 4 box region of the search
    map, then the template map), each followed by its own projection and
    LayerNorm, and a 3-layer ReLU MLP to one logit."""

    def __init__(self, dim: int = 1024, heads: int = 16, pool_size: int = 4, device=None):
        super().__init__()
        self.dim, self.heads, self.pool_size = dim, heads, pool_size
        self.scale = dim ** -0.5
        self.score_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.norm1 = LayerNorm(dim, device=device, eps=LN_EPS)
        for name in ("proj_q", "proj_k", "proj_v", "proj"):
            setattr(self, name, nn.ModuleList(Dense(dim, dim, device=device) for _ in range(2)))
        self.norm2 = nn.ModuleList(LayerNorm(dim, device=device, eps=LN_EPS) for _ in range(2))
        self.score_head = _MLPStack(dim, 3, device=device)

    def forward(self, search_feat: torch.Tensor, template_feat: torch.Tensor,
                search_box_xyxy: torch.Tensor) -> torch.Tensor:
        """search_feat (B, Hs, Ws, C), template_feat (B, Ht, Wt, C),
        normalised xyxy box (B, 4) -> score logit (B,)."""
        B, _, Ws, C = search_feat.shape
        box = search_box_xyxy * Ws
        rois = torch.cat([torch.arange(B, dtype=torch.float32, device=box.device)[:, None],
                          box], dim=1)
        pooled = prroi_pool(search_feat, rois, self.pool_size, self.pool_size, 1.0)
        kv = (pooled.reshape(B, -1, C), template_feat.reshape(B, -1, C))
        x = self.norm1(self.score_token.expand(B, -1, -1))
        for i in range(2):
            x = _attend(self.proj_q[i](x), self.proj_k[i](kv[i]), self.proj_v[i](kv[i]),
                        self.heads, self.scale)
            x = self.norm2[i](self.proj[i](x))
        return self.score_head(x[:, 0])[:, 0]


class MixFormer(nn.Module):
    """MixFormerRGBDOnlineScore (JAX :332-405).

    forward(template (B, 128, 128, C), online_template (B, K, 128, 128, C)
    or (B, 128, 128, C) for K = 1, search (B, 320, 320, C)) with C = 6 (RGB
    and depth through two backbones, max-merged) or 3 (one backbone) ->
    {'pred_boxes' (B, 4) cxcywh in [0, 1], 'score_logits' (B,),
    'pred_scores' (B,)}; `return_features` adds 'template_feat' and
    'search_feat'. score_box_xyxy (B, 4) pools another region than the
    predicted box; ot_mask (B, K) bool leaves out empty online-template
    slots (MixedAttention).
    """

    def __init__(self, template_size: int = 128, search_size: int = 320, in_channels: int = 6,
                 head_channel: int = 384, stage_dims=CVT_LARGE["stage_dims"],
                 stage_depths=CVT_LARGE["stage_depths"], stage_heads=CVT_LARGE["stage_heads"],
                 device=None):
        super().__init__()
        self.template_size, self.search_size = template_size, search_size
        self.in_channels = in_channels
        kw = dict(stage_dims=stage_dims, stage_depths=stage_depths, stage_heads=stage_heads,
                  device=device)
        self.backbone = CvT(3 if in_channels == 6 else in_channels, **kw)
        if in_channels == 6:
            self.backbone_depth = CvT(3, **kw)
        self.box_head = CornerPredictor(inplanes=stage_dims[-1], channel=head_channel,
                                        feat_sz=search_size // 16, stride=16, device=device)
        self.score_branch = ScoreDecoder(dim=stage_dims[-1], heads=stage_heads[-1],
                                         device=device)

    def forward(self, template, online_template, search, run_score_head: bool = True,
                return_features: bool = False, score_box_xyxy=None, ot_mask=None) -> dict:
        if online_template.dim() == 4:
            online_template = online_template[:, None]
        mt = torch.cat([template[:, None], online_template], dim=1)
        if self.in_channels == 6:
            mt_rgb, s_rgb = self.backbone(mt[..., :3], search[..., :3], ot_mask)
            mt_d, s_d = self.backbone_depth(mt[..., 3:], search[..., 3:], ot_mask)
            t_feat = torch.maximum(mt_rgb[:, 0], mt_d[:, 0])
            s_feat = torch.maximum(s_rgb, s_d)
        else:
            mt_f, s_feat = self.backbone(mt, search, ot_mask)
            t_feat = mt_f[:, 0]

        xyxy = self.box_head(s_feat)
        cx = (xyxy[:, 0] + xyxy[:, 2]) / 2
        cy = (xyxy[:, 1] + xyxy[:, 3]) / 2
        out = {"pred_boxes": torch.stack([cx, cy, xyxy[:, 2] - xyxy[:, 0],
                                          xyxy[:, 3] - xyxy[:, 1]], dim=1)}
        if return_features:
            out["template_feat"] = t_feat
            out["search_feat"] = s_feat
        if run_score_head:
            roi = xyxy if score_box_xyxy is None else score_box_xyxy
            logits = self.score_branch(s_feat, t_feat, roi)
            out["score_logits"] = logits
            out["pred_scores"] = torch.sigmoid(logits)
        return out


def build_mixformer_rgbd(device=None, **overrides) -> MixFormer:
    """Reference-scale MixFormer_RGBD (baseline_large.yaml), f32."""
    return MixFormer(device=device, **overrides)
