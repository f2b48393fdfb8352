"""STARK / SPT: encoder-decoder transformer tracker with a corner head, port
of mmtrack_tpu/models/stark.py (:30-309).

A trunk tapped at stride 16 (`backbone_type`: ResNet-50 to layer3, 1024
channels; RepVGG-A0 to stage3, 192; Swin-T to stage2, 384) bottlenecked to
d = 256,
DETR sine positional encodings (plain, or over the valid region of a
padded crop), post-norm encoder layers over the template + search tokens,
a one-query decoder with a final norm, and the corner head on the
decoder-modulated encoder memory (forward_box_head). six_channel=True is
SPT: a colour and a depth backbone, a 6-layer encoder per modality, a 1x1
neck over their concatenation and a 2-layer fusion encoder. score_head
adds STARK-ST's 3-layer MLP confidence head.

Module and parameter names are the reference's (SPT lib/models/stark:
`backbone.0.body.*` or `backbone_{color,depth}.0.body.*` with torchvision
ResNet names, or SPT's repvgg.py / swin_transformer.py names, `bottleneck[_{color,depth}]`, `transformer.encoder[_color,
_depth].layers.{i}`, `transformer.fusion.layers.{i}`, `transformer.neck`
(a Conv1d), `transformer.decoder.layers.{i}` with `self_attn` /
`multihead_attn` as nn.MultiheadAttention lays them out, `query_embed`,
`box_head.conv{k}_{tl,br}`, `cls_head.layers.{j}`), so a port state_dict
goes through JAX's convert_stark_checkpoint unchanged. Tensors are NHWC at
the module boundary, as in the JAX package; the models run in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.heads import CornerPredictor
from mmtrack_torch.models.layers import Dense, LayerNorm
from mmtrack_torch.models.repvgg import repvgg_a0
from mmtrack_torch.models.resnet import ResNet
from mmtrack_torch.models.swin import swin_tiny
from mmtrack_torch.ops.crop import div_rn


def _dim_t(dim: int, temperature: float, device) -> torch.Tensor:
    half = dim // 2
    return temperature ** (2 * (torch.arange(half, device=device) // 2) / half)


def _interleave(pos: torch.Tensor) -> torch.Tensor:
    """sin of the even and cos of the odd frequencies, interleaved."""
    return torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                       dim=-1).flatten(-2)


def sine_position_embedding(h: int, w: int, dim: int = 256, temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """DETR 2D sine positional embedding (stark.py:30-47) -> (h*w, dim) f32."""
    f32 = torch.float32
    ys = (torch.arange(1, h + 1, dtype=f32, device=device)[:, None]
          * torch.ones((1, w), device=device))
    xs = (torch.arange(1, w + 1, dtype=f32, device=device)[None, :]
          * torch.ones((h, 1), device=device))
    scale = 2 * math.pi
    ys = div_rn(ys, h) * scale
    xs = div_rn(xs, w) * scale
    dim_t = _dim_t(dim, temperature, device)
    pos_x = _interleave(xs[..., None] / dim_t)
    pos_y = _interleave(ys[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1).reshape(h * w, dim)


def sine_position_embedding_masked(not_mask: torch.Tensor, dim: int = 256,
                                   temperature: float = 10000.0) -> torch.Tensor:
    """Mask-aware DETR sine embedding (stark.py:50-74; PositionEmbeddingSine
    with normalize=True): coordinates are cumulative sums over the valid
    region in f32, normalised by the last one + 1e-6.

    not_mask (B, h, w), True = valid -> (B, h*w, dim) f32."""
    nm = not_mask.float()
    B, h, w = nm.shape
    scale = 2 * math.pi
    ys = torch.cumsum(nm, dim=1)
    xs = torch.cumsum(nm, dim=2)
    ys = ys / (ys[:, -1:, :] + 1e-6) * scale
    xs = xs / (xs[:, :, -1:] + 1e-6) * scale
    dim_t = _dim_t(dim, temperature, nm.device)
    pos_x = _interleave(xs[..., None] / dim_t)
    pos_y = _interleave(ys[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1).reshape(B, h * w, dim)


class MultiheadAttention(nn.Module):
    """`_MHA` (stark.py:77-99) with torch nn.MultiheadAttention's parameter
    layout: `in_proj_weight` (3d, d) and `in_proj_bias` stacking q, k, v,
    and `out_proj`. Logits in f32; keys where key_padding_mask (B, L_k) is
    True get -inf, so a row with every key masked is NaN, as in JAX."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = Dense(dim, dim, device=device)

    def forward(self, q, k, v, key_padding_mask: Optional[torch.Tensor] = None):
        d, H = self.dim, self.heads
        hd = d // H
        B = q.shape[0]
        w, b = self.in_proj_weight, self.in_proj_bias
        qh = (F.linear(q, w[:d]) + b[:d]).reshape(B, -1, H, hd)
        kh = (F.linear(k, w[d:2 * d]) + b[d:2 * d]).reshape(B, -1, H, hd)
        vh = (F.linear(v, w[2 * d:]) + b[2 * d:]).reshape(B, -1, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * hd ** -0.5, kh)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.out_proj(out.reshape(B, -1, d))


class EncoderLayer(nn.Module):
    """Post-norm DETR encoder layer (stark.py:102-117)."""

    def __init__(self, dim: int = 256, heads: int = 8, ffn: int = 2048, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads, device=device)
        self.linear1 = Dense(dim, ffn, device=device)
        self.linear2 = Dense(ffn, dim, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)

    def forward(self, x, pos, key_padding_mask=None):
        qk = x + pos
        x = self.norm1(x + self.self_attn(qk, qk, x, key_padding_mask))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class DecoderLayer(nn.Module):
    """Post-norm DETR decoder layer (stark.py:120-139): self-attention,
    cross-attention over the memory (`multihead_attn`), FFN."""

    def __init__(self, dim: int = 256, heads: int = 8, ffn: int = 2048, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads, device=device)
        self.multihead_attn = MultiheadAttention(dim, heads, device=device)
        self.linear1 = Dense(dim, ffn, device=device)
        self.linear2 = Dense(ffn, dim, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)

    def forward(self, tgt, memory, query_pos, mem_pos, memory_key_padding_mask=None):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        y = self.multihead_attn(tgt + query_pos, memory + mem_pos, memory,
                                memory_key_padding_mask)
        tgt = self.norm2(tgt + y)
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class _Layers(nn.Module):
    """`<name>.layers.{i}`, optionally with a final `norm`."""

    def __init__(self, layers, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class _Conv1d1x1(nn.Module):
    """A kernel-1 Conv1d over the channel axis of (B, L, I) tokens: weight
    (O, I, 1) as torch lays it out, applied as a Dense (SPT's neck)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0]) + self.bias


class _Conv2d1x1(nn.Module):
    """A 1x1 Conv2d (weight (O, I, 1, 1), bias) on NHWC maps."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0]) + self.bias


class _Joiner(nn.Module):
    """The reference's DETR Joiner slot 0: `<backbone>.0.body`."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body


# SPT's backbone menu (backbone.py:59-75, 101-116; JAX stark.py:163-186):
# each trunk's stride-16 tap and its channels, which the bottleneck reads
TRUNKS = {"resnet50": ("layer3", 1024), "repvgg_a0": ("stage3", 192),
          "swin_tiny": ("stage2", 384)}


def _trunk(backbone_type: str, device) -> nn.ModuleList:
    """The trunk of `backbone_type` built to its tap (ResNet-50 to layer3,
    RepVGG-A0 to stage3, Swin-T to stage2), wrapped so its names are
    `.0.body.*`."""
    if backbone_type == "repvgg_a0":
        body = repvgg_a0(last_layer="stage3", device=device)
    elif backbone_type == "swin_tiny":
        body = swin_tiny(("stage2",), device=device)
    else:
        body = ResNet(stage_sizes=(3, 4, 6), last_layer="layer3", block="bottleneck",
                      device=device)
    return nn.ModuleList([_Joiner(body)])


class STARK(nn.Module):
    """STARK-S / ST / SPT tracker model (stark.py:142-309).

    forward(template (B, Tz, Tz, C), search (B, Tx, Tx, C), template_mask,
    search_mask (B, T, T) bool, True = padded) -> {'pred_boxes' (B, 4)
    cxcywh in [0, 1], 'pred_scores' (B,) with score_head}. The tracker
    calls `embed`, `transformer`, `forward_box_head` and `predict_score`
    itself, so that the template is embedded once."""

    def __init__(self, template_size: int = 128, search_size: int = 320, dim: int = 256,
                 heads: int = 8, enc_layers: int = 6, dec_layers: int = 6,
                 fusion_layers: int = 2, six_channel: bool = False, score_head: bool = False,
                 backbone_type: str = "resnet50", device=None):
        super().__init__()
        if backbone_type not in TRUNKS:
            raise ValueError(f"backbone_type={backbone_type!r}: one of {sorted(TRUNKS)}")
        self.backbone_type = backbone_type
        self.tap, feat_ch = TRUNKS[backbone_type]
        self.dim, self.six_channel, self.has_score_head = dim, six_channel, score_head
        self.feat_sz_s = search_size // 16

        def encoder(n):
            return _Layers([EncoderLayer(dim, heads, device=device) for _ in range(n)])

        self.transformer = nn.Module()
        if six_channel:
            self.backbone_color = _trunk(backbone_type, device)
            self.backbone_depth = _trunk(backbone_type, device)
            self.bottleneck_color = _Conv2d1x1(feat_ch, dim, device=device)
            self.bottleneck_depth = _Conv2d1x1(feat_ch, dim, device=device)
            self.transformer.encoder_color = encoder(enc_layers)
            self.transformer.encoder_depth = encoder(enc_layers)
            self.transformer.neck = _Conv1d1x1(2 * dim, dim, device=device)
            self.transformer.fusion = encoder(fusion_layers)
        else:
            self.backbone = _trunk(backbone_type, device)
            self.bottleneck = _Conv2d1x1(feat_ch, dim, device=device)
            self.transformer.encoder = encoder(enc_layers)
        self.transformer.decoder = _Layers(
            [DecoderLayer(dim, heads, device=device) for _ in range(dec_layers)],
            LayerNorm(dim, device=device))
        self.query_embed = nn.Embedding(1, dim, device=device)
        self.box_head = CornerPredictor(dim, dim, self.feat_sz_s, 16, device=device)
        if score_head:
            self.cls_head = _Layers([Dense(dim, dim, device=device), Dense(dim, dim, device=device),
                                     Dense(dim, 1, device=device)])

    def _trunks(self):
        if self.six_channel:
            return ((self.backbone_color, self.bottleneck_color),
                    (self.backbone_depth, self.bottleneck_depth))
        return ((self.backbone, self.bottleneck),)

    def embed(self, im: torch.Tensor, att_mask: Optional[torch.Tensor] = None):
        """(B, S, S, 3|6) crops [+ pixel att_mask (B, S, S), True = padded]
        -> (colour tokens (B, hw, d), depth tokens or None, pos (B, hw, d),
        token mask (B, hw) or None). The mask is downsampled by the top-left
        pixel of each stride cell (backbone.py:88), and the positions follow
        its valid region. STARK-S reads the first 3 channels only."""
        trunks = self._trunks()
        feats = []
        for (backbone, bottleneck), sl in zip(trunks, (slice(0, 3), slice(3, 6))):
            f = backbone[0].body(im[..., sl], (self.tap,))[self.tap]
            feats.append(bottleneck(f))
        B, h, w, _ = feats[0].shape
        tokens_c = feats[0].reshape(B, h * w, self.dim)
        tokens_d = feats[1].reshape(B, h * w, self.dim) if self.six_channel else None
        if att_mask is None:
            pos = sine_position_embedding(h, w, self.dim, device=im.device)[None].expand(
                B, -1, -1)
            tok_mask = None
        else:
            sy, sx = im.shape[1] // h, im.shape[2] // w
            feat_mask = att_mask[:, ::sy, ::sx].bool()
            pos = sine_position_embedding_masked(~feat_mask, self.dim)
            tok_mask = feat_mask.reshape(B, h * w)
        return tokens_c, tokens_d, pos, tok_mask

    def transformer_forward(self, z_c, z_d, z_pos, x_c, x_d, x_pos, z_mask=None, x_mask=None):
        """(decoder output (B, 1, d), memory (B, Lz + Lx, d)); masks (B, L)
        bool, True = padded, feed every encoder's and the decoder's
        key padding (transformer.py:85-121)."""
        pos = torch.cat([z_pos, x_pos], dim=1)
        mask = None
        if z_mask is not None or x_mask is not None:
            B = z_c.shape[0]
            zm = z_mask if z_mask is not None else torch.zeros(
                (B, z_c.shape[1]), dtype=torch.bool, device=z_c.device)
            xm = x_mask if x_mask is not None else torch.zeros(
                (B, x_c.shape[1]), dtype=torch.bool, device=x_c.device)
            mask = torch.cat([zm, xm], dim=1)
        t = self.transformer
        mem = torch.cat([z_c, x_c], dim=1)
        for layer in (t.encoder_color if self.six_channel else t.encoder).layers:
            mem = layer(mem, pos, mask)
        if self.six_channel:
            mem_d = torch.cat([z_d, x_d], dim=1)
            for layer in t.encoder_depth.layers:
                mem_d = layer(mem_d, pos, mask)
            mem = t.neck(torch.cat([mem, mem_d], dim=-1))
            for layer in t.fusion.layers:
                mem = layer(mem, pos, mask)
        tgt = torch.zeros((mem.shape[0], 1, self.dim), dtype=mem.dtype, device=mem.device)
        qpos = self.query_embed.weight[None]
        for layer in t.decoder.layers:
            tgt = layer(tgt, mem, qpos, pos, mask)
        return t.decoder.norm(tgt), mem

    def forward_box_head(self, dec_out: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """Decoder-modulated corner decode (stark_s.py:87-102) -> (B, 4)
        cxcywh in [0, 1]."""
        S = self.feat_sz_s
        enc_opt = memory[:, -S * S:]                                  # (B, HW, C)
        att = torch.einsum("blc,bqc->blq", enc_opt, dec_out)          # (B, HW, 1)
        fmap = (enc_opt * att).reshape(-1, S, S, self.dim)
        xyxy = self.box_head(fmap)
        cx = (xyxy[:, 0] + xyxy[:, 2]) / 2
        cy = (xyxy[:, 1] + xyxy[:, 3]) / 2
        return torch.stack([cx, cy, xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], dim=1)

    def predict_score(self, dec_out: torch.Tensor) -> torch.Tensor:
        """STARK-ST's confidence on the decoder embedding -> (B,) in (0, 1)."""
        h = dec_out[:, 0]
        layers = self.cls_head.layers
        h = torch.relu(layers[1](torch.relu(layers[0](h))))
        return torch.sigmoid(layers[2](h))[:, 0]

    def forward(self, template, search, template_mask=None, search_mask=None) -> dict:
        z_c, z_d, z_pos, z_m = self.embed(template, template_mask)
        x_c, x_d, x_pos, x_m = self.embed(search, search_mask)
        dec, mem = self.transformer_forward(z_c, z_d, z_pos, x_c, x_d, x_pos, z_m, x_m)
        out = {"pred_boxes": self.forward_box_head(dec, mem)}
        if self.has_score_head:
            out["pred_scores"] = self.predict_score(dec)
        return out
