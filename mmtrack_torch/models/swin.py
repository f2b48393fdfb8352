"""Swin Transformer trunk, port of mmtrack_tpu/models/swin.py (SPT's
lib/models/stark/swin_transformer.py; Swin-T: embed 96, depths (2, 2, 6,
2), heads (3, 6, 12, 24), window 7).

Windowed self-attention with a learned relative-position bias, shifted
windows in every second block (the shift mask made once per padded shape
in numpy), patch merging between the stages, and a LayerNorm on each tap.
A map whose side is not a multiple of the window (320 / 4 = 80, 128 / 4 =
32) is padded on the right and bottom with zeros before the windows are
cut, and cropped back after them, as the reference does; the shift mask
covers the padded grid.

Public input and outputs are NHWC. Parameter names are the reference's:
`patch_embed.{proj,norm}.*`, `layers.{s}.blocks.{b}.{norm1,attn.qkv,
attn.proj,attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}.*`,
`layers.{s}.downsample.{norm,reduction}.*` and the taps' `norm{s}`. The
bias table is ((2 ws - 1)^2, heads), the transpose of the JAX package's.
Only the stages up to the deepest requested tap are built (STARK reads
`stage2`, stride 16, 384 channels).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.layers import Dense, LayerNorm
from mmtrack_torch.utils.device import device_constant

STAGES = ("stage0", "stage1", "stage2", "stage3")


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) bucket index into the (2 ws - 1)^2 bias table
    (swin_transformer.py:96-112)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


@lru_cache(maxsize=None)
def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """(windows, ws^2, ws^2) additive mask, -100 between tokens of
    different regions of the rolled map (BasicLayer.forward's img_mask)."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return (win[:, None, :] != win[:, :, None]).astype(np.float32) * -100.0


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws * ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class WindowAttention(nn.Module):
    """W-MSA with the relative-position bias (swin_transformer.py:71-146):
    logits and softmax in f32."""

    def __init__(self, dim: int, window_size: int, num_heads: int, device=None):
        super().__init__()
        self.ws, self.num_heads = window_size, num_heads
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.proj = Dense(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        Bw, N, C = x.shape
        hd = C // self.num_heads
        q, k, v = self.qkv(x).reshape(Bw, N, 3, self.num_heads, hd).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).float(), k.float())
        idx = device_constant(("swin_rpi", self.ws), lambda: relative_position_index(self.ws),
                              x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(N, N, -1)
        logits = logits + bias.permute(2, 0, 1)[None].float()
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(Bw // nW, nW, self.num_heads, N, N)
                      + mask[None, :, None]).reshape(Bw, self.num_heads, N, N)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).to(x.dtype)
        return self.proj(out.reshape(Bw, N, C))


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device)
        self.fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """SwinTransformerBlock (swin_transformer.py:153-238): (S)W-MSA and the
    MLP, each behind a LayerNorm (eps 1e-5) and a residual."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.ws, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, window_size, num_heads, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, s = self.ws, self.shift
        h = self.norm1(x)
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        if (Hp, Wp) != (H, W):
            h = F.pad(h, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
            mask = device_constant(("swin_mask", Hp, Wp, ws, s),
                                   lambda: shift_attn_mask(Hp, Wp, ws, s), x.device)
        h = window_reverse(self.attn(window_partition(h, ws), mask), ws, B, Hp, Wp)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + h[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated [(even, even), (odd, even), (even, odd),
    (odd, odd)], LayerNorm, a bias-free product to 2C
    (swin_transformer.py:241-277)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5, device=device)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """4x4 patches (a stride-4 conv `proj`) and a LayerNorm `norm`."""

    def __init__(self, embed_dim: int, patch: int = 4, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch, stride=patch, device=device)
        self.norm = LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, blocks: list, downsample: nn.Module | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin trunk with taps `out_layers` ('stage0'..'stage3', strides 4 to
    32, channels C 2^s), each through its own LayerNorm `norm{s}`; built to
    the deepest tap. forward(x (B, H, W, 3), out_layers) -> {tap: NHWC}."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 out_layers: Sequence[str] = ("stage2",), device=None):
        super().__init__()
        self.taps = tuple(sorted(STAGES.index(t) for t in out_layers))
        self.patch_embed = PatchEmbed(embed_dim, device=device)
        dim = embed_dim
        self.layers = nn.ModuleList()
        last = self.taps[-1]
        for s in range(last + 1):
            blocks = [SwinBlock(dim, num_heads[s], window_size,
                                0 if b % 2 == 0 else window_size // 2, device=device)
                      for b in range(depths[s])]
            self.layers.append(SwinStage(blocks, PatchMerging(dim, device=device)
                                         if s < last else None))
            if s in self.taps:
                self.add_module(f"norm{s}", LayerNorm(dim, eps=1e-5, device=device))
            dim *= 2
        self.out_channels = dim // 2

    def forward(self, x: torch.Tensor, out_layers: Sequence[str] = ("stage2",)) -> dict:
        out = {}
        x = self.patch_embed(x)
        for s, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x)
            if f"stage{s}" in out_layers:
                out[f"stage{s}"] = getattr(self, f"norm{s}")(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        return out


def swin_tiny(out_layers: Sequence[str] = ("stage2",), device=None) -> SwinTransformer:
    return SwinTransformer(out_layers=out_layers, device=device)
