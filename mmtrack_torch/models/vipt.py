"""ViPT: prompt-tuned one-stream ViT tracker, port of mmtrack_tpu/models/vipt.py
(:36-346, :412-428; the CENTER head).

Token-space PromptBlock/Fovea, 12 CE blocks with static-shape candidate
elimination, deep-prompt re-injection with scatter/gather recovery, and
the CenterPredictor head. Inputs are NHWC 6-channel crops; module and
parameter names are the reference torch ones, so `models/convert.py`
carries flax parameters across unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mmtrack_torch.models.heads import CenterPredictor, cal_bbox
from mmtrack_torch.models.layers import CEBlock, Conv2d, LayerNorm, PatchEmbed
from mmtrack_torch.ops.ce import gather_search_tokens, recover_search_tokens


class Fovea(nn.Module):
    """Spatial-softmax gate with a learnable temperature
    (vit_ce_prompt.py:22-47) over the token axis, in f32 (the f32
    temperature promotes the compute-dtype input)."""

    def __init__(self, device=None):
        super().__init__()
        self.smooth = nn.Parameter(torch.full((1,), 10.0, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return torch.softmax(xf * self.smooth, dim=1) * xf


class PromptBlock(nn.Module):
    """Modal prompt fusion (Prompt_block, vit_ce_prompt.py:50-71) in token
    space: two 1x1 convs to an 8-channel bottleneck, the Fovea gate on the
    RGB branch, sum, a 1x1 conv back to C. The 1x1 convs keep the
    reference's (O, I, 1, 1) weights and run as matrix products."""

    hide_channel = 8

    def __init__(self, embed_dim: int, dtype=torch.float32, device=None, param_dtype=None):
        super().__init__()
        hide = self.hide_channel
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.conv0_0 = Conv2d(embed_dim, hide, 1, **kw)
        self.conv0_1 = Conv2d(embed_dim, hide, 1, **kw)
        self.conv1x1 = Conv2d(hide, embed_dim, 1, **kw)
        self.fovea = Fovea(device=device)

    @staticmethod
    def _dense(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = conv.dtype
        return x.to(dt) @ conv.weight[:, :, 0, 0].to(dt).t() + conv.bias.to(dt)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x0 = self._dense(self.conv0_0, a)
        x1 = self._dense(self.conv0_1, b)
        x0 = self.fovea(x0) + x1
        return self._dense(self.conv1x1, x0)


def ce_keep_schedule(num_search_tokens: int, ce_loc: Sequence[int],
                     keep_ratios: Sequence[float]) -> tuple[int, ...]:
    """Kept-token count after each CE layer (ceil, attn_blocks.py:40)."""
    lens = []
    cur = num_search_tokens
    for r in keep_ratios:
        cur = math.ceil(r * cur)
        lens.append(cur)
    return tuple(lens)


def generate_ctr_mask(template_feat_size: int, mode: str,
                      device=None) -> Optional[torch.Tensor]:
    """Template-token vote mask for CE (ce_utils.py:15-65): (1, L_t) or None."""
    if mode == "ALL":
        return None
    m = torch.zeros((template_feat_size, template_feat_size), device=device)
    ctr = (template_feat_size - 1) // 2
    if mode == "CTR_POINT":
        m[ctr:ctr + 1, ctr:ctr + 1] = 1.0
    elif mode == "CTR_REC":
        width = 2 if template_feat_size % 2 == 0 else 1
        m[ctr:ctr + width, ctr:ctr + width] = 1.0
    else:
        raise NotImplementedError(f"CE_TEMPLATE_RANGE={mode}")
    return m.reshape(1, -1)


class ViTCEPrompt(nn.Module):
    """ViT backbone with candidate elimination and modal prompts
    (vit_ce_prompt.py:74-346). forward(z (B,T,T,6), x (B,S,S,6)) ->
    (B, L_t + L_x, C) tokens with pruned search positions recovered as
    zeros.

    Block i has drop-path rate drop_path_rate * i / (depth - 1)
    (vipt.py:204); drop path acts only when forward gets
    `deterministic=False`, with its masks drawn from `generator`."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, template_size: int = 128,
                 search_size: int = 256, ce_loc: tuple[int, ...] = (3, 6, 9),
                 prompt_type: str = "vipt_deep", dtype=torch.float32, device=None,
                 use_kernels: bool = True, drop_path_rate: float = 0.0, param_dtype=None):
        super().__init__()
        self.depth = depth
        self.ce_loc = tuple(ce_loc)
        self.prompt_type = prompt_type
        self.dtype = dtype
        self.lens_z = (template_size // patch_size) ** 2
        self.lens_x = (search_size // patch_size) ** 2
        kw = dict(dtype=dtype, device=device)
        pkw = dict(kw, param_dtype=param_dtype)
        self.patch_embed = PatchEmbed(embed_dim, patch_size, **pkw)
        self.patch_embed_prompt = PatchEmbed(embed_dim, patch_size, **pkw)
        if prompt_type in ("vipt_deep", "vipt_shaw"):
            n_prompt = depth if prompt_type == "vipt_deep" else 1
            self.prompt_blocks = nn.ModuleList(
                PromptBlock(embed_dim, **pkw) for _ in range(n_prompt))
            self.prompt_norms = nn.ModuleList(
                LayerNorm(embed_dim, **kw) for _ in range(n_prompt))
        self.pos_embed_z = nn.Parameter(torch.zeros(1, self.lens_z, embed_dim, device=device))
        self.pos_embed_x = nn.Parameter(torch.zeros(1, self.lens_x, embed_dim, device=device))
        self.blocks = nn.ModuleList(
            CEBlock(embed_dim, num_heads, use_kernels=use_kernels,
                    drop_path_rate=drop_path_rate * i / max(depth - 1, 1), **pkw)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, **kw)

    def forward(self, z: torch.Tensor, x: torch.Tensor,
                box_mask_z: Optional[torch.Tensor] = None,
                ce_keep_lens: Optional[tuple[int, ...]] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B = x.shape[0]
        lens_z, lens_x = self.lens_z, self.lens_x
        dt = self.dtype
        has_prompt = self.prompt_type in ("vipt_deep", "vipt_shaw")

        z_tok = self.patch_embed(z[..., :3])
        x_tok = self.patch_embed(x[..., :3])
        z_dte_tok = self.patch_embed_prompt(z[..., 3:])
        x_dte_tok = self.patch_embed_prompt(x[..., 3:])
        if has_prompt:
            n0, p0 = self.prompt_norms[0], self.prompt_blocks[0]
            z_prompted = p0(n0(z_tok), n0(z_dte_tok))
            x_prompted = p0(n0(x_tok), n0(x_dte_tok))
            z_tok = z_tok + z_prompted
            x_tok = x_tok + x_prompted
        else:
            z_tok = z_tok + z_dte_tok
            x_tok = x_tok + x_dte_tok

        z_tok = z_tok + self.pos_embed_z.to(dt)
        x_tok = x_tok + self.pos_embed_x.to(dt)
        tokens = torch.cat([z_tok, x_tok], dim=1)

        dev = tokens.device
        gidx_t = torch.arange(lens_z, device=dev)[None].expand(B, -1)
        gidx_s = torch.arange(lens_x, device=dev)[None].expand(B, -1)
        if box_mask_z is not None and box_mask_z.shape[0] == 1:
            box_mask_z = box_mask_z.expand(B, -1)

        ce_index = 0
        pruned = False
        x_cur = tokens
        for i, block in enumerate(self.blocks):
            if i >= 1 and self.prompt_type == "vipt_deep":
                x_ori = x_cur
                z_cur = x_cur[:, :lens_z]
                xs = x_cur[:, lens_z:]
                xs_full = recover_search_tokens(xs, gidx_s, lens_x) if pruned else xs
                full = self.prompt_norms[i - 1](torch.cat([z_cur, xs_full], dim=1))
                z_t, x_t = full[:, :lens_z], full[:, lens_z:]
                zp = self.prompt_norms[i](z_prompted)
                xp = self.prompt_norms[i](x_prompted)
                z_prompted = self.prompt_blocks[i](z_t, zp)
                x_prompted = self.prompt_blocks[i](x_t, xp)
                x_sel = (gather_search_tokens(x_prompted, gidx_s) if pruned
                         else x_prompted)
                x_cur = x_ori + torch.cat([z_prompted, x_sel], dim=1)

            lens_keep = None
            if ce_keep_lens is not None and i in self.ce_loc:
                lens_keep = ce_keep_lens[ce_index]
            x_cur, gidx_t, gidx_s, removed = block(x_cur, gidx_t, gidx_s, box_mask_z,
                                                   lens_keep, deterministic, generator)
            if i in self.ce_loc and ce_keep_lens is not None:
                ce_index += 1
                if removed is not None:
                    pruned = True

        x_cur = self.norm(x_cur)
        z_out = x_cur[:, :lens_z]
        xs = x_cur[:, lens_z:]
        xs_full = recover_search_tokens(xs, gidx_s, lens_x) if pruned else xs
        return torch.cat([z_out, xs_full], dim=1)


class ViPTrack(nn.Module):
    """Backbone + CenterPredictor (ostrack_prompt.py:17-91).

    forward(template (B,128,128,6), search (B,256,256,6)) -> dict with
    score_map (B,S,S), size_map/offset_map (B,S,S,2), pred_boxes (B,4)
    cxcywh in [0,1] crop coordinates, max_score (B,), backbone_tokens.
    """

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 template_size: int = 128, search_size: int = 256, patch_size: int = 16,
                 ce_loc: tuple[int, ...] = (3, 6, 9), prompt_type: str = "vipt_deep",
                 head_channel: int = 256, head_type: str = "CENTER", dtype=torch.float32,
                 device=None, use_kernels: bool = True, drop_path_rate: float = 0.0,
                 param_dtype=None):
        super().__init__()
        if head_type != "CENTER":
            raise NotImplementedError(f"head_type={head_type}: only CENTER is ported")
        self.head_type = head_type
        self.feat_sz = search_size // patch_size
        self.dtype = dtype
        self.backbone = ViTCEPrompt(
            embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch_size,
            template_size=template_size, search_size=search_size, ce_loc=ce_loc,
            prompt_type=prompt_type, dtype=dtype, device=device, use_kernels=use_kernels,
            drop_path_rate=drop_path_rate, param_dtype=param_dtype)
        self.box_head = CenterPredictor(embed_dim, head_channel, dtype=dtype, device=device,
                                        param_dtype=param_dtype)

    def forward(self, template: torch.Tensor, search: torch.Tensor,
                box_mask_z: Optional[torch.Tensor] = None,
                ce_keep_lens: Optional[tuple[int, ...]] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        tokens = self.backbone(template, search, box_mask_z, ce_keep_lens, deterministic,
                               generator)
        S = self.feat_sz
        feat = tokens[:, -S * S:].reshape(tokens.shape[0], S, S, -1)
        score_map, size_map, offset_map = self.box_head(feat)
        pred_boxes, max_score = cal_bbox(score_map, size_map, offset_map)
        return {"score_map": score_map, "size_map": size_map, "offset_map": offset_map,
                "pred_boxes": pred_boxes, "max_score": max_score,
                "backbone_tokens": tokens}


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random initialisation in the spirit of flax's defaults (the
    card's machine has no jax to run `model.init`): LeCun-normal Dense and
    conv kernels, Xavier-uniform prompt convs, truncated-normal(0.02)
    position embeddings, zero biases; LayerNorm, FrozenBatchNorm and the
    Fovea temperature keep their constructor values. Values are drawn in
    f32 on the CPU from a `torch.Generator`, so a seed gives the same
    weights on every device and dtype."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and "pos_embed" in name:
                v = torch.empty(p.shape).normal_(0.0, 0.02, generator=g).clamp_(-0.04, 0.04)
            elif p.dim() >= 2 and "prompt_blocks" in name:
                fan_in = p[0].numel()
                fan_out = p.shape[0] * p[0, 0].numel()
                a = math.sqrt(6.0 / (fan_in + fan_out))
                v = torch.empty(p.shape).uniform_(-a, a, generator=g)
            elif p.dim() >= 2:
                v = torch.empty(p.shape).normal_(0.0, 1.0 / math.sqrt(p[0].numel()),
                                                 generator=g)
            else:
                continue
            p.copy_(v)
    return model


def build_viptrack(cfg, dtype=torch.float32, device=None, seed: Optional[int] = None,
                   use_kernels: bool = True, param_dtype=None) -> ViPTrack:
    """ViPTrack from a config (build_viptrack, ostrack_prompt.py:94-145);
    seeded random weights when `seed` is given. Matmul and conv weights are
    held in `param_dtype` (default `dtype`); training passes f32 with a
    bf16 `dtype`, as flax keeps its parameters."""
    model = ViPTrack(
        template_size=cfg.DATA.TEMPLATE.SIZE,
        search_size=cfg.DATA.SEARCH.SIZE,
        patch_size=cfg.MODEL.BACKBONE.STRIDE,
        embed_dim=cfg.MODEL.BACKBONE.EMBED_DIM,
        depth=cfg.MODEL.BACKBONE.DEPTH,
        num_heads=cfg.MODEL.BACKBONE.NUM_HEADS,
        ce_loc=tuple(cfg.MODEL.BACKBONE.CE_LOC),
        prompt_type=cfg.TRAIN.PROMPT.TYPE,
        head_channel=cfg.MODEL.HEAD.NUM_CHANNELS,
        head_type=cfg.MODEL.HEAD.TYPE,
        drop_path_rate=cfg.TRAIN.DROP_PATH_RATE,
        dtype=dtype, device=device, use_kernels=use_kernels, param_dtype=param_dtype)
    if seed is not None:
        init_weights(model, seed)
    return model.eval()
