"""ViPT: prompt-tuned one-stream ViT tracker, port of mmtrack_tpu/models/vipt.py
(:36-454: the CENTER head, plain OSTrack, and OSTrack-online's score head).

Token-space PromptBlock/Fovea, 12 CE blocks with static-shape candidate
elimination, deep-prompt re-injection with scatter/gather recovery, and
the CenterPredictor head. Inputs are NHWC 6-channel crops (3-channel for
plain OSTrack); module and parameter names are the reference torch ones,
so `models/convert.py` carries flax parameters across unchanged.
`build_ostrack` is the prompt-free OSTrack, and `ScoreTransformer` (with
its `CABlock`s) the class-attention confidence head of OSTrack-online,
named as the reference's `cls_head.` tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mmtrack_torch.models.heads import CenterPredictor, CornerPredictor, MLPHead, cal_bbox
from mmtrack_torch.models.layers import CEBlock, Conv2d, Dense, LayerNorm, Mlp, PatchEmbed
from mmtrack_torch.ops.box import box_xyxy_to_cxcywh
from mmtrack_torch.ops.ce import ce_keep_schedule, gather_search_tokens, recover_search_tokens
from mmtrack_torch.utils import profiling


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
    zeros. 3-channel crops (plain OSTrack, JAX `build_ostrack`) skip the
    auxiliary stream: `patch_embed_prompt` and the prompts are not used,
    and a model bridged from such a flax tree lacks their weights. With
    prompt_type 'none', 6-channel crops add `patch_embed_prompt` of the
    auxiliary triplet to the RGB tokens (vipt.py:152-160); a model whose
    `patch_embed_prompt` was dropped (`drop_prompt_embed`, a 3-channel
    flax tree) refuses them, as flax finds no parameters for it.

    Block i has drop-path rate drop_path_rate * i / (depth - 1)
    (vipt.py:204); drop path acts only when forward gets
    `deterministic=False`, with its masks drawn from `generator`."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, template_size: int = 128,
                 search_size: int = 256, ce_loc: tuple[int, ...] = (3, 6, 9),
                 prompt_type: str = "vipt_deep", dtype=torch.float32, device=None,
                 use_kernels: bool = True, drop_path_rate: float = 0.0, param_dtype=None,
                 fuse: bool = True):
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
            CEBlock(embed_dim, num_heads, use_kernels=use_kernels, fuse=fuse,
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

        # 3-channel crops: plain OSTrack, no auxiliary-modality stream
        rgb_only = z.shape[-1] == 3
        if rgb_only and self.prompt_type == "vipt_deep":
            raise ValueError("vipt_deep re-injects its prompts in every block: it needs "
                             "6-channel crops")

        with profiling.span("vipt.embed", x.device):
            z_tok = self.patch_embed(z[..., :3])
            x_tok = self.patch_embed(x[..., :3])
            if rgb_only:
                pass
            elif has_prompt:
                z_dte_tok = self.patch_embed_prompt(z[..., 3:])
                x_dte_tok = self.patch_embed_prompt(x[..., 3:])
                n0, p0 = self.prompt_norms[0], self.prompt_blocks[0]
                z_prompted = p0(n0(z_tok), n0(z_dte_tok))
                x_prompted = p0(n0(x_tok), n0(x_dte_tok))
                z_tok = z_tok + z_prompted
                x_tok = x_tok + x_prompted
            else:
                if self.patch_embed_prompt is None:
                    raise ValueError("this model has no patch_embed_prompt weights (a 3-channel "
                                     "tree): it needs 3-channel crops")
                z_tok = z_tok + self.patch_embed_prompt(z[..., 3:])
                x_tok = x_tok + self.patch_embed_prompt(x[..., 3:])

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
                with profiling.span("vipt.prompt", dev):
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
            with profiling.span("vipt.block" if lens_keep is None else "vipt.ce_block", dev):
                x_cur, gidx_t, gidx_s, removed = block(x_cur, gidx_t, gidx_s, box_mask_z,
                                                       lens_keep, deterministic, generator)
            if i in self.ce_loc and ce_keep_lens is not None:
                ce_index += 1
                if removed is not None:
                    pruned = True

        with profiling.span("vipt.head", dev):
            x_cur = self.norm(x_cur)
            z_out = x_cur[:, :lens_z]
            xs = x_cur[:, lens_z:]
            xs_full = recover_search_tokens(xs, gidx_s, lens_x) if pruned else xs
            return torch.cat([z_out, xs_full], dim=1)


class ViPTrack(nn.Module):
    """Backbone + box head (ostrack_prompt.py:17-91; JAX vipt.py:248-337).

    forward(template (B,128,128,6), search (B,256,256,6)) -> dict with
    score_map (B,S,S), size_map/offset_map (B,S,S,2), pred_boxes (B,4)
    cxcywh in [0,1] crop coordinates, max_score (B,), backbone_tokens.

    `head_type` (MODEL.HEAD.TYPE): CENTER, the centre / size / offset maps
    decoded at the score map's argmax; CORNER, the corner head's
    soft-argmax box, `score_map` its top-left distribution, zero size and
    offset maps and max_score sqrt(max p_tl * max p_br); MLP, the sigmoid of
    MLPHead on the mean search token, `score_map` the softmax over the
    search tokens of their correlation with the mean template token over
    sqrt(C), in f32, and max_score its largest value. The heads read the
    search tokens in their image order (after `recover_search_tokens`).
    """

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 template_size: int = 128, search_size: int = 256, patch_size: int = 16,
                 ce_loc: tuple[int, ...] = (3, 6, 9), prompt_type: str = "vipt_deep",
                 head_channel: int = 256, head_type: str = "CENTER", dtype=torch.float32,
                 device=None, use_kernels: bool = True, drop_path_rate: float = 0.0,
                 param_dtype=None, fuse: bool = True):
        super().__init__()
        if head_type not in ("CENTER", "CORNER", "MLP"):
            raise ValueError(f"head_type={head_type!r}: one of CENTER, CORNER, MLP")
        self.head_type = head_type
        self.feat_sz = search_size // patch_size
        self.dtype = dtype
        self.backbone = ViTCEPrompt(
            embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch_size,
            template_size=template_size, search_size=search_size, ce_loc=ce_loc,
            prompt_type=prompt_type, dtype=dtype, device=device, use_kernels=use_kernels,
            drop_path_rate=drop_path_rate, param_dtype=param_dtype, fuse=fuse)
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        if head_type == "CORNER":
            self.box_head = CornerPredictor(embed_dim, head_channel, self.feat_sz, patch_size,
                                            **kw)
        elif head_type == "MLP":
            self.box_head = MLPHead(embed_dim, embed_dim, **kw)
        else:
            self.box_head = CenterPredictor(embed_dim, head_channel, **kw)

    def forward(self, template: torch.Tensor, search: torch.Tensor,
                box_mask_z: Optional[torch.Tensor] = None,
                ce_keep_lens: Optional[tuple[int, ...]] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        tokens = self.backbone(template, search, box_mask_z, ce_keep_lens, deterministic,
                               generator)
        with profiling.span("vipt.head", tokens.device):
            S = self.feat_sz
            B = tokens.shape[0]
            feat = tokens[:, -S * S:].reshape(B, S, S, -1)
            if self.head_type == "CENTER":
                score_map, size_map, offset_map = self.box_head(feat)
                pred_boxes, max_score = cal_bbox(score_map, size_map, offset_map)
            else:
                if self.head_type == "CORNER":
                    xyxy, p_tl, p_br = self.box_head(feat, return_dist=True)
                    pred_boxes = box_xyxy_to_cxcywh(xyxy)
                    prob = p_tl
                    max_score = torch.sqrt(p_tl.amax(1) * p_br.amax(1))
                else:
                    pred_boxes = torch.sigmoid(self.box_head(feat.mean(dim=(1, 2))))
                    z_tok = tokens[:, :tokens.shape[1] - S * S].float()
                    x_tok = feat.reshape(B, S * S, -1).float()
                    corr = torch.einsum("bnc,bc->bn", x_tok, z_tok.mean(dim=1))
                    prob = torch.softmax(corr / math.sqrt(x_tok.shape[-1]), dim=1)
                    max_score = prob.amax(1)
                score_map = prob.reshape(B, S, S).to(self.dtype)
                size_map = torch.zeros((B, S, S, 2), dtype=self.dtype, device=tokens.device)
                offset_map = torch.zeros_like(size_map)
            return {"score_map": score_map, "size_map": size_map, "offset_map": offset_map,
                    "pred_boxes": pred_boxes, "max_score": max_score,
                    "backbone_tokens": tokens}


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random initialisation in the spirit of flax's defaults (the
    card's machine has no jax to run `model.init`): LeCun-normal Dense and
    conv kernels (fan in = the product of all but the first axis),
    Xavier-uniform prompt convs, truncated-normal(0.02) position
    embeddings, relative-position bias tables and MixFormer's score token,
    a unit-normal query embedding
    (STARK's), zero biases;
    LayerNorm, FrozenBatchNorm, the Fovea temperature and SiamFC's
    response scale keep their constructor values. Values are drawn in f32
    on the CPU from a `torch.Generator`, so a seed gives the same weights
    on every device and dtype. The port's other models (Alpha-Refine,
    STARK, SiamFC, the score head) take their seeded weights from here
    too, and so does MixFormer."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and ("pos_embed" in name or name.endswith("score_token")
                                 or "relative_position_bias_table" in name):
                v = torch.empty(p.shape).normal_(0.0, 0.02, generator=g).clamp_(-0.04, 0.04)
            elif name == "query_embed.weight":
                v = torch.empty(p.shape).normal_(0.0, 1.0, generator=g)
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
        for m in model.modules():   # torch's own layers draw their biases from the global generator
            if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
                m.bias.zero_()
    return model


class _ClassAttention(nn.Module):
    """The class token's attention over [cls; tokens] (cross_attn.py
    ClassAttention): `qkv` projects every token, and the query is the
    class token's own row of the same Dense, computed alone as the JAX
    package does; logits and softmax in f32."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32, device=None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, L, C = h.shape
        hd = C // self.heads
        kv = self.qkv(h).reshape(B, L, 3, self.heads, hd)
        k, v = kv[:, :, 1], kv[:, :, 2]
        q = self.qkv(h[:, 0])[:, :C].reshape(B, 1, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).float(), k.float())
        a = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, 1, C)
        return self.proj(out)


class CABlock(nn.Module):
    """Class-attention block (vipt.py:349-376; OSTrack layers/cross_attn.py
    CABlock_): the class token attends [cls; tokens] after `norm1`, then
    `norm2` -> Mlp (exact GELU) refines it; LayerNorm epsilon 1e-5."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn = _ClassAttention(dim, heads, **kw)
        self.norm2 = LayerNorm(dim, eps=1e-5, **kw)
        self.mlp = Mlp(dim, 4 * dim, **kw)

    def forward(self, tokens: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        cls = cls + self.attn(self.norm1(torch.cat([cls, tokens], dim=1)))
        return cls + self.mlp(self.norm2(cls))


class _MLPStack(nn.Module):
    """`score_head.layers.{j}` of the reference's MLP (score_head.py)."""

    def __init__(self, dim: int, n_layers: int, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(dim, dim if j < n_layers - 1 else 1, dtype=dtype, device=device)
            for j in range(n_layers))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)


class ScoreTransformer(nn.Module):
    """OSTrack-online's confidence head (vipt.py:379-409; OSTrack
    score_head.py:20-83): the predicted box projects to a class token
    (`cls_proj`), `n_layers` CABlocks attend the token sequence, `norm`
    (epsilon 1e-5) takes the class row, and an `n_mlp_layers` MLP with
    ReLU maps it to a logit. forward(tokens (B, L, C), pred_box (B, 4)) ->
    score (B,) in (0, 1). Tokens of another dtype are cast to the head's,
    as flax promotes them. The state_dict names are the reference's under
    its `cls_head.` prefix (JAX convert.py::convert_score_head_checkpoint)."""

    def __init__(self, d_model: int = 768, n_layers: int = 2, n_heads: int = 12,
                 n_mlp_layers: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.cls_proj = Dense(4, d_model, **kw)
        self.blocks = nn.ModuleList(CABlock(d_model, n_heads, **kw) for _ in range(n_layers))
        self.norm = LayerNorm(d_model, eps=1e-5, **kw)
        self.score_head = _MLPStack(d_model, n_mlp_layers, **kw)

    def forward(self, tokens: torch.Tensor, pred_box: torch.Tensor) -> torch.Tensor:
        tokens = tokens.to(self.dtype)
        cls = self.cls_proj(pred_box)[:, None]
        for block in self.blocks:
            cls = block(tokens, cls)
        # the norm is per token: the class row of norm([cls; tokens])
        h = self.norm(cls)[:, 0]
        return torch.sigmoid(self.score_head(h).float())[:, 0]


def build_viptrack(cfg, dtype=torch.float32, device=None, seed: Optional[int] = None,
                   use_kernels: bool = True, param_dtype=None, fuse: bool = True) -> ViPTrack:
    """ViPTrack from a config (build_viptrack, ostrack_prompt.py:94-145);
    seeded random weights when `seed` is given. Matmul and conv weights are
    held in `param_dtype` (default `dtype`); training passes f32 with a
    bf16 `dtype`, as flax keeps its parameters. `use_kernels` and `fuse`
    go to every block (CEBlock; utils/optouts.py maps JAX's opt-outs to
    them)."""
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
        dtype=dtype, device=device, use_kernels=use_kernels, param_dtype=param_dtype,
        fuse=fuse)
    if seed is not None:
        init_weights(model, seed)
    return model.eval()


def build_ostrack(cfg=None, dtype=torch.float32, device=None, seed: Optional[int] = None,
                  use_kernels: bool = True, **overrides) -> ViPTrack:
    """Plain OSTrack (vipt.py:431-454): ViPTrack with prompt_type 'none',
    from a config or from ViPTrack's keyword arguments (`overrides`, e.g.
    template_size=128, search_size=320). 3-channel crops run the RGB
    baseline; 6-channel crops add the auxiliary triplet's patch embedding,
    as JAX's ViTCEPrompt does. Seeded random weights when `seed` is given."""
    kwargs = dict(prompt_type="none", dtype=dtype, device=device, use_kernels=use_kernels)
    if cfg is not None:
        kwargs.update(
            template_size=cfg.DATA.TEMPLATE.SIZE, search_size=cfg.DATA.SEARCH.SIZE,
            patch_size=cfg.MODEL.BACKBONE.STRIDE, embed_dim=cfg.MODEL.BACKBONE.EMBED_DIM,
            depth=cfg.MODEL.BACKBONE.DEPTH, num_heads=cfg.MODEL.BACKBONE.NUM_HEADS,
            ce_loc=tuple(cfg.MODEL.BACKBONE.CE_LOC), head_channel=cfg.MODEL.HEAD.NUM_CHANNELS,
            drop_path_rate=cfg.TRAIN.DROP_PATH_RATE)
    kwargs.update(overrides)
    model = ViPTrack(**kwargs)
    if seed is not None:
        init_weights(model, seed)
    return model.eval()


def drop_prompt_embed(model: ViPTrack) -> ViPTrack:
    """Remove `backbone.patch_embed_prompt` from a prompt-free model, so
    that a state_dict of a 3-channel flax tree (which has no such weights)
    loads strictly and 6-channel crops are refused, as in flax."""
    model.backbone.patch_embed_prompt = None
    return model
