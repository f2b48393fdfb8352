"""Transformer building blocks, port of mmtrack_tpu/models/layers.py.

Parameters use the reference torch names (the ones
mmtrack_tpu/models/convert.py::convert_vipt_checkpoint reads), so the
flax -> torch bridge (models/convert.py) is a pure relabelling.

Numerics follow flax at the module's compute `dtype`: matmul and conv
weights are held in `param_dtype` (default: `dtype`; training keeps them in
f32 like flax's parameters) and cast to `dtype` where they enter a product
or a kernel; biases and LayerNorm parameters stay f32 and are cast where
flax casts them (a Dense/Conv product is rounded to `dtype`, then the bias
is added in `dtype`; LayerNorm computes in f32 and rounds its output).
Inside the kernel modules (ops/flash_attn.py, ops/mlp_fuse.py) the Pallas
kernels' rounding points apply instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.ops.ce import candidate_elimination
from mmtrack_torch.ops.flash_attn import (
    attn_block_fused,
    attn_block_fused_plain,
    flash_mhsa_qkv,
    flash_mhsa_qkv_plain,
    mhsa_plain,
)
from mmtrack_torch.ops.mlp_fuse import (
    gelu_exact,
    layer_norm_f32,
    mlp_block_fused,
    mlp_block_fused_plain,
)
from mmtrack_torch.parallel.mesh import RowDraws


class Dense(nn.Module):
    """flax nn.Dense: y = round(x @ W^T) + bias, in the compute dtype.

    weight (out, in) in `param_dtype` (default `dtype`), bias (out,) f32.
    """

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32, device=None,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=param_dtype or dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class Conv2d(nn.Module):
    """flax nn.Conv on NCHW tensors: round(conv(x, W)) + bias in the compute
    dtype. weight (O, I, kh, kw) in `param_dtype` (default `dtype`), bias
    (O,) f32 (none with `bias=False`, flax's use_bias=False); `groups` is
    flax's feature_group_count."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, device=None, param_dtype=None,
                 bias: bool = True, groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel,
                                               dtype=param_dtype or dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, dtype=torch.float32, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding, 1,
                     self.groups)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (epsilon 1e-6 unless `eps` says otherwise): f32
    statistics and affine, output in `dtype`."""

    def __init__(self, dim: int, dtype=torch.float32, device=None, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias, self.eps).to(self.dtype)


class PatchEmbed(nn.Module):
    """Image to patch tokens: conv with kernel = stride = patch, NHWC in,
    (B, H/p * W/p, C) tokens out."""

    def __init__(self, embed_dim: int = 768, patch_size: int = 16, dtype=torch.float32,
                 device=None, param_dtype=None):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype,
                           device=device, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x.permute(0, 3, 1, 2))          # (B, C, H', W')
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32, device=None,
                 param_dtype=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype, device=device, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(gelu_exact(h.float()).to(h.dtype))


class Attention(nn.Module):
    """Fused-qkv multi-head self-attention (layers.py:90-151, no rpe).

    The unfused path of a block: the CE blocks, which need the probability
    matrix (`return_attn=True`), f32 models, and the training blocks with
    drop path. At bf16 without `return_attn` the attention itself goes to
    `flash_mhsa_qkv` (layers.py:129-136), its kernel on CUDA tensors;
    `use_kernels=False` selects its plain version on any device.
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 param_dtype=None, use_kernels: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.scale = (dim // num_heads) ** -0.5
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.proj = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        qkv = self.qkv(x)
        if self.dtype == torch.bfloat16 and not return_attn:
            mhsa = flash_mhsa_qkv if self.use_kernels else flash_mhsa_qkv_plain
            return self.proj(mhsa(qkv, self.num_heads, self.scale)), None
        out, attn = mhsa_plain(qkv, self.num_heads, self.scale)
        return self.proj(out), (attn if return_attn else None)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
              deterministic: bool = False) -> torch.Tensor:
    """Stochastic depth (layers.py:208-214): drop a residual branch per sample.

    The (B, 1, ..., 1) Bernoulli(1 - rate) mask is drawn from `generator`
    (on x's device), cast to x's dtype, and x is divided by the keep
    probability rounded to that dtype, as jax divides by a weakly typed
    python scalar. A `RowDraws` (a data-parallel rank's generator) draws
    the global batch's mask and keeps its rows of it.
    """
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    rows = slice(None)
    n = x.shape[0]
    if isinstance(generator, RowDraws):
        n, rows, generator = generator.batch, generator.rows, generator.generator
    shape = (n,) + (1,) * (x.dim() - 1)
    mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)[rows]
    return x * mask.to(x.dtype) / float(torch.tensor(keep, dtype=x.dtype))


class CEBlock(nn.Module):
    """Transformer block with optional candidate elimination after attention
    (layers.py:217-300).

    The gate of layers.py:252-256: the block is `fused` when it computes in
    bf16 and drop path is inactive (`deterministic`, or a zero rate). A
    fused block runs `attn_block_fused` when it does not eliminate and
    `mlp_block_fused` always; otherwise it runs norm1 -> Attention (whose
    attention is `flash_mhsa_qkv` at bf16 without CE) -> drop path ->
    residual, then norm2 -> Mlp -> drop path -> residual. The kernel
    wrappers launch the CUDA kernels for CUDA tensors and their plain
    versions on the CPU. `use_kernels=False` selects the plain versions on
    any device, for comparing a whole model with and without the kernels.
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 use_kernels: bool = True, drop_path_rate: float = 0.0, param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.drop_path_rate = drop_path_rate
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn = Attention(dim, num_heads, param_dtype=param_dtype, use_kernels=use_kernels,
                              **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.mlp = Mlp(dim, 4 * dim, param_dtype=param_dtype, **kw)

    def forward(self, x, global_index_t, global_index_s,
                box_mask_z: Optional[torch.Tensor] = None, lens_keep: Optional[int] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        lens_t = global_index_t.shape[1]
        lens_s = global_index_s.shape[1]
        needs_ce = lens_keep is not None and lens_keep < lens_s
        stochastic = not deterministic and self.drop_path_rate > 0
        fused = self.dtype == torch.bfloat16 and not stochastic
        attn_fn = attn_block_fused if self.use_kernels else attn_block_fused_plain
        mlp_fn = mlp_block_fused if self.use_kernels else mlp_block_fused_plain
        dt = self.dtype

        attn = None
        if fused and not needs_ce:
            n1, a = self.norm1, self.attn
            x = attn_fn(x, n1.weight, n1.bias, a.qkv.weight.to(dt), a.qkv.bias,
                        a.proj.weight.to(dt), a.proj.bias, num_heads=self.num_heads,
                        scale=a.scale, eps=n1.eps)
        else:
            attn_out, attn = self.attn(self.norm1(x), return_attn=needs_ce)
            x = x + drop_path(attn_out, self.drop_path_rate, generator, not stochastic)

        removed_index_s = None
        if needs_ce:
            x, global_index_s, removed_index_s = candidate_elimination(
                attn, x, lens_t, lens_keep, global_index_s, box_mask_z)

        if fused:
            n2, m = self.norm2, self.mlp
            x = mlp_fn(x, n2.weight, n2.bias, m.fc1.weight.to(dt), m.fc1.bias,
                       m.fc2.weight.to(dt), m.fc2.bias, eps=n2.eps)
        else:
            mlp_out = self.mlp(self.norm2(x))
            x = x + drop_path(mlp_out, self.drop_path_rate, generator, not stochastic)
        return x, global_index_t, global_index_s, removed_index_s
