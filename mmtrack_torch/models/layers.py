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

from functools import lru_cache
from typing import Optional

import numpy as np
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
from mmtrack_torch.utils.device import device_constant


@lru_cache(maxsize=None)
def rpe_index_concat(z_size: int, x_size: int) -> np.ndarray:
    """(N, N) relative-position bucket of every (query, key) pair of the
    concatenated [template; search] tokens, N = z_size^2 + x_size^2
    (rpe.py:27-58; JAX layers.py:24-51): one bucket per distinct (dh, dw,
    query origin, key origin), numbered in sorted order."""
    def grid(n):
        h, w = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        return h.ravel(), w.ravel()

    (zh, zw), (xh, xw) = grid(z_size), grid(x_size)
    h, w = np.concatenate([zh, xh]), np.concatenate([zw, xw])
    origin = np.concatenate([np.zeros(z_size * z_size, np.int64),
                             np.ones(x_size * x_size, np.int64)])
    n = h.shape[0]
    key = np.stack([h[:, None] - h[None, :], w[:, None] - w[None, :],
                    np.broadcast_to(origin[:, None], (n, n)),
                    np.broadcast_to(origin[None, :], (n, n))], axis=-1)
    _, inverse = np.unique(key.reshape(-1, 4), axis=0, return_inverse=True)
    return inverse.reshape(n, n)


def _rpe_bias(table: torch.Tensor, z_size: int, x_size: int) -> torch.Tensor:
    """(1, H, N, N) f32 bias gathered from a (H, buckets) table."""
    idx = device_constant(("rpe_index", z_size, x_size),
                          lambda: rpe_index_concat(z_size, x_size), table.device)
    return table[:, idx][None].float()


def _logits(qkv: torch.Tensor, num_heads: int, scale: float):
    """(q k^T * scale in f32 (B, H, L, L), v (B, H, L, D)) from a fused
    (B, L, 3C) qkv, q scaled in qkv's dtype as flax does."""
    B, L, C3 = qkv.shape
    parts = qkv.view(B, L, 3, num_heads, C3 // 3 // num_heads).permute(2, 0, 3, 1, 4)
    q = parts[0] * torch.tensor(scale, dtype=qkv.dtype)
    return q.float() @ parts[1].float().transpose(-1, -2), parts[2]


def _attend(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, L, C) of probabilities (B, H, L, L) in v's dtype over v."""
    B, H, L, D = v.shape
    out = (attn.to(v.dtype).float() @ v.float()).to(v.dtype)
    return out.transpose(1, 2).reshape(B, L, H * D)


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
    """Fused-qkv multi-head self-attention (layers.py:90-151).

    The unfused path of a block: the CE blocks, which need the probability
    matrix (`return_attn=True`), f32 models, and the training blocks with
    drop path. At bf16 without `return_attn` the attention itself goes to
    `flash_mhsa_qkv` (layers.py:129-136), its kernel on CUDA tensors;
    `use_kernels=False` selects its plain version on any device. With
    `rpe` the logits gain the learned relative-position bias of the
    concatenated z_size^2 template and x_size^2 search tokens
    (`relative_position_bias_table`, (heads, buckets); attn.py:23-45), and
    the attention stays unfused (no block of the port builds one).
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 param_dtype=None, use_kernels: bool = True, rpe: bool = False,
                 z_size: int = 8, x_size: int = 16):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.scale = (dim // num_heads) ** -0.5
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.proj = Dense(dim, dim, **kw)
        self.rpe, self.z_size, self.x_size = rpe, z_size, x_size
        if rpe:
            buckets = int(rpe_index_concat(z_size, x_size).max()) + 1
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(num_heads, buckets, device=device))

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        qkv = self.qkv(x)
        if self.rpe:
            logits, v = _logits(qkv, self.num_heads, self.scale)
            logits = logits + _rpe_bias(self.relative_position_bias_table, self.z_size,
                                        self.x_size)
            attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
            return self.proj(_attend(attn, v)), (attn if return_attn else None)
        if self.dtype == torch.bfloat16 and not return_attn:
            mhsa = flash_mhsa_qkv if self.use_kernels else flash_mhsa_qkv_plain
            return self.proj(mhsa(qkv, self.num_heads, self.scale)), None
        out, attn = mhsa_plain(qkv, self.num_heads, self.scale)
        return self.proj(out), (attn if return_attn else None)


class AttentionTalkingHead(nn.Module):
    """Talking-heads attention (attn.py:62-130; JAX layers.py:154-214): the
    logits (with the relative-position bias when `rpe`) mixed across the
    heads by `proj_l` before the softmax and the probabilities by `proj_w`
    after it (each a heads x heads Linear with bias, applied in f32), then
    the values; output through `proj`."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 rpe: bool = True, z_size: int = 8, x_size: int = 16):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.proj_l = nn.Linear(num_heads, num_heads, device=device)
        self.proj_w = nn.Linear(num_heads, num_heads, device=device)
        self.rpe, self.z_size, self.x_size = rpe, z_size, x_size
        if rpe:
            buckets = int(rpe_index_concat(z_size, x_size).max()) + 1
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(num_heads, buckets, device=device))

    @staticmethod
    def _mix(t: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        return (torch.einsum("bhqk,gh->bgqk", t, lin.weight.float())
                + lin.bias.float()[None, :, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        logits, v = _logits(qkv, self.num_heads, self.scale)
        if self.rpe:
            logits = logits + _rpe_bias(self.relative_position_bias_table, self.z_size,
                                        self.x_size)
        attn = torch.softmax(self._mix(logits, self.proj_l), dim=-1)
        return self.proj(_attend(self._mix(attn, self.proj_w), v))


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
    `fuse=False` runs the unfused layers at bf16 too, where JAX's gate sends
    its blocks under MMTRACK_ATTN=xla or MMTRACK_MLP=xla (utils/optouts.py);
    `use_kernels` then decides only the attention's `flash_mhsa_qkv`.
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 use_kernels: bool = True, drop_path_rate: float = 0.0, param_dtype=None,
                 fuse: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.fuse = fuse
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
        fused = self.fuse and self.dtype == torch.bfloat16 and not stochastic
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
