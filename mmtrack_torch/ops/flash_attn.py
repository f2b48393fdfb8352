"""The attention half-block, y = x + proj(MHSA(qkv(LayerNorm(x)))).

Port of mmtrack_tpu/ops/flash_attn.py::attn_block_fused (Pallas, :88-160),
used by the transformer blocks without candidate elimination. On CUDA it
runs four hand-written kernels from `csrc/`: the LayerNorm row kernel, the
bf16 GEMM for qkv (bias epilogue), the attention kernel (one block per 64
query rows, head and sequence, streaming K and V tiles through shared
memory from the fused (B, L, 3C) qkv and writing (B, L, C) token-major),
and the bf16 GEMM for the output projection (bias + residual epilogue).

Rounding points are the Pallas kernel's: qkv rounded to the compute dtype
after an f32 bias add; q scaled in the compute dtype; logits and the
max-subtracted softmax in f32; the normalised probabilities rounded before
PV; PV in f32 rounded per head; proj in f32 + bias, rounded, then the
residual added in the compute dtype.

Weights use the torch nn.Linear layout: wqkv (3C, C), wproj (C, C).

`flash_mhsa_qkv` ports mmtrack_tpu/ops/flash_attn.py::flash_mhsa_qkv
(Pallas, :34-85): the attention alone, softmax(q k^T s) v from the fused
(B, L, 3C) qkv to (B, L, C) token-major. It runs on the same attention
kernel (`csrc/attention.cu`), which computes exactly that function with
the same rounding points. Training reaches it in the blocks whose fused
half-block is off (drop path active) and that do not eliminate candidates.

Under autograd every kernel here runs the forward and the backward is the
gradient of its plain version, recomputed from the saved inputs
(ops/plain_grad.py): the Pallas kernels have no backward to port.
"""

from __future__ import annotations

import functools

import torch

from mmtrack_torch.kernels.build import load_library, stream_handle
from mmtrack_torch.ops.mlp_fuse import (
    EPI_BIAS,
    EPI_BIAS_RESIDUAL,
    check_kernel_input,
    gemm_bf16,
    layer_norm_f32,
    layernorm_bf16,
    linear_f32,
)
from mmtrack_torch.ops.plain_grad import launch_with_plain_grad
from mmtrack_torch.utils import profiling

HEAD_DIM = 64  # the attention kernel is specialised to ViT-B's head width


def mhsa_plain(qkv: torch.Tensor, num_heads: int,
               scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v from a fused (B, L, 3C) qkv, with the Pallas
    kernel's rounding points (also flax's: layers.py:138-146).

    Returns (out (B, L, C), probabilities (B, H, L, L) in qkv's dtype)."""
    dt = qkv.dtype
    B, L, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    parts = qkv.view(B, L, 3, num_heads, D).permute(2, 0, 3, 1, 4)  # (3, B, H, L, D)
    q = parts[0] * torch.tensor(scale, dtype=dt)   # scale rounded to dt, product in dt
    k, v = parts[1], parts[2]
    logits = q.float() @ k.float().transpose(-1, -2)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    attn = (p / p.sum(-1, keepdim=True)).to(dt)
    out = (attn.float() @ v.float()).to(dt)          # (B, H, L, D)
    return out.transpose(1, 2).reshape(B, L, C), attn


def attn_block_fused_plain(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                           wqkv: torch.Tensor, bqkv: torch.Tensor, wproj: torch.Tensor,
                           bproj: torch.Tensor, num_heads: int, scale: float,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of `attn_block_fused`, any device and dtype."""
    dt = x.dtype
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    qkv = linear_f32(h, wqkv, bqkv).to(dt)
    att, _ = mhsa_plain(qkv, num_heads, scale)
    return x + linear_f32(att, wproj, bproj).to(dt)


def flash_mhsa_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of `flash_mhsa_qkv`: the output of `mhsa_plain`."""
    return mhsa_plain(qkv, num_heads, scale)[0]


@functools.lru_cache(maxsize=None)
def _bf16_value(v: float) -> float:
    """v rounded to bf16 (to nearest even), as a Python float."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def mhsa_bf16(qkv2d: torch.Tensor, B: int, L: int, num_heads: int,
              scale: float) -> torch.Tensor:
    """Launch the attention kernel on a contiguous (B*L, 3C) bf16 qkv."""
    C = qkv2d.shape[1] // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"attention kernel needs head dim {HEAD_DIM}, got {C // num_heads}")
    if qkv2d.data_ptr() % 16:
        raise ValueError("attention kernel needs a 16-byte aligned qkv")
    out = torch.empty((B * L, C), dtype=torch.bfloat16, device=qkv2d.device)
    load_library().launch("mmt_attention_bf16", qkv2d.data_ptr(), out.data_ptr(), B, L,
                          num_heads, _bf16_value(scale), stream_handle(qkv2d.device))
    return out


def _flash_mhsa_launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    check_kernel_input(qkv)
    B, L, C3 = qkv.shape
    out = mhsa_bf16(qkv.view(B * L, C3), B, L, num_heads, scale)
    profiling.count("launches.flash_mhsa_qkv")
    return out.view(B, L, C3 // 3)


def flash_mhsa_qkv(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for a fused qkv (B, L, 3C) -> (B, L, C).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    attention kernel (contiguous bf16, head dim 64, any L) or raises.
    """
    if qkv.device.type == "cpu":
        return flash_mhsa_qkv_plain(qkv, num_heads, scale)
    return launch_with_plain_grad(_flash_mhsa_launch, flash_mhsa_qkv_plain, (qkv,),
                                  num_heads=num_heads, scale=scale)



def _attn_block_launch(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                       wqkv: torch.Tensor, bqkv: torch.Tensor, wproj: torch.Tensor,
                       bproj: torch.Tensor, num_heads: int, scale: float,
                       eps: float) -> torch.Tensor:
    check_kernel_input(x)
    B, L, C = x.shape
    x2d = x.view(B * L, C)
    h = layernorm_bf16(x2d, ln_scale, ln_bias, eps)
    qkv = gemm_bf16(h, wqkv, bqkv, EPI_BIAS)
    att = mhsa_bf16(qkv, B, L, num_heads, scale)
    y = gemm_bf16(att, wproj, bproj, EPI_BIAS_RESIDUAL, residual=x2d)
    profiling.count("launches.attn_block_fused")
    return y.view(B, L, C)


def attn_block_fused(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                     wqkv: torch.Tensor, bqkv: torch.Tensor, wproj: torch.Tensor,
                     bproj: torch.Tensor, num_heads: int, scale: float,
                     eps: float = 1e-6) -> torch.Tensor:
    """x + proj(MHSA(qkv(LayerNorm(x)))) for x (B, L, C).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernels (bf16 x and weights, f32 LayerNorm parameters and biases, head
    dim 64) or raises.
    """
    if x.device.type == "cpu":
        return attn_block_fused_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                                      num_heads, scale, eps)
    return launch_with_plain_grad(_attn_block_launch, attn_block_fused_plain,
                                  (x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj),
                                  num_heads=num_heads, scale=scale, eps=eps)

