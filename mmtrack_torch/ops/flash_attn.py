"""The attention half-block, y = x + proj(MHSA(qkv(LayerNorm(x)))).

Port of mmtrack_tpu/ops/flash_attn.py::attn_block_fused (Pallas, :88-160),
used by the transformer blocks without candidate elimination. On CUDA it
runs four hand-written kernels from `csrc/`: the LayerNorm row kernel, the
bf16 GEMM for qkv (bias epilogue), the attention kernel (one block per
query tile, head and sequence, reading the fused (B, L, 3C) qkv directly
and writing (B, L, C) token-major), and the bf16 GEMM for the output
projection (bias + residual epilogue).

Rounding points are the Pallas kernel's: qkv rounded to the compute dtype
after an f32 bias add; q scaled in the compute dtype; logits and the
max-subtracted softmax in f32; probabilities rounded before PV; PV in f32
rounded per head; proj in f32 + bias, rounded, then the residual added in
the compute dtype.

Weights use the torch nn.Linear layout: wqkv (3C, C), wproj (C, C).
`flash_mhsa_qkv` (the TPU kernel without the LayerNorm and projections) is
not on the ported path and is not ported yet.
"""

from __future__ import annotations

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


def mhsa_bf16(qkv2d: torch.Tensor, B: int, L: int, num_heads: int,
              scale: float) -> torch.Tensor:
    """Launch the attention kernel on a contiguous (B*L, 3C) bf16 qkv."""
    C = qkv2d.shape[1] // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"attention kernel needs head dim {HEAD_DIM}, got {C // num_heads}")
    lib = load_library()
    if L > lib.attention_max_tokens:
        raise ValueError(f"attention kernel holds at most {lib.attention_max_tokens} "
                         f"tokens in shared memory, got L={L}")
    out = torch.empty((B * L, C), dtype=torch.bfloat16, device=qkv2d.device)
    scale_bf16 = float(torch.tensor(scale, dtype=torch.bfloat16))
    lib.launch("mmt_attention_bf16", qkv2d.data_ptr(), out.data_ptr(), B, L, num_heads,
               scale_bf16, stream_handle(qkv2d.device))
    return out


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
    check_kernel_input(x)
    B, L, C = x.shape
    x2d = x.view(B * L, C)
    h = layernorm_bf16(x2d, ln_scale, ln_bias, eps)
    qkv = gemm_bf16(h, wqkv, bqkv, EPI_BIAS)
    att = mhsa_bf16(qkv, B, L, num_heads, scale)
    y = gemm_bf16(att, wproj, bproj, EPI_BIAS_RESIDUAL, residual=x2d)
    attn_block_fused.launches += 1
    return y.view(B, L, C)


attn_block_fused.launches = 0
