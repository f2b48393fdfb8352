"""The transformer MLP half-block, y = x + fc2(gelu(fc1(LayerNorm(x)))).

Port of mmtrack_tpu/ops/mlp_fuse.py::mlp_block_fused (Pallas, :55-107).
On CUDA it runs three hand-written kernels from `csrc/`: the LayerNorm row
kernel, then the bf16 GEMM twice (fc1 with a bias + exact-GELU epilogue,
fc2 with a bias + residual epilogue). The (B*L, 4C) hidden goes through
device memory between the two GEMMs in this first version. Under autograd
the kernels run the forward and the backward is the plain version's.

Rounding points are the Pallas kernel's: LayerNorm statistics and both
matmul accumulations in f32; bias added in f32 before one rounding to the
compute dtype; the hidden rounded before and after the GELU; the residual
added in the compute dtype. GELU is the exact-erf form (the Pallas kernel
used a polynomial erf good to 4e-7 because Mosaic has no erf).

Weights use the torch nn.Linear layout: w1 (4C, C), w2 (C, 4C).
"""

from __future__ import annotations

import torch

from mmtrack_torch.kernels.build import load_library, stream_handle
from mmtrack_torch.ops.plain_grad import launch_with_plain_grad

EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL = 0, 1, 2


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Two-pass LayerNorm over the last axis, in f32 (the kernels' prologue)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def linear_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b with f32 accumulation and the bias added in f32."""
    return x.float() @ w.float().t() + b.float()


def mlp_block_fused_plain(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of `mlp_block_fused`, any device and dtype."""
    dt = x.dtype
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    h = linear_f32(h, w1, b1).to(dt)
    h = gelu_exact(h.float()).to(dt)
    return x + linear_f32(h, w2, b2).to(dt)


def gemm_bf16(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, epilogue: int,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the bf16 GEMM kernel: epilogue(x2d @ w.T + b) -> (M, N) bf16."""
    M, K = x2d.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,):
        raise ValueError(f"gemm shapes: x {tuple(x2d.shape)} w {tuple(w.shape)} "
                         f"b {tuple(b.shape)}")
    if K % 32 or N % 64:
        raise ValueError(f"gemm kernel needs K % 32 == 0 and N % 64 == 0, got K={K} N={N}")
    if w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError(f"gemm kernel needs bf16 weights and f32 bias, got {w.dtype}/{b.dtype}")
    for t in (x2d, w, b):
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError("gemm operands must be contiguous tensors on one device")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2d.device)
    if epilogue == EPI_BIAS_RESIDUAL and (residual is None or residual.shape != (M, N)
                                          or not residual.is_contiguous()):
        raise ValueError("residual epilogue needs a contiguous (M, N) residual")
    load_library().launch(
        "mmt_gemm_bf16", x2d.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        M, N, K, epilogue, stream_handle(x2d.device))
    return out


def layernorm_bf16(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch the LayerNorm row kernel: (M, C) bf16 -> (M, C) bf16."""
    M, C = x2d.shape
    if scale.shape != (C,) or bias.shape != (C,) or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError("layernorm kernel needs f32 (C,) scale and bias")
    out = torch.empty_like(x2d)
    load_library().launch(
        "mmt_layernorm_bf16", x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), M, C, float(eps), stream_handle(x2d.device))
    return out


def check_kernel_input(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel input must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise TypeError(f"kernel input must be a contiguous (B, L, C) bf16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")


def _mlp_block_launch(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      eps: float) -> torch.Tensor:
    check_kernel_input(x)
    B, L, C = x.shape
    x2d = x.view(B * L, C)
    h = layernorm_bf16(x2d, ln_scale, ln_bias, eps)
    h = gemm_bf16(h, w1, b1, EPI_BIAS_GELU)
    y = gemm_bf16(h, w2, b2, EPI_BIAS_RESIDUAL, residual=x2d)
    mlp_block_fused.launches += 1
    return y.view(B, L, C)


def mlp_block_fused(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(gelu(fc1(LayerNorm(x)))) for x (B, L, C).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernels (bf16 x and weights, f32 LayerNorm parameters and biases) or
    raises; under autograd the gradient is the plain version's
    (ops/plain_grad.py).
    """
    if x.device.type == "cpu":
        return mlp_block_fused_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return launch_with_plain_grad(_mlp_block_launch, mlp_block_fused_plain,
                                  (x, ln_scale, ln_bias, w1, b1, w2, b2), eps=eps)


mlp_block_fused.launches = 0
