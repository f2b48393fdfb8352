"""The transformer MLP half-block, y = x + fc2(gelu(fc1(LayerNorm(x)))).

Port of mmtrack_tpu/ops/mlp_fuse.py::mlp_block_fused (Pallas, :55-107).
On CUDA it runs three hand-written kernels from `csrc/`: the LayerNorm row
kernel (one read of each row), then the bf16 GEMM twice (TMA + wgmma; fc1
with a bias + exact-GELU epilogue, fc2 with a bias + residual epilogue),
each with the block tile that `gemm_plan` picks for its (M, N). The
(B*L, 4C) hidden goes through device memory between the two GEMMs. Under
autograd the kernels run the forward and the backward is the plain
version's.

Rounding points are the Pallas kernel's: LayerNorm statistics and both
matmul accumulations in f32; bias added in f32 before one rounding to the
compute dtype; the hidden rounded before and after the GELU; the residual
added in the compute dtype. GELU is the exact-erf form (the Pallas kernel
used a polynomial erf good to 4e-7 because Mosaic has no erf).

Weights use the torch nn.Linear layout: w1 (4C, C), w2 (C, 4C).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


GEMM_BM = 128                     # block rows: two wgmma warpgroups of 64 (csrc/gemm.cu)
GEMM_BN = (256, 192, 128, 64)     # the compiled block widths, widest first
NUM_SMS = 132                     # H100 SXM; one GEMM block per SM (shared memory, registers)
LAYERNORM_MAX_C = 1024            # csrc/layernorm.cu keeps at most 4 x 8 values a lane


class GemmPlan(NamedTuple):
    bm: int
    bn: int
    tiles: int
    waves: float        # tiles / NUM_SMS
    tail_fill: float    # share of the SMs busy in the last wave


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int) -> GemmPlan:
    """The block tile of the GEMM kernel for an (M, K) x (N, K)^T product.

    Every block is 128 rows high; its width is the compiled one (256, 192,
    128 or 64, dividing N) that takes the fewest columns' worth of time in
    whole waves on the card's SMs: ceil(tiles / NUM_SMS) x (width + 64),
    where the 64 stand for a tile's fixed work (its A loads, which a narrow
    tile repeats more often per output, its pipeline fill and epilogue). An
    SM idle in the last wave still waits out the wave, so at M = 3040,
    N = 768 the plan takes 96 tiles of 128 x 192 in one wave over 144 of
    128 x 128 in two. Ties go to the widest tile. Raises ValueError for
    N % 64 or K % 8 (TMA needs 16-byte row strides)."""
    if M < 1 or K < 8 or K % 8 or N < GEMM_BN[-1] or N % GEMM_BN[-1]:
        raise ValueError(f"gemm kernel needs M >= 1, K % 8 == 0 and N % {GEMM_BN[-1]} == 0, "
                         f"got M={M} N={N} K={K}")
    row_tiles = -(-M // GEMM_BM)

    def cost(bn):
        tiles = row_tiles * (N // bn)
        return -(-tiles // NUM_SMS) * (bn + 64)

    bn = min((bn for bn in GEMM_BN if N % bn == 0), key=lambda bn: (cost(bn), -bn))
    tiles = row_tiles * (N // bn)
    tail = tiles % NUM_SMS or NUM_SMS
    return GemmPlan(GEMM_BM, bn, tiles, tiles / NUM_SMS, tail / NUM_SMS)


def _check_aligned(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {device}")


def gemm_bf16_plain(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, epilogue: int,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `gemm_bf16`, with the kernel's rounding points."""
    h = linear_f32(x2d, w, b).to(torch.bfloat16)
    if epilogue == EPI_BIAS_GELU:
        return gelu_exact(h.float()).to(torch.bfloat16)
    if epilogue == EPI_BIAS_RESIDUAL:
        return residual + h
    return h


def gemm_bf16(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor, epilogue: int,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the bf16 GEMM kernel: epilogue(x2d @ w.T + b) -> (M, N) bf16.

    Every check (shapes, dtypes, contiguity, 16-byte alignment, a CUDA
    device) raises before the library is built or a kernel launched."""
    M, K = x2d.shape
    N = w.shape[0]
    if w.shape != (N, K) or b.shape != (N,):
        raise ValueError(f"gemm shapes: x {tuple(x2d.shape)} w {tuple(w.shape)} "
                         f"b {tuple(b.shape)}")
    if x2d.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError(f"gemm kernel needs bf16 x and weights and an f32 bias, got "
                        f"{x2d.dtype}/{w.dtype}/{b.dtype}")
    if epilogue not in (EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL):
        raise ValueError(f"unknown gemm epilogue {epilogue}")
    operands = {"x": x2d, "w": w, "bias": b}
    if epilogue == EPI_BIAS_RESIDUAL:
        if residual is None or residual.shape != (M, N) or residual.dtype != torch.bfloat16:
            raise ValueError("residual epilogue needs an (M, N) bf16 residual")
        operands["residual"] = residual
    plan = gemm_plan(M, N, K)
    for name, t in operands.items():
        _check_aligned(name, t, x2d.device)
    if x2d.device.type != "cuda":
        raise ValueError(f"gemm kernel needs CUDA tensors, got {x2d.device}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2d.device)
    load_library().launch(
        "mmt_gemm_bf16", x2d.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        M, N, K, epilogue, plan.bn, stream_handle(x2d.device))
    return out


def layernorm_bf16(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch the LayerNorm row kernel: (M, C) bf16 -> (M, C) bf16.

    Every check raises before the library is built or a kernel launched."""
    M, C = x2d.shape
    if x2d.dtype != torch.bfloat16 or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError("layernorm kernel needs bf16 x and f32 scale and bias")
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"layernorm shapes: x {tuple(x2d.shape)} scale {tuple(scale.shape)} "
                         f"bias {tuple(bias.shape)}")
    if M < 1 or C % 8 or not 0 < C <= LAYERNORM_MAX_C:
        raise ValueError(f"layernorm kernel needs M >= 1, C % 8 == 0 and "
                         f"C <= {LAYERNORM_MAX_C}, got M={M} C={C}")
    for name, t in (("x", x2d), ("scale", scale), ("bias", bias)):
        _check_aligned(name, t, x2d.device)
    if x2d.device.type != "cuda":
        raise ValueError(f"layernorm kernel needs CUDA tensors, got {x2d.device}")
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
