"""The bf16 GEMM kernel (csrc/gemm.cu) of the fused half-blocks against
its roofline. Per tracking step, each block without candidate
elimination runs qkv (bias) and proj (bias + residual) at its attention's
tokens, and every block fc1 (bias + GELU) and fc2 (bias + residual) at
its MLP's; the CE blocks' attention products are cuBLAS's."""

from benchmarks import flops, readers, roofline

KERNELS = ("gemm_bf16_kernel",)


def step_calls(cfg, B):
    C = cfg["model"]["embed_dim"]
    H = cfg["model"]["mlp_ratio"] * C
    calls = []
    for la, lm, ce in flops.block_tokens(cfg):
        if not ce:
            calls += [roofline.gemm(B * la, 3 * C, C, roofline.EPI_BIAS),
                      roofline.gemm(B * la, C, C, roofline.EPI_RESIDUAL)]
        calls += [roofline.gemm(B * lm, H, C, roofline.EPI_GELU),
                  roofline.gemm(B * lm, C, H, roofline.EPI_RESIDUAL)]
    return calls


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, step_calls(ctx["cfg"], ctx["batch"]) * ctx["steps"])
