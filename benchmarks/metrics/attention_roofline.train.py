"""The attention kernel (csrc/attention.cu) in training against its
roofline. Per step it runs forward in every block without candidate
elimination: block 0's fused half-block (no drop path there) and
`flash_mhsa_qkv` in the others; the backward recomputes the plain
attention and runs no kernel of its own."""

from benchmarks import flops, readers, roofline

KERNELS = ("attention_resident_kernel", "attention_streaming_kernel")


def read(ctx):
    C = ctx["cfg"]["model"]["embed_dim"]
    calls = [roofline.attention(ctx["batch"], la, C)
             for la, _, ce in flops.block_tokens(ctx["cfg"]) if not ce]
    return readers.kernel_share(ctx, KERNELS, calls * ctx["steps"])
