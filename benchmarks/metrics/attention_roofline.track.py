"""The attention kernel (csrc/attention.cu: the resident kernel up to 320
tokens, the streaming one beyond) against its roofline. Per tracking
step it runs in every block without candidate elimination, inside the
fused attention half-block, at that block's tokens."""

from benchmarks import flops, readers, roofline

KERNELS = ("attention_resident_kernel", "attention_streaming_kernel")


def read(ctx):
    C = ctx["cfg"]["model"]["embed_dim"]
    calls = [roofline.attention(ctx["batch"], la, C)
             for la, _, ce in flops.block_tokens(ctx["cfg"]) if not ce]
    return readers.kernel_share(ctx, KERNELS, calls * ctx["steps"])
