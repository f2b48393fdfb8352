"""ViPT's prompt step kernels (the program's csrc/prompt.cu) against their
roofline. Per tracking step, one prompt step at block 0 (the RGB and the
auxiliary modality's tokens of the template and the search grid) and, for
`vipt_deep`, one at each later block (the tokens entering the block and
the prompt state of the whole grid). Each byte once: block i >= 1 reads
its L_a tokens and the 320 state rows and writes both back, block 0
reads 2 x 320 rows and writes 2 x 320. A step is two launches: the first
reads and multiplies by W0 and W1 (C -> 8), the second writes after the
8 -> C product. A config without prompts has no calls."""

from benchmarks import flops, readers, roofline

KERNELS = ("prompt_proj_kernel", "prompt_out_kernel")


def step_calls(cfg, B):
    m = cfg["model"]
    blocks = {"vipt_deep": m["depth"], "vipt_shaw": 1}.get(m["prompt_type"], 0)
    if not blocks:
        return []
    C, hide = m["embed_dim"], m["prompt_hidden"]
    tokens = flops.block_tokens(cfg)
    grid = tokens[0][0]                         # template + search grid rows
    calls = []
    for la, _, _ in tokens[:blocks]:
        rows = la + grid                        # tokens and state (block 0: RGB and auxiliary)
        calls += [(2.0 * B * grid * 2 * hide * C, float(B * rows * C * roofline.BF16)),
                  (2.0 * B * grid * hide * C, float(B * rows * C * roofline.BF16))]
    return calls


def read(ctx):
    return readers.kernel_share(ctx, KERNELS, step_calls(ctx["cfg"], ctx["batch"]) * ctx["steps"])
