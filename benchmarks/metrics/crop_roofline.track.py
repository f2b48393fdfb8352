"""The crop kernel (csrc/crop.cu) against its roofline: one launch per
tracking step over the B search crops, and one over the B template crops
where a batch of sequences starts; each bounded by its bytes (the f32
output and the source pixels its taps can read, from the launch's boxes);
its few operations per output are far under that bound."""

from benchmarks import readers, roofline

KERNELS = ("crop_rows_kernel",)


def read(ctx):
    p, c = ctx["traffic"], ctx["cfg"]["model"]["channels"]
    calls = [(0.0, roofline.crop_bytes(b, p["height"], p["width"], c, size, factor))
             for b, factor, size in ctx["crops"]]
    return readers.kernel_share(ctx, KERNELS, calls)
