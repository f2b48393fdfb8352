"""The crop kernel's row-staging plan and the wrapper's checks, on the CPU.

csrc/crop.cu runs one block per (output row, sequence): it stages the two
source rows in shared memory, cut to the sampled columns the row can read
(`_kernel_span` mirrors it), at the same offset mod 16 as in the frame, and reads
its four taps from there. The kernel runs only on the card
(tests/test_torch_cuda.py), so here the plan is held to what the kernel
needs, on seeded boxes across every edge of the frame, crops of side 1 and
crops wider than the frame: every tap that `crop_resize_normalized_plain`
reads with a non-zero weight lies inside the staged span, the staged bytes
fit `crop_plan`'s row, and the kernel's index arithmetic, emulated here
with the staged rows at every alignment of the frame, gives the plain
version's crops bit for bit. The kernel's divisions (five FMA-unit
operations from a correctly rounded reciprocal, in place of `__fdiv_rn`)
are held to the correctly rounded quotient in exact rational arithmetic.
The wrapper must refuse boxes, mean or std that are not f32 tensors on the
frames' device, before any build.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.ops.crop import (  # noqa: E402
    CROP_MAX_SMEM,
    CROP_MAX_THREADS,
    CROP_ROWS,
    crop_plan,
    crop_resize_normalized,
    crop_resize_normalized_plain,
)

SEEDS = range(12)


def _case(seed):
    """Seeded frames shape, crop size, factor and boxes: inside, across
    each edge and corner, entirely outside, side 1, and wider than W."""
    rng = np.random.RandomState(seed)
    H, W = int(rng.randint(1, 48)), int(rng.randint(1, 64))
    C = int(rng.choice([1, 3, 6]))
    S = int(rng.choice([1, 2, 7, 16, 31, 32]))
    factor = float(rng.choice([2.0, 4.0, 5.3]))
    n = 12
    xy = rng.uniform(-1.5, 1.5, (n, 2)) * (W, H)
    wh = rng.uniform(0.0, 1.2, (n, 2)) * (W, H)
    boxes = np.concatenate([xy, wh], 1)
    boxes[0] = (-0.6 * W, -0.4 * H, 0.5 * W, 0.5 * H)             # top-left corner
    boxes[1] = (W - 2.5, H - 1.5, 4.0, 3.0)                        # bottom-right corner
    boxes[2] = (0.5 * W, 0.5 * H, 0.01, 0.02)                      # side 1
    boxes[3] = (-2.0 * W, 0.2 * H, 3.0 * W, 2.0 * H)               # side > W and > 2S
    boxes[4] = (2.0 * W, 3.0 * H, 5.0, 5.0)                        # entirely outside
    boxes[5] = (W - 0.5, 0.25, 1.0, 1.0)                           # on the last column
    return H, W, C, S, factor, torch.from_numpy(boxes.astype(np.float32))


def _kernel_span(boxes: torch.Tensor, search_area_factor: float, out_size: int,
                     W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampled source columns each sequence's crop rows read, as
    csrc/crop.cu computes them: (lo (B,), n (B,)) with columns [lo, lo + n)
    of [0, W - 2]; n <= 0 when the crop samples none. The first and last
    output pixels' left taps bound the row (source x never decreases along
    it), in the plain version's f32 arithmetic."""
    f32 = torch.float32
    x, _, w, h = boxes.to(f32).unbind(1)
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * search_area_factor), min=1.0)
    x1 = torch.round(x + 0.5 * w - crop_sz * 0.5)
    size = torch.full_like(crop_sz, float(out_size))
    j = torch.tensor([0.5, out_size - 0.5], dtype=f32, device=boxes.device)
    s = j[None, :] * (crop_sz / size)[:, None] - 0.5
    s = torch.minimum(torch.clamp(s, min=0.0), (crop_sz - 1.0)[:, None])
    x0 = torch.floor(x1[:, None] + s).long()                        # (B, 2)
    lo = x0[:, 0].clamp(min=0)
    hi = torch.minimum(x0[:, 1] + 1, torch.full_like(lo, W - 2))
    return lo, hi - lo + 1


def _plain_taps(boxes, factor, S, W):
    """Left taps x0 (B, S) and their fractions fx of the plain version."""
    x, _, w, h = boxes.unbind(1)
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * factor), min=1.0)
    x1 = torch.round(x + 0.5 * w - crop_sz * 0.5)
    size = torch.full_like(crop_sz, float(S))
    j = torch.arange(S, dtype=torch.float32) + 0.5
    s = j[None, :] * (crop_sz / size)[:, None] - 0.5
    s = torch.minimum(torch.clamp(s, min=0.0), (crop_sz - 1.0)[:, None])
    xs = x1[:, None] + s
    x0 = torch.floor(xs)
    return x0.long(), xs - x0


@pytest.mark.parametrize("seed", SEEDS)
def test_span_holds_every_sampled_tap(seed):
    H, W, C, S, factor, boxes = _case(seed)
    plan = crop_plan(H, W, C, S)
    lo, n = _kernel_span(boxes, factor, S, W)
    x0, fx = _plain_taps(boxes, factor, S, W)
    for b in range(boxes.shape[0]):
        # column x0 always weighs 1 - fx > 0; x0 + 1 weighs fx
        taps = set(x0[b].tolist()) | set((x0[b] + 1)[fx[b] > 0].tolist())
        sampled = {t for t in taps if 0 <= t < W - 1}
        span = set(range(int(lo[b]), int(lo[b] + n[b])))
        assert sampled <= span, (b, sorted(sampled - span))
        assert 0 <= lo[b] and (n[b] <= 0 or lo[b] + n[b] <= W - 1)
        staged = max(int(n[b]), 0) * C
        assert 16 * math.ceil((15 + staged) / 16) <= plan.row_bytes


@pytest.mark.parametrize("seed", SEEDS)
def test_emulated_kernel_indexing_equals_plain(seed):
    """csrc/crop.cu's staging and tap offsets, in numpy, on the plain
    version's arithmetic: the crops come out bit for bit, for frames whose
    base address sits at each offset mod 16."""
    H, W, C, S, factor, boxes = _case(seed)
    B = boxes.shape[0]
    rng = np.random.RandomState(100 + seed)
    frames = rng.randint(0, 256, (B, H, W, C)).astype(np.uint8)
    mean = torch.from_numpy(rng.uniform(0.2, 0.6, C).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.1, 0.3, C).astype(np.float32))
    want, rf_w = crop_resize_normalized_plain(torch.from_numpy(frames), boxes, factor, S,
                                              mean, std)
    plan = crop_plan(H, W, C, S)
    lo, n = _kernel_span(boxes, factor, S, W)
    x0, fx = _plain_taps(boxes, factor, S, W)
    # the rows: the same formula on y
    _, y, w, h = boxes.unbind(1)
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * factor), min=1.0)
    y1 = torch.round(y + 0.5 * h - crop_sz * 0.5)
    j = torch.arange(S, dtype=torch.float32) + 0.5
    s = j[None, :] * (crop_sz / torch.full_like(crop_sz, float(S)))[:, None] - 0.5
    s = torch.minimum(torch.clamp(s, min=0.0), (crop_sz - 1.0)[:, None])
    ys = y1[:, None] + s
    y0 = torch.floor(ys)
    fy = ys - y0
    y0 = y0.long()
    # the frames' bytes with 16 bytes of other memory on either side: whole
    # chunks may reach past the frames' first and last byte
    flat = np.concatenate([np.full(16, 0xCD, np.uint8), frames.reshape(-1),
                           np.full(16, 0xCD, np.uint8)])
    den = torch.full((C,), 255.0)
    for base in (0, 3, 8, 13):                      # the frames' address mod 16
        out = torch.empty(B, S, S, C)
        for b in range(B):
            nbytes = max(int(n[b]), 0) * C
            for oy in range(S):
                staged = np.full((2, plan.row_bytes), 0xAB, np.uint8)   # stale bytes
                heads, ok = [], []
                for r in (0, 1):
                    yr = int(y0[b, oy]) + r
                    row_ok = 0 <= yr <= H - 2 and nbytes > 0
                    src = b * H * W * C + ((yr * W + int(lo[b])) * C if row_ok else 0)
                    head = (base + src) % 16
                    if row_ok:                      # whole aligned 16-byte chunks
                        chunks = math.ceil((head + nbytes) / 16)
                        assert 16 * chunks <= plan.row_bytes
                        got = flat[16 + src - head:16 + src - head + 16 * chunks]
                        staged[r, :len(got)] = got
                    heads.append(head)
                    ok.append(row_ok)
                xb, fxb = x0[b], fx[b]
                c0 = (xb >= 0) & (xb < W - 1)
                c1 = (xb >= -1) & (xb < W - 2)
                cc = torch.arange(C)

                def tap(r, valid, col):
                    off = torch.where(valid, (col - lo[b]) * C, 0)[:, None] + cc[None, :]
                    read = (valid & ok[r])[:, None].expand_as(off)
                    assert ((off[read] >= 0) & (off[read] < nbytes)).all()
                    idx = (heads[r] + off).clamp(max=plan.row_bytes - 1)
                    v = torch.from_numpy(staged[r][idx.numpy()].astype(np.float32))
                    return torch.where(read, v, 0.0)

                fyv = fy[b, oy]
                gy, gx = 1 - fyv, (1 - fxb)[:, None]
                f = fxb[:, None]
                v = ((gy * gx) * tap(0, c0, xb) + (gy * f) * tap(0, c1, xb + 1)
                     + (fyv * gx) * tap(1, c0, xb) + (fyv * f) * tap(1, c1, xb + 1))
                out[b, oy] = (v / den - mean) / std
        assert torch.equal(out, want), f"base {base}"
    assert torch.equal(torch.full_like(crop_sz, float(S)) / crop_sz, rf_w)


@pytest.mark.parametrize("H,W,C,S", [(240, 320, 6, 256), (240, 320, 6, 128),
                                     (480, 640, 6, 256), (480, 640, 3, 256), (31, 17, 6, 32),
                                     (1, 1, 1, 1), (480, 640, 3, 255)])
def test_plan_fits_the_block(H, W, C, S):
    plan = crop_plan(H, W, C, S)
    assert plan.row_bytes % 16 == 0 and plan.row_bytes >= 15 + (W - 1) * C
    assert plan.smem_bytes == 2 * CROP_ROWS * plan.row_bytes + 4 * S * C <= CROP_MAX_SMEM
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= CROP_MAX_THREADS
    assert plan.threads >= min(S, CROP_MAX_THREADS)


@pytest.mark.parametrize("H,W,C,S", [(2, 2, 6, 10000), (100, 10000, 6, 64),
                                     (2 ** 16, 2 ** 12, 8, 8), (0, 4, 6, 8)])
def test_plan_refuses_what_the_kernel_cannot_take(H, W, C, S):
    with pytest.raises(ValueError):
        crop_plan(H, W, C, S)


@pytest.mark.parametrize("bad", ["boxes_host", "mean_host", "std_host", "boxes_f64",
                                 "mean_f64", "std_strided"])
def test_wrapper_refuses_host_or_converted_arguments_before_any_build(bad):
    """A non-CPU frames tensor takes the kernel path; boxes, mean and std
    that are not contiguous f32 tensors on its device raise TypeError, and
    nothing is converted. (The meta device stands in for the card: the
    checks run before the library is built.)"""
    dev = torch.device("meta")
    frames = torch.empty(2, 24, 32, 6, dtype=torch.uint8, device=dev)
    args = {"boxes": torch.zeros(2, 4, device=dev), "mean": torch.zeros(6, device=dev),
            "std": torch.ones(6, device=dev)}
    name, how = bad.split("_")
    t = args[name]
    args[name] = {"host": lambda: torch.zeros(t.shape),
                  "f64": lambda: t.double(),
                  "strided": lambda: torch.ones(12, device=dev)[::2]}[how]()
    with pytest.raises(TypeError, match=name):
        crop_resize_normalized(frames, args["boxes"], 4.0, 16, args["mean"], args["std"])


def test_wrapper_checks_shapes_before_any_build():
    dev = torch.device("meta")
    frames = torch.empty(2, 24, 32, 6, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="boxes"):
        crop_resize_normalized(frames, torch.zeros(3, 4, device=dev), 4.0, 16,
                               torch.zeros(6, device=dev), torch.ones(6, device=dev))
    with pytest.raises(ValueError, match="mean"):
        crop_resize_normalized(frames, torch.zeros(2, 4, device=dev), 4.0, 16,
                               torch.zeros(3, device=dev), torch.ones(6, device=dev))


def _rn32(x: Fraction) -> float:
    """x rounded to the nearest f32, ties to even (normal range)."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if x < Fraction(2) ** e:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)                 # in [2^23, 2^24)
    q, r = divmod(scaled.numerator, scaled.denominator)
    rem = Fraction(r, scaled.denominator)
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and q % 2):
        q += 1
    return sign * float(q * Fraction(2) ** (e - 23))


def _fma32(a, b, c):
    return _rn32(Fraction(a) * Fraction(b) + Fraction(c))


def _kernel_div(a, b):
    """csrc/crop.cu::div_rn(a, b, __frcp_rn(b)), operation by operation."""
    y = _rn32(1 / Fraction(b))
    q = _rn32(Fraction(a) * Fraction(y))
    r = _fma32(-b, q, a)
    q = _fma32(r, y, q)
    r = _fma32(-b, q, a)
    return _fma32(r, y, q)


def _f32(v):
    return float(np.float32(v))


@pytest.mark.parametrize("b", [255.0, _f32(0.229), _f32(0.224), _f32(0.225), _f32(0.1),
                               _f32(1.0999), _f32(0.7071), _f32(0.3333)])
def test_kernel_division_is_correctly_rounded(b):
    """The quotients the crop divides: v / 255 for v in [0, 255], and
    (v / 255 - mean) / std for values in [-12, 12] and ImageNet's and the
    tests' std; numerators at every binade's edges and at random."""
    rng = np.random.RandomState(int(b * 1000))
    top = 255.0 if b == 255.0 else 12.0
    bits = rng.randint(0, 2 ** 23, 600).astype(np.uint32)
    exps = rng.randint(127 - 60, 127 + (7 if top == 255.0 else 3), 600).astype(np.uint32)
    a = list((exps << 23 | bits).view(np.float32))            # random f32 numerators
    for e in range(-60, 8 if top == 255.0 else 4):              # each binade's ends
        for m in (0, 1, 2 ** 23 - 2, 2 ** 23 - 1, 0x555555, 0x2AAAAA):
            a.append(np.float32((1 + m / 2 ** 23) * 2.0 ** e))
    a += [np.float32(v) for v in rng.uniform(0, top, 400)] + [np.float32(0), np.float32(top)]
    if b != 255.0:
        a += [-v for v in a]
    for v in a:
        v = float(v)
        if abs(v) > top:
            continue
        want = _rn32(Fraction(v) / Fraction(b))
        assert _kernel_div(v, b) == want == float(np.float32(v) / np.float32(b)), v
