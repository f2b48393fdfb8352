"""The port's CUDA kernels against their plain PyTorch versions, on the card.

    python -m pytest tests/test_torch_cuda.py -q

Every test needs an NVIDIA GPU and skips without one (the decision is made
in a fixture, never at import). chip_smoke.py covers the main path's shapes;
these cover the edges: one token, token counts that are not multiples of
16 or 32, the largest count the attention kernel holds, row counts that
are not multiples of the GEMM tile, boxes far outside the frame, and the
argument checks. Bars: the half-blocks within two bf16 ulps of the largest
|x|, |y - x| or |y| in the element's token row (the two versions sum in
another f32 order, so y = x + h may differ by one ulp of h plus one of y);
the crop bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.ops.crop import crop_resize_normalized, crop_resize_normalized_plain  # noqa: E402,E501
from mmtrack_torch.ops.flash_attn import attn_block_fused, attn_block_fused_plain  # noqa: E402
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused, mlp_block_fused_plain  # noqa: E402

pytestmark = pytest.mark.cuda
C = 768


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(n1, k2, dev, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    return (1 + r(C, scale=0.1), r(C, scale=0.1), r(n1, C, scale=C ** -0.5).bfloat16(),
            r(n1, scale=0.05), r(C, k2, scale=k2 ** -0.5).bfloat16(), r(C, scale=0.05))


def _x(B, L, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, L, C, generator=g).to(dev, torch.bfloat16)


def _assert_row_ulps(got, want, x, ulps=2):
    g, w = got.float(), want.float()
    xf = x.float()
    scale = torch.stack([xf.abs(), g.abs(), w.abs(), (w - xf).abs()]).amax(0).amax(-1, True)
    bar = ulps * torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0 ** -126))) - 7)
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= bar).all(), ((g - w).abs() - bar).max().item()


@pytest.mark.parametrize("B,L", [(1, 1), (1, 17), (3, 37), (2, 100), (1, 464)])
def test_attn_block_kernel_matches_plain(dev, B, L):
    p = _params(3 * C, C, dev, seed=L)
    x = _x(B, L, dev, seed=B)
    kw = dict(num_heads=12, scale=64 ** -0.5)
    before = attn_block_fused.launches
    got = attn_block_fused(x, *p, **kw)
    assert attn_block_fused.launches == before + 1
    _assert_row_ulps(got, attn_block_fused_plain(x, *p, **kw), x)


@pytest.mark.parametrize("B,L", [(1, 1), (3, 37), (2, 100)])
def test_mlp_block_kernel_matches_plain(dev, B, L):
    p = _params(4 * C, 4 * C, dev, seed=L)
    x = _x(B, L, dev, seed=B)
    before = mlp_block_fused.launches
    got = mlp_block_fused(x, *p)
    assert mlp_block_fused.launches == before + 1
    _assert_row_ulps(got, mlp_block_fused_plain(x, *p), x)


@pytest.mark.parametrize("H,W,S,factor", [(96, 128, 64, 4.0), (480, 640, 256, 4.0),
                                          (31, 17, 32, 2.0)])
def test_crop_kernel_bit_equal_to_plain(dev, H, W, S, factor):
    g = torch.Generator().manual_seed(H)
    B = 8
    frames = torch.randint(0, 256, (B, H, W, 6), generator=g, dtype=torch.uint8).to(dev)
    boxes = torch.rand(B, 4, generator=g) * torch.tensor([W, H, W / 2, H / 2])
    boxes[0] = torch.tensor([-3.0 * W, -2.0 * H, 10.0, 8.0])      # entirely outside
    boxes[1] = torch.tensor([W - 0.5, H - 0.5, 1.0, 1.0])         # on the last pixel
    boxes[2] = torch.tensor([0.25, 0.75, 0.01, 0.02])             # degenerate
    boxes = boxes.to(dev)
    mean = torch.rand(6, generator=g).to(dev)
    std = (0.1 + torch.rand(6, generator=g)).to(dev)
    before = crop_resize_normalized.launches
    got, rf = crop_resize_normalized(frames, boxes, factor, S, mean, std)
    assert crop_resize_normalized.launches == before + 1
    want, rf_w = crop_resize_normalized_plain(frames, boxes, factor, S, mean, std)
    assert torch.equal(rf, rf_w)
    assert torch.equal(got, want)


def test_kernel_argument_checks(dev):
    p = _params(3 * C, C, dev, seed=0)
    kw = dict(num_heads=12, scale=64 ** -0.5)
    with pytest.raises(TypeError):
        attn_block_fused(_x(1, 8, dev, 0).float(), *p, **kw)
    with pytest.raises(ValueError):
        attn_block_fused(_x(1, 465, dev, 0), *p, **kw)          # beyond shared memory
    with pytest.raises(ValueError):
        attn_block_fused(_x(1, 8, dev, 0), *p, num_heads=6, scale=1.0)   # head dim 128
    with pytest.raises(TypeError):
        crop_resize_normalized(torch.zeros(1, 8, 8, 6, device=dev), torch.zeros(1, 4),
                               2.0, 16, torch.zeros(6), torch.ones(6))
