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
the crop and the depthwise correlation bit for bit; flash_mhsa_qkv within
two bf16 ulps of the row's largest |output|.

Under autograd (grad mode, an input that needs a gradient) each kernel
runs inside a torch.autograd.Function whose backward is the gradient of
the plain version recomputed from the saved inputs, so its gradients must
equal plain autograd's exactly, for the activations alone (the training
path's frozen weights) and for the weights too; a CUDA output made under
grad mode must have a grad_fn.
"""

import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.ops.crop import crop_resize_normalized, crop_resize_normalized_plain  # noqa: E402,E501
from mmtrack_torch.ops.flash_attn import (  # noqa: E402
    attn_block_fused,
    attn_block_fused_plain,
    flash_mhsa_qkv,
    flash_mhsa_qkv_plain,
)
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused, mlp_block_fused_plain  # noqa: E402
from mmtrack_torch.ops.xcorr import depthwise_xcorr, depthwise_xcorr_plain  # noqa: E402

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


@pytest.mark.parametrize("B,L", [(1, 1), (1, 17), (3, 37), (2, 100), (1, 464)])
def test_flash_mhsa_qkv_kernel_matches_plain(dev, B, L):
    g = torch.Generator().manual_seed(L)
    qkv = torch.randn(B, L, 3 * C, generator=g).to(dev, torch.bfloat16)
    before = flash_mhsa_qkv.launches
    got = flash_mhsa_qkv(qkv, 12, 64 ** -0.5)
    assert flash_mhsa_qkv.launches == before + 1
    want = flash_mhsa_qkv_plain(qkv, 12, 64 ** -0.5)
    gf, wf = got.float(), want.float()
    scale = torch.maximum(gf.abs(), wf.abs()).amax(-1, keepdim=True)
    bar = 2 * torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0 ** -126))) - 7)
    assert torch.isfinite(gf).all()
    assert ((gf - wf).abs() <= bar).all()


def _function_case(kind, L, dev):
    """(kernel, plain, tensors, kwargs) at B=2 and L tokens."""
    heads = dict(num_heads=12, scale=64 ** -0.5)
    if kind == "flash_mhsa_qkv":
        g = torch.Generator().manual_seed(L)
        qkv = torch.randn(2, L, 3 * C, generator=g).to(dev, torch.bfloat16)
        return flash_mhsa_qkv, flash_mhsa_qkv_plain, [qkv], heads
    if kind == "attn_block_fused":
        return (attn_block_fused, attn_block_fused_plain,
                [_x(2, L, dev, L), *_params(3 * C, C, dev, seed=L)], heads)
    return (mlp_block_fused, mlp_block_fused_plain,
            [_x(2, L, dev, L), *_params(4 * C, 4 * C, dev, seed=L)], {})


@pytest.mark.parametrize("L", [1, 17, 37, 100])
@pytest.mark.parametrize("kind,needs", [("flash_mhsa_qkv", "x"), ("attn_block_fused", "x"),
                                        ("attn_block_fused", "all"), ("mlp_block_fused", "x"),
                                        ("mlp_block_fused", "all")])
def test_function_gradients_equal_plain_autograd(dev, kind, needs, L):
    kernel, plain, tensors, kw = _function_case(kind, L, dev)
    wants = [i == 0 or needs == "all" for i in range(len(tensors))]
    a = [t.clone().requires_grad_(w) for t, w in zip(tensors, wants)]
    b = [t.clone().requires_grad_(w) for t, w in zip(tensors, wants)]
    before = kernel.launches
    out = kernel(*a, **kw)
    assert kernel.launches == before + 1
    assert out.grad_fn is not None
    ref = plain(*b, **kw)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev, out.dtype)
    got = torch.autograd.grad(out, [t for t in a if t.requires_grad], g_out)
    want = torch.autograd.grad(ref, [t for t in b if t.requires_grad], g_out)
    assert kernel.launches == before + 1        # the backward launches no kernel
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_kernels_record_nothing_without_grad(dev):
    x = _x(1, 9, dev, 0).requires_grad_(True)
    p = _params(4 * C, 4 * C, dev, seed=0)
    with torch.no_grad():
        assert mlp_block_fused(x, *p).grad_fn is None
    with torch.inference_mode():
        assert flash_mhsa_qkv(torch.zeros(1, 9, 3 * C, device=dev, dtype=torch.bfloat16),
                              12, 0.125).grad_fn is None


def test_flash_mhsa_qkv_argument_checks(dev):
    with pytest.raises(TypeError):
        flash_mhsa_qkv(torch.zeros(1, 8, 3 * C, device=dev), 12, 0.125)
    with pytest.raises(ValueError):
        flash_mhsa_qkv(torch.zeros(1, 465, 3 * C, device=dev, dtype=torch.bfloat16), 12, 0.125)


XCORR_CASES = {
    # name: (N, H, W, C, fh, fw, per-sample filter, pad)
    "pallas-test-shared": (3, 22, 22, 256, 6, 6, False, 0),
    "pallas-test-per-sample": (3, 22, 22, 256, 6, 6, True, 0),
    "alpha-refine-n1": (1, 32, 32, 64, 3, 3, True, 1),
    "alpha-refine-n16": (16, 32, 32, 64, 3, 3, True, 1),
    "alpha-refine-shared": (1, 32, 32, 64, 3, 3, False, 1),
    "odd-edges": (2, 7, 5, 3, 3, 4, True, 2),
}


@pytest.mark.parametrize("case", list(XCORR_CASES))
def test_depthwise_xcorr_kernel_bit_equal_to_plain(dev, case):
    N, H, W, C_, fh, fw, per_sample, pad = XCORR_CASES[case]
    g = torch.Generator().manual_seed(N * H + C_)
    x = torch.randn(N, H, W, C_, generator=g).to(dev)
    z = torch.randn(*((N,) if per_sample else ()), fh, fw, C_, generator=g).to(dev)
    before = depthwise_xcorr.launches
    got = depthwise_xcorr(z, x, pad=pad)
    assert depthwise_xcorr.launches == before + 1
    want = depthwise_xcorr_plain(z, x, pad=pad)
    assert got.shape == (N, H + 2 * pad - fh + 1, W + 2 * pad - fw + 1, C_)
    assert torch.equal(got, want)


def test_depthwise_xcorr_kernel_special_values_and_gradient(dev):
    """Padded taps multiply +0.0 like the padded tensor (inf * 0 = nan);
    under autograd the gradients equal plain autograd's."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 6, 8, generator=g).to(dev)
    z = torch.randn(2, 3, 3, 8, generator=g).to(dev)
    z[0, 0, 0, 0] = float("inf")
    z[1, 2, 2, 1] = -0.0
    got, want = depthwise_xcorr(z, x, pad=1), depthwise_xcorr_plain(z, x, pad=1)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    z = torch.randn(2, 3, 3, 8, generator=g).to(dev)
    _, a = _grad_pair(depthwise_xcorr, z, x)
    _, b = _grad_pair(depthwise_xcorr_plain, z, x)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _grad_pair(fn, z, x):
    z, x = z.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = fn(z, x, pad=1)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(out.device)
    return out, torch.autograd.grad(out, [z, x], g_out)
