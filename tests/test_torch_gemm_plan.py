"""The GEMM kernel's tile plan and the wrappers' argument checks, on the CPU.

`gemm_plan` picks the block tile of csrc/gemm.cu for each (M, N, K); the
kernel runs only on the card (tests/test_torch_cuda.py), so here the plan is
held to what the kernel needs (a compiled width that divides N, a grid that
covers M) and to its purpose (no emptier last wave than 128 x 128 where the
main path's N = 768 products quantize badly). The wrappers must raise on a
bad shape, dtype or alignment before the library is built or a kernel
launched, and the plain GEMM must be the half-block's own arithmetic.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import math

import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.ops import mlp_fuse  # noqa: E402
from mmtrack_torch.ops.mlp_fuse import (  # noqa: E402
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_BIAS_RESIDUAL,
    GEMM_BN,
    NUM_SMS,
    gemm_bf16,
    gemm_bf16_plain,
    gemm_plan,
    layer_norm_f32,
    layernorm_bf16,
    mlp_block_fused_plain,
)

PAIRS = {"qkv": (2304, 768), "proj": (768, 768), "fc1": (3072, 768), "fc2": (768, 3072)}
TRACKING_M = [16 * L for L in (320, 244, 190, 153)]    # 5120, 3904, 3040, 2448
TRAINING_M = [32 * 320]
EDGE_M = [1, 17, 111, 200, 464, 465, 1024]


@pytest.mark.parametrize("M", TRACKING_M + TRAINING_M + EDGE_M)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_plan_is_a_compiled_variant_that_covers_the_product(pair, M):
    N, K = PAIRS[pair]
    plan = gemm_plan(M, N, K)
    assert plan.bm == 128 and plan.bn in GEMM_BN and N % plan.bn == 0 and K % 8 == 0
    row_tiles = math.ceil(M / plan.bm)
    assert row_tiles * plan.bm >= M > (row_tiles - 1) * plan.bm
    assert plan.tiles == row_tiles * (N // plan.bn)
    assert plan.waves == pytest.approx(plan.tiles / NUM_SMS)
    assert 0 < plan.tail_fill <= 1


def _tail_fill(M, N, bn):
    tiles = math.ceil(M / 128) * (N // bn)
    return (tiles % NUM_SMS or NUM_SMS) / NUM_SMS


@pytest.mark.parametrize("M", [3040, 2448])
def test_plan_fills_the_last_wave_at_least_as_128x128(M):
    plan = gemm_plan(M, 768, 768)
    assert plan.tail_fill >= _tail_fill(M, 768, 128)
    assert plan.tail_fill == pytest.approx(_tail_fill(M, 768, plan.bn))


def test_plan_at_3040_takes_one_wave_of_192_wide_tiles():
    plan = gemm_plan(3040, 768, 3072)
    assert (plan.bn, plan.tiles) == (192, 96)


def test_plan_takes_the_narrowest_width_where_only_it_divides_n():
    assert gemm_plan(5120, 320, 768).bn == 64


@pytest.mark.parametrize("N,K", [(96, 768), (768, 100), (768, 4), (0, 768)])
def test_plan_rejects_what_the_kernel_cannot_tile(N, K):
    with pytest.raises(ValueError):
        gemm_plan(64, N, K)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if a wrapper reaches the library."""
    def refuse():
        raise AssertionError("the wrapper reached the kernel library")
    monkeypatch.setattr(mlp_fuse, "load_library", refuse)


def _operands(M=64, N=768, K=768):
    a = torch.zeros(M, K, dtype=torch.bfloat16)
    w = torch.zeros(N, K, dtype=torch.bfloat16)
    return a, w, torch.zeros(N), torch.zeros(M, N, dtype=torch.bfloat16)


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)          # 2 or 4 bytes past an aligned start


GEMM_BAD = {
    "w shape": (lambda a, w, b, r: (a, w[:, :-8], b, r), ValueError),
    "bias shape": (lambda a, w, b, r: (a, w, b[:-1], r), ValueError),
    "x dtype": (lambda a, w, b, r: (a.float(), w, b, r), TypeError),
    "w dtype": (lambda a, w, b, r: (a, w.half(), b, r), TypeError),
    "bias dtype": (lambda a, w, b, r: (a, w, b.bfloat16(), r), TypeError),
    "N not a multiple of 64": (lambda a, w, b, r: (a, w[:96], b[:96], r[:, :96]), ValueError),
    "K not a multiple of 8": (lambda a, w, b, r: (a[:, :100].contiguous(),
                                                  w[:, :100].contiguous(), b, r), ValueError),
    "residual shape": (lambda a, w, b, r: (a, w, b, r[:-1]), ValueError),
    "residual missing": (lambda a, w, b, r: (a, w, b, None), ValueError),
    "x misaligned": (lambda a, w, b, r: (_misaligned(a), w, b, r), ValueError),
    "w misaligned": (lambda a, w, b, r: (a, _misaligned(w), b, r), ValueError),
    "bias misaligned": (lambda a, w, b, r: (a, w, _misaligned(b), r), ValueError),
    "residual misaligned": (lambda a, w, b, r: (a, w, b, _misaligned(r)), ValueError),
    "x not contiguous": (lambda a, w, b, r: (torch.zeros(768, 64, dtype=a.dtype).t(), w, b, r),
                         ValueError),
    "a CPU tensor": (lambda a, w, b, r: (a, w, b, r), ValueError),
}


@pytest.mark.parametrize("case", list(GEMM_BAD))
def test_gemm_wrapper_checks_raise_before_any_build(no_build, case):
    make, err = GEMM_BAD[case]
    a, w, b, r = make(*_operands())
    with pytest.raises(err):
        gemm_bf16(a, w, b, EPI_BIAS_RESIDUAL, r)


def test_gemm_wrapper_rejects_an_unknown_epilogue(no_build):
    a, w, b, _ = _operands()
    with pytest.raises(ValueError):
        gemm_bf16(a, w, b, 3)


LAYERNORM_BAD = {
    "x dtype": (lambda x, g, b: (x.float(), g, b), TypeError),
    "scale dtype": (lambda x, g, b: (x, g.bfloat16(), b), TypeError),
    "scale shape": (lambda x, g, b: (x, g[:-8], b), ValueError),
    "C not a multiple of 8": (lambda x, g, b: (x[:, :12].contiguous(), g[:12], b[:12]),
                              ValueError),
    "C over 1024": (lambda x, g, b: (torch.zeros(4, 1032, dtype=x.dtype), torch.ones(1032),
                                     torch.zeros(1032)), ValueError),
    "x misaligned": (lambda x, g, b: (_misaligned(x), g, b), ValueError),
    "scale misaligned": (lambda x, g, b: (x, _misaligned(g), b), ValueError),
    "a CPU tensor": (lambda x, g, b: (x, g, b), ValueError),
}


@pytest.mark.parametrize("case", list(LAYERNORM_BAD))
def test_layernorm_wrapper_checks_raise_before_any_build(no_build, case):
    make, err = LAYERNORM_BAD[case]
    x, g, b = make(torch.zeros(4, 768, dtype=torch.bfloat16), torch.ones(768), torch.zeros(768))
    with pytest.raises(err):
        layernorm_bf16(x, g, b, 1e-6)


def test_plain_gemm_chain_is_the_plain_mlp_half_block():
    """LayerNorm, fc1 (GELU epilogue) and fc2 (residual epilogue) through
    the plain GEMM give the plain half-block bit for bit: the kernels'
    plain version rounds where the half-block's does."""
    g = torch.Generator().manual_seed(0)
    C, L = 64, 37
    x = torch.randn(2, L, C, generator=g).bfloat16()
    scale, bias = 1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g)
    w1 = (torch.randn(4 * C, C, generator=g) * C ** -0.5).bfloat16()
    b1 = 0.05 * torch.randn(4 * C, generator=g)
    w2 = (torch.randn(C, 4 * C, generator=g) * (4 * C) ** -0.5).bfloat16()
    b2 = 0.05 * torch.randn(C, generator=g)
    x2d = x.view(-1, C)
    h = layer_norm_f32(x2d, scale, bias, 1e-6).bfloat16()
    h = gemm_bf16_plain(h, w1, b1, EPI_BIAS_GELU)
    y = gemm_bf16_plain(h, w2, b2, EPI_BIAS_RESIDUAL, x2d)
    want = mlp_block_fused_plain(x, scale, bias, w1, b1, w2, b2)
    assert torch.equal(y.view(x.shape), want)
    assert torch.equal(gemm_bf16_plain(x2d, w2[:, :C].contiguous(), b2, EPI_BIAS),
                       (x2d.float() @ w2[:, :C].float().t() + b2).bfloat16())
