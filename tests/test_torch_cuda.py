"""The port's CUDA kernels against their plain PyTorch versions, on the card.

    python -m pytest tests/test_torch_cuda.py -q

Every test needs an NVIDIA GPU and skips without one (the decision is made
in a fixture, never at import). chip_smoke.py covers the main path's shapes;
these cover the edges: one token, token counts that are not multiples of
16 or 64, counts of several hundred and a thousand tokens, logits spread
over more than 80 in a row (max subtraction, no overflow), row counts that
are not multiples of the GEMM tile, boxes far outside the frame, output
widths and channel counts that the correlation's tiles do not divide, and
the argument checks; the attention kernels and the MLP half-block also at
the main paths' shapes (B = 16 and 32, L = 320 / 244 / 190 / 153). The GEMM
alone at each epilogue for the half-blocks' four products at M = 1, 37,
2448 and 5120, plus an N only its 64-wide tile divides with a K that its
64-deep k-tiles do not (zero-filled by TMA), and each tile width at the M
whose plan takes it; the LayerNorm kernel at widths 8 to 1024 (and
refusing others); a misaligned GEMM operand raises. Bars: the half-blocks
(and the GEMM and LayerNorm kernels alone) within
two bf16 ulps of the largest |x|, |y - x| or |y| in the element's token
row (the two versions sum in another f32 order, so y = x + h may differ by
one ulp of h plus one of y);
the crop and the depthwise correlation bit for bit; flash_mhsa_qkv within
two bf16 ulps of the row's largest |output|. ViPT's prompt step
(ops/prompt.py) against its plain composition at B = 1 and 32, for every
token count of the main path with random live rows, block 0's form and
inside a CUDA graph replayed twice, each output within two bf16 ulps of
its row's largest value; with the tracking cell's weights (sharp Fovea
logits), tokens within PROMPT_SHARP_TOKEN_ULPS and the state within two
ulps but on a few rows; under autograd the kernels' forward with the
plain gradient, bit for bit; f32 refused; and a model's prompt steps
launching the kernels only where its blocks run theirs.

The streamed OPE step (parallel/batched_eval.py) on the card: track_split
(rgb + JET-index planes from pinned memory, composed on the card) gives
the host-composed frames' boxes and scores bit for bit through the
one-frame graph, and both give the eager step loop's; one scan shared by
two interleaved trackers captures once per frame shape and keeps each
tracker's state; the device compose on CUDA tensors gives the CPU's bytes.

Under autograd (grad mode, an input that needs a gradient) each kernel
runs inside a torch.autograd.Function whose backward is the gradient of
the plain version recomputed from the saved inputs, so its gradients must
equal plain autograd's exactly, for the activations alone (the training
path's frozen weights) and for the weights too; a CUDA output made under
grad mode must have a grad_fn.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.ops.crop import crop_resize_normalized, crop_resize_normalized_plain  # noqa: E402,E501
from mmtrack_torch.ops.flash_attn import (  # noqa: E402
    attn_block_fused,
    attn_block_fused_plain,
    flash_mhsa_qkv,
    flash_mhsa_qkv_plain,
)
from mmtrack_torch.ops.mlp_fuse import (  # noqa: E402
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_BIAS_RESIDUAL,
    gemm_bf16,
    gemm_bf16_plain,
    gemm_plan,
    layer_norm_f32,
    layernorm_bf16,
    linear_f32,
    mlp_block_fused,
    mlp_block_fused_plain,
)
from mmtrack_torch.ops.xcorr import depthwise_xcorr, depthwise_xcorr_plain  # noqa: E402
from mmtrack_torch.utils import profiling  # noqa: E402

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


def _max_logit_spread(qkv):
    """The largest max - min of q k^T * scale over the rows of head 0."""
    q = qkv[..., :64].float() * 64 ** -0.5
    logits = q @ qkv[..., C:C + 64].float().transpose(-1, -2)
    return (logits.amax(-1) - logits.amin(-1)).max().item()


def _assert_row_ulps(got, want, x, ulps=2):
    g, w = got.float(), want.float()
    xf = x.float()
    scale = torch.stack([xf.abs(), g.abs(), w.abs(), (w - xf).abs()]).amax(0).amax(-1, True)
    bar = ulps * torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0 ** -126))) - 7)
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= bar).all(), ((g - w).abs() - bar).max().item()


MAIN_PATH = [(B, L) for B in (16, 32) for L in (320, 244, 190, 153)]
EDGES = [(1, 1), (1, 17), (3, 37), (2, 100), (1, 464), (1, 465), (1, 1024)]


@pytest.mark.parametrize("B,L,spread", [(B, L, False) for B, L in EDGES + MAIN_PATH]
                         + [(2, 320, True)])
def test_attn_block_kernel_matches_plain(dev, B, L, spread):
    p = _params(3 * C, C, dev, seed=L)
    x = _x(B, L, dev, seed=B)
    if spread:       # q rows of wqkv x 32: a row's logits spread over more than 80
        p[2][:C] *= 32
        h = layer_norm_f32(x, p[0], p[1], 1e-6).to(torch.bfloat16)
        assert _max_logit_spread(linear_f32(h, p[2], p[3]).to(torch.bfloat16)) > 80
    kw = dict(num_heads=12, scale=64 ** -0.5)
    before = profiling.counters()
    got = attn_block_fused(x, *p, **kw)
    assert profiling.launches([attn_block_fused], before) == {"attn_block_fused": 1}
    _assert_row_ulps(got, attn_block_fused_plain(x, *p, **kw), x)


@pytest.mark.parametrize("B,L", [(1, 1), (3, 37), (2, 100)] + MAIN_PATH)
def test_mlp_block_kernel_matches_plain(dev, B, L):
    p = _params(4 * C, 4 * C, dev, seed=L)
    x = _x(B, L, dev, seed=B)
    before = profiling.counters()
    got = mlp_block_fused(x, *p)
    assert profiling.launches([mlp_block_fused], before) == {"mlp_block_fused": 1}
    _assert_row_ulps(got, mlp_block_fused_plain(x, *p), x)


GEMM_PAIRS = {"qkv": (2304, 768), "proj": (768, 768), "fc1": (3072, 768), "fc2": (768, 3072),
              # N that only the 64-wide tile divides; K past the last 64 zero-filled by TMA
              "narrow": (320, 200)}


def _gemm_case(N, K, M, epilogue, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).bfloat16()
    w = (torch.randn(N, K, generator=g) * K ** -0.5).bfloat16()
    b = torch.randn(N, generator=g) * 0.05
    res = torch.randn(M, N, generator=g).bfloat16() if epilogue == EPI_BIAS_RESIDUAL else None
    return a, w, b, res


@pytest.mark.parametrize("M", [1, 37, 2448, 5120])
@pytest.mark.parametrize("pair", list(GEMM_PAIRS))
@pytest.mark.parametrize("epilogue", [EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL])
def test_gemm_kernel_matches_plain(dev, epilogue, pair, M):
    """Every tile width the plan picks at these shapes (64 at M <= 37 and
    for "narrow", 128 / 192 / 256 at the main path's M), a ragged last
    row tile, each epilogue."""
    N, K = GEMM_PAIRS[pair]
    a, w, b, res = (None if t is None else t.to(dev) for t in _gemm_case(N, K, M, epilogue, M))
    got = gemm_bf16(a, w, b, epilogue, res)
    want = gemm_bf16_plain(a, w, b, epilogue, res)
    _assert_row_ulps(got, want, torch.zeros_like(want) if res is None else res)
    if pair == "narrow":
        assert gemm_plan(M, N, K).bn == 64


@pytest.mark.parametrize("bn_M", [(64, 37), (128, 2448), (192, 3040), (256, 5120)])
def test_gemm_kernel_every_tile_width_at_main_path_rows(dev, bn_M):
    """proj's shape at the M whose plan takes each width, the residual
    epilogue (reads and writes through the 16-byte epilogue path)."""
    bn, M = bn_M
    assert gemm_plan(M, 768, 768).bn == bn
    a, w, b, res = (t.to(dev) for t in _gemm_case(768, 768, M, EPI_BIAS_RESIDUAL, bn))
    _assert_row_ulps(gemm_bf16(a, w, b, EPI_BIAS_RESIDUAL, res),
                     gemm_bf16_plain(a, w, b, EPI_BIAS_RESIDUAL, res), res)


@pytest.mark.parametrize("operand", ["x", "w", "residual"])
def test_gemm_kernel_rejects_misaligned_operand(dev, operand):
    a, w, b, res = (t.to(dev) for t in _gemm_case(768, 768, 64, EPI_BIAS_RESIDUAL, 0))
    ops = dict(x=a, w=w, residual=res)
    t = ops[operand]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    ops[operand] = flat[1:].view(t.shape).copy_(t)        # 2 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm_bf16(ops["x"], ops["w"], b, EPI_BIAS_RESIDUAL, ops["residual"])


@pytest.mark.parametrize("M,C", [(1, 768), (5120, 768), (37, 8), (17, 264), (9, 1024),
                                 (3, 776)])
def test_layernorm_kernel_matches_plain(dev, M, C):
    g = torch.Generator().manual_seed(C)
    x = (torch.randn(M, C, generator=g) * 3 + 1).to(dev, torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    bias = (0.1 * torch.randn(C, generator=g)).to(dev)
    got = layernorm_bf16(x, scale, bias, 1e-6)
    want = layer_norm_f32(x, scale, bias, 1e-6).to(torch.bfloat16)
    _assert_row_ulps(got, want, torch.zeros_like(want))


@pytest.mark.parametrize("C", [12, 1032])
def test_layernorm_kernel_rejects_width(dev, C):
    x = torch.zeros(4, C, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        layernorm_bf16(x, torch.ones(C, device=dev), torch.zeros(C, device=dev), 1e-6)


@pytest.mark.parametrize("H,W,S,factor,C,B", [
    (96, 128, 64, 4.0, 6, 8), (480, 640, 256, 4.0, 6, 8), (31, 17, 32, 2.0, 6, 8),
    (480, 640, 256, 2.0, 3, 8),             # Alpha-Refine's 3-channel crop
    (240, 320, 255, 4.0, 6, 8),             # odd S: rows that are not 16-byte aligned
    (481, 641, 127, 4.0, 3, 5),             # odd everything
    (240, 320, 256, 4.0, 6, 1),             # one sequence: the crop wider than 2S and W
    (240, 320, 256, 4.0, 6, 16)])           # the main path's search crop
def test_crop_kernel_bit_equal_to_plain(dev, H, W, S, factor, C, B):
    g = torch.Generator().manual_seed(H + S + C + B)
    frames = torch.randint(0, 256, (B, H, W, C), generator=g, dtype=torch.uint8).to(dev)
    boxes = torch.rand(B, 4, generator=g) * torch.tensor([W, H, W / 2, H / 2])
    huge = torch.tensor([-0.5 * W, -0.3 * H, 2.0 * W, 1.6 * H])   # side > 2S and > W
    if B == 1:
        boxes[0] = huge
    else:
        boxes[0] = torch.tensor([-3.0 * W, -2.0 * H, 10.0, 8.0])      # entirely outside
        boxes[1] = torch.tensor([W - 0.5, H - 0.5, 1.0, 1.0])         # on the last pixel
        boxes[2] = torch.tensor([0.25, 0.75, 0.01, 0.02])             # degenerate
        boxes[3] = huge
    boxes = boxes.to(dev)
    mean = torch.rand(C, generator=g).to(dev)
    std = (0.1 + torch.rand(C, generator=g)).to(dev)
    before = profiling.counters()
    got, rf = crop_resize_normalized(frames, boxes, factor, S, mean, std)
    assert profiling.launches([crop_resize_normalized], before) == {"crop_resize_normalized": 1}
    want, rf_w = crop_resize_normalized_plain(frames, boxes, factor, S, mean, std)
    assert torch.equal(rf, rf_w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("host", ["boxes", "mean", "std"])
def test_crop_kernel_refuses_host_arguments(dev, host):
    """The wrapper copies nothing: boxes, mean or std on the host raise."""
    args = {"boxes": torch.zeros(2, 4, device=dev), "mean": torch.zeros(6, device=dev),
            "std": torch.ones(6, device=dev)}
    args[host] = args[host].cpu()
    before = profiling.counters()
    with pytest.raises(TypeError, match=host):
        crop_resize_normalized(torch.zeros(2, 24, 32, 6, dtype=torch.uint8, device=dev),
                               args["boxes"], 4.0, 16, args["mean"], args["std"])
    assert profiling.launches([crop_resize_normalized], before) == {"crop_resize_normalized": 0}


def test_graphed_scan_bit_equal_to_eager_scan(dev):
    """make_track_scan on a depth-4, full-width deep_rgbd in bf16 (CE in
    block 3), T=4, B=2: the replayed graph gives the eager loop's boxes and
    scores bit for bit, twice in a row from the returned state; the
    wrappers count at capture (the warm-up steps and the T captured steps),
    not at replay."""
    import numpy as np

    from mmtrack_torch.config import merge_overrides, vipt_experiment_config
    from mmtrack_torch.models.vipt import build_viptrack
    from mmtrack_torch.trackers.vipt_tracker import (
        SCAN_WARMUP_STEPS,
        ViPTRuntime,
        make_track_scan,
        vipt_init_state,
        vipt_track_scan_batched,
    )

    cfg = merge_overrides(vipt_experiment_config("deep_rgbd"),
                          {"MODEL": {"BACKBONE": {"DEPTH": 4, "CE_LOC": [3],
                                                  "CE_KEEP_RATIO": [0.7]}}})
    rt = ViPTRuntime.from_config(cfg)
    model = build_viptrack(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    rng = np.random.RandomState(0)
    T, B, H, W = 4, 2, 96, 128
    frames = torch.from_numpy(rng.randint(0, 256, (2 * T + 1, B, H, W, 6)).astype(np.uint8))
    box0 = torch.tensor([[40.0, 30.0, 30.0, 24.0], [60.0, 40.0, 20.0, 28.0]])
    chunks = frames[1:].to(dev).view(2, T, B, H, W, 6)
    with torch.inference_mode():
        state = vipt_init_state(rt, frames[0].to(dev), box0)
        eager = [vipt_track_scan_batched(rt, model, state, chunks[0])]
        eager.append(vipt_track_scan_batched(rt, model, eager[0][0], chunks[1]))
        scan = make_track_scan(rt, model, dev)
        counters = (attn_block_fused, mlp_block_fused, crop_resize_normalized)
        before = profiling.counters()
        s, boxes, scores = scan(state, chunks[0])
        got = [(boxes.clone(), scores.clone())]
        captured = list(profiling.launches(counters, before).values())
        s, boxes, scores = scan(s, chunks[1])
        got.append((boxes.clone(), scores.clone()))
        replayed = list(profiling.launches(counters, before).values())
    torch.cuda.synchronize()
    steps = SCAN_WARMUP_STEPS + T
    assert captured == replayed == [3 * steps, 4 * steps, steps]
    for (_, eb, es), (gb, gs) in zip(eager, got):
        assert torch.equal(gb, eb) and torch.equal(gs, es)
    assert torch.equal(s["box"], eager[1][0]["box"])
    with pytest.raises(ValueError, match="captured for"):
        scan({"box": s["box"][:1], "template": s["template"]}, chunks[1])


def test_kernel_argument_checks(dev):
    p = _params(3 * C, C, dev, seed=0)
    kw = dict(num_heads=12, scale=64 ** -0.5)
    with pytest.raises(TypeError):
        attn_block_fused(_x(1, 8, dev, 0).float(), *p, **kw)
    with pytest.raises(ValueError):
        attn_block_fused(_x(1, 8, dev, 0), *p, num_heads=6, scale=1.0)   # head dim 128
    with pytest.raises(TypeError):
        crop_resize_normalized(torch.zeros(1, 8, 8, 6, device=dev), torch.zeros(1, 4),
                               2.0, 16, torch.zeros(6), torch.ones(6))


@pytest.mark.parametrize("B,L,spread", [(B, L, False) for B, L in EDGES + MAIN_PATH]
                         + [(2, 320, True)])
def test_flash_mhsa_qkv_kernel_matches_plain(dev, B, L, spread):
    g = torch.Generator().manual_seed(L)
    qkv = torch.randn(B, L, 3 * C, generator=g).to(dev, torch.bfloat16)
    if spread:       # q x 32: a row's logits spread over more than 80
        qkv[..., :C] *= 32
        assert _max_logit_spread(qkv) > 80
    before = profiling.counters()
    got = flash_mhsa_qkv(qkv, 12, 64 ** -0.5)
    assert profiling.launches([flash_mhsa_qkv], before) == {"flash_mhsa_qkv": 1}
    want = flash_mhsa_qkv_plain(qkv, 12, 64 ** -0.5)
    gf, wf = got.float(), want.float()
    scale = torch.maximum(gf.abs(), wf.abs()).amax(-1, keepdim=True)
    bar = 2 * torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0 ** -126))) - 7)
    assert torch.isfinite(gf).all()
    assert ((gf - wf).abs() <= bar).all()
    # the normalised rounding point: rounding p before the division would
    # change 12-50% of the outputs (tests/test_torch_attention_order.py)
    assert (gf != wf).float().mean() < 0.01


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
    before = profiling.counters()
    out = kernel(*a, **kw)
    assert list(profiling.launches([kernel], before).values()) == [1]
    assert out.grad_fn is not None
    ref = plain(*b, **kw)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev, out.dtype)
    got = torch.autograd.grad(out, [t for t in a if t.requires_grad], g_out)
    want = torch.autograd.grad(ref, [t for t in b if t.requires_grad], g_out)
    assert list(profiling.launches([kernel], before).values()) == [1]  # none in the backward
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
    with pytest.raises(ValueError):     # head dim 128
        flash_mhsa_qkv(torch.zeros(1, 8, 3 * C, device=dev, dtype=torch.bfloat16), 6, 0.125)
    with pytest.raises(ValueError):     # not 16-byte aligned
        flat = torch.zeros(8 * 3 * C + 1, device=dev, dtype=torch.bfloat16)
        flash_mhsa_qkv(flat[1:].view(1, 8, 3 * C), 12, 0.125)


XCORR_CASES = {
    # name: (N, H, W, C, fh, fw, per-sample filter, pad)
    "pallas-test-shared": (3, 22, 22, 256, 6, 6, False, 0),
    "pallas-test-per-sample": (3, 22, 22, 256, 6, 6, True, 0),
    "alpha-refine-n1": (1, 32, 32, 64, 3, 3, True, 1),
    "alpha-refine-n16": (16, 32, 32, 64, 3, 3, True, 1),
    "alpha-refine-shared": (1, 32, 32, 64, 3, 3, False, 1),
    "odd-edges": (2, 7, 5, 3, 3, 4, True, 2),
    # ow and C that the kernel's runs (2 or 8 columns) and 32-channel chunks do not divide
    "ragged-tiles": (2, 19, 23, 70, 3, 3, True, 1),
    # rows wider than one segment of the kernel's (8 runs)
    "wide-segments": (1, 12, 150, 33, 5, 7, False, 2),
    # a filter whose staged band needs more than 48 KB of shared memory
    "large-filter": (1, 24, 24, 8, 20, 20, False, 0),
}


@pytest.mark.parametrize("case", list(XCORR_CASES))
def test_depthwise_xcorr_kernel_bit_equal_to_plain(dev, case):
    N, H, W, C_, fh, fw, per_sample, pad = XCORR_CASES[case]
    g = torch.Generator().manual_seed(N * H + C_)
    x = torch.randn(N, H, W, C_, generator=g).to(dev)
    z = torch.randn(*((N,) if per_sample else ()), fh, fw, C_, generator=g).to(dev)
    before = profiling.counters()
    got = depthwise_xcorr(z, x, pad=pad)
    assert profiling.launches([depthwise_xcorr], before) == {"depthwise_xcorr": 1}
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


def _depth4_model(dev):
    """deep_rgbd at full width, depth 4 (CE in block 3), bf16, seed 0."""
    from mmtrack_torch.config import merge_overrides, vipt_experiment_config
    from mmtrack_torch.models.vipt import build_viptrack
    from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime

    cfg = merge_overrides(vipt_experiment_config("deep_rgbd"),
                          {"MODEL": {"BACKBONE": {"DEPTH": 4, "CE_LOC": [3],
                                                  "CE_KEEP_RATIO": [0.7]}}})
    return ViPTRuntime.from_config(cfg), build_viptrack(cfg, dtype=torch.bfloat16, device=dev,
                                                        seed=0)


def _streamed_planes(T, B, H, W, seed):
    """T frames of B sequences as host-composed rgbcolormap frames and as
    the rgb + JET-index planes of the streamed wire."""
    import numpy as np

    from mmtrack_torch.data.composition import compose_x, depth_index_u8

    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    depth = (rng.randint(500, 4000, (B, H, W))[None] + 11 * np.arange(T)[:, None, None, None])
    depth = depth.astype(np.uint16)
    frames = np.stack([[compose_x(rgb[t, b], depth[t, b], "rgbcolormap", x_clip=True)
                        for b in range(B)] for t in range(T)])
    idx = np.stack([[depth_index_u8(depth[t, b]) for b in range(B)] for t in range(T)])
    return frames, rgb, idx


def test_track_split_bit_equal_to_track_through_the_graph(dev):
    """BatchedViPTTracker on the card: track_split (upload of rgb + index,
    compose on the card, one-frame graph) gives track(get_x_frame-style
    frames)'s boxes and scores bit for bit, and both give the eager step
    loop's."""
    from functools import partial

    from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
    from mmtrack_torch.trackers.vipt_tracker import vipt_track_scan_batched

    rt, model = _depth4_model(dev)
    frames, rgb, idx = _streamed_planes(5, 2, 96, 128, seed=1)
    box0 = [[40.0, 30.0, 30.0, 24.0], [60.0, 40.0, 20.0, 28.0]]
    composed = BatchedViPTTracker(model, dev, rt)
    split = BatchedViPTTracker(model, dev, rt, scan=composed.scan)
    eager = BatchedViPTTracker(model, dev, rt, scan=partial(vipt_track_scan_batched, rt, model))
    rgb_buf, idx_buf = split.host_buffer(rgb.shape[1:]), split.host_buffer(idx.shape[1:])
    assert rgb_buf.dtype == idx_buf.dtype and torch.from_numpy(rgb_buf).is_pinned()
    for tr in (composed, split, eager):
        tr.initialize(frames[0], box0)
    for t in range(1, 5):
        rgb_buf[...], idx_buf[...] = rgb[t], idx[t]
        a, b, c = composed.track(frames[t]), split.track_split(rgb_buf, idx_buf), \
            eager.track(frames[t])
        for u, v in zip(a, b):
            assert (u == v).all(), t
        for u, v in zip(a, c):
            assert (u == v).all(), t


def test_shared_scan_captures_once_per_shape(dev):
    """Two trackers sharing one scan: the first step of a shape warms up
    and captures (the wrappers count then), every later step of that shape,
    by either tracker, replays and counts nothing; a new B captures again.
    Interleaved trackers keep their own state."""
    from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
    from mmtrack_torch.trackers.vipt_tracker import SCAN_WARMUP_STEPS, make_track_scan

    rt, model = _depth4_model(dev)
    frames, _, _ = _streamed_planes(4, 2, 96, 128, seed=2)
    box0 = [[40.0, 30.0, 30.0, 24.0], [60.0, 40.0, 20.0, 28.0]]
    scan = make_track_scan(rt, model, dev)
    a, b = (BatchedViPTTracker(model, dev, rt, scan=scan) for _ in range(2))
    alone = BatchedViPTTracker(model, dev, rt)
    counters = (attn_block_fused, mlp_block_fused, crop_resize_normalized)

    def counts():
        return list(profiling.launches(counters).values())

    for tr in (a, b, alone):
        tr.initialize(frames[0], box0)
    b.initialize(frames[0][::-1].copy(), box0[::-1])
    before = counts()
    a_out = [a.track(frames[1])]
    captured = [n - m for n, m in zip(counts(), before)]
    assert captured == [3 * (SCAN_WARMUP_STEPS + 1), 4 * (SCAN_WARMUP_STEPS + 1),
                        SCAN_WARMUP_STEPS + 1]
    before = counts()
    b_out = []
    for t in (1, 2, 3):
        b_out.append(b.track(frames[t][::-1].copy()))
        if t < 3:
            a_out.append(a.track(frames[t + 1]))
    assert counts() == before
    alone_out = [alone.track(frames[t]) for t in (1, 2, 3)]
    for (ab, asc), (lb, lsc) in zip(a_out, alone_out):
        assert (ab == lb).all() and (asc == lsc).all()
    for (bb, bsc), (lb, lsc) in zip(b_out, alone_out):
        assert (bb[::-1] == lb).all() and (bsc[::-1] == lsc).all()
    one = BatchedViPTTracker(model, dev, rt, scan=scan)
    one.initialize(frames[0][:1], box0[:1])
    before = counts()
    one.track(frames[1][:1])
    assert [n - m for n, m in zip(counts(), before)] == captured


def test_device_compose_on_the_card_bit_equal_to_the_cpu(dev):
    """ops/compose.py on CUDA tensors (plain PyTorch, one rounding per
    operation) gives the CPU's bytes."""
    import numpy as np

    from mmtrack_torch.ops.compose import (
        compose_rgb_index_device,
        compose_yuv_index_device,
        jet_lut,
    )

    rng = np.random.RandomState(4)
    c = np.arange(256, dtype=np.uint8)
    cb, cr = (a.reshape(128, 512) for a in np.meshgrid(c, c, indexing="ij"))
    planes = [torch.from_numpy(a) for a in (
        rng.randint(0, 256, (256, 1024)).astype(np.uint8), cb, cr,
        rng.randint(0, 256, (256, 1024)).astype(np.uint8), jet_lut(),
        rng.randint(0, 256, (256, 1024, 3)).astype(np.uint8))]
    y, cb, cr, idx, lut, rgb = planes
    for fn, args in ((compose_yuv_index_device, (y, cb, cr, idx, lut)),
                     (compose_rgb_index_device, (rgb, idx, lut))):
        want = fn(*args)
        got = fn(*(a.to(dev) for a in args))
        assert got.is_cuda and torch.equal(got.cpu(), want)


LAYERS = ["vipt.crop", "vipt.embed", "vipt.block", "vipt.prompt", "vipt.ce_block", "vipt.head",
          "vipt.decode"]


def _chunk_inputs(dev, T=4, B=2, H=96, W=128):
    import numpy as np

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 256, (T + 1, B, H, W, 6)).astype(np.uint8)).to(dev)
    box0 = torch.tensor([[40.0, 30.0, 30.0, 24.0], [60.0, 40.0, 20.0, 28.0]])
    return frames[0], box0, frames[1:]


def test_traced_chunk_graph_stamps_every_step(dev):
    """Under profiling.tracing() a chunk shape is captured a second time,
    with the steps' device spans stamped in the graph: every replay gives
    each step its seven layers in order under its `vipt.step`, one chunk
    id a replay, and the layers cover the stamped step within 2 %."""
    from mmtrack_torch.trackers.vipt_tracker import make_track_scan, vipt_init_state

    rt, model = _depth4_model(dev)
    first, box0, chunk = _chunk_inputs(dev)
    T = chunk.shape[0]
    with torch.inference_mode():
        state = vipt_init_state(rt, first, box0)
        scan = make_track_scan(rt, model, dev)
        scan(state, chunk)
        with profiling.tracing() as tr:
            for _ in range(3):
                scan(state, chunk)
            snap = tr.snapshot()
    assert [c["traced"] for c in profiling.captures()[-2:]] == [False, True]
    spans = snap["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "vipt.step"]
    assert len(steps) == 3 * T
    assert sorted({spans[i]["chunk"] for i in steps}) == [0, 1, 2]
    for i in steps:
        kids = [s for s in spans if s["parent"] == i]
        names = list(dict.fromkeys(s["name"] for s in kids))
        assert names == LAYERS
        assert all(s["chunk"] == spans[i]["chunk"] for s in kids)
        step = spans[i]["dend"] - spans[i]["dstart"]
        covered = sum(s["dend"] - s["dstart"] for s in kids)
        assert step > 0 and 0.98 * step <= covered <= step
    assert len([s for s in spans if s["name"] == "track.replay"]) == 3
    loads = [s for s in spans if s["name"] == "track.load"]
    assert loads and all(s["dend"] >= s["dstart"] for s in loads)


def test_graph_nodes_of_the_untraced_graph(dev):
    """The untraced chunk graph has the same nodes whether or not a traced
    graph of the shape was captured before it in the process; the kernels
    the profiler sees in a replay are its nodes to within the copies (a
    copy or fill node shows as a kernel, `memcpy32_post` or `memset32`, or
    as a copy)."""
    from torch.profiler import ProfilerActivity, profile

    from mmtrack_torch.trackers.vipt_tracker import make_track_scan, vipt_init_state

    rt, model = _depth4_model(dev)
    first, box0, chunk = _chunk_inputs(dev)
    with torch.inference_mode():
        state = vipt_init_state(rt, first, box0)
        plain = make_track_scan(rt, model, dev)
        plain(state, chunk)
        alone = profiling.captures()[-1]
        with profiling.tracing():
            make_track_scan(rt, model, dev)(state, chunk)
        again = make_track_scan(rt, model, dev)
        again(state, chunk)
        after = profiling.captures()[-1]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                again(state, chunk)
            torch.cuda.synchronize()
    assert not alone["traced"] and not after["traced"]
    assert after["nodes"] == alone["nodes"] and after["kernels"] == alone["kernels"]
    assert alone["kernels"] <= alone["nodes"]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset"))
               and not getattr(e, "is_user_annotation", lambda: False)()]
    assert 3 * alone["kernels"] <= len(kernels) <= 3 * alone["nodes"]


# ViPT's prompt step (ops/prompt.py over csrc/prompt.cu) against the plain
# composition. Inputs: tokens of a ViT-B block (C = 768, 64 template rows,
# a 256-row grid), product weights at a scale that keeps the Fovea's
# logits (x0 times the temperature 10) spread by ~3 per part, so that a
# one-ulp flip of x0 in the two versions' f32 orders moves the output by
# well under the bar; the plain products without reduced-precision
# reductions, as the kernel accumulates in f32.
PROMPT_LZ, PROMPT_LX = 64, 256


def _prompt_modules(dev, seed, dtype=torch.bfloat16):
    from mmtrack_torch.models.layers import LayerNorm
    from mmtrack_torch.models.vipt import PromptBlock

    g = torch.Generator().manual_seed(seed)
    norms = [LayerNorm(C, dtype=dtype, device=dev) for _ in range(2)]
    block = PromptBlock(C, dtype=dtype, device=dev)
    with torch.no_grad():
        for n in norms:
            n.weight.copy_(1 + 0.1 * torch.randn(C, generator=g))
            n.bias.copy_(0.1 * torch.randn(C, generator=g))
        for conv, scale in ((block.conv0_0, 0.3 * C ** -0.5), (block.conv0_1, 0.3 * C ** -0.5),
                            (block.conv1x1, 8 ** -0.5)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * scale)
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=g))
    return norms, block


def _prompt_case(dev, B, La, seed, permuted=False):
    """(tokens pair, state pair, live index or None) of a later block with
    La tokens entering it: La - 64 live grid rows, random per lane."""
    g = torch.Generator().manual_seed(seed)
    live = La - PROMPT_LZ
    x_cur = (torch.randn(B, La, C, generator=g) * 2 + 0.3).to(dev, torch.bfloat16)
    state = tuple(torch.randn(B, L, C, generator=g).to(dev, torch.bfloat16)
                  for L in (PROMPT_LZ, PROMPT_LX))
    gidx = None
    if live < PROMPT_LX or permuted:
        gidx = torch.stack([torch.randperm(PROMPT_LX, generator=g)[:live]
                            for _ in range(B)]).to(dev)
    return (x_cur[:, :PROMPT_LZ], x_cur[:, PROMPT_LZ:]), state, gidx


def _assert_prompt_close(got, want, tokens):
    out, (p_z, p_s) = got
    w_out, (w_z, w_s) = want
    x = torch.cat(tokens, dim=1)
    assert out.shape == w_out.shape and p_z.shape == w_z.shape and p_s.shape == w_s.shape
    _assert_row_ulps(out, w_out, x)
    _assert_row_ulps(p_z, w_z, torch.zeros_like(p_z))
    _assert_row_ulps(p_s, w_s, torch.zeros_like(p_s))


@pytest.fixture
def f32_products(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        False)


@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("La,permuted", [(320, False), (320, True), (244, False),
                                         (190, False), (153, False)],
                         ids=["320", "320_permuted", "244", "190", "153"])
def test_prompt_kernel_matches_plain(dev, f32_products, B, La, permuted):
    from mmtrack_torch.ops.prompt import prompt_step, prompt_step_plain

    (norm_a, norm_b), block = _prompt_modules(dev, seed=La)
    tokens, state, gidx = _prompt_case(dev, B, La, seed=B, permuted=permuted)
    before = profiling.counters()
    with torch.no_grad():
        got = prompt_step(tokens, state, norm_a, norm_b, block, gidx)
        want = prompt_step_plain(tokens, state, norm_a, norm_b, block, gidx)
    assert profiling.launches([prompt_step], before) == {"prompt_step": 1}
    _assert_prompt_close(got, want, tokens)


@pytest.mark.parametrize("B", [1, 32])
def test_prompt_kernel_block0_form_matches_plain(dev, f32_products, B):
    """Block 0: the RGB tokens and the auxiliary tokens (separate tensors,
    one LayerNorm for both) in place of the tokens and the state."""
    from mmtrack_torch.ops.prompt import prompt_step, prompt_step_plain

    (n0, _), block = _prompt_modules(dev, seed=0)
    g = torch.Generator().manual_seed(B)
    rgb, aux = [tuple((torch.randn(B, L, C, generator=g) * 2).to(dev, torch.bfloat16)
                      for L in (PROMPT_LZ, PROMPT_LX)) for _ in range(2)]
    before = profiling.counters()
    with torch.no_grad():
        got = prompt_step(rgb, aux, n0, n0, block)
        want = prompt_step_plain(rgb, aux, n0, n0, block)
    assert profiling.launches([prompt_step], before) == {"prompt_step": 1}
    _assert_prompt_close(got, want, rgb)


def test_prompt_kernel_in_a_captured_graph_replayed_twice(dev, f32_products):
    from mmtrack_torch.ops.prompt import prompt_step, prompt_step_plain

    (norm_a, norm_b), block = _prompt_modules(dev, seed=1)
    tokens, state, gidx = _prompt_case(dev, 4, 190, seed=0)
    x_cur = torch.cat(tokens, dim=1)
    static = (x_cur, *state, gidx)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = profiling.counters()
    with torch.no_grad():
        with torch.cuda.stream(side):
            prompt_step((x_cur[:, :PROMPT_LZ], x_cur[:, PROMPT_LZ:]), state, norm_a, norm_b,
                        block, gidx)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = prompt_step((x_cur[:, :PROMPT_LZ], x_cur[:, PROMPT_LZ:]), state, norm_a,
                              norm_b, block, gidx)
        for seed in (5, 6):
            fresh_tokens, fresh_state, fresh_gidx = _prompt_case(dev, 4, 190, seed=seed)
            for dst, src in zip(static, (torch.cat(fresh_tokens, dim=1), *fresh_state,
                                         fresh_gidx)):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            want = prompt_step_plain(fresh_tokens, fresh_state, norm_a, norm_b, block,
                                     fresh_gidx)
            _assert_prompt_close(out, want, fresh_tokens)
    assert profiling.launches([prompt_step], before) == {"prompt_step": 2}   # warm-up, capture


def test_prompt_step_under_autograd_launches_with_the_plain_gradient(dev, f32_products):
    """Prompt tuning: the kernels run the forward (one launch, none in the
    backward) and every input and parameter gets the plain step's
    gradient, bit for bit (ops/plain_grad.py)."""
    from mmtrack_torch.ops.prompt import prompt_step, prompt_step_plain

    (norm_a, norm_b), block = _prompt_modules(dev, seed=2)
    tokens, state, gidx = _prompt_case(dev, 2, 244, seed=3)
    x_cur = torch.cat(tokens, dim=1).requires_grad_()
    state = tuple(t.requires_grad_() for t in state)
    tokens = (x_cur[:, :PROMPT_LZ], x_cur[:, PROMPT_LZ:])
    g = torch.Generator().manual_seed(4)
    weights = [torch.randn(2, n, C, generator=g).to(dev) for n in (244, PROMPT_LZ + PROMPT_LX)]
    leaves = [x_cur, *state, *norm_a.parameters(), *norm_b.parameters(), *block.parameters()]

    def grads(step):
        for t in leaves:
            t.grad = None
        out, (p_z, p_s) = step(tokens, state, norm_a, norm_b, block, gidx)
        ((out.float() * weights[0]).sum()
         + (torch.cat([p_z, p_s], 1).float() * weights[1]).sum()).backward()
        return out, [t.grad.clone() for t in leaves]

    before = profiling.counters()
    got, got_grads = grads(prompt_step)
    assert profiling.launches([prompt_step], before) == {"prompt_step": 1}
    want, want_grads = grads(prompt_step_plain)
    assert got.grad_fn is not None
    _assert_row_ulps(got.detach(), want.detach(), x_cur.detach())
    for gg, wg in zip(got_grads, want_grads):
        assert torch.equal(gg, wg)


def test_prompt_step_refuses_f32_on_the_card(dev):
    """A CUDA step launches the kernels or raises: an f32 model's steps
    are `prompt_step_plain`, chosen by the model."""
    from mmtrack_torch.ops.prompt import prompt_step

    (norm_a, norm_b), block = _prompt_modules(dev, seed=2, dtype=torch.float32)
    tokens, state, gidx = _prompt_case(dev, 2, 244, seed=3)
    tokens, state = (tuple(t.float() for t in pair) for pair in (tokens, state))
    before = profiling.counters()
    with torch.no_grad(), pytest.raises(TypeError, match="bf16"):
        prompt_step(tokens, state, norm_a, norm_b, block, gidx)
    assert profiling.launches([prompt_step], before) == {"prompt_step": 0}


@pytest.mark.parametrize("use_kernels,dtype,launches", [
    (True, torch.bfloat16, 2), (False, torch.bfloat16, 0), (True, torch.float32, 0)],
    ids=["kernels_bf16", "plain_bf16", "kernels_f32"])
def test_a_models_prompt_steps_launch_where_its_blocks_do(dev, use_kernels, dtype, launches):
    """ViT-B with two blocks: block 0's step and block 1's launch the
    kernels with `use_kernels` at bf16; with use_kernels=False and at f32
    (CEBlock's plain layers) the steps are plain and launch nothing."""
    from mmtrack_torch.models.vipt import ViTCEPrompt, init_weights
    from mmtrack_torch.ops.prompt import prompt_step

    model = ViTCEPrompt(depth=2, ce_loc=(), dtype=dtype, device=dev, use_kernels=use_kernels)
    init_weights(model, 0)
    g = torch.Generator().manual_seed(0)
    z, x = (torch.randn(2, S, S, 6, generator=g).to(dev) for S in (128, 256))
    before = profiling.counters()
    with torch.no_grad():
        out = model(z, x)
    assert profiling.launches([prompt_step], before) == {"prompt_step": launches}
    assert torch.isfinite(out.float()).all()


# The tracking cell's weight statistics: `init_weights`' Xavier-uniform
# prompt convs and zero biases, unit LayerNorms, the Fovea's temperature
# 10. x0 of a normalised row is ~1.4 a channel, so a part's logits spread
# by ~60 and its top two often tie: one x0 flipped by an ulp between the
# kernels' f32 order and the plain one moves the softmax of the few rows
# that dominate a channel, and with it those rows of the state. Read on
# an H100, 16 seeds of each form below: tokens (whose scale is the
# residual stream) within 1 ulp, at most 2 state rows a step past two
# ulps, the worst 5 ulps; in the tracking cell's own steps (384 steps of
# 32 lanes) the worst state row read 7.75. Bars: tokens within
# PROMPT_SHARP_TOKEN_ULPS, at most PROMPT_SHARP_ROWS state rows past two
# ulps, none past PROMPT_SHARP_ROW_ULPS. Softmax statistics gone wrong
# move whole channels of every row, by far more.
PROMPT_SHARP_TOKEN_ULPS = 2
PROMPT_SHARP_ROWS = 4
PROMPT_SHARP_ROW_ULPS = 8


def _cell_prompt_modules(dev, seed):
    from torch import nn

    from mmtrack_torch.models.layers import LayerNorm
    from mmtrack_torch.models.vipt import PromptBlock, init_weights

    holder = nn.Module()
    holder.prompt_norms = nn.ModuleList(LayerNorm(C, dtype=torch.bfloat16, device=dev)
                                        for _ in range(2))
    holder.prompt_blocks = nn.ModuleList([PromptBlock(C, dtype=torch.bfloat16, device=dev)])
    init_weights(holder, seed)
    return tuple(holder.prompt_norms), holder.prompt_blocks[0]


def _row_ulps(got, want, x):
    """Each row's largest |got - want| in bf16 ulps of the row's scale
    (as _assert_row_ulps)."""
    g, w, xf = got.float(), want.float(), x.float()
    scale = torch.stack([xf.abs(), g.abs(), w.abs(), (w - xf).abs()]).amax(0).amax(-1, True)
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0 ** -126))) - 7)
    return ((g - w).abs() / ulp).amax(-1)


def _fovea_spread(tokens, gidx, Lx, norm_a, block):
    from mmtrack_torch.ops.ce import recover_search_tokens

    full_s = tokens[1] if gidx is None else recover_search_tokens(tokens[1], gidx, Lx)
    a = norm_a(torch.cat([tokens[0], full_s], dim=1))
    x0 = block._dense(block.conv0_0, a).float() * block.fovea.smooth
    return (x0.amax(1) - x0.amin(1)).min().item()


@pytest.mark.parametrize("La", [320, 244, 190, 153, 0],
                         ids=["320", "244", "190", "153", "block0"])
def test_prompt_kernel_with_the_cells_weights(dev, f32_products, La):
    from mmtrack_torch.ops.prompt import prompt_step, prompt_step_plain

    (norm_a, norm_b), block = _cell_prompt_modules(dev, seed=La)
    if La:
        tokens, state, gidx = _prompt_case(dev, 32, La, seed=La + 1)
    else:           # block 0: the RGB and the auxiliary tokens, one LayerNorm for both
        norm_b = norm_a
        g = torch.Generator().manual_seed(8)
        tokens, state = [tuple((torch.randn(32, L, C, generator=g) * 2).to(dev, torch.bfloat16)
                               for L in (PROMPT_LZ, PROMPT_LX)) for _ in range(2)]
        gidx = None
    with torch.no_grad():
        assert _fovea_spread(tokens, gidx, PROMPT_LX, norm_a, block) > 30
        out, (p_z, p_s) = prompt_step(tokens, state, norm_a, norm_b, block, gidx)
        w_out, (w_z, w_s) = prompt_step_plain(tokens, state, norm_a, norm_b, block, gidx)
    tok = _row_ulps(out, w_out, torch.cat(tokens, dim=1))
    w_state = torch.cat([w_z, w_s], 1)
    st = _row_ulps(torch.cat([p_z, p_s], 1), w_state, torch.zeros_like(w_state))
    assert tok.max().item() <= PROMPT_SHARP_TOKEN_ULPS, tok.max().item()
    assert int((st > 2).sum()) <= PROMPT_SHARP_ROWS, int((st > 2).sum())
    assert st.max().item() <= PROMPT_SHARP_ROW_ULPS, st.max().item()
