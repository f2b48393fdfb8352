"""ViPT's prompt step (`ops/prompt.py`) on the CPU.

`prompt_step_plain` is the composition `ViTCEPrompt.forward` ran inline
before the step had a kernel: it must give the same bits as that
composition, written out here as it was, for block 0 (the RGB and the
auxiliary tokens) and for a later block (tokens and the prompt state),
pruned and unpruned, at bf16 and f32. Off the card `prompt_step` takes
the plain path and counts no launch; the kernels' wrapper's argument
checks raise before the library is built (meta tensors stand in for the
card); under autograd the kernels' forward takes the plain step's
gradient; and the model runs `prompt_step` where its blocks run their
kernels (`use_kernels` at bf16), `prompt_step_plain` otherwise. The
kernel itself is held against the plain path on the card
(tests/test_torch_cuda.py).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.models.layers import LayerNorm  # noqa: E402
from mmtrack_torch.models.vipt import PromptBlock  # noqa: E402
from mmtrack_torch.ops import prompt  # noqa: E402
from mmtrack_torch.ops.ce import gather_search_tokens, recover_search_tokens  # noqa: E402
from mmtrack_torch.utils import profiling  # noqa: E402

C, LZ, LX, LIVE = 64, 4, 16, 11


def _modules(dtype, seed, width=C):
    g = torch.Generator().manual_seed(seed)
    norms = [LayerNorm(width, dtype=dtype) for _ in range(2)]
    block = PromptBlock(width, dtype=dtype)
    with torch.no_grad():
        for n in norms:
            n.weight.copy_(1 + 0.1 * torch.randn(width, generator=g))
            n.bias.copy_(0.1 * torch.randn(width, generator=g))
        for conv in (block.conv0_0, block.conv0_1, block.conv1x1):
            fan_in = conv.weight.shape[1]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * fan_in ** -0.5)
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=g))
    return norms, block


def _tokens(B, L, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, L, C, generator=g) * 2 + 0.3).to(dtype)


def _live_index(B, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(LX, generator=g)[:LIVE] for _ in range(B)])


def _block0_as_it_was(z_tok, x_tok, z_dte_tok, x_dte_tok, n0, p0):
    z_prompted = p0(n0(z_tok), n0(z_dte_tok))
    x_prompted = p0(n0(x_tok), n0(x_dte_tok))
    return z_tok + z_prompted, x_tok + x_prompted, z_prompted, x_prompted


def _block_as_it_was(x_cur, z_prompted, x_prompted, gidx_s, pruned, norm_prev, norm, block):
    lens_z, lens_x = LZ, LX
    x_ori = x_cur
    z_cur = x_cur[:, :lens_z]
    xs = x_cur[:, lens_z:]
    xs_full = recover_search_tokens(xs, gidx_s, lens_x) if pruned else xs
    full = norm_prev(torch.cat([z_cur, xs_full], dim=1))
    z_t, x_t = full[:, :lens_z], full[:, lens_z:]
    zp = norm(z_prompted)
    xp = norm(x_prompted)
    z_prompted = block(z_t, zp)
    x_prompted = block(x_t, xp)
    x_sel = gather_search_tokens(x_prompted, gidx_s) if pruned else x_prompted
    return x_ori + torch.cat([z_prompted, x_sel], dim=1), z_prompted, x_prompted


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block0_plain_step_bit_equal_to_the_composition_it_replaced(dtype, B):
    dt = DTYPES[dtype]
    (n0, _), p0 = _modules(dt, seed=B)
    z, x = _tokens(B, LZ, dt, 1), _tokens(B, LX, dt, 2)
    z_dte, x_dte = _tokens(B, LZ, dt, 3), _tokens(B, LX, dt, 4)
    with torch.no_grad():
        want = _block0_as_it_was(z, x, z_dte, x_dte, n0, p0)
        tokens, (p_z, p_s) = prompt.prompt_step_plain((z, x), (z_dte, x_dte), n0, n0, p0)
    got = (tokens[:, :LZ], tokens[:, LZ:], p_z, p_s)
    assert tokens.shape == (B, LZ + LX, C) and tokens.dtype == dt
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_plain_step_bit_equal_to_the_composition_it_replaced(dtype, pruned, B):
    dt = DTYPES[dtype]
    (norm_prev, norm), block = _modules(dt, seed=10 + B)
    gidx = _live_index(B, seed=B) if pruned else None
    x_cur = _tokens(B, LZ + (LIVE if pruned else LX), dt, 5)
    z_prompted, x_prompted = _tokens(B, LZ, dt, 6), _tokens(B, LX, dt, 7)
    with torch.no_grad():
        want = _block_as_it_was(x_cur, z_prompted, x_prompted, gidx, pruned, norm_prev, norm,
                                block)
        tokens, (p_z, p_s) = prompt.prompt_step_plain(
            (x_cur[:, :LZ], x_cur[:, LZ:]), (z_prompted, x_prompted), norm_prev, norm, block,
            gidx)
    for g, w in zip((tokens, p_z, p_s), want):
        assert g.dtype == dt and torch.equal(g, w)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prompt_step_off_the_card_is_the_plain_step_and_counts_no_launch(dtype):
    dt = DTYPES[dtype]
    (norm_prev, norm), block = _modules(dt, seed=3)
    gidx = _live_index(2, seed=3)
    x_cur = _tokens(2, LZ + LIVE, dt, 8)
    state = (_tokens(2, LZ, dt, 9), _tokens(2, LX, dt, 10))
    args = ((x_cur[:, :LZ], x_cur[:, LZ:]), state, norm_prev, norm, block, gidx)
    before = profiling.counters()
    with torch.no_grad():
        got = prompt.prompt_step(*args)
        want = prompt.prompt_step_plain(*args)
    assert profiling.launches([prompt.prompt_step], before) == {"prompt_step": 0}
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))


def test_prompt_step_trains_through_the_plain_step():
    """Prompt tuning: gradients reach every parameter of the step."""
    (norm_prev, norm), block = _modules(torch.float32, seed=4)
    x_cur = _tokens(2, LZ + LX, torch.float32, 11)
    state = (_tokens(2, LZ, torch.float32, 12), _tokens(2, LX, torch.float32, 13))
    tokens, (p_z, p_s) = prompt.prompt_step((x_cur[:, :LZ], x_cur[:, LZ:]), state, norm_prev,
                                            norm, block)
    (tokens.square().sum() + p_z.sum() + p_s.sum()).backward()
    params = [*norm_prev.parameters(), *norm.parameters(), *block.parameters()]
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params)
    assert block.fovea.smooth.grad.abs().item() > 0


def _grads(loss_of, leaves):
    for t in leaves:
        t.grad = None
    loss_of().backward()
    return [t.grad.clone() for t in leaves]


@pytest.mark.parametrize("form", ["block0", "unpruned", "pruned"])
def test_the_kernels_forward_takes_the_plain_steps_gradient(form):
    """The card's route under autograd (ops/plain_grad.py with two
    outputs): a stand-in computes the kernels' forward; every input and
    parameter gets the plain step's gradient, bit for bit, and
    `_step_plain` gives the plain step's numbers."""
    from mmtrack_torch.ops.plain_grad import launch_with_plain_grad

    dt = torch.float32
    (norm_a, norm_b), block = _modules(dt, seed=20)
    if form == "block0":
        norm_b = norm_a
    gidx = _live_index(2, seed=5) if form == "pruned" else None
    x_cur = _tokens(2, LZ + (LIVE if gidx is not None else LX), dt, 14).requires_grad_()
    state = tuple(_tokens(2, L, dt, 15 + L).requires_grad_() for L in (LZ, LX))
    tokens = (x_cur[:, :LZ], x_cur[:, LZ:])
    kw = dict(modules=(norm_a, norm_b, block), global_index_s=gidx)
    weights = [_tokens(2, LZ + x_cur.shape[1] - LZ, dt, 30), _tokens(2, LZ + LX, dt, 31)]

    def plain_loss():
        out, (p_z, p_s) = prompt.prompt_step_plain(tokens, state, norm_a, norm_b, block, gidx)
        return (out * weights[0]).sum() + (torch.cat([p_z, p_s], 1) * weights[1]).sum()

    def route_loss():
        out, st = launch_with_plain_grad(
            lambda *t, **k: prompt._step_plain(*t, **k),
            prompt._step_plain, prompt._step_tensors(tokens, state, norm_a, norm_b, block), **kw)
        return (out * weights[0]).sum() + (st * weights[1]).sum()

    leaves = [x_cur, *state, *{id(p): p for m in (norm_a, norm_b, block)
                               for p in m.parameters()}.values()]
    with torch.no_grad():
        out, (p_z, p_s) = prompt.prompt_step_plain(tokens, state, norm_a, norm_b, block, gidx)
        got_out, got_state = prompt._step_plain(
            *prompt._step_tensors(tokens, state, norm_a, norm_b, block), **kw)
    assert torch.equal(got_out, out) and torch.equal(got_state, torch.cat([p_z, p_s], 1))
    for g, w in zip(_grads(route_loss, leaves), _grads(plain_loss, leaves)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("use_kernels,dtype,step", [
    (True, "bf16", "prompt_step"), (False, "bf16", "prompt_step_plain"),
    (True, "f32", "prompt_step_plain")], ids=["kernels_bf16", "plain_bf16", "kernels_f32"])
def test_the_model_picks_the_prompt_step_of_its_blocks(monkeypatch, use_kernels, dtype, step):
    """`ViTCEPrompt` runs `prompt_step` where its blocks run their kernels
    (`use_kernels` at bf16; CEBlock's gate) and `prompt_step_plain`
    otherwise: block 0's step and one a later block."""
    from mmtrack_torch.models import vipt

    calls = {"prompt_step": 0, "prompt_step_plain": 0}

    def counted(name):
        fn = getattr(vipt, name)

        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    for name in calls:
        monkeypatch.setattr(vipt, name, counted(name))
    depth = 3
    model = vipt.ViTCEPrompt(embed_dim=C, depth=depth, num_heads=2, template_size=32,
                             search_size=64, ce_loc=(1,), dtype=DTYPES[dtype],
                             use_kernels=use_kernels)
    vipt.init_weights(model, 0)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = model(torch.randn(2, 32, 32, 6, generator=g), torch.randn(2, 64, 64, 6, generator=g))
    assert out.shape == (2, 4 + 16, C) and torch.isfinite(out.float()).all()
    assert calls == {name: depth if name == step else 0 for name in calls}


class _Built(Exception):
    pass


def _meta_case(B=2, c=prompt.PROMPT_C, live=LIVE, hide=8, with_index=True,
               dtype=torch.bfloat16, module_dtype=torch.bfloat16):
    meta = torch.device("meta")
    (norm_prev, norm), block = _modules(module_dtype, seed=0, width=c)
    norm_prev, norm, block = norm_prev.to(meta), norm.to(meta), block.to(meta)
    if hide != 8:
        block.conv0_0.weight = torch.nn.Parameter(torch.empty(hide, c, 1, 1, device=meta))
    x_cur = torch.empty(B, LZ + live, c, dtype=dtype, device=meta)
    state = (torch.empty(B, LZ, c, dtype=dtype, device=meta),
             torch.empty(B, LX, c, dtype=dtype, device=meta))
    gidx = torch.empty(B, live, dtype=torch.int64, device=meta) if with_index else None
    return (x_cur[:, :LZ], x_cur[:, LZ:]), state, norm_prev, norm, block, gidx


@pytest.mark.parametrize("case,error,match", [
    (dict(), ValueError, "needs CUDA tensors"),
    (dict(live=LX + 1), ValueError, "live of"),
    (dict(with_index=False), ValueError, "needs its global_index_s"),
    (dict(hide=4), ValueError, "C -> 8 -> C"),
    (dict(dtype=torch.float16), TypeError, "bf16 tokens"),
    (dict(dtype=torch.float32, module_dtype=torch.float32), TypeError, "bf16 tokens"),
    (dict(c=512), ValueError, "C == 768"),
    (dict(c=1024), ValueError, "C == 768"),
], ids=["meta_device", "more_live_than_grid", "pruned_without_index", "hidden_width",
        "dtype", "f32_model", "width_512", "width_1024"])
def test_prompt_kernel_checks_raise_before_any_build(monkeypatch, case, error, match):
    """Off the CPU, `prompt_step` launches the kernels or raises: it never
    falls back to the plain step."""
    def load_library():
        raise _Built

    monkeypatch.setattr(prompt, "load_library", load_library)
    with torch.no_grad(), pytest.raises(error, match=match):
        prompt.prompt_step(*_meta_case(**case))
