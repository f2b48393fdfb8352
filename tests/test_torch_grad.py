"""The kernels under autograd, flash_mhsa_qkv, drop path and the block gate.

  * flash_mhsa_qkv's plain version against the Pallas kernel in interpret
    mode: f32 within 1e-6, bf16 within one bf16 ulp of the largest |output|
    of the element's token row (another f32 summation order can flip a
    rounding of the probabilities or the output by one ulp).
  * The autograd Function of ops/plain_grad.py, driven on the CPU with the
    plain version standing in for the kernel: output and gradients equal
    plain autograd exactly; inputs that need no gradient get none; without
    grad mode nothing is recorded.
  * drop_path: identity when deterministic, one Bernoulli draw per sample
    from the given generator, the 1/keep scale in the compute dtype exactly
    as the JAX package rounds it.
  * The block gate of mmtrack_tpu/models/layers.py:252-299 on a 12-block
    bf16 model: which kernel wrapper each block calls, per forward.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mmtrack_torch.models import layers, vipt  # noqa: E402
from mmtrack_torch.ops.flash_attn import (  # noqa: E402
    attn_block_fused_plain,
    flash_mhsa_qkv,
    flash_mhsa_qkv_plain,
)
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused_plain  # noqa: E402
from mmtrack_torch.ops.plain_grad import launch_with_plain_grad  # noqa: E402
from mmtrack_torch.utils import profiling  # noqa: E402

C, H = 64, 4


def _rand(seed, *shape, k=1.0):
    return torch.from_numpy((np.random.RandomState(seed).randn(*shape) * k).astype(np.float32))


@pytest.mark.parametrize("L", [1, 17, 37])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_mhsa_qkv_plain_matches_pallas(dtype, L):
    from mmtrack_tpu.ops.flash_attn import flash_mhsa_qkv as pallas_mhsa

    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    qkv = _rand(L, 2, L, 3 * C).to(tdt)
    scale = (C // H) ** -0.5
    want = np.asarray(pallas_mhsa(jnp.asarray(qkv.float().numpy()).astype(jdt), H, scale,
                                  interpret=True).astype(jnp.float32))
    before = profiling.counters()
    got = flash_mhsa_qkv(qkv, H, scale)
    assert profiling.launches([flash_mhsa_qkv], before) == {"flash_mhsa_qkv": 0}  # CPU: none
    assert got.dtype == tdt and got.shape == (2, L, C)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    scale_row = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale_row, 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def _block_args(kind, seed):
    """(plain, tensors, kwargs) of one half-block or the attention alone."""
    if kind == "flash_mhsa_qkv":
        return flash_mhsa_qkv_plain, [_rand(seed, 2, 9, 3 * C)], dict(num_heads=H, scale=0.25)
    n1, k2 = (3 * C, C) if kind == "attn_block_fused" else (4 * C, 4 * C)
    tensors = [_rand(seed, 2, 9, C), 1 + _rand(seed + 1, C, k=0.1), _rand(seed + 2, C, k=0.1),
               _rand(seed + 3, n1, C, k=0.1), _rand(seed + 4, n1, k=0.05),
               _rand(seed + 5, C, k2, k=0.1), _rand(seed + 6, C, k=0.05)]
    if kind == "attn_block_fused":
        return attn_block_fused_plain, tensors, dict(num_heads=H, scale=0.25)
    return mlp_block_fused_plain, tensors, {}


KINDS = ["flash_mhsa_qkv", "attn_block_fused", "mlp_block_fused"]


@pytest.mark.parametrize("needs", ["x", "all"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_grad_function_equals_plain_autograd(kind, needs):
    plain, tensors, kw = _block_args(kind, seed=3)
    wants = [i == 0 or needs == "all" for i in range(len(tensors))]
    a = [t.clone().requires_grad_(w) for t, w in zip(tensors, wants)]
    b = [t.clone().requires_grad_(w) for t, w in zip(tensors, wants)]
    calls = []

    def launch(*ts, **kws):          # stands in for the kernel
        calls.append(torch.is_grad_enabled())
        return plain(*ts, **kws)

    out = launch_with_plain_grad(launch, plain, tuple(a), **kw)
    assert calls == [False]          # the forward runs once, outside autograd
    assert out.grad_fn is not None
    ref = plain(*b, **kw)
    assert torch.equal(out, ref)
    g = _rand(9, *out.shape)
    out.backward(g)
    ref.backward(g)
    for ta, tb, w in zip(a, b, wants):
        assert (ta.grad is None) == (not w)
        if w:
            assert torch.equal(ta.grad, tb.grad)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_grad_function_records_nothing_without_grad(kind):
    plain, tensors, kw = _block_args(kind, seed=5)
    tensors[0].requires_grad_(True)
    with torch.no_grad():
        out = launch_with_plain_grad(plain, plain, tuple(tensors), **kw)
    assert out.grad_fn is None
    tensors[0].requires_grad_(False)
    assert launch_with_plain_grad(plain, plain, tuple(tensors), **kw).grad_fn is None


def test_drop_path_identity_when_deterministic_or_zero_rate():
    x = _rand(0, 4, 5, C)
    assert layers.drop_path(x, 0.1, None, deterministic=True) is x
    assert layers.drop_path(x, 0.0, None) is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drop_path_mask_scale_and_generator(dtype):
    rate = 0.3
    x = _rand(1, 64, 5, C).to(dtype)
    y = layers.drop_path(x, rate, torch.Generator().manual_seed(7))
    assert y.dtype == dtype and y.shape == x.shape
    kept = (y != 0).flatten(1).any(1)
    assert 0 < int(kept.sum()) < 64              # some samples kept, some dropped
    assert (y[~kept] == 0).all()
    # the JAX package's rounding: x * mask.astype(dtype) / keep, in dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mask = kept.float().numpy().reshape(64, 1, 1)
    want = (jnp.asarray(x.float().numpy()).astype(jdt) * jnp.asarray(mask).astype(jdt)
            / (1.0 - rate))
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the generator decides the draw
    again = layers.drop_path(x, rate, torch.Generator().manual_seed(7))
    other = layers.drop_path(x, rate, torch.Generator().manual_seed(8))
    assert torch.equal(y, again) and not torch.equal(y, other)


COUNTED = ("attn_block_fused", "mlp_block_fused", "flash_mhsa_qkv")


@pytest.mark.parametrize("mode,keep,want", [
    ("drop_path", (45, 32, 23), (1, 1, 8)),      # CE at 3/6/9 with keep 0.7
    ("drop_path", None, (1, 1, 11)),             # CE warm-up: no elimination
    ("deterministic", (45, 32, 23), (9, 12, 0)),
])
def test_block_gate_per_forward(monkeypatch, mode, keep, want):
    """Calls per forward of a 12-block bf16 ViPT with drop path 0.1, in the
    order attn_block_fused, mlp_block_fused, flash_mhsa_qkv: the counts a
    training step on the card must show."""
    calls = dict.fromkeys(COUNTED, 0)

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in COUNTED:
        monkeypatch.setattr(layers, name, counting(name, getattr(layers, name)))
    model = vipt.ViPTrack(embed_dim=C, depth=12, num_heads=H, template_size=32,
                          search_size=128, head_channel=16, dtype=torch.bfloat16,
                          drop_path_rate=0.1, param_dtype=torch.float32)
    vipt.init_weights(model, seed=0)
    z, x = _rand(1, 2, 32, 32, 6), _rand(2, 2, 128, 128, 6)
    mask = vipt.generate_ctr_mask(2, "CTR_POINT")
    deterministic = mode == "deterministic"
    with torch.no_grad():
        out = model(z, x, mask, keep, deterministic=deterministic,
                    generator=None if deterministic else torch.Generator().manual_seed(0))
    assert torch.isfinite(out["score_map"]).all()
    assert tuple(calls[n] for n in COUNTED) == want
