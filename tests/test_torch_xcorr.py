"""The port's cross-correlation ops against the JAX package's, at f32.

`depthwise_xcorr_plain` (what a CPU tensor runs, and what the CUDA kernel
csrc/xcorr.cu repeats bit for bit on the card) is held against the Pallas
kernel `depthwise_xcorr_pallas` in interpret mode and against the XLA
`depthwise_xcorr`, on unit-normal numpy inputs, within 1e-5: at the Pallas
test's shape (3, 22, 22, 256) x (6, 6, 256) with a shared filter, and at
Alpha-Refine's (1 and 4 samples, 32 x 32 x 64 padded by one, 3 x 3
per-sample filters, as alpha_refine.py:81-83 vmaps them). `xcorr` (summed
over channels) within 1e-5 of JAX's on a 3 x 3 x 8 filter: a sum of 72
unit-normal products, whose f32 rounding in another order stays below that
(at 6 x 6 x 32, 1152 products, the two orders differ by 1.4e-4).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mmtrack_tpu.ops import xcorr as jax_xcorr  # noqa: E402
from mmtrack_torch.ops import xcorr  # noqa: E402
from mmtrack_torch.utils import profiling  # noqa: E402

ATOL = 1e-5


def _pallas(z, x):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_xcorr.depthwise_xcorr_pallas(jnp.asarray(z), jnp.asarray(x)))


def test_shared_filter_matches_pallas_and_xla():
    rng = np.random.RandomState(2)
    z = rng.randn(6, 6, 256).astype(np.float32)
    x = rng.randn(3, 22, 22, 256).astype(np.float32)
    got = xcorr.depthwise_xcorr(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    assert got.shape == (3, 17, 17, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, _pallas(z, x), rtol=0, atol=ATOL)
    want = np.asarray(jax_xcorr.depthwise_xcorr(jnp.asarray(z), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 4])
def test_per_sample_padded_filter_matches_alpha_refine_form(n):
    """Alpha-Refine's call: each sample's own 3x3 filter over its search
    feature padded by one; the kernel's `pad` against JAX's jnp.pad."""
    rng = np.random.RandomState(3 + n)
    k = rng.randn(n, 3, 3, 64).astype(np.float32)
    s = rng.randn(n, 32, 32, 64).astype(np.float32)
    padded = np.pad(s, ((0, 0), (1, 1), (1, 1), (0, 0)))
    got = xcorr.depthwise_xcorr(torch.from_numpy(k), torch.from_numpy(s), pad=1).numpy()
    assert got.shape == (n, 32, 32, 64)
    # JAX: vmapped XLA correlation exactly as alpha_refine.py:81-83 writes it
    want = jax.vmap(lambda kk, f: jax_xcorr.depthwise_xcorr(
        kk, jnp.pad(f[None], ((0, 0), (1, 1), (1, 1), (0, 0)))[0][None])[0])(
        jnp.asarray(k), jnp.asarray(s))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    for i in range(n):
        np.testing.assert_allclose(got[i:i + 1], _pallas(k[i], padded[i:i + 1]), rtol=0,
                                   atol=ATOL)
    # the in-kernel padding is the padded tensor, bit for bit
    unpadded = xcorr.depthwise_xcorr_plain(torch.from_numpy(k), torch.from_numpy(padded))
    assert torch.equal(unpadded, torch.from_numpy(got))


def test_xcorr_matches_jax():
    rng = np.random.RandomState(5)
    z = rng.randn(3, 3, 8).astype(np.float32)
    x = rng.randn(2, 12, 12, 8).astype(np.float32)
    got = xcorr.xcorr(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    want = np.asarray(jax_xcorr.xcorr(jnp.asarray(z), jnp.asarray(x)))
    assert got.shape == want.shape == (2, 10, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_cpu_dispatch_counts_no_launch_and_keeps_the_gradient():
    rng = np.random.RandomState(6)
    z = torch.from_numpy(rng.randn(2, 3, 3, 8).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.randn(2, 5, 6, 8).astype(np.float32)).requires_grad_(True)
    before = profiling.counters()
    out = xcorr.depthwise_xcorr(z, x, pad=1)
    assert profiling.launches([xcorr.depthwise_xcorr], before) == {"depthwise_xcorr": 0}
    out.square().sum().backward()
    assert z.grad is not None and x.grad is not None


@pytest.mark.parametrize("z_shape,x_shape,pad", [((3, 3, 4), (1, 5, 5, 8), 0),
                                                 ((2, 3, 3, 8), (1, 5, 5, 8), 0),
                                                 ((7, 7, 8), (1, 5, 5, 8), 0),
                                                 ((3, 3, 8), (5, 5, 8), 0),
                                                 ((3, 3, 8), (1, 5, 5, 8), -1)])
def test_shape_checks_raise(z_shape, x_shape, pad):
    with pytest.raises(ValueError):
        xcorr.depthwise_xcorr(torch.zeros(z_shape), torch.zeros(x_shape), pad=pad)
