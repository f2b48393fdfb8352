"""MobileNetV3-Large, the relative-position attention and the talking-heads
attention of the port against the JAX package's, at f32 on the CPU, built
as tests/test_backbones.py builds them.

MobileNetV3-Large flax-initialised on 64 px crops with its frozen BN
leaves drawn from a numpy seed (so that BN does something), through
mobilenet_state_dict_from_flax: every tap (init_conv .. out_conv1) within
1e-5 of its largest magnitude. The attentions (dim 16, 4 heads, 2 x 2
template and 4 x 4 search tokens; at full size 8 x 8 and 16 x 16) with
their bias tables and head-mixing weights drawn from a numpy seed: the
bucket index equal to JAX's, outputs (and Attention's probabilities)
within 1e-6 of their largest magnitude.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import backbones as jax_bb  # noqa: E402
from mmtrack_tpu.models import layers as jax_layers  # noqa: E402
from mmtrack_torch.models import backbones, layers  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    attention_state_dict_from_flax,
    mobilenet_state_dict_from_flax,
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_hard_activations_match_jax():
    x = np.linspace(-5, 5, 41).astype(np.float32)
    for f, g in ((backbones.h_sigmoid, jax_bb.h_sigmoid), (backbones.h_swish, jax_bb.h_swish)):
        np.testing.assert_array_equal(f(torch.from_numpy(x)).numpy(), np.asarray(g(x)))


def test_mobilenetv3_taps_match_jax():
    jm = jax_bb.mobilenetv3_large()
    taps = backbones.MOBILENET_LAYERS
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    params = _np_tree(jax.jit(lambda r: jm.init(r, jnp.asarray(x), taps))(
        jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)

    def leaf(path, v):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v
    params = jax.tree_util.tree_map_with_path(leaf, params)
    want = jax.jit(lambda p: jm.apply(p, jnp.asarray(x), taps))(params)
    port = backbones.mobilenetv3_large()
    port.load_state_dict(mobilenet_state_dict_from_flax(params["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), taps)
    for t in taps:
        w = np.asarray(want[t])
        assert got[t].shape == w.shape, t
        np.testing.assert_allclose(got[t].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=t)


@pytest.mark.parametrize("z,x", [(2, 4), (8, 16)])
def test_rpe_index_equals_jax(z, x):
    np.testing.assert_array_equal(layers.rpe_index_concat(z, x),
                                  jax_layers.rpe_index_concat(z, x))


def _seeded(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda v: (0.5 * rng.randn(*v.shape)).astype(np.float32),
                        _np_tree(tree))


@pytest.mark.parametrize("kind", ["rpe", "plain", "talking", "talking_no_rpe"])
def test_attention_variants_match_jax(kind):
    x = np.random.RandomState(2).randn(2, 2 * 2 + 4 * 4, 16).astype(np.float32)
    rpe = kind in ("rpe", "talking")
    if kind.startswith("talking"):
        jm = jax_layers.AttentionTalkingHead(dim=16, num_heads=4, rpe=rpe, z_size=2, x_size=4)
        port = layers.AttentionTalkingHead(16, 4, rpe=rpe, z_size=2, x_size=4)
    else:
        jm = jax_layers.Attention(dim=16, num_heads=4, rpe=rpe, z_size=2, x_size=4)
        port = layers.Attention(16, 4, rpe=rpe, z_size=2, x_size=4)
    args = () if kind.startswith("talking") else (True,)
    params = _seeded(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)["params"], 3)
    want = jm.apply({"params": params}, jnp.asarray(x), *args)
    port.load_state_dict(attention_state_dict_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), *args)
    if kind.startswith("talking"):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
