"""STARK's RepVGG-A0 and Swin-T trunks in the port against the JAX
package's, at f32 on the CPU.

The trunks alone on 64 px (RepVGG, every tap stage0-stage4) and 96 px
(Swin, stage0-stage3: 24, 12, 6 and 3 tokens a side, each padded to a
multiple of the 7-token window) crops, flax-initialised, through the
bridge: each tap within 1e-5 of its largest magnitude (RepVGG's seeded
taps grow to ~4e3). `fuse_repvgg_params` on a tree whose BN leaves are
drawn from a numpy seed: the port's deploy state_dict equal to JAX's
fused tree through the bridge, the deploy forward within 1e-5 (relative to
the tap's largest magnitude) of the three-branch one. SPT, whose colour
and depth trunks are both of the type, on each trunk (d = 32, 2 heads, one encoder / decoder / fusion layer, 64 /
96 crops: 16 and 24 Swin tokens a side, padded to 21 and 28; trees from a
numpy seed at the shapes of jax.eval_shape of the init): boxes within
1e-5, and the SPT tracker's 4-frame free run within 0.05 px.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import repvgg as jax_repvgg  # noqa: E402
from mmtrack_tpu.models import stark as jax_stark  # noqa: E402
from mmtrack_tpu.models import swin as jax_swin  # noqa: E402
from mmtrack_tpu.trackers import stark_tracker as jax_st  # noqa: E402
from mmtrack_torch.models import repvgg, stark, swin  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    repvgg_state_dict_from_flax,
    stark_state_dict_from_flax,
    swin_state_dict_from_flax,
)
from mmtrack_torch.trackers import stark_tracker as st  # noqa: E402

TRUNKS = ("repvgg_a0", "swin_tiny")
SMALL = dict(template_size=64, search_size=96, dim=32, heads=2, enc_layers=1, dec_layers=1,
             fusion_layers=1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("trunk", TRUNKS)
def test_trunk_taps_match_jax(trunk):
    if trunk == "repvgg_a0":
        jm, size, taps = jax_repvgg.repvgg_a0(), 64, repvgg.STAGES
        port, bridge = repvgg.repvgg_a0(), repvgg_state_dict_from_flax
    else:
        jm, size, taps = jax_swin.swin_tiny(), 96, swin.STAGES
        port, bridge = swin.swin_tiny(swin.STAGES), swin_state_dict_from_flax
    x = np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32)
    params = jax.jit(lambda r: jm.init(r, jnp.asarray(x), taps))(jax.random.PRNGKey(0))
    want = jax.jit(lambda p: jm.apply(p, jnp.asarray(x), taps))(params)
    port.load_state_dict(bridge(_np_tree(params["params"])))
    with torch.no_grad():
        got = port(torch.from_numpy(x), taps)
    for t in taps:
        assert got[t].shape == want[t].shape, t
        _close(got[t].numpy(), want[t])


def test_swin_shift_mask_and_index_equal_jax():
    for Hp, Wp in ((7, 7), (14, 21), (35, 35)):
        np.testing.assert_array_equal(swin.shift_attn_mask(Hp, Wp, 7, 3),
                                      jax_swin._shift_attn_mask(Hp, Wp, 7, 3))
    np.testing.assert_array_equal(swin.relative_position_index(7),
                                  jax_swin._relative_position_index(7))


def _seeded_bn(tree, rng):
    """Draw a RepVGG tree's BN leaves away from their init values."""
    def leaf(path, v):
        name = path[-1].key
        if name.endswith("_scale"):
            return (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        if name.endswith("_var"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name.endswith(("_bias", "_mean")):
            return (0.2 * rng.randn(*v.shape)).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_fuse_repvgg_params_matches_jax():
    jm = jax_repvgg.repvgg_a0()
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    params = jax.jit(lambda r: jm.init(r, jnp.asarray(x), ("stage4",)))(jax.random.PRNGKey(1))
    tree = _seeded_bn(_np_tree(params["params"]), np.random.RandomState(2))
    jax_fused = _np_tree(jax_repvgg.fuse_repvgg_params({"params": tree})["params"])

    three = repvgg.repvgg_a0()
    three.load_state_dict(repvgg_state_dict_from_flax(tree))
    fused_sd = repvgg.fuse_repvgg_params(three.state_dict())
    want_sd = repvgg_state_dict_from_flax(jax_fused)
    assert fused_sd.keys() == want_sd.keys()
    for k in want_sd:
        np.testing.assert_array_equal(fused_sd[k].numpy(), want_sd[k].numpy(), err_msg=k)

    deploy = repvgg.repvgg_a0(deploy=True)
    deploy.load_state_dict(fused_sd)
    with torch.no_grad():
        a = three(torch.from_numpy(x), repvgg.STAGES)
        b = deploy(torch.from_numpy(x), repvgg.STAGES)
    want = jax.jit(lambda p: jax_repvgg.repvgg_a0(deploy=True).apply(
        p, jnp.asarray(x), repvgg.STAGES))({"params": jax_fused})
    for t in repvgg.STAGES:
        _close(b[t].numpy(), a[t].numpy())
        _close(b[t].numpy(), want[t])


def _seeded_tree(shapes, rng):
    """A flax tree at `shapes` from a numpy seed: LeCun-normal kernels,
    scales and variances near 1, small biases, means and tables."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name.endswith(("scale", "var")) or name == "query_embed":
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            v = 0.02 * rng.randn(*s.shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=TRUNKS)
def models(request):
    """(trunk, jax SPT, its flax params, the port's SPT) on numpy-seeded
    weights: the colour and depth trunks both of the type."""
    trunk = request.param
    jm = jax_stark.STARK(**SMALL, six_channel=True, backbone_type=trunk)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 6)), jnp.zeros((1, 96, 96, 6))))
    params = _seeded_tree(shapes, np.random.RandomState(5))
    port = stark.STARK(**SMALL, six_channel=True, backbone_type=trunk)
    port.load_state_dict(stark_state_dict_from_flax(_np_tree(params["params"])))
    return trunk, jm, params, port.eval()


def test_spt_on_trunk_matches_jax(models):
    trunk, jm, params, port = models
    rng = np.random.RandomState(3)
    z = rng.randn(2, 64, 64, 6).astype(np.float32)
    x = rng.randn(2, 96, 96, 6).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(z), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(x))
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]),
                               rtol=0, atol=1e-5, err_msg=trunk)
    for bottleneck in (port.bottleneck_color, port.bottleneck_depth):
        assert bottleneck.weight.shape[1] == stark.TRUNKS[trunk][1]
    single = stark.STARK(**SMALL, backbone_type=trunk)        # STARK-S: one trunk
    assert single.bottleneck.weight.shape[1] == stark.TRUNKS[trunk][1]


def test_spt_tracker_on_trunk_matches_jax(models):
    """The device-crop SPT tracker on 6-channel frames, 4 frames free."""
    trunk, jm, params, port = models
    rt = dict(template_size=64, search_size=96)
    ours = st.STARKTracker(port, "cpu", st.STARKRuntime(**rt))
    theirs = jax_st.STARKTracker(jm, params, jax_st.STARKRuntime(**rt))
    frames, gt = make_synthetic_sequence(n_frames=5, height=96, width=128, seed=6,
                                         box0=(40.0, 30.0, 24.0, 20.0))
    boxes = {}
    for name, tr in (("ours", ours), ("theirs", theirs)):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
        boxes[name] = np.asarray([tr.track(f)["target_bbox"] for f in frames[1:]])
    np.testing.assert_allclose(boxes["ours"], boxes["theirs"], rtol=0, atol=0.05,
                               err_msg=trunk)
