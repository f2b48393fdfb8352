"""The MDNet family's models in the port (MDNet single / dual / adapter,
pyVITAL's fc6 sum, APFNet, DAFNet, MaCNet, VITAL's G) against the JAX
package at f32 on bridged weights, the weight bridge, and the seven
registry recipes. The tracker: tests/test_torch_mdnet_tracker.py.

The flax trees' leaves are drawn from a numpy seed at the shapes of
jax.eval_shape of the init (no init compile) and carried into the port
by models/convert.py::mdnet_state_dict_from_flax; inputs are numpy-seeded
crops on the tracker's scale (0..255 - 128) at the JAX runtime's 107 px.
The port's conv3 flatten is CHW and JAX's HWC, so features are compared
through that permutation. Bars: LRN within 1e-6 relative; features within
1e-4 of their largest magnitude; logits from the same features within
1e-4, from the port's features within 1e-4 of their largest magnitude
(seeded VGG-M logits reach ~100); the dropout masks drawn with JAX's keys give JAX's
training logits; G, its masks and the hardest one-cell mask within 1e-5;
the port's state_dict back to the flax tree through JAX's
convert_mdnet_checkpoint / convert_manet_checkpoint /
convert_apfnet_checkpoint exactly; flax .npz files of every topology
through run_ope's loader.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import apfnet as japf  # noqa: E402
from mmtrack_tpu.models import convert as jconvert  # noqa: E402
from mmtrack_tpu.models import mdnet as jmd  # noqa: E402
from mmtrack_tpu.models import rgbt_fusion as jrf  # noqa: E402
from mmtrack_tpu.models import vital as jvital  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import apfnet, mdnet, rgbt_fusion, vital  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    _hwc_rows_to_chw,
    gnet_state_dict_from_flax,
    mdnet_state_dict_from_flax,
)

# name -> (JAX model, port model factory, the JAX converter of its torch names)
TOPOLOGIES = {
    "single": (lambda: jmd.MDNet(mode="single"), lambda: mdnet.MDNet("single"),
               jconvert.convert_mdnet_checkpoint),
    "dual": (lambda: jmd.MDNet(mode="dual"), lambda: mdnet.MDNet("dual"),
             jconvert.convert_mdnet_checkpoint),
    "dual_sum": (lambda: jmd.MDNet(mode="dual", fc6_merge="sum"),
                 lambda: mdnet.MDNet("dual", fc6_merge="sum"), jconvert.convert_mdnet_checkpoint),
    "adapter": (lambda: jmd.MDNet(mode="adapter"), lambda: mdnet.MDNet("adapter"),
                jconvert.convert_manet_checkpoint),
    "apfnet": (japf.APFNet, apfnet.APFNet, jconvert.convert_apfnet_checkpoint),
    "dafnet": (jrf.DAFNet, rgbt_fusion.DAFNet, None),
    "macnet": (jrf.MaCNet, rgbt_fusion.MaCNet, None),
}
# (channel count of each HWC-flattened 3x3 block at the head of the feature)
BLOCKS = {"single": (512,), "dual": (512,), "dual_sum": (512,), "adapter": (1024,),
          "apfnet": (1024,), "dafnet": (512,), "macnet": (512, 512)}


def _leaf(rng, path, shape):
    """A seeded value for one flax leaf: LeCun-normal kernels, positive
    variances, scales near 1, small biases and means."""
    name = path[-1].key
    if name == "kernel":
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    return 0.1 * rng.randn(*shape)


def flax_tree(model, seed: int = 1, x_shape=(1, 107, 107, 6)):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(x_shape)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)


def port_model(name: str, params):
    port = TOPOLOGIES[name][1]()
    port.load_state_dict(mdnet_state_dict_from_flax(params["params"]))
    return port.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jax_model, _, _) in TOPOLOGIES.items():
        jm = jax_model()
        params = flax_tree(jm)
        out[name] = (jm, params, port_model(name, params))
    return out


def crops(n=3, seed=0):
    """Crops on the tracker's input scale (0..255 - 128), NHWC."""
    return np.random.RandomState(seed).uniform(-128, 127, (n, 107, 107, 6)).astype(np.float32)


def chw(feats: np.ndarray, blocks) -> np.ndarray:
    """JAX's (N, S, D) HWC-flattened features in the port's CHW order."""
    n, s, d = feats.shape
    eye = np.eye(d, dtype=np.float32)
    return (feats.reshape(n * s, d) @ _hwc_rows_to_chw(eye, blocks)).reshape(n, s, d)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("style", ["torch", "manet"])
def test_lrn_matches_jax(style):
    x = (50 * np.random.RandomState(1).randn(2, 7, 5, 96)).astype(np.float32)
    want = np.asarray(jmd.lrn(jnp.asarray(x), style=style))
    got = mdnet.lrn(nchw(x), style=style).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_features_and_logits_match_jax(models, name):
    jm, params, port = models[name]
    x = crops(2)
    j_feats = np.asarray(jax.jit(partial(jm.apply, method=type(jm).extract_features))(
        params, jnp.asarray(x)))
    j_logits = np.asarray(jax.jit(partial(jm.apply, method=type(jm).score))(
        params, jnp.asarray(j_feats)))
    want = chw(j_feats, BLOCKS[name])
    with torch.no_grad():
        feats = port.extract_features(nchw(x)).numpy()
        logits = port.score(torch.from_numpy(feats)).numpy()
        same_feats = port.score(torch.from_numpy(want)).numpy()
    assert feats.shape == want.shape == (2, port.streams, want.shape[2])
    assert np.abs(feats - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(same_feats - j_logits).max() <= 1e-4
    assert np.abs(logits - j_logits).max() <= 1e-4 * np.abs(j_logits).max()


class KeyDraws:
    """Bernoulli masks and key arithmetic with JAX's own keys."""

    def split(self, key, n=2):
        return list(jax.random.split(key, n))

    def fold_in(self, key, data):
        return jax.random.fold_in(key, data)

    def bernoulli(self, key, p, shape):
        return torch.from_numpy(np.array(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("name", ["dual", "dual_sum", "apfnet", "macnet"])
def test_training_dropout_follows_jax_keys(models, name):
    """The training forward's dropout masks drawn with JAX's keys (MDNet:
    key and fold_in(key, 6); APFNet: split(key); DAFNet / MaCNet:
    fold_in(key, 5) and fold_in(key, 6)) give JAX's training logits."""
    jm, params, port = models[name]
    d = 9 * sum(BLOCKS[name]) + (256 if name == "macnet" else 0)
    feats = np.random.RandomState(2).randn(5, port.streams, d).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jm.apply(params, jnp.asarray(feats), 0, True, key, method=type(jm).score))
    keep = port.dropout_masks(KeyDraws(), key, 5)
    with torch.no_grad():
        got = port.score(torch.from_numpy(chw(feats, BLOCKS[name])), 0, keep).numpy()
    assert np.abs(got - want).max() <= 1e-4


@pytest.fixture(scope="module")
def gnet_pair():
    jg = jvital.GNet()
    tree = flax_tree(jg, seed=4, x_shape=(1, 4608))
    port = vital.GNet()
    port.load_state_dict(gnet_state_dict_from_flax(tree["params"]))
    return jg, tree, port.eval()


def test_gnet_masks_match_jax(models, gnet_pair):
    """GNet, apply_mask and hardest_fixed_mask through the layout
    permutation; g_loss on the dual model's scores."""
    jg, tree, port = gnet_pair
    rng = np.random.RandomState(5)
    f = np.abs(rng.randn(6, 4608)).astype(np.float32)
    f_chw = chw(f[:, None], (512,))[:, 0]
    want = np.asarray(jg.apply(tree, jnp.asarray(f)))
    with torch.no_grad():
        got = port(torch.from_numpy(f_chw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    mask = rng.uniform(0, 1, (6, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        vital.apply_mask(torch.from_numpy(f_chw), torch.from_numpy(mask)).numpy(),
        chw(np.asarray(jvital.apply_mask(jnp.asarray(f), jnp.asarray(mask)))[:, None],
            (512,))[:, 0], rtol=0, atol=0)

    jm, params, pm = models["dual_sum"]
    f2 = np.abs(rng.randn(6, 2, 4608)).astype(np.float32)

    def j_score(flat):
        return jm.apply(params, jnp.stack([flat, flat], 1), method=type(jm).score)

    def p_score(flat):
        return pm.score(torch.stack([flat, flat], 1))

    with torch.no_grad():
        got_mask = vital.hardest_fixed_mask(p_score, torch.from_numpy(chw(f2, (512,))[:, 0]))
        got_loss = float(vital.g_loss(port, None, p_score, torch.from_numpy(chw(f2, (512,))[:, 0])))
    want_mask = np.asarray(jvital.hardest_fixed_mask(j_score, jnp.asarray(f2[:, 0])))
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    want_loss = float(jvital.g_loss(tree, jg, j_score, jnp.asarray(f2[:, 0])))
    assert abs(got_loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))


@pytest.mark.parametrize("name", ["single", "dual", "adapter", "apfnet"])
def test_state_dict_round_trips_through_jax_converter(models, name):
    """The port's names are the reference's: JAX's own converter reads the
    port's state_dict back to the flax tree, every leaf, exactly."""
    _, params, port = models[name]
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = jax.tree.map(np.asarray, TOPOLOGIES[name][2](sd))
    want = params["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_flax_npz_loads_through_run_ope(models, name, tmp_path):
    """A flax .npz of each topology reaches the port through run_ope's
    loader (the 'mdnet' family's bridge), the topology from its keys."""
    _, params, port = models[name]
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, params=np.asarray(params["params"], dtype=object))
    sd = load_checkpoint(path, "mdnet")
    fresh = TOPOLOGIES[name][1]()
    fresh.load_state_dict(sd)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---------------------------------------------------------------- registry

MDNET_RECIPES = {"mdnet": ("single", "concat"), "pymdnet": ("dual", "concat"),
                 "pyvital": ("dual", "sum"), "manet": ("adapter", "concat"),
                 "apfnet": apfnet.APFNet, "dafnet": rgbt_fusion.DAFNet,
                 "macnet": rgbt_fusion.MaCNet}


def test_registry_mdnet_recipes_match_jax():
    """The seven recipes build on the CPU with JAX's modality, family,
    composition and runtime (the JAX build given weights compiles nothing),
    their networks of the recipe's kind, the trainable leaves fc4-fc6."""
    for name, kind in MDNET_RECIPES.items():
        r, j = registry.TRACKER_REGISTRY[name], JAX_REGISTRY[name]
        assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
        tracker = registry.build_tracker(name, device="cpu")
        jax_rt = j.build(params={}).rt
        assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jax_rt), name
        model = tracker.model
        if isinstance(kind, tuple):
            assert (model.mode, model.fc6_merge) == kind, name
        else:
            assert type(model) is kind, name
        assert [model._fc_layer(n) for n in model.fc_names()][::2] == ["fc4", "fc5", "fc6_0"
                                                                        if isinstance(kind, tuple)
                                                                        or kind is apfnet.APFNet
                                                                        else "fc6"]
        assert (tracker.gnet is not None) == (name == "pyvital")


@pytest.mark.parametrize("name", ["atom", "apfnet"])
def test_seeded_weights_depend_on_the_seed_alone(name):
    """A recipe's seeded weights are the same whatever torch's global
    generator holds (init_weights zeroes the biases torch's own layers
    draw from it; ATOM's IoUNet has three)."""
    sds = []
    for state in (0, 1):
        torch.manual_seed(state)
        sds.append(registry.build_tracker(name, device="cpu").model.state_dict())
    for k, v in sds[0].items():
        assert torch.equal(v, sds[1][k]), k
