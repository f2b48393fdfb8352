"""The DiMP family's modules in the port (models/dimp.py, ops/augment.py,
the weight bridge) against the JAX package at f32.

The flax trees' shapes come from jax.eval_shape of DiMPNet's init at 64 px
(no compile); their values from a numpy seed, except the filter
optimizers' leaves, which keep the values of JAX's own init. They reach
the port through mmtrack_torch.models.convert.dimp_state_dict_from_flax.
JAX runs eagerly (each primitive compiled once), which is faster here
than one jit of a dual ResNet-50 per merge.

Bars, each the largest difference over the largest |JAX value| of the
array: the primitives, apply_feat_transpose against jax.vjp and the three
filter optimizers (1, 2 and 10 iterations with sample weights) within
1e-5; FilterInitializer, the IoUNet (modulation, IoU and its gradient in
the boxes) and extract_backbone with its classification features for
all five merges within 1e-4; the augmentations' 13 patches within 1e-5 on
JAX's uniforms, their shifts and the dropout copies exact (the latter
against the jitted function, as the JAX init runs it). A tensor
num_iter of 0 leaves the weights bit-equal and a tensor num_iter runs the
int loop's iterations bit-equal. The port state_dict goes back through
JAX's convert_dimp_checkpoint to the flax tree leaf for leaf; the only
leaves it lacks are the trunks' layer4, which DiMP never reads.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import dimp as jd  # noqa: E402
from mmtrack_tpu.models.convert import convert_dimp_checkpoint, load_into  # noqa: E402
from mmtrack_tpu.ops import augment as jaug  # noqa: E402
from mmtrack_torch.models import dimp  # noqa: E402
from mmtrack_torch.models.convert import dimp_state_dict_from_flax  # noqa: E402
from mmtrack_torch.ops import augment  # noqa: E402

KINDS = {  # tree name -> (JAX model, port model)
    "det_conv": (lambda: jd.DiMPNet(merge_type="conv"), lambda: dimp.DiMPNet(merge_type="conv")),
    "dimp": (lambda: jd.DiMPNet(), lambda: dimp.DiMPNet()),
    "prdimp": (jd.build_prdimp50, dimp.build_prdimp50),
    "hinge": (jd.build_super_dimp50, dimp.build_super_dimp50),
}


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"max |diff| / max |want| = {err:.3g} > {rel}"


def _leaf(rng, path, shape):
    """LeCun-normal kernels, scales near 1, positive variances, small biases
    and means."""
    name = path[-1].key
    if name == "kernel":
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    return 0.1 * rng.randn(*shape)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(module, *args):
    return _np_tree(module.init(jax.random.PRNGKey(0), *args)["params"])


def optimizer_init(kind: str) -> dict:
    """The filter optimizer's leaves as JAX's init makes them."""
    w, feat = jnp.zeros((4, 4, 8)), jnp.ones((1, 5, 5, 8))
    bb = jnp.asarray([[20.0, 20.0, 30.0, 30.0]])
    if kind == "hinge":
        return _jax_init(jd.SteepestDescentHinge(num_iter=1), w, feat, jnp.zeros((1, 6, 6)))
    opt = jd.SteepestDescentNewtonKL if kind == "prdimp" else jd.SteepestDescentGN
    return _jax_init(opt(num_iter=1), w, feat, bb)


def flax_tree(kind: str, seed: int = 0) -> dict:
    """{'params': ...} of a DiMPNet of `kind`: shapes from eval_shape of the
    init, numpy-seeded values, JAX's init for the filter optimizer."""
    jm = KINDS[kind][0]()
    im = jnp.zeros((1, 64, 64, 6))
    bb = jnp.asarray([[16.0, 16.0, 24.0, 24.0]])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), im, im, bb,
                                            jnp.stack([bb, bb], axis=1)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    params["params"]["filter_optimizer"] = optimizer_init(kind)
    return params


def strip_merge(params: dict) -> dict:
    """The conv tree without its merge convolutions: the tree of the other merges."""
    return {"params": {k: v for k, v in params["params"].items() if not k.startswith("merge")}}


def port_model(kind_or_merge, params: dict):
    if kind_or_merge in KINDS:
        m = KINDS[kind_or_merge][1]()
    else:
        m = dimp.DiMPNet(merge_type=kind_or_merge)
    m.load_state_dict(dimp_state_dict_from_flax(params["params"]))
    return m.eval()


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = flax_tree(kind)
        return cache[kind]
    return get


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- primitives

def test_primitives_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 6, 8).astype(np.float32)
    close(dimp.instance_l2_norm(T(x), 0.3), jd.instance_l2_norm(jnp.asarray(x), 0.3), 1e-5)
    for fsz in (4, 3):
        w = rng.randn(fsz, fsz, 8).astype(np.float32)
        got = dimp.apply_filter(T(x), T(w))
        assert got.shape == (3, 5 + (fsz + 1) % 2, 6 + (fsz + 1) % 2)
        close(got, jd.apply_filter(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    c = rng.uniform(-1, 9, (3, 2)).astype(np.float32)
    close(dimp.distance_map(T(c), (7, 9), 100, 0.1),
          jd.distance_map(jnp.asarray(c), (7, 9), 100, 0.1), 1e-5)
    s, a = rng.randn(2, 7, 7).astype(np.float32), rng.uniform(0, 1, (2, 7, 7)).astype(np.float32)
    s[0, 0, 0] = 0.0                                                  # sign(0) = 0 in both
    close(dimp.leaky_relu_par(T(s), T(a)), jd.leaky_relu_par(jnp.asarray(s), jnp.asarray(a)), 1e-6)
    close(dimp.leaky_relu_par_deriv(T(s), T(a)),
          jd.leaky_relu_par_deriv(jnp.asarray(s), jnp.asarray(a)), 1e-6)


@pytest.mark.parametrize("fsz", [4, 3])
def test_apply_feat_transpose_matches_vjp(fsz):
    """The filter gradient against jax.vjp of apply_filter; the even
    kernel's extra output row and column are part of the residuals."""
    rng = np.random.RandomState(fsz)
    feat = rng.randn(5, 9, 9, 16).astype(np.float32)
    w = rng.randn(fsz, fsz, 16).astype(np.float32)
    out = 9 + (fsz + 1) % 2
    res = rng.randn(5, out, out).astype(np.float32)
    _, vjp = jax.vjp(lambda w_: jd.apply_filter(jnp.asarray(feat), w_), jnp.asarray(w))
    (want,) = vjp(jnp.asarray(res))
    got = dimp.apply_feat_transpose(T(feat), T(res), (fsz, fsz))
    assert got.shape == (fsz, fsz, 16)
    close(got, want, 1e-5)


def _opt_problem(seed=0, N=5, H=9, C=16):
    """Features with a target direction inside each box, boxes in crop
    pixels (stride 16), sample weights, an initial filter and Gaussian
    labels for the hinge."""
    rng = np.random.RandomState(seed)
    feat = 0.3 * rng.randn(N, H, H, C).astype(np.float32)
    v = rng.randn(C).astype(np.float32)
    boxes = []
    for i in range(N):
        cy, cx = H // 2 + rng.randint(-2, 3), H // 2 + rng.randint(-2, 3)
        feat[i, cy - 1:cy + 2, cx - 1:cx + 2] += v / np.linalg.norm(v)
        boxes.append([(cx - 1.5) * 16, (cy - 1.5) * 16, 48.0, 48.0])
    sw = rng.uniform(0.2, 1.0, N).astype(np.float32)
    w0 = 0.1 * rng.randn(4, 4, C).astype(np.float32)
    k = np.arange(H + 1, dtype=np.float32) - H / 2
    label = np.exp(-0.5 * (k[None, :, None] ** 2 + k[None, None, :] ** 2) / 2.0)
    label = np.repeat(label, N, axis=0).astype(np.float32)
    return feat, np.asarray(boxes, np.float32), sw / sw.sum(), w0, label


OPTIMIZERS = {
    "gn": (jd.SteepestDescentGN, dimp.SteepestDescentGN, "dimp"),
    "newton_kl": (jd.SteepestDescentNewtonKL, dimp.SteepestDescentNewtonKL, "prdimp"),
    "hinge": (jd.SteepestDescentHinge, dimp.SteepestDescentHinge, "hinge"),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("num_iter", [1, 2, 10])
def test_optimizers_match_jax(name, num_iter):
    jcls, pcls, kind = OPTIMIZERS[name]
    feat, boxes, sw, w0, label = _opt_problem()
    target = label if name == "hinge" else boxes
    want = jcls(num_iter=num_iter).apply({"params": optimizer_init(kind)}, jnp.asarray(w0),
                                          jnp.asarray(feat), jnp.asarray(target),
                                          jnp.asarray(sw))
    opt = pcls(num_iter=num_iter)
    with torch.no_grad():
        got = opt(T(w0), T(feat), T(target), T(sw))
        masked = opt(T(w0), T(feat), T(target), T(sw), torch.tensor(num_iter), 10)
    close(got, want, 1e-5)
    assert torch.equal(masked, got)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_without_iterations_is_identity(name):
    _, pcls, _ = OPTIMIZERS[name]
    feat, boxes, sw, w0, label = _opt_problem(seed=1)
    target = label if name == "hinge" else boxes
    with torch.no_grad():
        got = pcls(num_iter=5)(T(w0), T(feat), T(target), T(sw), torch.tensor(0), 2)
        plain = pcls(num_iter=5)(T(w0), T(feat), T(target), None, 0)
    assert torch.equal(got, T(w0)) and torch.equal(plain, T(w0))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_parameters_are_jax_init(name):
    """The port's constructor values are JAX's init: the seeded recipes
    keep them (init_dimp_weights)."""
    _, pcls, kind = OPTIMIZERS[name]
    want = optimizer_init(kind)
    sd = dimp_state_dict_from_flax({"filter_optimizer": want})
    got = {k.replace("classifier.filter_optimizer.", ""): v for k, v in sd.items()}
    port = pcls().state_dict()
    assert set(got) == set(port)
    for k, v in port.items():
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    model = dimp.init_dimp_weights(KINDS[kind][1](), 3)
    for k, v in model.classifier.filter_optimizer.state_dict().items():
        assert torch.equal(v, port[k]), k


# ---------------------------------------------------------------- networks

def _image(seed=0, B=2, S=64):
    return np.random.RandomState(seed).randn(B, S, S, 6).astype(np.float32)


@pytest.mark.parametrize("merge", dimp.MERGE_MODES)
def test_extract_backbone_matches_jax(trees, merge):
    params = trees("det_conv")
    if merge != "conv":
        params = strip_merge(params)
    jm, port = jd.DiMPNet(merge_type=merge), port_model(merge, params)
    im = _image()
    want = jm.apply(params, jnp.asarray(im), method="extract_backbone")
    want_clf = jm.apply(params, want, method="extract_classification_feat")
    with torch.no_grad():
        got = port.extract_backbone(T(im))
        got_clf = port.extract_classification_feat(got)
    for k in ("layer2", "layer3"):
        close(got[k], want[k], 1e-4)
    close(got_clf, want_clf, 1e-4)


def test_single_backbone_reads_rgb_only(trees):
    params = trees("dimp")
    port = port_model("dimp", params)
    im = _image(1)
    want = jd.DiMPNet().apply(params, jnp.asarray(im), method="extract_backbone")
    other = im.copy()
    other[..., 3:] = 7.0
    with torch.no_grad():
        got, same = port.extract_backbone(T(im)), port.extract_backbone(T(other))
    close(got["layer3"], want["layer3"], 1e-4)
    assert torch.equal(got["layer3"], same["layer3"])


def _clf_inputs(seed=2, N=3, S=64):
    rng = np.random.RandomState(seed)
    feat = rng.randn(N, S // 16, S // 16, 512).astype(np.float32)
    bb = np.stack([rng.uniform(4, 20, N), rng.uniform(4, 20, N), rng.uniform(16, 36, N),
                   rng.uniform(16, 36, N)], 1).astype(np.float32)
    return feat, bb


def test_filter_initializer_matches_jax(trees):
    params = trees("dimp")
    port = port_model("dimp", params)
    feat, bb = _clf_inputs()
    want = jd.DiMPNet().apply(params, jnp.asarray(feat), jnp.asarray(bb), method="get_filter")
    with torch.no_grad():
        got = port.get_filter(T(feat), T(bb))
    assert got.shape == (4, 4, 512)
    close(got, want, 1e-4)


def test_iou_net_and_its_box_gradient_match_jax(trees):
    """Modulation, IoU features, predict_iou and d(sum IoU)/d(proposals)."""
    params = trees("dimp")
    port = port_model("dimp", params)
    rng = np.random.RandomState(3)
    f2 = rng.randn(1, 16, 16, 512).astype(np.float32)
    f3 = rng.randn(1, 8, 8, 1024).astype(np.float32)
    t2 = rng.randn(1, 16, 16, 512).astype(np.float32)
    t3 = rng.randn(1, 8, 8, 1024).astype(np.float32)
    bb = np.asarray([[30.0, 34.0, 50.0, 40.0]], np.float32)
    props = (bb[:, None] + rng.uniform(-8, 8, (1, 6, 4))).astype(np.float32)
    jm = jd.DiMPNet()

    def jax_iou(p, props_):
        mod = jm.apply(p, [jnp.asarray(f2), jnp.asarray(f3)], jnp.asarray(bb),
                       method=lambda m, f, b: m.bb_regressor.get_modulation(f, b))
        feat = jm.apply(p, [jnp.asarray(t2), jnp.asarray(t3)],
                        method=lambda m, f: m.bb_regressor.get_iou_feat(f))
        return jm.apply(p, mod, feat, props_,
                        method=lambda m, a, b, c: m.bb_regressor.predict_iou(a, b, c))

    want = jax.jit(lambda x: jax_iou(params, x))(jnp.asarray(props))
    want_g = jax.jit(jax.grad(lambda x: jax_iou(params, x).sum()))(jnp.asarray(props))
    net = port.bb_regressor
    with torch.no_grad():
        mod = net.get_modulation([T(f2), T(f3)], T(bb))
        feat = net.get_iou_feat([T(t2), T(t3)])
    x = T(props).requires_grad_(True)
    got = net.predict_iou(mod, feat, x)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    close(got.detach(), want, 1e-4)
    close(got_g, want_g, 1e-4)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_state_dict_goes_back_through_jax_converter(trees, kind):
    """convert_dimp_checkpoint(port state_dict) is the flax tree leaf for
    leaf; the trunks' layer4 leaves are all it lacks."""
    params = _np_tree(trees(kind)["params"])
    port = port_model(kind, {"params": params})
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, missing, unexpected = load_into(params, convert_dimp_checkpoint(sd))
    assert not unexpected
    assert missing and all(k[0] in ("backbone", "backbone_x") and k[1].startswith("layer4_")
                           for k in missing)
    back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        if not path[1].key.startswith("layer4_"):
            np.testing.assert_array_equal(np.asarray(back[path]), leaf)


# ---------------------------------------------------------------- augmentation

@pytest.mark.parametrize("factor", [1.0 / 3.0, 3.0])
def test_init_augmentations_match_jax(factor):
    """13 patches and their shifts on JAX's uniforms; factor 3 moves some
    windows past the patch, where dynamic_slice and the rotation's index
    clamp take over."""
    S, C = 48, 6
    expanded = np.random.RandomState(4).randn(2 * S, 2 * S, C).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_p, want_s = jaug.dimp_init_augmentations(jnp.asarray(expanded), S, key,
                                                  random_shift_factor=factor)
    u = np.asarray(jax.random.uniform(key, (augment.num_random_shifts(), 2)))
    got_p, got_s = augment.dimp_init_augmentations(T(expanded), S, T(u),
                                                   random_shift_factor=factor)
    assert got_p.shape == (augment.num_image_augmentations(), S, S, C) == want_p.shape
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    for i in range(got_p.shape[0]):
        close(got_p[i], want_p[i], 1e-5)
    if factor > 1:
        assert np.abs(np.asarray(want_s)).max() > S // 2       # a window was clamped


def test_feature_dropout_matches_jax_bernoulli():
    feat = np.random.RandomState(6).randn(5, 5, 64).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(jaug.feature_dropout, static_argnums=(2, 3))(jnp.asarray(feat), key, 2, 0.2)
    u = np.asarray(jax.random.uniform(key, (2, 1, 1, 64)))
    got = augment.feature_dropout(T(feat), T(u), 0.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got[:, 0, 0] == 0).sum()) < 128


def test_rotation_weights_come_from_the_unclamped_coordinate():
    """mode='nearest' clamps the tap index, not the coordinate: at a
    coordinate past the edge the two taps read the same edge pixel with
    weights 1 - t and t, which sum to the edge value."""
    E = 8
    expanded = torch.arange(E * E, dtype=torch.float32).reshape(E, E, 1)
    out = augment._rotated_window(expanded, 4, 45.0, (20, 20))
    want = jaug._rotated_window(jnp.asarray(expanded.numpy()), 4, 45.0, (20, 20))
    close(out, want, 1e-6)
    assert math.isfinite(float(out.sum()))
