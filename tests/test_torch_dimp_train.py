"""DiMP training in the port (train/dimp_actor.py, DiMPNet's training
forward, lb_hinge_loss) against the JAX package's (train/dimp_actor.py)
at f32.

The flax trees are tests/test_torch_dimp.py's: shapes from jax.eval_shape
of DiMPNet's init, values from a numpy seed, JAX's own init for the filter
optimizer; DeT-max takes DeT-conv's tree without its merge convolutions,
DiMP-50 DeT-max's without its depth trunk. JAX's trunks run and hold a
layer4, which DiMP never reads and the port does not build: its leaves
have no port counterpart.
JAX's proposal noise is `jax.random.normal` of the step's key; the port's
step is given the same draws. One optimizer step (AdamW, lr 4e-4, decay
1e-4, the global-norm clip at 0.1) of dimp and det_dimp at 96-px crops
(a 7 x 7 score map), B = 2, JAX's step jitted; det_dimp's step is in
tests/test_torch_det_dimp_train.py, which shares this file's helpers.

Bars: the label map, proposals and their IoUs, LBHinge and the
per-sequence scores within 1e-5 of the largest |JAX value|; DiMPNet's
training forward (super_dimp's, through `_train_labels`) within 1e-4; the step's
loss and stats within 1e-5 relative; the parameters after the step within
1e-5 relative L2 over all leaves, and
at most one element in a thousand further than a tenth of the learning
rate from JAX's (Adam's first step is lr x g / (|g| + eps): where a
gradient lies within both sides' rounding of zero, its sign is not
defined by the math) and none further than two learning rates.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import dimp as jd  # noqa: E402
from mmtrack_tpu.ops import losses as jax_losses  # noqa: E402
from mmtrack_tpu.train import dimp_actor as jax_actor  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_torch.models import dimp  # noqa: E402
from mmtrack_torch.models.convert import dimp_state_dict_from_flax  # noqa: E402
from mmtrack_torch.ops.losses import lb_hinge_loss  # noqa: E402
from mmtrack_torch.train import dimp_actor  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from test_torch_dimp import close, flax_tree, optimizer_init, strip_merge  # noqa: E402

LR, WD = 4e-4, 1e-4
IMAGE_SZ = 96
B = 2


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _boxes(rng, n, image_sz):
    """xywh boxes in crop pixels, inside the crop, 15-45 % of its side."""
    wh = rng.uniform(0.15, 0.45, (n, 2)) * image_sz
    xy = rng.uniform(0.05, 0.5, (n, 2)) * image_sz
    return np.concatenate([xy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("score_sz,image_sz", [(19, 288), (7, 96), (18, 288)])
def test_gaussian_label_map_matches_jax(score_sz, image_sz):
    bb = _boxes(np.random.RandomState(score_sz), 5, image_sz)
    want = jax.jit(jax_actor.gaussian_label_map, static_argnums=(1, 2))(
        jnp.asarray(bb), score_sz, image_sz)
    got = dimp_actor.gaussian_label_map(T(bb), score_sz, image_sz)
    assert got.shape == (5, score_sz, score_sz)
    close(got, want, 1e-5)


def test_make_proposals_match_jax():
    """The proposals and IoUs from JAX's own draws of a key, given to the
    port as its noise; sizes below 1 are raised to 1 on both sides."""
    bb = _boxes(np.random.RandomState(1), 4, 288)
    bb[0, 2:] = [1.0, 1.2]                       # jitter pushes sizes below 1
    key = jax.random.PRNGKey(3)
    props, ious = jax.jit(jax_actor.make_proposals)(key, jnp.asarray(bb))
    noise = np.asarray(jax.random.normal(key, (4, dimp_actor.N_PROPOSALS, 4)))
    got_p, got_iou = dimp_actor.make_proposals(T(bb), T(noise))
    close(got_p, props, 1e-6)
    close(got_iou, ious, 1e-5)
    assert (got_p[..., 2:] == 1.0).any() and (np.asarray(props)[..., 2:] == 1.0).any()
    gen = torch.Generator().manual_seed(0)
    assert dimp_actor.proposal_noise(gen, 4, "cpu").shape == noise.shape


def test_lb_hinge_loss_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(3, 7, 7).astype(np.float32)
    label = np.exp(-rng.uniform(0, 6, (3, 7, 7))).astype(np.float32)
    label[0, 0, :3] = [0.05, 0.0499, 0.0]        # the threshold and below
    got = lb_hinge_loss(T(pred), T(label))
    close(got, jax_losses.lb_hinge_loss(jnp.asarray(pred), jnp.asarray(label)), 1e-6)


def det_max_tree() -> dict:
    return strip_merge(flax_tree("det_conv"))


@pytest.fixture(scope="module")
def trees():
    """DiMP-50's tree: DeT-max's without the depth trunk."""
    det = det_max_tree()
    return {"dimp": {"params": {k: v for k, v in det["params"].items() if k != "backbone_x"}}}


def _port(kind, params, model=None):
    m = model or dimp.DiMPNet(merge_type="max" if kind == "det_dimp" else None)
    m.load_state_dict(dimp_state_dict_from_flax(params["params"]))
    return m


def test_per_sequence_scores_match_jax(trees):
    """One filter per sequence: each sample's scores from its own train
    features only, equal to JAX's vmap."""
    params = trees["dimp"]
    jm = jd.DiMPNet()
    rng = np.random.RandomState(4)
    train_clf = rng.randn(3, 6, 6, 512).astype(np.float32)
    test_clf = rng.randn(3, 6, 6, 512).astype(np.float32)
    bb = _boxes(rng, 3, 96)
    want = jax.jit(lambda p, a, b, c: jax_actor.per_sequence_scores(jm, p, a, b, c))(
        params, jnp.asarray(train_clf), jnp.asarray(test_clf), jnp.asarray(bb))
    port = _port("dimp", params)
    with torch.no_grad():
        got = dimp_actor.per_sequence_scores(port, T(train_clf), T(test_clf), T(bb))
        alone = dimp_actor.per_sequence_scores(port, T(train_clf[1:2]), T(test_clf[1:2]),
                                               T(bb[1:2]))
    assert got.shape == (3, 7, 7)
    close(got, want, 1e-5)
    torch.testing.assert_close(alone[0], got[1], rtol=1e-6, atol=1e-6)


def test_training_forward_matches_jax(trees):
    """DiMPNet's training-style forward (`forward`, JAX's `__call__`) of
    super_dimp, whose hinge optimizer learns from `_train_labels`: two
    train frames as one sequence at 64 px, scores and the IoUs of three
    proposals a test frame within 1e-4 of the largest |JAX value|, the
    labels within 1e-6."""
    params = {"params": {**trees["dimp"]["params"], "filter_optimizer": optimizer_init("hinge")}}
    jm, port = jd.build_super_dimp50(), _port("dimp", params, dimp.build_super_dimp50())
    rng = np.random.RandomState(5)
    train_im, test_im = (rng.randn(2, 64, 64, 3).astype(np.float32) for _ in range(2))
    train_bb = _boxes(rng, 2, 64)
    props = np.stack([_boxes(rng, 3, 64) for _ in range(2)])
    want = jax.jit(jm.apply)(params, *map(jnp.asarray, (train_im, test_im, train_bb, props)))
    with torch.no_grad():
        got = port(T(train_im), T(test_im), T(train_bb), T(props))
        clf = port.extract_classification_feat(port.extract_backbone(T(train_im)))
        labels = port._train_labels(clf, T(train_bb))
    assert got["target_scores"].shape == (2, 5, 5) and got["iou_pred"].shape == (2, 3)
    for k in ("target_scores", "iou_pred"):
        close(got[k], want[k], 1e-4)
    want_labels = jm.apply(params, jnp.asarray(clf.numpy()), jnp.asarray(train_bb),
                           method="_train_labels")
    close(labels, want_labels, 1e-6)


def batch(seed, channels=6, b=B, image_sz=IMAGE_SZ):
    """A seeded batch as the loader gives it: normalised crops, normalised
    xywh boxes."""
    rng = np.random.RandomState(seed)
    return {"template": rng.randn(b, image_sz, image_sz, channels).astype(np.float32),
            "search": rng.randn(b, image_sz, image_sz, channels).astype(np.float32),
            "template_anno": _boxes(rng, b, 1.0),
            "search_anno": _boxes(rng, b, 1.0)}


def assert_step_matches(stats, jstats, got, want, start, trained, lr=LR):
    """The bars of one optimizer step, both packages from the same `start`
    state_dict: stats within 1e-5 relative; `got` (the port's state_dict
    after the step) against `want` (JAX's, through the bridge): the leaves
    not in `trained` unmoved in both; the trained ones within 1e-5
    relative L2, at most one element in a thousand off by more than lr / 10
    and none by more than 2 lr. (A trained leaf without gradient moves by
    AdamW's decay alone, p (1 - lr wd): at lr wd = 4e-8, below half an f32
    ulp for some values, either side may leave such an element where it
    was or move it one ulp.)"""
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)
    assert want.keys() == got.keys()
    diff2 = norm2 = 0.0
    off, n_trained = [], 0
    for k in got:
        if k not in trained:
            assert torch.equal(got[k], start[k]) and torch.equal(want[k], start[k]), k
            continue
        d = (got[k] - want[k]).abs()
        assert d.max() <= 2 * lr, (k, float(d.max()))
        off += [(k, float(v)) for v in d[d > 0.1 * lr]]
        n_trained += d.numel()
        diff2 += float((d * d).sum())
        norm2 += float((want[k] * want[k]).sum())
    assert len(off) <= n_trained // 1000, off[:20]
    assert (diff2 / norm2) ** 0.5 <= 1e-5, (diff2 / norm2) ** 0.5


def check_dimp_step(kind, params, batch_seed, key_seed):
    """One step of JAX's (jitted) and the port's dimp or det_dimp step from
    the flax tree `params` on a seeded batch, JAX's proposal noise given
    to the port, held to assert_step_matches."""
    jm = jd.DiMPNet(merge_type="max" if kind == "det_dimp" else None)
    tx = jax_optim.build_optimizer(params, lr=LR, weight_decay=WD)
    jstep = jax.jit(jax_actor.make_dimp_train_step(jm, tx, image_sz=IMAGE_SZ))
    b = batch(batch_seed)
    key = jax.random.PRNGKey(key_seed)
    jstate, jstats = jstep(jax_train_step.TrainState.create(params, tx),
                           {k: jnp.asarray(v) for k, v in b.items()}, key)
    want = dimp_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))

    port = _port(kind, params)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt, sched = build_optimizer(port, lr=LR, weight_decay=WD)
    step = dimp_actor.make_dimp_train_step(image_sz=IMAGE_SZ)
    noise = np.array(jax.random.normal(key, (B, dimp_actor.N_PROPOSALS, 4)))
    _, stats = step(TrainState(port, opt, sched), b, noise=noise)
    assert set(stats) == {"Loss/total", "Loss/iou", "Loss/clf"}
    assert all(np.isfinite(float(v)) and float(v) > 0 for v in stats.values())
    assert_step_matches(stats, jstats, port.state_dict(), want, start, set(start))


def test_dimp_step_matches_jax(trees):
    check_dimp_step("dimp", trees["dimp"], 10, 20)
