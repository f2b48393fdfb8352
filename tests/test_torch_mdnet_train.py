"""MDNet training in the port (ops/crop.py::crop_resize, the patch boxes,
patches and step of train/zoo_actors.py) against the JAX package's
(ops/crop.py::crop_resize, train/zoo_actors.py:176-243) at f32.

The crop: bit-equal to JAX's on a 0..255 float frame, boxes inside,
across each edge and below one pixel, at MDNet's context factor (139 /
107, rounded to f32 where JAX rounds it) and at 2.0. The box draw: JAX's
own normal draws of a key (rngs per sample, then positive / negative,
then centre / scale, as JAX splits them) given to the port; the boxes
within 4 ulps of JAX's (exp differs by an ulp between XLA and PyTorch),
read out of JAX's step by a stand-in crop that writes its box into the
patch. The patches on JAX's boxes: bit-equal.

One step of MDNet-dual at full width (VGG-M, fc6 on the concatenated
streams; the flax tree of tests/test_torch_mdnet.py, from a numpy seed)
on a 96-px search with 2 positive and 4 negative patches, B = 1, JAX's
step jitted with its key, the port's given JAX's draws. Bars, those of
tests/test_torch_dimp_train.py::assert_step_matches: loss and accuracy
within 1e-5 relative, every leaf within 1e-5 relative L2, at most one
element in a thousand past a tenth of the learning rate and none past
two.

A comparison tests the port only where neither input noise nor f32
rounding decides the step, so before JAX the port's step is held to
itself under a 1e-7 change of the search crops and to its own f64
evaluation (the same patches, loss and update in f64), both within the
bars. Two things decide a step otherwise. A patch that reads the crop's
zero padding holds constant regions whose max-pool windows tie in exact
arithmetic, and each side's rounding picks the cell that takes the
gradient (APFNet's f32 step at 6 such patches is 7 % of its largest
conv2 gradient from its f64 evaluation; the padding does not move under
the 1e-7 change): the steps' patches stay inside the search crop.
And Adam's first step (lr x sign(g)) turns a gradient within rounding of
zero into a whole-lr difference; one such element is already 2e-5 of
MDNet's trained norm (43), past the relative L2 bar. At the batch seeds
10, 13 and 15 JAX's f32 step flips such elements against the f64
evaluation (5.8e-5, 1.6e-5 and 1.2e-5 relative L2) where the port's
flips none: seed 11 tests the port.
APFNet's steps use the same step
(tests/test_torch_apfnet_train.py).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import mdnet as jmd  # noqa: E402
from mmtrack_tpu.ops import crop as jax_crop  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_tpu.train import zoo_actors as jax_zoo  # noqa: E402
from mmtrack_torch.models import mdnet  # noqa: E402
from mmtrack_torch.models.convert import mdnet_state_dict_from_flax  # noqa: E402
from mmtrack_torch.ops.crop import crop_resize  # noqa: E402
from mmtrack_torch.train import zoo_actors  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer  # noqa: E402
from mmtrack_torch.train.train_step import TrainState, apply_update  # noqa: E402
from test_torch_dimp_train import LR, WD, assert_step_matches  # noqa: E402
from test_torch_mdnet import flax_tree  # noqa: E402

SEARCH = 96
B = 2
N_POS, N_NEG = 4, 12


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def frame(seed, h=SEARCH, w=SEARCH, c=6):
    """A frame on the unnormalised crop's scale (floats, not integers)."""
    return np.random.RandomState(seed).uniform(-30, 280, (h, w, c)).astype(np.float32)


EDGE_BOXES = np.array([[30.2, 20.7, 25.3, 31.9],      # inside
                       [-12.4, 40.1, 30.0, 22.5],     # across the left edge
                       [70.6, -9.3, 28.8, 26.1],      # across the top
                       [80.5, 61.2, 33.3, 40.7],      # across the right and bottom
                       [-50.0, -60.0, 20.0, 20.0],    # outside
                       [47.9, 51.1, 0.4, 0.7],        # below one pixel: side 1
                       [10.0, 5.0, 120.0, 90.0]],     # wider than the frame
                      np.float32)


@pytest.mark.parametrize("factor", [zoo_actors.MDNET_CONTEXT, 2.0])
def test_crop_resize_bit_equal_to_jax(factor):
    img = frame(0, 90, 110)
    want = jax.vmap(lambda b: jax_crop.crop_resize(jnp.asarray(img), b, factor, 107))(
        jnp.asarray(EDGE_BOXES))
    got, rf = crop_resize(T(img)[None], T(EDGE_BOXES)[None], factor, 107)
    assert got.shape == (1, len(EDGE_BOXES), 107, 107, 6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(rf[0].numpy(), np.asarray(want[1]))
    assert (got[0, 4] == 0).all() and (got[0, 0] != 0).all()


def jax_box_noise(key, b=B, n_pos=N_POS, n_neg=N_NEG):
    """JAX's normal draws of make_mdnet_train_step's key, as
    mdnet_box_noise lays them out."""
    out = {"pos": ([], []), "neg": ([], [])}
    for r in jax.random.split(key, b):
        for sign, rr, n in zip(("pos", "neg"), jax.random.split(r), (n_pos, n_neg)):
            rc, rs = jax.random.split(rr)
            out[sign][0].append(np.asarray(jax.random.normal(rc, (n, 2))))
            out[sign][1].append(np.asarray(jax.random.normal(rs, (n, 1))))
    return {k: (np.stack(c), np.stack(s)) for k, (c, s) in out.items()}


def _boxes_as_patches(image, box, factor, out_size):
    """A stand-in for JAX's crop_resize whose patch holds its box."""
    return jnp.zeros((out_size, out_size, image.shape[-1])).at[0, 0, :4].set(box), 1.0


def annos(seed, b=B):
    rng = np.random.RandomState(seed)
    wh = rng.uniform(0.1, 0.4, (b, 2))
    return np.concatenate([rng.uniform(0.1, 0.5, (b, 2)), wh], 1).astype(np.float32)


def test_box_draw_from_jax_normals(monkeypatch):
    """The port's boxes from JAX's draws within 4 ulps of the boxes JAX's
    step crops at; the draws' layout is mdnet_box_noise's."""
    key = jax.random.PRNGKey(5)
    anno = annos(1, b=3)
    monkeypatch.setattr(jax_zoo, "crop_resize", _boxes_as_patches)
    raw = jnp.zeros((3, SEARCH, SEARCH, 6))
    patches, labels = jax.vmap(lambda img, a, r: jax_zoo.mdnet_training_patches(
        img, a, r, N_POS, N_NEG))(raw, jnp.asarray(anno), jax.random.split(key, 3))
    want = np.asarray(patches)[:, :, 0, 0, :4]
    noise = jax_box_noise(key, b=3)
    got = zoo_actors.mdnet_sample_boxes(T(anno), SEARCH, {k: (T(c), T(s))
                                                          for k, (c, s) in noise.items()})
    assert got.shape == (3, N_POS + N_NEG, 4)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=4)
    np.testing.assert_array_equal(np.asarray(labels)[0], [1] * N_POS + [0] * N_NEG)
    gen = torch.Generator().manual_seed(0)
    draw = zoo_actors.mdnet_box_noise(gen, 3, N_POS, N_NEG, "cpu")
    assert {k: tuple(t.shape for t in v) for k, v in draw.items()} == {
        k: tuple(a.shape for a in v) for k, v in noise.items()}


def test_patches_bit_equal_on_jax_boxes(monkeypatch):
    """JAX's patches of a key, and the port's patches at the boxes JAX
    cropped them at."""
    key = jax.random.PRNGKey(6)
    anno = annos(2)
    raw = np.stack([frame(3), frame(4)])
    run = jax.vmap(lambda img, a, r: jax_zoo.mdnet_training_patches(img, a, r, N_POS, N_NEG)[0])
    args = (jnp.asarray(raw), jnp.asarray(anno), jax.random.split(key, B))
    want = np.asarray(run(*args))
    monkeypatch.setattr(jax_zoo, "crop_resize", _boxes_as_patches)
    boxes = np.asarray(run(*args))[:, :, 0, 0, :4]
    got = zoo_actors.mdnet_training_patches(T(raw), T(boxes))
    assert got.shape == (B * (N_POS + N_NEG), 107, 107, 6)
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))


def search_batch(seed, b=1, search=SEARCH):
    """A loader batch: normalised search crops, and normalised boxes of 8-12
    % of the side near the centre, around which every patch of the step
    tests stays inside the search crop."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(0.08, 0.12, (b, 2))
    xy = 0.5 - wh / 2 + rng.uniform(-0.02, 0.02, (b, 2))
    return {"template": rng.randn(b, 32, 32, 6).astype(np.float32),
            "search": rng.randn(b, search, search, 6).astype(np.float32),
            "search_anno": np.concatenate([xy, wh], 1).astype(np.float32)}


def assert_port_stable(port_step, batch, trained, keys=("search",)):
    """`port_step(batch) -> (stats, state_dict after, state_dict before)`
    from one fixed start; the port's step on `batch` and on `batch` with
    `keys` scaled by 1 + 1e-7 within assert_step_matches's bars: the step
    is continuous at this point, so a comparison with JAX tests something."""
    runs = [port_step({k: (v * np.float32(s)).astype(np.float32) if k in keys else v
                       for k, v in batch.items()}) for s in (1.0, 1.0 + 1e-7)]
    (s0, sd0, start), (s1, sd1, _) = runs
    assert_step_matches(s1, s0, sd1, sd0, start, trained)


def f64_step(state, batch, noise, n_pos, n_neg):
    """The MDNet-family step's f64 evaluation: the step's own f32 patches
    through the same loss and update in f64 (the model already f64)."""
    raw = zoo_actors._unnormalise(T(batch["search"])) * 255.0
    boxes = zoo_actors.mdnet_sample_boxes(T(batch["search_anno"]), raw.shape[1],
                                          {k: (T(c), T(s)) for k, (c, s) in noise.items()})
    patches = zoo_actors.mdnet_training_patches(raw, boxes).double()
    labels = torch.cat([torch.ones(n_pos), torch.zeros(n_neg)]).repeat(raw.shape[0]).double()
    logp = torch.log_softmax(state.model((patches - 128.0).permute(0, 3, 1, 2)), dim=-1)
    loss = -(labels * logp[:, 1] + (1 - labels) * logp[:, 0]).mean()
    return apply_update(state, loss, {"Loss/total": loss})[1]


def check_mdnet_step(jm, port_cls, params, batch_seed, key_seed, n_pos=2, n_neg=4,
                     mask=None, port_mask=None):
    """One step of JAX's (jitted) and the port's MDNet-family step from the
    flax tree `params` (`mask` JAX's trainable tree, `port_mask` the
    port's) on one sample of `n_pos` + `n_neg` patches, none of which
    reads the crop's padding; JAX's draws given to the port. The port
    first against itself under a 1e-7 change of the search crops and
    against its own f64 evaluation, then against JAX."""
    batch = search_batch(batch_seed)
    key = jax.random.PRNGKey(key_seed)
    noise = jax_box_noise(key, 1, n_pos, n_neg)
    boxes = zoo_actors.mdnet_sample_boxes(T(batch["search_anno"]), SEARCH,
                                          {k: (T(c), T(s)) for k, (c, s) in noise.items()})
    raw = zoo_actors._unnormalise(T(batch["search"])) * 255.0
    assert (zoo_actors.mdnet_training_patches(raw, boxes) != 0).all()
    sd = mdnet_state_dict_from_flax(params["params"])

    def port_step(b, dtype=torch.float32):
        port = port_cls()
        port.load_state_dict(sd)
        port.to(dtype)
        start = {k: v.float() for k, v in port.state_dict().items()}
        opt, sched = build_optimizer(port, lr=LR, weight_decay=WD, trainable_mask=port_mask)
        state = TrainState(port, opt, sched)
        if dtype == torch.float64:
            stats = f64_step(state, b, noise, n_pos, n_neg)
        else:
            _, stats = zoo_actors.make_mdnet_train_step(n_pos, n_neg)(state, b, noise=noise)
        return stats, {k: v.float() for k, v in port.state_dict().items()}, start

    trained = set(sd) if port_mask is None else {k for k, v in port_mask.items() if v}
    assert_port_stable(port_step, batch, trained)
    stats, got, start = port_step(batch)
    ref_stats, ref, _ = port_step(batch, torch.float64)
    assert_step_matches({"Loss/total": stats["Loss/total"]}, ref_stats, got, ref, start, trained)

    tx = jax_optim.build_optimizer(params, lr=LR, weight_decay=WD,
                                   trainable_mask=None if mask is None else {"params": mask})
    jstep = jax.jit(jax_zoo.make_mdnet_train_step(jm, tx, n_pos, n_neg))
    jstate, jstats = jstep(jax_train_step.TrainState.create(params, tx),
                           {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want = mdnet_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    assert set(stats) == {"Loss/total", "Acc"} and np.isfinite(float(stats["Loss/total"]))
    assert_step_matches(stats, jstats, got, want, start, trained)


def test_mdnet_dual_step_matches_jax():
    jm = jmd.MDNet(mode="dual")
    check_mdnet_step(jm, lambda: mdnet.MDNet("dual"), flax_tree(jm), 11, 21)
