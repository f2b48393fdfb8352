"""LWL training in the port (ops/losses.py::lovasz_hinge_loss;
train/zoo_actors.py: rect_masks, lwl_adapt_batch, make_lwl_train_step,
make_lwl_box_train_step; the lwl / lwl_box branches of train/run.py)
against the JAX package's (ops/losses.py:52-76; train/zoo_actors.py:
318-348, :391-419, :472-500; tools/train.py:378-412) at f32 on the CPU.

The Lovász hinge on maps built with ties on purpose (logits on a grid of
halves, whole rows at the hinge's kink, one constant map): the gradient
bit-equal to JAX's value_and_grad, as both sort the negated errors
stably, the value within 1e-6 relative (XLA's and PyTorch's sums over a
map add in different orders). lwl_adapt_batch in both modes and at 3 and 6 channels
bit-equal to JAX's jitted one (the template's centred box a Python float
rounded to f32, the masks' f32 comparisons).

The network: LWLNet at the scripts' filter size 3 and 5 Gauss-Newton
steps, narrowed (2 filters, label encoder (4, 8, 8), decoder mdim 16, box
encoder (8, 4), as tests/test_torch_lwl.py's narrow model), its flax tree
drawn as that file draws it (numpy seed, jax.eval_shape of the init) through
models/convert.py::lwl_state_dict_from_flax, on 64-px crops. The gradient
of the Lovász loss through the learner (the reference's create_graph=True
meta-learning: the port differentiates its torch.func vjp / jvp steps),
from given backbone maps through the target model's features, the label
encoder, the five steps and the decoder, against jax.grad in f64 on both
sides, each leaf within 1e-6 of its largest magnitude; filter_reg, the
label encoder and the target model's features get theirs only through
the learner. In f32 either side sits up
to 1e-2 of a leaf's largest magnitude from the f64 gradient (five
Gauss-Newton steps), so f32 is held on the step's bars below.

One step of each script, B = 2, at f32: JAX's (tools/train.py's wrapper of
lwl_adapt_batch, jitted) and the port's, lwl at 3 channels with every
parameter trained, lwl_box at 6 channels with the box encoder alone. The
port first against itself under a 1e-7 change of the crops (Lovász's sort
must not flip a near-tie that moves the step), then against JAX with
tests/test_torch_dimp_train.py::assert_step_matches's bars: loss and stats
within 1e-5 relative, trained leaves within 1e-5 relative L2, frozen
leaves bit-unmoved on both sides. `--channels 6` builds a 6-channel conv1
on both sides.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import lwl as jl  # noqa: E402
from mmtrack_tpu.ops.losses import lovasz_hinge_loss as jax_lovasz  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_tpu.train import zoo_actors as jax_zoo  # noqa: E402
from mmtrack_torch.models import lwl as pl  # noqa: E402
from mmtrack_torch.models.convert import lwl_state_dict_from_flax  # noqa: E402
from mmtrack_torch.ops.losses import lovasz_hinge_loss  # noqa: E402
from mmtrack_torch.train import run, zoo_actors  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from test_torch_dimp_train import LR, WD, assert_step_matches  # noqa: E402
from test_torch_dimp import _leaf  # noqa: E402
from test_torch_lwl import NARROW  # noqa: E402
from test_torch_mdnet_train import assert_port_stable  # noqa: E402

S, TF, B = 64, 6.0, 2
NET = {**NARROW, "filter_size": 3, "optim_iter": 5}


# ----------------------------------------------------------------- Lovász

def tied_maps(case: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(3, 9, 11) > 0.5).astype(np.float32)
    if case == "grid":                 # logits on halves: many tied errors
        logits = np.round(rng.randn(3, 9, 11) * 2) / 2
    elif case == "kink":               # errors exactly 0 on whole rows
        logits = rng.randn(3, 9, 11)
        logits[:, :3] = 2 * labels[:, :3] - 1
    else:                              # one constant map: every error of a label tied
        logits = np.full((3, 9, 11), 0.25)
    return logits.astype(np.float32), labels


@pytest.mark.parametrize("case", ["grid", "kink", "constant"])
def test_lovasz_value_and_gradient_match_jax_with_ties(case):
    logits, labels = tied_maps(case)
    want, want_g = jax.value_and_grad(jax_lovasz)(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = lovasz_hinge_loss(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want_g))
    assert (x.grad != 0).any()


# ----------------------------------------------------------------- batches

def sampler_batch(seed: int, size: int = S) -> dict:
    """A batch as the loader gives it: 6-channel crops (B, size, size, 6),
    the search box normalised, some boxes past the crop's edges."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.1, 0.7, (B, 2))
    wh = rng.uniform(0.1, 0.5, (B, 2))
    return {"template": rng.uniform(-1, 1, (B, size, size, 6)).astype(np.float32),
            "search": rng.uniform(-1, 1, (B, size, size, 6)).astype(np.float32),
            "search_anno": np.concatenate([xy, wh], 1).astype(np.float32)}


@pytest.mark.parametrize("box_mode", [False, True])
@pytest.mark.parametrize("channels", [3, 6])
def test_lwl_adapt_batch_bit_equal_to_jax(box_mode, channels):
    batch = sampler_batch(3, 256)
    batch["search_anno"][0] = [0.25, 0.5, 0.125, 0.375]      # edges on whole pixels
    want = jax.jit(lambda b: jax_zoo.lwl_adapt_batch(b, 256, TF, box_mode,
                                                     channels=channels))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = zoo_actors.lwl_adapt_batch({k: torch.from_numpy(v) for k, v in batch.items()}, 256,
                                     TF, box_mode, channels)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    masks = got["train_masks"]
    assert ((masks == 0) | (masks == 1)).all() and (masks.sum((1, 2)) > 0).all()


# ------------------------------------------------------ the network's tree

def flax_tree(seed: int, channels: int = 3) -> dict:
    """{'params': ...} of the narrow LWLNet with its box encoder for
    `channels`-channel crops: shapes from jax.eval_shape of the inits,
    values from a numpy seed (tests/test_torch_dimp.py::_leaf), filter_reg
    0.05, as tests/test_torch_lwl.py::lwl_tree draws them."""
    jm = jl.build_lwl(**NET)
    im, m = jnp.zeros((1, S, S, channels)), jnp.zeros((1, S, S))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), im, im, m))
    bf = {f"layer{i}": jnp.zeros((1, S // 2 ** (i + 1), S // 2 ** (i + 1), 128 * 2 ** i))
          for i in range(1, 5)}
    g = S // 16
    sb = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)),
                                        jnp.zeros((1, g, g, 512)), bf, (S, S),
                                        method="mask_from_box"))
    shapes["params"]["box_label_encoder"] = sb["params"]["box_label_encoder"]
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    tree["params"]["filter_reg"] = np.full((1,), 0.05, np.float32)
    return tree


@pytest.fixture(scope="module")
def narrow_tree():
    return flax_tree(2)


def port_model(tree, channels=3, dtype=torch.float32):
    port = pl.build_lwl(in_channels=channels, **NET)
    port.load_state_dict(lwl_state_dict_from_flax(tree["params"]))
    if dtype == torch.float64:
        port.double()
        for mod in port.modules():
            if hasattr(mod, "dtype"):
                mod.dtype = torch.float64
    return port


def test_gradient_through_the_learner_matches_jax_in_f64(narrow_tree):
    """The backbone's maps are given (seeded, non-negative), so the graph
    is the target model's features, the label encoder, the five steps and
    the decoder: the Lovász loss of the test frames' segmentation."""
    rng = np.random.RandomState(1)
    bf_tr, bf_te = ({f"layer{i}": rng.uniform(0, 1, (B, S // 2 ** (i + 1), S // 2 ** (i + 1),
                                                     128 * 2 ** i)) for i in range(1, 5)}
                    for _ in range(2))
    m1, m2 = np.zeros((B, S, S)), np.zeros((B, S, S))
    m1[:, 20:40, 16:50] = 1
    m2[:, 22:44, 18:46] = 1

    def loss_fn(apply, p, bf_tr, bf_te, m1, m2, lovasz):
        feat_tr = apply(p, bf_tr, method="extract_target_model_features")
        feat_te = apply(p, bf_te, method="extract_target_model_features")
        label, sw = apply(p, m1, method="encode_labels")
        filt = apply(p, feat_tr, label, sw, method="get_filter")
        return lovasz(apply(p, filt, feat_te, bf_te, (S, S), method="segment"), m2)

    with jax.enable_x64(True):
        jm = jl.build_lwl(dtype=jnp.float64, **NET)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64), narrow_tree)
        want, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(jm.apply, p, bf_tr, bf_te, m1, m2, jax_lovasz)))(tree)
        want_g = lwl_state_dict_from_flax(jax.tree.map(np.asarray, grads["params"]))
        want = float(want)
    port = port_model(narrow_tree, dtype=torch.float64)
    T = {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in (("tr", bf_tr), ("te", bf_te))}

    def apply(_, *args, method):
        return getattr(port, method)(*args)

    got = loss_fn(apply, None, T["tr"], T["te"], torch.from_numpy(m1), torch.from_numpy(m2),
                  lovasz_hinge_loss)
    got.backward()
    assert abs(float(got.detach()) - want) <= 1e-9 * want
    through = ("target_model.", "label_encoder.")
    for k, p in port.named_parameters():
        w = want_g[k].double()
        if k.startswith(("box_label_encoder.", "feature_extractor.")):
            assert p.grad is None and not w.any(), k
            continue
        scale = float(w.abs().max())
        assert scale > 0 or not k.startswith(through), k
        assert float((p.grad - w).abs().max()) <= 1e-6 * max(scale, 1e-30), k


# -------------------------------------------------------------- the steps

def check_step(tree, script: str, channels: int, batch_seed: int):
    box_mode = script == "lwl_box"
    jm = jl.build_lwl(**NET)
    mask = None
    if box_mode:
        mask = {"params": jax.tree_util.tree_map_with_path(
            lambda path, _: path[0].key == "box_label_encoder", tree["params"])}
    tx = jax_optim.build_optimizer(tree, lr=LR, weight_decay=WD, trainable_mask=mask)
    inner = (jax_zoo.make_lwl_box_train_step if box_mode else jax_zoo.make_lwl_train_step)(jm, tx)

    def jstep(state, batch, rng):
        return inner(state, jax_zoo.lwl_adapt_batch(batch, S, TF, box_mode,
                                                    channels=channels), rng)

    batch = sampler_batch(batch_seed)
    sd = lwl_state_dict_from_flax(tree["params"])
    make = zoo_actors.make_lwl_box_train_step if box_mode else zoo_actors.make_lwl_train_step
    step = make(S, TF, channels=channels)

    def port_step(b):
        port = port_model(tree, channels)
        start = {k: v.clone() for k, v in port.state_dict().items()}
        trainable = run.zoo_trainable_mask(port, script, "")
        opt, sched = build_optimizer(port, lr=LR, weight_decay=WD, trainable_mask=trainable)
        _, stats = step(TrainState(port, opt, sched), b)
        return stats, port.state_dict(), start

    trained = ({k for k in sd if k.startswith("box_label_encoder.")} if box_mode
               else set(sd))
    assert trained and (len(trained) < len(sd)) == box_mode
    assert_port_stable(port_step, batch, trained, keys=("template", "search"))
    jstate, jstats = jax.jit(jstep)(jax_train_step.TrainState.create(tree, tx),
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(0))
    want = lwl_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    stats, got, start = port_step(batch)
    keys = {"Loss/total", "Stats/acc_box_train"} if box_mode else {"Loss/total", "Loss/segm",
                                                                   "Acc"}
    assert set(stats) == keys
    assert all(np.isfinite(float(v)) for v in stats.values()) and float(stats["Loss/total"]) > 0
    assert_step_matches(stats, jstats, got, want, start, trained)


def test_lwl_step_matches_jax(narrow_tree):
    check_step(narrow_tree, "lwl", 3, batch_seed=7)


def test_lwl_box_step_matches_jax_at_six_channels():
    tree = flax_tree(3, channels=6)
    assert tree["params"]["feature_extractor"]["conv1"]["kernel"].shape == (7, 7, 6, 64)
    assert run.build_zoo_model("lwl_box", "", 0, "meta", 6).feature_extractor.conv1.weight.shape \
        == (64, 6, 7, 7)
    check_step(tree, "lwl_box", 6, batch_seed=11)
