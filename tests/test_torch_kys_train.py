"""KYS training in the port (data: SyntheticVideoDataset(distractor=),
KYSPairProcessing, collate_pair; train/zoo_actors.py: kys_pair_adapt_batch
and the step) against the JAX package's (data/datasets.py, processing.py,
loader.py; train/zoo_actors.py:247-317, :422-442) at f32.

The data: the synthetic corpus with its crossing distractor, the two-frame
sampler (search frames at most 5 apart) through KYSPairProcessing, and
collate_pair bit-equal to JAX's from the same seed; kys_pair_adapt_batch
on that batch against JAX's jitted one: the crops and the boxes in crop
pixels bit-equal, the Gaussian labels of both search frames on the
stride-16 grid within 1e-6 of their peak (XLA's exp flushes subnormals).

The network: KYSNet's flax tree from tests/test_torch_kys.py (numpy seed,
shapes of jax.eval_shape of its init, JAX's filter-optimizer init)
through models/convert.py::kys_state_dict_from_flax. `--channels 6`
hands KYS the 6-channel crops: JAX's KYSNet, initialised on them, still
builds a 3-channel conv1, as its DiMP base reads the first three channels
(DiMPNet.extract_backbone's im[..., :3]); the port's build_kysnet does
the same, and its backbone features of 6-channel input are held to
JAX's within 1e-5 of their largest magnitude.

One step at 96-px crops (a 6 x 6 label grid, the 7 x 7 DiMP score cut to
it), B = 2, with channels 3 and 6: JAX's step (tools/train.py's wrapper of
kys_pair_adapt_batch and make_kys_train_step, jitted) and the port's, only
the predictor trainable. The port's step first against itself under a
1e-7 change of the crops, then against JAX's, with
tests/test_torch_dimp_train.py::assert_step_matches's bars: both loss
terms and the total within 1e-5 relative, the predictor's leaves within
1e-5 relative L2 (at most one element in a thousand past lr / 10, none past
2 lr), every leaf of the DiMP base bit-unmoved on both sides.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data import datasets as jax_datasets  # noqa: E402
from mmtrack_tpu.data import loader as jax_loader  # noqa: E402
from mmtrack_tpu.data import processing as jax_processing  # noqa: E402
from mmtrack_tpu.data import sampler as jax_sampler  # noqa: E402
from mmtrack_tpu.models import kys as jkys  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_tpu.train import zoo_actors as jax_zoo  # noqa: E402
from mmtrack_torch.data import datasets, loader, processing, sampler  # noqa: E402
from mmtrack_torch.models import kys  # noqa: E402
from mmtrack_torch.models.convert import kys_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train import run, zoo_actors  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from test_torch_dimp import _leaf, close, optimizer_init  # noqa: E402
from test_torch_dimp_train import LR, WD, assert_step_matches  # noqa: E402
from test_torch_mdnet_train import assert_port_stable  # noqa: E402

S = 96
B = 2
PAIR_KEYS = ("template", "template_anno", "search", "search_anno", "search_prev",
             "search_prev_anno")


def test_synthetic_distractor_bit_equal_to_jax():
    want = jax_datasets.SyntheticVideoDataset(3, 40, distractor=True)
    got = datasets.SyntheticVideoDataset(3, 40, distractor=True)
    plain = datasets.SyntheticVideoDataset(3, 40)
    for i in range(3):
        wf, wb = want.get_frames(i, list(range(40)))
        gf, gb = got.get_frames(i, list(range(40)))
        np.testing.assert_array_equal(np.stack(gf), np.stack(wf))
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gb, plain.get_frames(i, list(range(40)))[1])
        assert (np.stack(gf) != np.stack(plain.get_frames(i, list(range(40)))[0])).any()


def pair_samplers(seed=3, n=6):
    """JAX's and the port's two-frame samplers over the distractor corpus
    through KYSPairProcessing at 96 px, as tools/train.py builds them."""
    out = []
    for ds, smp, proc in ((jax_datasets, jax_sampler, jax_processing),
                          (datasets, sampler, processing)):
        out.append(smp.TrackingSampler(
            [ds.SyntheticVideoDataset(4, 40, distractor=True)], None, samples_per_epoch=n,
            max_gap=min(200, run.KYS_MAX_GAP), num_search_frames=2,
            processing=proc.KYSPairProcessing(search_area_factor=5.0, output_sz=S), seed=seed))
    return out


@pytest.fixture(scope="module")
def pair_batches():
    """(JAX's, the port's) collate_pair batches of 3 samples, twice."""
    jax_s, port_s = pair_samplers()
    return [(jax_loader.collate_pair([jax_s.sample() for _ in range(3)]),
             loader.collate_pair([port_s.sample() for _ in range(3)])) for _ in range(2)]


def test_pair_processing_and_collate_bit_equal_to_jax(pair_batches):
    for want, got in pair_batches:
        assert set(got) == set(want) == set(PAIR_KEYS)
        for k in PAIR_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["search_prev"].shape == (3, S, S, 6)
        assert not np.array_equal(got["search_prev"], got["search"])


@pytest.mark.parametrize("channels", [3, 6])
def test_kys_pair_adapt_batch_matches_jax(pair_batches, channels):
    """Crops and boxes bit-equal to JAX's jitted adaptation (as its step
    runs it); the labels within 1e-6 of their peak (XLA's exp and its
    flushed subnormals against PyTorch's)."""
    want_in, got_in = pair_batches[0]
    adapt = jax.jit(lambda b: jax_zoo.kys_pair_adapt_batch(b, S, 5.0, channels=channels))
    want = adapt({k: jnp.asarray(v) for k, v in want_in.items()})
    got = zoo_actors.kys_pair_adapt_batch({k: torch.from_numpy(v) for k, v in got_in.items()},
                                          S, channels=channels)
    assert set(got) == set(want)
    for k in got:
        if k.startswith("label"):
            close(got[k], want[k], 1e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["train_images"].shape[-1] == channels and got["label_cur"].shape == (3, 6, 6)


@pytest.mark.parametrize("channels", [3, 6])
def test_kys_adapt_batch_matches_jax(pair_batches, channels):
    """The template-as-previous-frame form (zoo_actors.py:446-469) on the
    sampler's template / search / search_anno: the crops and the centred
    template box bit-equal to JAX's jitted adaptation, the labels within
    1e-6 of their peak."""
    want_in, got_in = pair_batches[0]
    keys = ("template", "search", "search_anno")
    adapt = jax.jit(lambda b: jax_zoo.kys_adapt_batch(b, S, 5.0, channels=channels))
    want = adapt({k: jnp.asarray(want_in[k]) for k in keys})
    got = zoo_actors.kys_adapt_batch({k: torch.from_numpy(got_in[k]) for k in keys}, S, 5.0,
                                     channels=channels)
    assert set(got) == set(want)
    for k in got:
        if k.startswith("label"):
            close(got[k], want[k], 1e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert torch.equal(got["test_prev"], got["train_images"])


def kys_tree(channels=3, seed=0):
    """KYSNet's flax tree, initialised (shapes only) on `channels`-channel
    images."""
    jm = jkys.build_kysnet()
    im = jnp.zeros((1, 64, 64, channels))
    bb = jnp.asarray([[16.0, 16.0, 24.0, 24.0]])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), im, im, bb,
                                            jnp.stack([bb, bb], axis=1), method="init_forward"))
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    tree["params"]["dimp"]["filter_optimizer"] = optimizer_init("dimp")
    return tree


def port_kys(tree):
    port = kys.build_kysnet()
    port.load_state_dict(kys_state_dict_from_flax(tree["params"]))
    return port


def test_six_channel_kysnet_matches_jax():
    """JAX's KYSNet initialised on 6-channel images has the 3-channel
    tree; the port's KYSNet loads it and reads 6-channel images as JAX
    does (the backbone's layer2 / layer3 and the motion features)."""
    t3, t6 = kys_tree(3), kys_tree(6)
    assert jax.tree.map(np.shape, t3) == jax.tree.map(np.shape, t6)
    assert t6["params"]["dimp"]["backbone"]["conv1"]["kernel"].shape == (7, 7, 3, 64)
    im = np.random.RandomState(1).randn(2, 64, 64, 6).astype(np.float32)
    want = jax.jit(lambda p, x: jkys.build_kysnet().apply(p, x, method="extract_backbone"))(
        t6, jnp.asarray(im))
    port = port_kys(t6).eval()
    with torch.no_grad():
        got = port.extract_backbone(torch.from_numpy(im))
        motion = port.motion_feat(got)
    for k in ("layer2", "layer3"):
        close(got[k], want[k], 1e-5)
    close(motion, want["layer3"], 1e-5)


def step_batch(seed, b=B):
    """A collate_pair batch of normalised 96-px crops: the target near the
    centre at a fifth of the side (KYSPairProcessing's geometry), moving
    a few pixels between the two search frames."""
    rng = np.random.RandomState(seed)

    def boxes():
        wh = rng.uniform(0.17, 0.23, (b, 2))
        return np.concatenate([0.5 - wh / 2 + rng.uniform(-0.05, 0.05, (b, 2)), wh],
                              1).astype(np.float32)

    return {"template": rng.randn(b, S, S, 6).astype(np.float32), "template_anno": boxes(),
            "search": rng.randn(b, S, S, 6).astype(np.float32), "search_anno": boxes(),
            "search_prev": rng.randn(b, S, S, 6).astype(np.float32),
            "search_prev_anno": boxes()}


@pytest.mark.parametrize("channels", [3, 6])
def test_kys_step_matches_jax(channels):
    tree = kys_tree()
    flat_mask = jax.tree_util.tree_map_with_path(
        lambda path, _: path[0].key == "predictor", tree["params"])
    tx = jax_optim.build_optimizer(tree, lr=LR, weight_decay=WD,
                                   trainable_mask={"params": flat_mask})
    inner = jax_zoo.make_kys_train_step(jkys.build_kysnet(), tx)

    def jstep(state, batch, rng):
        return inner(state, jax_zoo.kys_pair_adapt_batch(batch, S, 5.0, channels=channels), rng)

    batch = step_batch(7 + channels)
    sd = kys_state_dict_from_flax(tree["params"])
    step = zoo_actors.make_kys_train_step(S, channels=channels)

    def port_step(b):
        port = kys.build_kysnet()
        port.load_state_dict(sd)
        start = {k: v.clone() for k, v in port.state_dict().items()}
        mask = run.zoo_trainable_mask(port, "kys", "")
        opt, sched = build_optimizer(port, lr=LR, weight_decay=WD, trainable_mask=mask)
        _, stats = step(TrainState(port, opt, sched), b)
        return stats, port.state_dict(), start

    trained = {k for k in sd if k.startswith("predictor.")}
    assert trained and len(trained) < len(sd)
    assert_port_stable(port_step, batch, trained, keys=("template", "search", "search_prev"))

    jstate, jstats = jax.jit(jstep)(jax_train_step.TrainState.create(tree, tx),
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(0))
    want = kys_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    stats, got, start = port_step(batch)
    assert set(stats) == {"Loss/total", "Loss/test_clf", "Loss/is_target"}
    assert all(np.isfinite(float(v)) and float(v) > 0 for v in stats.values())
    assert_step_matches(stats, jstats, got, want, start, trained)
