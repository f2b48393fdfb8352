"""Alpha-Refine training in the port (train/zoo_actors.py::make_ar_train_step)
against the JAX package's at f32 on the CPU.

The batch of tests/test_zoo_actors.py::test_alpha_refine_trains (input
128, B = 2, uniform crops in [-1, 1], a rectangular mask, `mask_valid`
[1, 0] so the second sample's mask term is gated off), the network
flax-initialised (PRNGKey(0)) and carried across by
alpha_refine_state_dict_from_flax (which leaves out the trunk's layer3 /
layer4, unread by the network). One AdamW step (lr 4e-4, decay 1e-4, the
global-norm clip at 0.1) on every parameter, JAX's step jitted, held to
tests/test_torch_dimp_train.py::assert_step_matches: loss and its terms
within 1e-5 relative, the trained leaves within 1e-5 relative L2.
The gate: the mask term equals the first sample's mask BCE alone.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models.alpha_refine import AlphaRefineNet as JaxAR  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_tpu.train import zoo_actors as jax_zoo  # noqa: E402
from mmtrack_torch.models.alpha_refine import AlphaRefineNet  # noqa: E402
from mmtrack_torch.models.convert import alpha_refine_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train import zoo_actors  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from test_torch_dimp_train import LR, WD, assert_step_matches  # noqa: E402

SIZE = 128


def ar_batch(mask_valid=(1.0, 0.0)):
    r = np.random.RandomState(0)
    mask = np.zeros((2, SIZE, SIZE), np.float32)
    mask[:, 40:90, 30:100] = 1.0
    return {"template": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
            "template_anno": np.asarray([[32.0, 32.0, 64.0, 64.0]] * 2, np.float32),
            "search": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
            "search_anno": np.asarray([[0.25, 0.3, 0.5, 0.4]] * 2, np.float32),
            "masks": mask, "mask_valid": np.asarray(mask_valid, np.float32)}


@pytest.fixture(scope="module")
def flax_params():
    b = ar_batch()
    jm = JaxAR(input_size=SIZE)
    return jm, jax.jit(lambda k: jm.init(k, b["template"], b["template_anno"], b["search"]))(
        jax.random.PRNGKey(0))


def _port(params):
    model = AlphaRefineNet(SIZE)
    model.load_state_dict(alpha_refine_state_dict_from_flax(
        jax.tree.map(np.asarray, params["params"])))
    return model


def test_ar_step_matches_jax(flax_params):
    jm, params = flax_params
    batch = ar_batch()
    tx = jax_optim.build_optimizer(params, lr=LR, weight_decay=WD)
    jstep = jax.jit(jax_zoo.make_ar_train_step(jm, tx))
    jstate, jstats = jstep(jax_train_step.TrainState.create(params, tx),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    model = _port(params)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = build_optimizer(model, lr=LR, weight_decay=WD)
    _, stats = zoo_actors.make_ar_train_step()(TrainState(model, opt, sched), batch)
    want = alpha_refine_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    assert_step_matches(stats, jstats, model.state_dict(), want, start, set(start))


def test_ar_mask_term_is_gated_by_mask_valid(flax_params):
    """With mask_valid [1, 0] the mask term is the first sample's BCE: the
    step's loss_mask equals the mean-over-pixels BCE of sample 0 alone,
    and the second sample's mask never enters it."""
    _, params = flax_params
    model = _port(params)
    batch = ar_batch()
    with torch.no_grad():
        _, logits = model(*(torch.from_numpy(batch[k])
                            for k in ("template", "template_anno", "search")))
    x, y = logits[0].double(), torch.from_numpy(batch["masks"][0]).double()
    want = float((torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean())
    opt, sched = build_optimizer(model, lr=LR, weight_decay=WD)
    flipped = dict(batch, masks=batch["masks"] * np.asarray([1.0, 0.0])[:, None, None])
    _, stats = zoo_actors.make_ar_train_step()(TrainState(model, opt, sched), flipped)
    np.testing.assert_allclose(float(stats["loss_mask"]), want, rtol=1e-5)
