"""APFNet training in the port (models/apfnet.py::stage_mask, the MDNet
family's step of train/zoo_actors.py) against the JAX package's
(models/apfnet.py::stage_mask, train/zoo_actors.py:212-243) at f32.

The stage masks: each stage's trainable set (stage 1 for each of the five
attributes, stages 2 and 3) is exactly the leaves JAX's stage_mask
selects, carried to the port's names by the flax -> torch bridge
(models/convert.py::mdnet_state_dict_from_flax: a leaf filled with its
mask bit arrives as a tensor of that bit), by name and element count.

The steps: the flax tree of tests/test_torch_mdnet.py (numpy seed) at
full width, one step of each stage (stage 1 at attribute 2) through
tests/test_torch_mdnet_train.py::check_mdnet_step (its docstring says
why at this point): 2 positive and 4 negative patches inside a 96-px
search, JAX's step jitted and its draws given to the port, the port
first against itself under a 1e-7 change of the search crops and against
its own f64 evaluation; assert_step_matches's bars (loss and accuracy within 1e-5
relative; trained leaves within 1e-5 relative L2, at most one element in
a thousand past lr / 10, none past 2 lr; frozen leaves unmoved on both
sides). JAX's forward is the tracking topology in every stage, as its
step passes no `active_attribute`.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mmtrack_tpu.models import apfnet as japf  # noqa: E402
from mmtrack_torch.models import apfnet  # noqa: E402
from mmtrack_torch.models.convert import mdnet_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train.optim import count_trainable  # noqa: E402
from test_torch_mdnet import flax_tree  # noqa: E402
from test_torch_mdnet_train import check_mdnet_step  # noqa: E402

STAGES = [(1, a) for a in range(5)] + [(2, None), (3, None)]


@pytest.fixture(scope="module")
def tree():
    return flax_tree(japf.APFNet())


@pytest.mark.parametrize("stage,attribute", STAGES)
def test_stage_mask_selects_jax_leaves(tree, stage, attribute):
    jmask = japf.stage_mask(tree["params"], stage, attribute)
    bits = jax.tree.map(lambda v, m: np.full(v.shape, float(m), np.float32),
                        tree["params"], jmask)
    want = {k: bool(v.all()) for k, v in mdnet_state_dict_from_flax(bits).items()}
    assert all(v.all() or not v.any() for v in mdnet_state_dict_from_flax(bits).values())
    port = apfnet.APFNet()
    mask = apfnet.stage_mask(port, stage, attribute)
    assert mask == want
    n_jax = sum(int(v.size) for v, m in zip(jax.tree.leaves(tree["params"]),
                                            jax.tree.leaves(jmask)) if m)
    assert count_trainable(port, mask) == n_jax
    assert 0 < n_jax <= sum(p.numel() for p in port.parameters())


def test_stage_mask_refuses_bad_stages():
    port = apfnet.APFNet()
    for stage, attribute in ((0, None), (4, None), (1, None), (1, 5)):
        with pytest.raises(ValueError):
            apfnet.stage_mask(port, stage, attribute)


@pytest.mark.parametrize("stage,attribute", [(1, 2), (2, None), (3, None)])
def test_apfnet_step_matches_jax(tree, stage, attribute):
    jmask = japf.stage_mask(tree["params"], stage, attribute)
    port_mask = apfnet.stage_mask(apfnet.APFNet(), stage, attribute)
    check_mdnet_step(japf.APFNet(), apfnet.APFNet, tree, 11, 21,
                     mask=jmask, port_mask=port_mask)


@pytest.mark.parametrize("attribute", [0, 3])
def test_stage1_topology_matches_jax(tree, attribute):
    """`active_attribute`: one attribute's branch added to both streams, no
    ensemble, no transformers (JAX apfnet.py:181-205), on tracker-scale
    crops: the CHW features within 1e-4 of their largest magnitude and the
    logits within 1e-4 relative, as tests/test_torch_mdnet.py holds the
    tracking topology; it differs from the tracking topology."""
    from functools import partial

    import jax.numpy as jnp
    from test_torch_mdnet import BLOCKS, chw, crops, nchw, port_model

    jm = japf.APFNet()
    x = crops(2, seed=attribute)
    j_feats = np.asarray(jax.jit(partial(jm.apply, method=japf.APFNet.extract_features,
                                         active_attribute=attribute))(tree, jnp.asarray(x)))
    j_logits = np.asarray(jm.apply(tree, jnp.asarray(x), active_attribute=attribute))
    port = port_model("apfnet", tree)
    with torch.no_grad():
        feats = port.extract_features(nchw(x), attribute).numpy()
        logits = port(nchw(x), active_attribute=attribute).numpy()
        tracking = port.extract_features(nchw(x)).numpy()
    want = chw(j_feats, BLOCKS["apfnet"])
    assert np.abs(feats - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(logits - j_logits).max() <= 1e-4 * np.abs(j_logits).max()
    assert np.abs(tracking - feats).max() > 1e-2 * np.abs(want).max()
