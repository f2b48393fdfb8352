"""The flax -> torch weight bridge (mmtrack_torch/models/convert.py).

`convert_vipt_checkpoint(vipt_state_dict_from_flax(p))` must give back
every leaf of `p` bit for bit, and the bridge's names and shapes must be
exactly the port model's state_dict.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.config import vipt_experiment_config as jax_config  # noqa: E402
from mmtrack_tpu.models.convert import convert_vipt_checkpoint  # noqa: E402
from mmtrack_tpu.models.vipt import ViPTrack as JaxViPTrack  # noqa: E402
from mmtrack_tpu.models.vipt import build_viptrack as jax_build  # noqa: E402
from mmtrack_torch.config import vipt_experiment_config  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.models.vipt import ViPTrack, build_viptrack  # noqa: E402

TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16,
            template_size=32, search_size=64, ce_loc=(1,), head_channel=16)


def _assert_round_trip(p):
    sd = vipt_state_dict_from_flax(p)
    back = flax.traverse_util.flatten_dict(convert_vipt_checkpoint(sd))
    flat = flax.traverse_util.flatten_dict(p)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert np.array_equal(back[k], v), k
    return sd


def _assert_matches_model(sd, model):
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


@pytest.mark.parametrize("prompt_type", ["vipt_deep", "vipt_shaw", "none"])
def test_bridge_round_trip_tiny(prompt_type):
    model = JaxViPTrack(**TINY, prompt_type=prompt_type)
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 32, 32, 6)),
                        jnp.zeros((1, 64, 64, 6)), None, (12,))
    sd = _assert_round_trip(jax.tree.map(np.asarray, params["params"]))
    port = ViPTrack(**TINY, prompt_type=prompt_type)
    _assert_matches_model(sd, port)
    port.load_state_dict(sd, strict=True)


def test_bridge_round_trip_deep_rgbd():
    """Full-size deep_rgbd tree from eval_shape + seeded numpy (no init)."""
    cfg = jax_config("deep_rgbd")
    shapes = jax.eval_shape(lambda: jax_build(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 6)), jnp.zeros((1, 256, 256, 6)),
        None, (180, 126, 89)))
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda s: rng.standard_normal(s.shape, dtype=np.float32),
                     shapes["params"])
    sd = _assert_round_trip(p)
    _assert_matches_model(sd, build_viptrack(vipt_experiment_config("deep_rgbd"),
                                             device="meta"))
