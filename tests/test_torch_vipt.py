"""The ported ViPT slice against the JAX package at f32, on bridged weights.

Weights come from flax init and cross through
mmtrack_torch.models.convert.vipt_state_dict_from_flax; inputs are made
from numpy seeds. The tiny model of tests/test_golden.py (CE at block 1)
must match every output map within 1e-4 and keep exactly the same
candidate-elimination indices. The full-width deep_rgbd forward (B=1,
~45 s on one CPU thread) is held to 1e-4 on the maps as well.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.config import vipt_experiment_config as jax_config  # noqa: E402
from mmtrack_tpu.models import vipt as jax_vipt  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime  # noqa: E402
from mmtrack_torch.config import vipt_experiment_config  # noqa: E402
from mmtrack_torch.models import vipt  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime  # noqa: E402

TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16,
            template_size=32, search_size=64, ce_loc=(1,), head_channel=16)
MAPS = ("score_map", "size_map", "offset_map", "pred_boxes", "max_score")
CONFIG_KEYS = ("MODEL.BACKBONE.EMBED_DIM", "MODEL.BACKBONE.DEPTH", "MODEL.BACKBONE.NUM_HEADS",
               "MODEL.BACKBONE.STRIDE", "MODEL.BACKBONE.CE_LOC",
               "MODEL.BACKBONE.CE_KEEP_RATIO", "MODEL.BACKBONE.CE_TEMPLATE_RANGE",
               "MODEL.HEAD.TYPE", "MODEL.HEAD.NUM_CHANNELS", "TRAIN.PROMPT.TYPE",
               "DATA.TEMPLATE.SIZE", "DATA.TEMPLATE.FACTOR", "DATA.SEARCH.SIZE",
               "DATA.SEARCH.FACTOR", "TEST.TEMPLATE_FACTOR", "TEST.TEMPLATE_SIZE",
               "TEST.SEARCH_FACTOR", "TEST.SEARCH_SIZE")


def _get(cfg, path):
    for k in path.split("."):
        cfg = getattr(cfg, k)
    return cfg


@pytest.mark.parametrize("name", ["deep_rgbd", "shaw_rgbd", "deep_rgbt", "shaw_rgbt",
                                  "deep_rgbe", "shaw_rgbe"])
def test_config_matches_jax(name):
    ours, theirs = vipt_experiment_config(name), jax_config(name)
    for key in CONFIG_KEYS:
        assert _get(ours, key) == _get(theirs, key), key
    assert (dataclasses.asdict(ViPTRuntime.from_config(ours))
            == dataclasses.asdict(JaxRuntime.from_config(theirs)))


@pytest.mark.parametrize("size,mode", [(2, "CTR_POINT"), (8, "CTR_POINT"), (7, "CTR_REC"),
                                       (8, "CTR_REC"), (8, "ALL")])
def test_ctr_mask_and_keep_schedule(size, mode):
    want = jax_vipt.generate_ctr_mask(size, mode)
    got = vipt.generate_ctr_mask(size, mode)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (vipt.ce_keep_schedule(256, (3, 6, 9), (0.7, 0.7, 0.7))
            == jax_vipt.ce_keep_schedule(256, (3, 6, 9), (0.7, 0.7, 0.7)))


def _compare_forward(jax_model, params, port, z, x, mask, keep, atol):
    """Run both forwards: maps within `atol`, identical kept CE indices."""
    out, inter = jax_model.apply(params, jnp.asarray(z), jnp.asarray(x),
                                 None if mask is None else jnp.asarray(mask), keep,
                                 capture_intermediates=True, mutable=["intermediates"])
    kept = {}
    hooks = [port.backbone.blocks[i].register_forward_hook(
        lambda m, inp, o, i=i: kept.__setitem__(i, o[2].numpy())) for i in port.backbone.ce_loc]
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask), keep)
    for h in hooks:
        h.remove()
    for k in MAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(out[k]), rtol=0, atol=atol,
                                   err_msg=k)
    for i in port.backbone.ce_loc:
        jax_kept = inter["intermediates"]["backbone"][f"blocks_{i}"]["__call__"][0][2]
        np.testing.assert_array_equal(kept[i], np.asarray(jax_kept))


@pytest.mark.parametrize("prompt_type", ["vipt_deep", "vipt_shaw", "none"])
def test_tiny_vipt_forward_matches_jax(prompt_type):
    rt = JaxRuntime(template_size=32, search_size=64, stride=16, ce_loc=(1,),
                    ce_keep_ratio=(0.7,))
    jm = jax_vipt.ViPTrack(**TINY, prompt_type=prompt_type)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6)),
                                       None, rt.ce_keep_lens))(jax.random.PRNGKey(7))
    port = vipt.ViPTrack(**TINY, prompt_type=prompt_type).eval()
    port.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    rng = np.random.RandomState(0)
    z = rng.randn(3, 32, 32, 6).astype(np.float32)
    x = rng.randn(3, 64, 64, 6).astype(np.float32)
    mask = np.array(jax_vipt.generate_ctr_mask(2, "CTR_POINT"))
    _compare_forward(jm, params, port, z, x, mask, rt.ce_keep_lens, atol=1e-4)


def test_tiny_ostrack_rgb_only_matches_jax():
    """3-channel crops through a prompt_type='none' model (JAX
    `build_ostrack`): no auxiliary stream on either side, maps within 1e-4."""
    rt = JaxRuntime(template_size=32, search_size=64, stride=16, ce_loc=(1,),
                    ce_keep_ratio=(0.7,))
    jm = jax_vipt.build_ostrack(**TINY)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 64, 3)),
                                       None, rt.ce_keep_lens))(jax.random.PRNGKey(7))
    port = vipt.ViPTrack(**TINY, prompt_type="none").eval()
    missing, unexpected = port.load_state_dict(
        vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])), strict=False)
    assert sorted(missing) == ["backbone.patch_embed_prompt.proj.bias",
                               "backbone.patch_embed_prompt.proj.weight"] and not unexpected
    rng = np.random.RandomState(0)
    z = rng.randn(3, 32, 32, 3).astype(np.float32)
    x = rng.randn(3, 64, 64, 3).astype(np.float32)
    mask = np.array(jax_vipt.generate_ctr_mask(2, "CTR_POINT"))
    _compare_forward(jm, params, port, z, x, mask, rt.ce_keep_lens, atol=1e-4)


def test_deep_rgbd_forward_matches_jax():
    """Full-width deep_rgbd (ViT-B, 12 blocks, CE at 3/6/9) at f32, B=1."""
    jcfg = jax_config("deep_rgbd")
    rt = JaxRuntime.from_config(jcfg)
    jm = jax_vipt.build_viptrack(jcfg)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 128, 128, 6)),
                                       jnp.zeros((1, 256, 256, 6)), None,
                                       rt.ce_keep_lens))(jax.random.PRNGKey(0))
    port = vipt.build_viptrack(vipt_experiment_config("deep_rgbd"))
    port.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    rng = np.random.RandomState(1)
    z = rng.randn(1, 128, 128, 6).astype(np.float32)
    x = rng.randn(1, 256, 256, 6).astype(np.float32)
    mask = np.array(jax_vipt.generate_ctr_mask(8, "CTR_POINT"))
    _compare_forward(jm, params, port, z, x, mask, rt.ce_keep_lens, atol=1e-4)
