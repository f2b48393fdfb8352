"""Plain OSTrack, the score head and OSTrack-online of the port against the
JAX package at f32, on bridged weights, and the port's registry.

Weights come from flax init and cross through mmtrack_torch.models.convert;
inputs are made from numpy seeds. Bars: OSTrack maps within 1e-4 on 3- and
6-channel crops; CABlock and ScoreTransformer within 1e-5; `main_lobe`
exact (area and mask); trackers run free from frame 0 against the JAX
trackers, boxes within 0.05 px (tools/parity/freerun.py::compare_freerun)
and OSTrack-online's refresh decisions equal frame by frame; the score
head's port state_dict goes back to the JAX tree through JAX's
convert_score_head_checkpoint.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import vipt as jax_vipt  # noqa: E402
from mmtrack_tpu.models.convert import convert_score_head_checkpoint, load_into  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.registry import list_trackers as jax_list_trackers  # noqa: E402
from mmtrack_tpu.trackers import ostrack_online as jax_oo  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTTracker as JaxTracker  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import vipt  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    score_head_state_dict_from_flax,
    vipt_state_dict_from_flax,
)
from mmtrack_torch.trackers import ostrack_online as oo  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, template_size=32,
            search_size=64, ce_loc=(1,), head_channel=16)
MAPS = ("score_map", "size_map", "offset_map", "pred_boxes", "max_score")
PX = 0.05
NEW = ("ostrack", "ostrack_online", "stark_s", "stark_st", "spt", "siamfc")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _init(model, shapes, *extra, key=7):
    args = [jnp.zeros(s) for s in shapes]
    return jax.jit(lambda r: model.init(r, *args, *extra))(jax.random.PRNGKey(key))


@pytest.mark.parametrize("channels", [3, 6])
def test_build_ostrack_forward_matches_jax(channels):
    """3-channel crops: the RGB baseline (a 3-channel tree has no
    patch_embed_prompt, and the port's model drops it); 6-channel crops: the
    auxiliary triplet's patch embedding is added, as JAX's ViTCEPrompt does."""
    keep = vipt.ce_keep_schedule(4, (1,), (0.7,))
    jm = jax_vipt.build_ostrack(**TINY)
    params = _init(jm, [(1, 32, 32, channels), (1, 64, 64, channels)], None, keep)
    port = vipt.build_ostrack(**TINY)
    sd = vipt_state_dict_from_flax(_np_tree(params["params"]))
    if channels == 3:
        vipt.drop_prompt_embed(port)
    port.load_state_dict(sd)
    rng = np.random.RandomState(channels)
    z = rng.randn(2, 32, 32, channels).astype(np.float32)
    x = rng.randn(2, 64, 64, channels).astype(np.float32)
    mask = np.array(jax_vipt.generate_ctr_mask(2, "CTR_POINT"))
    want = jm.apply(params, jnp.asarray(z), jnp.asarray(x), jnp.asarray(mask), keep)
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(mask), keep)
    for k in MAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    if channels == 3:
        with pytest.raises(ValueError, match="3-channel"):
            port(torch.zeros(1, 32, 32, 6), torch.zeros(1, 64, 64, 6))


def _score_head(n_mlp=12):
    jm = jax_vipt.ScoreTransformer(d_model=32, n_layers=2, n_heads=2, n_mlp_layers=n_mlp)
    params = _init(jm, [(1, 20, 32), (1, 4)])
    port = vipt.ScoreTransformer(d_model=32, n_layers=2, n_heads=2, n_mlp_layers=n_mlp)
    port.load_state_dict(score_head_state_dict_from_flax(_np_tree(params["params"])))
    return jm, params, port


def test_score_head_and_cablock_match_jax():
    jm, params, port = _score_head()
    rng = np.random.RandomState(0)
    tokens = rng.randn(3, 20, 32).astype(np.float32)
    boxes = rng.rand(3, 4).astype(np.float32)
    want = jm.apply(params, jnp.asarray(tokens), jnp.asarray(boxes))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    cls = rng.randn(3, 1, 32).astype(np.float32)
    jb = jax_vipt.CABlock(32, 2)
    want = jb.apply({"params": params["params"]["blocks_1"]}, jnp.asarray(tokens),
                    jnp.asarray(cls))
    with torch.no_grad():
        got = port.blocks[1](torch.from_numpy(tokens), torch.from_numpy(cls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_score_head_state_dict_goes_back_through_jax_converter():
    """Port names are the reference's `cls_head.` names: JAX's converter and
    load_into (strict) rebuild the flax tree exactly."""
    _, params, port = _score_head()
    sd = {f"cls_head.{k}": v.numpy() for k, v in port.state_dict().items()}
    back, missing, unexpected = load_into(params["params"], convert_score_head_checkpoint(sd),
                                          strict=True)
    assert not missing and not unexpected
    flat_want = jax.tree_util.tree_leaves_with_path(_np_tree(params["params"]))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)


def _ring_map():
    m = np.full((20, 20), 0.05, np.float32)
    m[4:16, 4] = m[4:16, 15] = m[4, 4:16] = m[15, 4:16] = 0.6
    m[10, 10] = 0.9                       # the peak, cut off from the ring
    return m


def _diagonal_map():
    m = np.full((20, 20), 0.01, np.float32)
    for i in range(3, 12):
        m[i, i] = 0.7                     # cells touching only at their corners
    m[3, 3] = 1.0
    m[15, 2:6] = 0.8                      # a second lobe, not connected
    return m


def _tied_map():
    m = np.full((20, 20), 0.02, np.float32)
    m[12, 12:15] = 0.5                    # tied peak: the first index (row 5) must seed
    m[5, 7] = m[12, 13] = 0.95
    m[5, 6:9] = np.maximum(m[5, 6:9], 0.4)
    return m


@pytest.mark.parametrize("case", ["random0", "random1", "random2", "ring", "diagonal", "tied"])
def test_main_lobe_matches_jax_exactly(case):
    if case.startswith("random"):
        rng = np.random.RandomState(int(case[-1]))
        m = rng.rand(20, 20).astype(np.float32) ** 4
    else:
        m = {"ring": _ring_map, "diagonal": _diagonal_map, "tied": _tied_map}[case]()
    area_w, mask_w = jax_oo.main_lobe(jnp.asarray(m), 0.2)
    area, mask = oo.main_lobe(torch.from_numpy(m), 0.2)
    assert area == int(area_w)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_w))
    if case == "tied":
        assert mask[5, 7] and not mask[12, 13]


OO_TINY = dict(embed_dim=32, depth=3, num_heads=2, patch_size=16, template_size=32,
               search_size=128, ce_loc=(1,), head_channel=16)
# random weights give a flat score map (every cell above 0.2 of the peak);
# a main-lobe ratio of 0.99 keeps the lobe small, so the score head decides
OO_RT = dict(template_size=32, search_size=128, ce_loc=(1,), ce_keep_ratio=(0.7,),
             cls_attn_layers=2, cls_mlp_layers=3, main_lobe_score_ratio=0.99)


def test_ostrack_online_free_run_matches_jax():
    """Dual-template step, CE per sample, the averaged map, the score head
    and the refresh gate, free-running on a synthetic 3-channel sequence.
    With these weights the gate opens at frames 1, 4, 5, 6 and 7 (asserted
    below), so the online template is re-cropped and both trackers track
    on it."""
    jm = jax_vipt.build_ostrack(**OO_TINY)
    jrt = jax_oo.OSTrackOnlineRuntime(**OO_RT)
    params = _init(jm, [(1, 32, 32, 3), (1, 128, 128, 3)])
    jcls = jax_vipt.ScoreTransformer(d_model=32, n_layers=2, n_heads=2, n_mlp_layers=3)
    cls_params = _init(jcls, [(1, 4 + 64, 32), (1, 4)], key=8)
    port = vipt.drop_prompt_embed(vipt.build_ostrack(**OO_TINY))
    port.load_state_dict(vipt_state_dict_from_flax(_np_tree(params["params"])))
    pcls = vipt.ScoreTransformer(d_model=32, n_layers=2, n_heads=2, n_mlp_layers=3)
    pcls.load_state_dict(score_head_state_dict_from_flax(_np_tree(cls_params["params"])))
    ours = oo.OSTrackOnlineTracker(port, pcls, "cpu", oo.OSTrackOnlineRuntime(**OO_RT))
    theirs = jax_oo.OSTrackOnlineTracker(jm, params, cls_params, jrt, cls_model=jcls)

    frames, gt = make_synthetic_sequence(n_frames=8, height=120, width=160, seed=4,
                                         box0=(60.0, 40.0, 24.0, 20.0), channels=3)
    boxes, events = {}, {}
    for name, tr in (("ours", ours), ("theirs", theirs)):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
        outs = [tr.track(f) for f in frames[1:]]
        boxes[name] = [o["target_bbox"] for o in outs]
        events[name] = [(o["update_flag"],) for o in outs]
    res = compare_freerun(boxes["theirs"], boxes["ours"], PX, ref_events=events["theirs"],
                          our_events=events["ours"])
    assert res["pass"], res
    assert [e[0] for e in events["ours"]] == [True, False, False, True, True, True, True]


def test_ostrack_tracker_free_run_matches_jax():
    """The `ostrack` recipe's tracker (ViPTTracker over plain OSTrack) on
    6-channel frames, against JAX's ViPTTracker on a 6-channel tree."""
    keep = vipt.ce_keep_schedule(4, (1,), (0.7,))
    jm = jax_vipt.build_ostrack(**TINY)
    params = _init(jm, [(1, 32, 32, 6), (1, 64, 64, 6)], None, keep)
    port = vipt.build_ostrack(**TINY)
    port.load_state_dict(vipt_state_dict_from_flax(_np_tree(params["params"])))
    rt = dict(template_size=32, search_size=64, stride=16, ce_loc=(1,), ce_keep_ratio=(0.7,))
    ours = ViPTTracker(port, "cpu", ViPTRuntime(**rt))
    theirs = JaxTracker(jm, params, JaxRuntime(**rt))
    frames, gt = make_synthetic_sequence(n_frames=6, height=96, width=128, seed=2,
                                         box0=(40.0, 30.0, 24.0, 20.0))
    boxes = {}
    for name, tr in (("ours", ours), ("theirs", theirs)):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
        boxes[name] = [tr.track(f)["target_bbox"] for f in frames[1:]]
    res = compare_freerun(boxes["theirs"], boxes["ours"], PX)
    assert res["pass"], res


def test_registry_recipes_match_jax():
    assert set(NEW) <= set(registry.list_trackers())
    for name, r in registry.TRACKER_REGISTRY.items():
        j = JAX_REGISTRY[name]
        assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition), name


@pytest.mark.parametrize("modality", ["rgb", "rgbd", "rgbt", "rgbe", "any"])
def test_list_trackers_matches_jax(modality):
    ported = set(registry.TRACKER_REGISTRY)
    assert registry.list_trackers(modality) == [n for n in jax_list_trackers(modality)
                                                if n in ported]


def test_ostrack_online_npz_round_trips(tmp_path):
    """A flax .npz of the model and the score head (`cls_params`) goes through
    the entry's loader into the ostrack_online recipe; the family without a
    bridge is refused."""
    jm = jax_vipt.build_ostrack(**TINY)
    params = _init(jm, [(1, 32, 32, 3), (1, 64, 64, 3)])
    _, cls_params, _ = _score_head(n_mlp=3)
    path = str(tmp_path / "oo.npz")
    np.savez(path, params=np.asarray(_np_tree(params["params"]), dtype=object),
             cls_params=np.asarray(_np_tree(cls_params["params"]), dtype=object))
    sd = load_checkpoint(path, "ostrack")
    head = {k[len("cls_head."):]: v for k, v in sd.items() if k.startswith("cls_head.")}
    port = vipt.ScoreTransformer(d_model=32, n_layers=2, n_heads=2, n_mlp_layers=3)
    port.load_state_dict(head)
    model = vipt.drop_prompt_embed(vipt.build_ostrack(**TINY))
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("cls_head.")})
    for k, v in vipt_state_dict_from_flax(_np_tree(params["params"])).items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="no flax weight bridge"):
        load_checkpoint(path, "no_such_family")
