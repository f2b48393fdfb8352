"""STARK-S, STARK-ST and SPT of the port against the JAX package at f32, on
bridged weights, with their crop helpers.

A narrow transformer (d = 32, 2 heads, one encoder / decoder / fusion
layer) over ResNet-50's full stage counts to layer3, on 64 / 128 crops.
Bars: crop_att_mask exact; crop_at within 1e-4 on the 0-255 scale (both
borders, with and without a given origin); the sine embeddings within one
f32 ulp (their sin / cos arguments are the same f32 operations, but the
JAX package's CPU sin and cos are glibc's and PyTorch's are SLEEF's, which
round 1-ulp cases apart); the ResNet-50 trunk within 1e-4 of the largest
feature; boxes (and ST scores) within 1e-5 with and without masks;
trackers free from frame 0 within 0.05 px, ST's template updates equal
frame by frame; the port state_dicts go back to the JAX trees through
JAX's convert_stark_checkpoint.
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
from mmtrack_tpu.models import stark as jax_stark  # noqa: E402
from mmtrack_tpu.models.convert import convert_stark_checkpoint, load_into  # noqa: E402
from mmtrack_tpu.ops import crop as jax_crop  # noqa: E402
from mmtrack_tpu.trackers import stark_tracker as jax_st  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import stark  # noqa: E402
from mmtrack_torch.models.convert import stark_state_dict_from_flax  # noqa: E402
from mmtrack_torch.ops.crop import crop_at, crop_att_mask  # noqa: E402
from mmtrack_torch.trackers import stark_tracker as st  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

SMALL = dict(template_size=64, search_size=128, dim=32, heads=2, enc_layers=1, dec_layers=1,
             fusion_layers=1)
RT = dict(template_size=64, search_size=128)
KINDS = {"s": (False, False), "st": (False, True), "spt": (True, False)}
PX = 0.05


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _boxes(rng, n, H, W):
    """Boxes inside the frame, across each edge and tiny."""
    u = rng.rand(n, 4).astype(np.float32)
    b = np.stack([u[:, 0] * W, u[:, 1] * H, u[:, 2] * 40 + 1, u[:, 3] * 40 + 1], 1)
    b[:4] = [[-12.3, -7.6, 40.0, 30.0], [W - 20.5, H - 15.2, 42.0, 33.0],
             [W * 0.5, H * 0.5, 0.6, 0.4], [W * 0.25 + 0.5, H * 0.25 + 0.5, 3.0, 5.0]]
    return b.astype(np.float32)


@pytest.mark.parametrize("factor,size", [(2.0, 128), (5.0, 320), (4.0, 63)])
def test_crop_att_mask_equals_jax(factor, size):
    H, W = 96, 128
    boxes = _boxes(np.random.RandomState(size), 64, H, W)
    want = jax.vmap(lambda b: jax_crop.crop_att_mask(b, factor, size, H, W))(jnp.asarray(boxes))
    got = crop_att_mask(torch.from_numpy(boxes), factor, size, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("border", ["replicate", "zero"])
def test_crop_at_matches_jax(border):
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    for cy, cx, side, out in ((25.3, 34.8, 31.7, 16), (-3.0, 60.5, 40.2, 33), (48.9, 2.2, 9.5, 64)):
        want = jax_crop.crop_at(jnp.asarray(image), jnp.asarray([cy, cx], jnp.float32),
                                jnp.float32(side), out, border)
        got = crop_at(torch.from_numpy(image), torch.tensor([cy, cx]), torch.tensor(side), out,
                      border)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    origin = jnp.asarray([-5.0, 61.0], jnp.float32)
    want = jax_crop.crop_at(jnp.asarray(image), None, jnp.float32(23.0), 30, border,
                            origin_yx=origin)
    got = crop_at(torch.from_numpy(image), None, 23.0, 30, border,
                  origin_yx=torch.from_numpy(np.array(origin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(8, 8), (20, 20), (5, 7)])
def test_sine_embeddings_match_jax(hw):
    h, w = hw
    np.testing.assert_array_max_ulp(stark.sine_position_embedding(h, w, 256).numpy(),
                                    np.asarray(jax_stark.sine_position_embedding(h, w, 256)),
                                    maxulp=1)
    rng = np.random.RandomState(h * w)
    not_mask = rng.rand(2, h, w) > 0.3
    not_mask[1] = True
    not_mask[0, :, -2:] = False
    np.testing.assert_array_max_ulp(
        stark.sine_position_embedding_masked(torch.from_numpy(not_mask), 256).numpy(),
        np.asarray(jax_stark.sine_position_embedding_masked(jnp.asarray(not_mask), 256)),
        maxulp=1)


@pytest.fixture(scope="module")
def models():
    """kind -> (jax model, flax params, port model) on PRNGKey(5) weights;
    STARK-S takes STARK-ST's tree without its score head."""
    out = {}
    for kind in ("st", "spt"):
        six, score = KINDS[kind]
        C = 6 if six else 3
        jm = jax_stark.STARK(**SMALL, six_channel=six, score_head=score)
        params = jax.jit(lambda r, jm=jm, C=C: jm.init(r, jnp.zeros((1, 64, 64, C)),
                                                       jnp.zeros((1, 128, 128, C))))(
            jax.random.PRNGKey(5))
        out[kind] = (jm, params)
    st_params = out["st"][1]["params"]
    out["s"] = (jax_stark.STARK(**SMALL),
                {"params": {k: v for k, v in st_params.items() if not k.startswith("cls_")}})
    for kind, (jm, params) in out.items():
        port = stark.STARK(**SMALL, six_channel=KINDS[kind][0], score_head=KINDS[kind][1])
        port.load_state_dict(stark_state_dict_from_flax(_np_tree(params["params"])))
        out[kind] = (jm, params, port.eval())
    return out


def test_resnet50_layer3_matches_jax(models):
    jm, params, port = models["s"]
    from mmtrack_tpu.models.resnet import ResNet
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    want = ResNet(stage_sizes=(3, 4, 6), block="bottleneck").apply(
        {"params": params["params"]["backbone"]}, jnp.asarray(x), ("layer3",))["layer3"]
    with torch.no_grad():
        got = port.backbone[0].body(torch.from_numpy(x), ("layer3",))["layer3"]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("masked", [False, True])
def test_stark_forward_matches_jax(models, kind, masked):
    jm, params, port = models[kind]
    C = 6 if KINDS[kind][0] else 3
    rng = np.random.RandomState(3)
    z = rng.randn(2, 64, 64, C).astype(np.float32)
    x = rng.randn(2, 128, 128, C).astype(np.float32)
    zm = xm = None
    if masked:
        zm = np.zeros((2, 64, 64), bool)
        zm[0, :, :20] = True
        xm = np.zeros((2, 128, 128), bool)
        xm[1, 100:] = True
        xm[0, :, :7] = True
    want = jm.apply(params, jnp.asarray(z), jnp.asarray(x), None if zm is None else jnp.asarray(zm),
                    None if xm is None else jnp.asarray(xm))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(x),
                   None if zm is None else torch.from_numpy(zm),
                   None if xm is None else torch.from_numpy(xm))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_stark_state_dict_goes_back_through_jax_converter(models, kind):
    """Port names are the reference's: JAX's converter and a strict load_into
    rebuild the flax tree exactly."""
    _, params, port = models[kind]
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, missing, unexpected = load_into(params["params"], convert_stark_checkpoint(sd),
                                          strict=True)
    assert not missing and not unexpected
    back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(params["params"])):
        np.testing.assert_array_equal(np.asarray(back[path]), leaf)


@pytest.mark.parametrize("kind", list(KINDS))
def test_stark_tracker_free_run_matches_jax(models, kind):
    """Device-crop trackers on 6-channel frames (STARK-S reads the first
    three), boxes within 0.05 px. STARK-ST runs with update_interval 2 and
    threshold 0.5: its scores stay near 0.61, so the dynamic template
    updates at frames 2, 4 and 6 (asserted below), equal on both sides."""
    jm, params, port = models[kind]
    dynamic = KINDS[kind][1]
    rt = dict(RT, dynamic_template=dynamic, update_interval=2 if dynamic else 200)
    ours = st.STARKTracker(port, "cpu", st.STARKRuntime(**rt))
    theirs = jax_st.STARKTracker(jm, params, jax_st.STARKRuntime(**rt))
    frames, gt = make_synthetic_sequence(n_frames=7, height=96, width=128, seed=6,
                                         box0=(40.0, 30.0, 24.0, 20.0))
    boxes, scores, updates = {}, {}, []
    for name, tr in (("ours", ours), ("theirs", theirs)):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
        outs = [tr.track(f) for f in frames[1:]]
        boxes[name] = [o["target_bbox"] for o in outs]
        scores[name] = [o["best_score"] for o in outs]
        if name == "ours":
            updates = [o["update_flag"] for o in outs]
    theirs_updates = [dynamic and (t % 2 == 0) and s > 0.5
                      for t, s in zip(range(1, 7), scores["theirs"])]
    res = compare_freerun(boxes["theirs"], boxes["ours"], PX,
                          ref_events=[(u,) for u in theirs_updates],
                          our_events=[(u,) for u in updates])
    assert res["pass"], res
    np.testing.assert_allclose(scores["ours"], scores["theirs"], rtol=0, atol=1e-5)
    assert updates == ([False, True] * 3 if dynamic else [False] * 6)


def test_stark_npz_round_trips_and_backbone_menu(models, tmp_path):
    _, params, port = models["spt"]
    path = str(tmp_path / "spt.npz")
    np.savez(path, params=np.asarray(_np_tree(params["params"]), dtype=object))
    fresh = stark.STARK(**SMALL, six_channel=True)
    fresh.load_state_dict(load_checkpoint(path, "stark"))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # SPT's other trunks build and load from their flax .npz as well
    for trunk in ("repvgg_a0", "swin_tiny"):
        jm = jax_stark.STARK(**SMALL, six_channel=True, backbone_type=trunk)
        shapes = jax.eval_shape(lambda jm=jm: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)), jnp.zeros((1, 128, 128, 6))))
        rng = np.random.RandomState(0)
        tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
        path = str(tmp_path / f"spt_{trunk}.npz")
        np.savez(path, params=np.asarray(tree["params"], dtype=object))
        port = stark.STARK(**SMALL, six_channel=True, backbone_type=trunk)
        port.load_state_dict(load_checkpoint(path, "stark"))
        want = stark_state_dict_from_flax(tree["params"])
        assert port.state_dict().keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(port.state_dict()[k], v), (trunk, k)


def test_stark_host_crop_tracker_matches_jax(models):
    """STARKTracker(host_preproc=True): the reference's cv2 crop and its
    att_mask made on the host on both sides, ST updating every 2 frames
    (at frames 2 and 4 here, as the device-crop run)."""
    jm, params, port = models["st"]
    rt = dict(RT, dynamic_template=True, update_interval=2)
    ours = st.STARKTracker(port, "cpu", st.STARKRuntime(**rt), host_preproc=True)
    theirs = jax_st.STARKTracker(jm, params, jax_st.STARKRuntime(**rt), host_preproc=True)
    frames, gt = make_synthetic_sequence(n_frames=5, height=96, width=128, seed=6,
                                         box0=(40.0, 30.0, 24.0, 20.0))
    boxes, updates = {}, []
    for name, tr in (("ours", ours), ("theirs", theirs)):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
        outs = [tr.track(f) for f in frames[1:]]
        boxes[name] = [o["target_bbox"] for o in outs]
        if name == "ours":
            updates = [o["update_flag"] for o in outs]
    res = compare_freerun(boxes["theirs"], boxes["ours"], PX)
    assert res["pass"], res
    assert updates == [False, True, False, True]
