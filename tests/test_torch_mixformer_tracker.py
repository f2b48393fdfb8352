"""The MixFormer tracker runtime of the port (MixFormer_RGBD, SAMF,
ProMixTrack) against the JAX package at f32, on bridged weights.

The model of tests/test_torch_mixformer.py (JAX's small configuration,
numpy-seeded flax leaves through the bridge) on 120 x 160 synthetic
frames. The device-crop trackers run free from frame 0 against JAX's step
(mixformer_track_step, its aux exposed) for scales (1.0,) and
(0.8, 1.0, 1.25) and re-constraints simple, complex and none, with
update_interval 2 and online_threshold 0: boxes within 0.05 px
(tools/parity/freerun.py::compare_freerun), scores within 1e-4, and the
nomination, the interval, n_online and forget_id equal frame by frame;
the ring grows to K = 3 and then replaces at the forget pointer, as JAX's
test_mixformer_ring_grows_like_reference asserts. The host-crop harness
step (mixformer_step_from_patch) on injected patches against JAX's.
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
from mmtrack_tpu.ops import crop as jax_crop  # noqa: E402
from mmtrack_tpu.trackers import mixformer_tracker as jax_mt  # noqa: E402
from mmtrack_torch.trackers import mixformer_tracker as mt  # noqa: E402
from test_torch_mixformer import mixformer_models  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

RT = dict(template_size=64, search_size=96, update_interval=2, online_size=3,
          online_threshold=0.0)
PX = 0.05
# (n_online, forget_id) after frames 1-8 with update_interval 2 and K = 3
RING = [(1, 0), (2, 0), (2, 0), (3, 0), (3, 0), (3, 1), (3, 1), (3, 2)]


@pytest.fixture(scope="module")
def models():
    return {C: mixformer_models(C) for C in (3, 6)}


def _jax_run(rt, jm, params, frames, box0):
    """JAX's tracker step (mixformer_track_step) with its aux: per frame
    the box, the score and (nominate, at_interval, n_online, forget_id)."""
    def step(params, state, frame):
        mean, std = jax_mt._mean_std(frame.shape[-1])
        crops, rfs = zip(*(jax_crop.crop_resize_normalized(
            frame, state["box"], rt.search_factor * sf, rt.search_size, mean, std)
            for sf in rt.scale_factors))

        def cand_fn(box):
            return jax_crop.crop_resize_normalized(frame, box, rt.template_factor,
                                                   rt.template_size, mean, std)[0]

        return jax_mt._mixformer_core(rt, jm, params, state, jnp.stack(crops), jnp.stack(rfs),
                                      (float(frame.shape[0]), float(frame.shape[1])), cand_fn)

    step = jax.jit(step)
    state = jax_mt.mixformer_init_state(rt, jm, params, jnp.asarray(frames[0]),
                                        jnp.asarray(box0))
    boxes, scores, events = [], [], []
    for f in frames[1:]:
        state, box, score, aux = step(params, state, jnp.asarray(f))
        boxes.append(np.asarray(box))
        scores.append(float(score))
        events.append((bool(aux["nominate"]), bool(aux["at_interval"]),
                       int(state["n_online"]), int(state["forget_id"])))
    return boxes, scores, events


@pytest.mark.parametrize("C,scales,re_constrain", [
    (6, (1.0,), "simple"),               # mixformer_rgbd
    (3, (0.8, 1.0, 1.25), "complex"),    # samf's scales
    (3, (1.0,), "none"),                 # promixtrack
])
def test_mixformer_tracker_free_run_matches_jax(models, C, scales, re_constrain):
    """Device-crop trackers from frame 0, 9 frames: nominations at
    threshold 0, the ring written every 2 frames, growing to K = 3 and then
    replacing at the forget pointer."""
    jm, params, port = models[C]
    rt = dict(RT, scale_factors=scales, re_constrain=re_constrain)
    frames, gt = make_synthetic_sequence(n_frames=9, height=120, width=160, seed=7,
                                         box0=(50.0, 40.0, 30.0, 24.0))
    frames = frames[..., :C]
    theirs_boxes, theirs_scores, theirs_events = _jax_run(jax_mt.MixFormerRuntime(**rt), jm,
                                                          params, frames, gt[0])
    ours = mt.MixFormerTracker(port, "cpu", mt.MixFormerRuntime(**rt))
    ours.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    boxes, scores, events = [], [], []
    for f in frames[1:]:
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
        events.append((o["nominated"], o["ring_update"], ours.state["n_online"],
                       ours.state["forget_id"]))
    res = compare_freerun(theirs_boxes, boxes, PX, ref_events=theirs_events,
                          our_events=events)
    assert res["pass"], res
    np.testing.assert_allclose(scores, theirs_scores, rtol=0, atol=1e-4)
    assert [e[2:] for e in events] == RING
    assert ours.nominations == sum(e[0] for e in events) > 0
    assert ours.ring_updates == 4


def test_mixformer_step_from_patch_matches_jax(models):
    """The host-crop harness step: injected search patches, resize factors
    and nominees; boxes, scores and events equal to JAX's."""
    jm, params, port = models[3]
    rt = dict(RT, re_constrain="complex")
    jrt, prt = jax_mt.MixFormerRuntime(**rt), mt.MixFormerRuntime(**rt)
    frames, gt = make_synthetic_sequence(n_frames=1, height=120, width=160, seed=8,
                                         box0=(50.0, 40.0, 30.0, 24.0))
    frame = frames[0][..., :3]
    js = jax_mt.mixformer_init_state(jrt, jm, params, jnp.asarray(frame), jnp.asarray(gt[0]))
    ps = mt.mixformer_init_state(prt, torch.from_numpy(frame[None]),
                                 torch.from_numpy(gt[:1].astype(np.float32)))
    jstep = jax.jit(lambda p, s, x, rf, c: jax_mt.mixformer_step_from_patch(
        jrt, jm, p, s, x, rf, c, (120.0, 160.0)))
    rng = np.random.RandomState(9)
    for t in range(5):
        search = rng.randn(96, 96, 3).astype(np.float32)
        cand = rng.randn(64, 64, 3).astype(np.float32)
        rf = np.float32(1.5 + 0.1 * t)
        js, jbox, jscore, jaux = jstep(params, js, jnp.asarray(search), rf, jnp.asarray(cand))
        with torch.no_grad():
            ps, pbox, pscore, paux = mt.mixformer_step_from_patch(
                prt, port, ps, torch.from_numpy(search[None]), rf,
                torch.from_numpy(cand[None]), (120.0, 160.0))
        np.testing.assert_allclose(pbox[0].numpy(), np.asarray(jbox), rtol=0, atol=1e-4)
        np.testing.assert_allclose(pscore.numpy(), float(jscore), rtol=0, atol=1e-5)
        assert (paux["nominate"], paux["at_interval"], ps["n_online"], ps["forget_id"]) == (
            bool(jaux["nominate"]), bool(jaux["at_interval"]), int(js["n_online"]),
            int(js["forget_id"]))
        np.testing.assert_allclose(ps["his_sum"].numpy(), np.asarray(js["his_sum"]), rtol=0,
                                   atol=1e-4)
