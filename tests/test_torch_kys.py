"""KYS in the port (models/kys.py, trackers/kys_tracker.py) against the JAX
package at f32 on the CPU.

The flax leaves of KYSNet are drawn from a numpy seed at the shapes of
jax.eval_shape of its init_forward at 64 px (no init compile), the DiMP
filter optimizer's at JAX's own init, and reach the port through
models/convert.py::kys_state_dict_from_flax.

Bars: local_cost_volume within 1e-5 of its largest magnitude against JAX
and against the naive window sum of tests/test_kys.py; shift_features
within 1e-6 with shifts past the edge, at sub-pixel offsets and by whole
cells, single and batched; center_shift_translation, the ConvGRUCell and
the ResponsePredictor (with and without the DiMP threshold and the
window: the fused map, the new state, the propagation weights and
confidence, the target maps of the state) within 1e-5 of their largest
magnitude. The bridge: the port's state_dict through JAX's
convert_kys_checkpoint gives the flax tree exactly (but the trunk's
layer4, which KYS never reads), and a flax .npz loads through run_ope's
'dimp' family. A free run of 6 frames at tests/test_kys.py:160's runtime
(96 px, memory 8, train_skipping 3, no augmentation) with JAX's own
uniforms: the first frame derives the GRU state from the label, the
others shift the previous frame by its sub-pixel rounding; boxes within
0.05 px (compare_freerun), fused scores within 1e-4, the flags, gru_valid
and do_shift equal per frame. Seeded weights keep the fused peak near the
centre, so the centre shift (the box outside the central region) is held
by one step from JAX's state with the previous box moved out of it.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import os
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import kys as jkys  # noqa: E402
from mmtrack_tpu.models.convert import convert_kys_checkpoint  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import kys_tracker as jky  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import dimp, kys  # noqa: E402
from mmtrack_torch.models.convert import kys_state_dict_from_flax  # noqa: E402
from mmtrack_torch.trackers import kys_tracker as ky  # noqa: E402
from test_torch_dimp import _leaf, close, optimizer_init  # noqa: E402
from test_torch_dimp_tracker import JaxDraws  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05
RT_KW = dict(image_sample_size=96, sample_memory_size=8, train_skipping=3,
             use_augmentation=False)


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def kys_tree(seed: int = 0) -> dict:
    jm = jkys.build_kysnet()
    im = jnp.zeros((1, 64, 64, 3))
    bb = jnp.asarray([[16.0, 16.0, 24.0, 24.0]])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), im, im, bb,
                                            jnp.stack([bb, bb], axis=1), method="init_forward"))
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    tree["params"]["dimp"]["filter_optimizer"] = optimizer_init("dimp")
    return tree


@pytest.fixture(scope="module")
def nets():
    tree = kys_tree()
    port = kys.build_kysnet()
    port.load_state_dict(kys_state_dict_from_flax(tree["params"]))
    return tree, port.eval().requires_grad_(False)


# ---------------------------------------------------------------- cost volume, shifts

def naive_cost_volume(f_cur, f_prev, md, k):
    """The correlation sampler's window sums (tests/test_kys.py:19)."""
    H, W = f_cur.shape[:2]
    r = k // 2
    f1 = np.pad(f_cur, ((r, r), (r, r), (0, 0)))
    f2 = np.pad(f_prev, ((r, r), (r, r), (0, 0)))
    out = np.zeros((H * W, H, W), np.float64)
    for qy in range(H):
        for qx in range(W):
            for py in range(H):
                for px in range(W):
                    if abs(qy - py) <= md and abs(qx - px) <= md:
                        out[qy * W + qx, py, px] = sum(
                            np.dot(f1[py + ky, px + kx], f2[qy + ky, qx + kx])
                            for ky in range(k) for kx in range(k))
    return out


@pytest.mark.parametrize("shape", [(6, 6, 4, 2, 3), (7, 9, 16, 9, 3), (5, 8, 8, 3, 1)])
def test_local_cost_volume_matches_jax_and_naive(shape):
    H, W, C, md, k = shape
    rng = np.random.RandomState(H * W)
    f_cur = rng.randn(2, H, W, C).astype(np.float32)
    f_prev = rng.randn(2, H, W, C).astype(np.float32)
    want = jax.jit(partial(jkys.local_cost_volume, max_disp=md, kernel=k))(f_cur, f_prev)
    got = kys.local_cost_volume(T(f_cur), T(f_prev), md, k)
    close(got.numpy(), want, 1e-5)
    close(got.numpy()[1], naive_cost_volume(f_cur[1], f_prev[1], md, k), 1e-5)


SHIFTS = {  # name -> (t_x, t_y)
    "sub_pixel": (0.3, -0.45),
    "past_the_edge": (1.7, -2.3),
    "whole_cells": (2.0 / 8 * 2, -1.0 / 6 * 2),
    "half_cell": (-0.5 / 8, -0.5 / 6),
}


@pytest.mark.parametrize("case", sorted(SHIFTS))
@pytest.mark.parametrize("batched", [False, True])
def test_shift_features_matches_jax(case, batched):
    rng = np.random.RandomState(len(case))
    x = rng.randn(*((2,) if batched else ()), 6, 8, 3).astype(np.float32)
    t = np.asarray(SHIFTS[case], np.float32)
    want = jax.jit(jkys.shift_features)(x, t)
    got = kys.shift_features(T(x), T(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_center_shift_translation_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(8):
        box = rng.uniform(-20, 120, 4).astype(np.float32)
        want = jax.jit(partial(jkys.center_shift_translation, feat_hw=(18, 18)))(box)
        close(kys.center_shift_translation(T(box), (18, 18)).numpy(), want, 1e-5)


# ---------------------------------------------------------------- the predictor

def test_conv_gru_matches_jax(nets):
    tree, port = nets
    rng = np.random.RandomState(2)
    x, h = rng.randn(2, 7, 7, 4).astype(np.float32), rng.randn(2, 7, 7, 8).astype(np.float32)
    want = jkys.ConvGRUCell(8).apply(
        {"params": tree["params"]["predictor"]["state_predictor"]}, x, h)
    with torch.no_grad():
        got = port.predictor.predictor.state_predictor(T(x).permute(0, 3, 1, 2),
                                                       T(h).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


@pytest.mark.parametrize("gates", ["none", "threshold", "threshold_window"])
def test_response_predictor_matches_jax(nets, gates):
    tree, port = nets
    H = W = 6
    rng = np.random.RandomState(3)
    cv = rng.randn(2, H * W, H, W).astype(np.float32)
    state = np.tanh(rng.randn(2, H, W, 8)).astype(np.float32)
    score = rng.uniform(-0.1, 1.0, (2, H, W)).astype(np.float32)
    thresh = None if gates == "none" else 0.3
    window = (rng.uniform(0, 1, (H, W)).astype(np.float32) if gates == "threshold_window"
              else None)
    pv = {"params": tree["params"]["predictor"]}
    jp = jkys.ResponsePredictor()
    fused, new_state, aux = jp.apply(pv, cv, state, score, thresh,
                                     None if window is None else jnp.asarray(window))
    pred = port.predictor.predictor
    with torch.no_grad():
        g_fused, g_state, g_aux = pred(T(cv), T(state), T(score), thresh,
                                       None if window is None else T(window))
        close(pred.is_target(T(state)).numpy(), aux["is_target"], 1e-5)
        close(pred.is_target(g_state).numpy(), aux["is_target_new"], 1e-5)
    close(g_fused.numpy(), fused, 1e-5)
    close(g_state.numpy(), new_state, 1e-5)
    for k in ("cost_volume_processed", "propagated_h", "propagation_conf", "fused_score_orig"):
        close(g_aux[k].numpy(), aux[k], 1e-5)
    init = jp.apply(pv, jnp.asarray(score), method=jkys.ResponsePredictor.init_state)
    with torch.no_grad():
        close(pred.init_state(T(score)).numpy(), init, 1e-5)


# ---------------------------------------------------------------- the bridge

def test_kys_bridge_round_trip(nets):
    tree, port = nets
    back = convert_kys_checkpoint(port.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == {p for p in want if "layer4" not in jax.tree_util.keystr(p)}
    for path, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), want[path], err_msg=str(path))


def test_kys_npz_loads_through_the_entry(nets, tmp_path):
    tree, port = nets
    path = str(tmp_path / "kys.npz")
    np.savez(path, params=np.asarray(tree["params"], dtype=object))
    sd = load_checkpoint(path, "dimp")
    built = registry.build_tracker("kys", params=sd, device="cpu")
    want = port.state_dict()
    for k, v in built.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_kys_recipe_matches_jax():
    r, j = registry.TRACKER_REGISTRY["kys"], JAX_REGISTRY["kys"]
    assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
    tracker = registry.build_tracker("kys", device="cpu")
    assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jky.KYSRuntime())
    assert isinstance(tracker.model, kys.KYSNet)
    assert isinstance(tracker.model.classifier.filter_optimizer, dimp.SteepestDescentGN)


# ---------------------------------------------------------------- the tracker

@pytest.fixture(scope="module")
def trackers(nets):
    tree, port = nets
    prt, jrt = ky.KYSRuntime(**RT_KW), jky.KYSRuntime(**RT_KW)
    assert dataclasses.asdict(prt) == dataclasses.asdict(jrt)
    frames, gt = make_synthetic_sequence(n_frames=7, height=240, width=320, seed=7,
                                         box0=(50.0, 40.0, 30.0, 24.0))
    return (jky.KYSTracker(jkys.build_kysnet(), tree, jrt),
            ky.KYSTracker(port, "cpu", prt, draws=JaxDraws), frames, gt)


def _jax_do_shift(rt, state) -> bool:
    t = np.asarray(jky._prev_alignment(rt, state))
    return bool(state["gru_valid"]) and bool(np.any(t != 0.0))


def test_free_run_matches_jax(trackers):
    theirs, ours, frames, gt = trackers
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    j_boxes, j_scores, j_events, boxes, scores, events = [], [], [], [], [], []
    for f in frames[1:]:
        shift = _jax_do_shift(theirs.rt, theirs.state)
        o = theirs.track(f)
        j_boxes.append(o["target_bbox"])
        j_scores.append(o["best_score"])
        j_events.append((int(theirs.state["last_flag"]), bool(theirs.state["gru_valid"]), shift))
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
        events.append((ky.FLAG_NAMES.index(o["flag"]), o["gru_valid"], o["do_shift"]))
        np.testing.assert_allclose(ours.state["last_fused"].numpy(),
                                   np.asarray(theirs.state["last_fused"]), rtol=0, atol=1e-4)
    res = compare_freerun(j_boxes, boxes, PX, ref_events=j_events, our_events=events)
    assert res["pass"], res
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-4)
    assert not events[0][2] and all(e[2] for e in events[1:])


def test_centre_shift_step_matches_jax(trackers):
    """One step from JAX's state after the free run's third frame with the
    previous box moved out of the central region: the previous frame is
    centred on it (center_shift_translation), both sides alike."""
    theirs, ours, frames, gt = trackers
    theirs.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    for f in frames[1:4]:
        theirs.track(f)
    box = np.asarray(theirs.state["prev_box_patch"]).copy()
    box[:2] += np.float32(0.3 * ours.rt.image_sample_size)
    js = {**theirs.state, "prev_box_patch": jnp.asarray(box)}
    t = np.asarray(jky._prev_alignment(theirs.rt, js))
    np.testing.assert_allclose(t, np.asarray(jkys.center_shift_translation(
        jnp.asarray(box), (ours.rt.motion_sz,) * 2, ours.rt.feat_stride)))
    draws = JaxDraws()
    draws.key = js["rng"]
    ps = {k: torch.from_numpy(np.array(v)) for k, v in js.items() if k != "rng"}
    ps["frame_num"] = int(js["frame_num"])
    new_j, jbox, jscore = theirs._step_fn(theirs.params, js, jnp.asarray(frames[4]))
    with torch.no_grad():
        new_p, pbox, pscore, aux = ky.kys_track_step(
            ours.rt, ours.model, ps, torch.from_numpy(frames[4]),
            draws("jitter", (ours.rt.num_init_random_boxes, 4)))
    assert bool(aux["do_shift"]) and int(aux["flag"]) == int(new_j["last_flag"])
    assert np.abs(pbox.numpy() - np.asarray(jbox)).max() <= PX
    assert abs(float(pscore) - float(jscore)) <= 1e-4
    np.testing.assert_allclose(new_p["last_fused"].numpy(), np.asarray(new_j["last_fused"]),
                               rtol=0, atol=1e-4)
