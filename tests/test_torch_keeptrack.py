"""KeepTrack in the port (trackers/keep_track.py, models/peak_matching.py,
trackers/keeptrack_tracker.py) against the JAX package at f32 on the CPU.

The flax leaves are drawn from a numpy seed at the shapes of
jax.eval_shape of the inits (no init compile): the super_dimp DiMPNet of
tests/test_torch_dimp.py ('hinge') and the matcher's two trees of
tests/test_torch_peak_matching.py.

Exact: extract_peaks on maps with tied, plateau and sub-threshold cells
(and fewer peaks than slots, whose -inf cells enter by index);
update_peak_state over the scripted frames of tests/test_keep_track.py
(identity, redetection, the uncertain init, the jump, the occlusion
markers with the chronological logic on, release-mode redetection) with
the mutual-NN matcher, every field of the collection each frame;
_update_memory_keeptrack over fills, the same slot replaced twice in a
row, the init-weight floor and frames without an update, each update from
JAX's state: the slot, the counts, the memory rows and the certainties
exact, the weights within 4 ulps (XLA's CPU sum vectorises in another
order than PyTorch's, and the weights are normalised twice);
_occlusion_rescale on dyadic scale histories (sums exact in any order).
The matcher itself: tests/test_torch_peak_matching.py.

The tracker at tests/test_keeptrack_tracker.py's reduced runtime (96 px,
memory 6, train_skipping 3, scale_memory 4, 4 peaks, no augmentation)
with the learned matcher at descriptor_dim 32: injected normalised
patches through keeptrack_step_from_patch from states set so that each
branch runs (low, fresh, match with the matcher, the 1-v-1 speedup, lost
then redetected), and a free run of 6 frames through KeepTrackTracker
with JAX's own uniforms (`JaxDraws`). Per frame the branch, the flag and
the selected id equal, boxes within 0.05 px (compare_freerun), scores
within 1e-4. KeepTrack's search region is 8 x sqrt(w h), so the frames
are 240 x 320 and the box small enough that inside_major's shrink stays
off its integer boundary (see test_torch_dimp_tracker.py).
"""

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
from mmtrack_tpu.models import dimp as jd  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import keep_track as jk  # noqa: E402
from mmtrack_tpu.trackers import keeptrack_tracker as jkt  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import dimp  # noqa: E402
from mmtrack_torch.trackers import keep_track as kp  # noqa: E402
from mmtrack_torch.trackers import keeptrack_tracker as kt  # noqa: E402
from test_torch_dimp import flax_tree, port_model  # noqa: E402
from test_torch_dimp_tracker import JaxDraws  # noqa: E402
from test_torch_peak_matching import D_SMALL, K, matcher_trees, port_matcher  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05
RT_KW = dict(image_sample_size=96, sample_memory_size=6, train_skipping=3, scale_memory=4,
             use_augmentation=False, descriptor_dim=D_SMALL)
FRAME_HW = (240, 320)
BOX0 = (50.0, 40.0, 20.0, 16.0)


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def runtimes():
    return (kt.KeepTrackRuntime(peaks=kp.PeakMatchConfig(num_peaks=K), **RT_KW),
            jkt.KeepTrackRuntime(peaks=jk.PeakMatchConfig(num_peaks=K), **RT_KW))


# ---------------------------------------------------------------- peak functions

def _map(cells, shape=(9, 11)):
    m = np.zeros(shape, np.float32)
    for (y, x), v in cells:
        m[y, x] = v
    return m


PEAK_MAPS = {
    # equal peaks far apart, a two-cell plateau (both cells maxima), a
    # sub-threshold cell: more candidates than slots, ties by index
    "ties_and_plateau": _map([((1, 1), 0.7), ((7, 9), 0.7), ((4, 5), 0.7), ((8, 1), 0.5),
                              ((8, 2), 0.5), ((1, 8), 0.04)]),
    # two peaks for four slots: the -inf cells fill the rest by index
    "fewer_than_slots": _map([((5, 5), 0.9), ((0, 10), 0.3), ((5, 6), 0.2)]),
    "threshold_exact": _map([((2, 2), 0.05), ((6, 8), 0.051)]),
    "random": np.random.RandomState(4).uniform(-0.2, 1.0, (9, 11)).astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(PEAK_MAPS))
def test_extract_peaks_matches_jax(case):
    m = PEAK_MAPS[case]
    want = jk.extract_peaks(jnp.asarray(m), jk.PeakMatchConfig(num_peaks=K))
    got = kp.extract_peaks(T(m), kp.PeakMatchConfig(num_peaks=K))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _unit(rng, n=8):
    v = rng.randn(n).astype(np.float32)
    return v / np.linalg.norm(v)


def _frame(peaks):
    """(scores, coords, desc, valid) of up to K peaks (score, (y, x), desc)."""
    zero = np.zeros(8, np.float32)
    n = len(peaks)
    scores = np.asarray([p[0] for p in peaks] + [0.0] * (K - n), np.float32)
    coords = np.asarray([p[1] for p in peaks] + [[0.0, 0.0]] * (K - n), np.float32)
    desc = np.stack([p[2] for p in peaks] + [zero] * (K - n)).astype(np.float32)
    valid = np.asarray([True] * n + [False] * (K - n))
    return scores, coords, desc, valid


def _scripts():
    rng = np.random.RandomState(2)
    tgt, dis = _unit(rng), _unit(rng)
    return {  # name -> (chrono, certain, init frame, frames)
        "identity_and_redetection": (False, True, [(0.9, [5.0, 5.0], tgt)], [
            [(0.85, [15.0, 15.0], dis), (0.8, [6.0, 5.0], tgt)],
            [(0.1, [15.0, 15.0], dis)],
            [(0.6, [7.0, 6.0], tgt)]]),
        "uncertain_init": (False, False, [(0.9, [5.0, 5.0], tgt), (0.4, [9.0, 9.0], tgt)], [
            [(0.7, [5.0, 6.0], tgt), (0.5, [9.0, 9.0], dis)]]),
        "jump": (False, True, [(0.9, [5.0, 5.0], tgt)], [
            [(0.95, [15.0, 15.0], dis), (0.8, [6.0, 5.0], tgt)]]),
        "occlusion_chrono": (True, True, [(0.95, [5.0, 5.0], tgt)], [
            [(0.9, [5.5, 5.0], tgt), (0.7, [15.0, 15.0], dis)],
            [(0.8, [15.5, 15.0], dis)],
            [(0.8, [15.5, 15.5], dis), (0.6, [30.0, 2.0], _unit(rng))]]),
        "release_redetect": (False, True, [(0.95, [5.0, 5.0], tgt)], [
            [(0.9, [5.5, 5.0], tgt), (0.7, [15.0, 15.0], dis)],
            [(0.8, [15.5, 15.0], dis)]]),
        "low_probability_drop": (False, True, [(0.9, [5.0, 5.0], tgt), (0.3, [2.0, 9.0], dis)], [
            [(0.15, [5.0, 5.5], 0.6 * tgt + 0.8 * _unit(rng)), (0.3, [2.0, 9.0], dis)]]),
    }


@pytest.mark.parametrize("case", sorted(_scripts()))
def test_update_peak_state_matches_jax(case):
    chrono, certain, init, frames = _scripts()[case]
    pc, jc = (kp.PeakMatchConfig(num_peaks=K, disable_chrono=not chrono),
              jk.PeakMatchConfig(num_peaks=K, disable_chrono=not chrono))
    s, c, d, v = _frame(init)
    j_update = jax.jit(partial(jk.update_peak_state, cfg=jc))
    js = jk.init_peak_state(jc, jnp.asarray(s), jnp.asarray(c), jnp.asarray(c), jnp.asarray(v),
                            jnp.asarray(d), certain=certain)
    ps = kp.init_peak_state(pc, T(s), T(c), T(c), T(v, bool), T(d), certain=certain)
    for t, peaks in enumerate([None] + frames):
        if peaks is not None:
            s, c, d, v = _frame(peaks)
            js, j_sel, j_lost = j_update(js, scores=jnp.asarray(s), coords=jnp.asarray(c),
                                         kpts=jnp.asarray(c), valid=jnp.asarray(v),
                                         descriptors=jnp.asarray(d))
            ps, p_sel, p_lost = kp.update_peak_state(ps, pc, T(s), T(c), T(c), T(v, bool), T(d))
            assert (int(p_sel), bool(p_lost)) == (int(j_sel), bool(j_lost)), t
        for key in js:
            np.testing.assert_array_equal(ps[key].numpy(), np.asarray(js[key]),
                                          err_msg=f"{case} frame {t} {key}")


# ---------------------------------------------------------------- memory, rescale

def test_update_memory_keeptrack_matches_jax():
    """12 frames into a 6-slot memory with one init sample: the fill, the
    lowest certainty x weight replaced (the same slot twice in a row by a
    low certainty), the init weight's floor, frames without an update."""
    prt, jrt = runtimes()
    M, S, C = 6, 3, 2
    rng = np.random.RandomState(5)
    certs = [1.0, 0.5, 0.75, 0.25, 1.0, 0.5, 0.0625, 0.0625, 0.125, 0.5, 0.0625, 1.0]
    oks = [True, True, False, True, True, True, True, True, True, False, True, True]
    sw0 = np.zeros(M, np.float32)
    sw0[0] = 1.0
    js = {"memory_feat": jnp.asarray(np.zeros((M, S, S, C), np.float32)),
          "memory_boxes": jnp.zeros((M, 4)), "memory_labels": jnp.zeros((M, 4, 4)),
          "certainties": jnp.asarray(np.eye(1, M, dtype=np.float32)[0]),
          "sample_weights": jnp.asarray(sw0), "num_stored": jnp.asarray(1, jnp.int32),
          "prev_replace_ind": jnp.asarray(-1, jnp.int32)}
    update = jax.jit(partial(jkt._update_memory_keeptrack, jrt))
    slots = []
    for t, (cert, ok) in enumerate(zip(certs, oks)):
        f = rng.randint(-8, 8, (S, S, C)).astype(np.float32) / 4
        b = rng.randint(0, 64, 4).astype(np.float32)
        lab = rng.randint(0, 8, (4, 4)).astype(np.float32) / 8
        ps = {k: T(np.asarray(v), np.asarray(v).dtype) for k, v in js.items()}
        upd = update(js, jnp.asarray(f), jnp.asarray(b), jnp.asarray(lab), jnp.float32(0.5),
                     jnp.float32(cert))
        js = {k: jnp.where(ok, upd[k], js[k]) for k in js}
        ps = kt._update_memory_keeptrack(prt, ps, T(f), T(b), T(lab), torch.tensor(0.5),
                                         torch.tensor(cert), torch.tensor(ok))
        slots.append(int(js["prev_replace_ind"]))
        for k in js:
            if k == "sample_weights":
                np.testing.assert_array_max_ulp(ps[k].numpy(), np.asarray(js[k]), maxulp=4)
            else:
                np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]),
                                              err_msg=f"{k} {t}")
    assert int(js["num_stored"]) == M
    assert any(a == b and a >= 0 for a, b in zip(slots, slots[1:]))   # the same slot twice


SCALE_CASES = {  # name -> (scale history, counters)
    "short": ([1.0, 1.25, 0.875, 1.125, 1.0625], (1, 2, 3, 5)),
    "wrapped": ([1.0, 1.375, 0.75, 1.125, 0.9375, 1.25, 1.0, 0.96875, 1.1875], (2, 4, 30)),
    "empty": ([], (1, 3)),
}


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_occlusion_rescale_matches_jax(case):
    hist, counters = SCALE_CASES[case]
    prt, jrt = runtimes()
    Mr = prt.scale_memory
    ring = np.zeros(Mr, np.float32)
    for i, v in enumerate(hist):
        ring[i % Mr] = v
    rescale = jax.jit(partial(jkt._occlusion_rescale, jrt))
    for counter in counters:
        want = rescale(jnp.asarray(ring), jnp.asarray(len(hist), jnp.int32),
                       jnp.asarray(counter, jnp.int32))
        got = kt._occlusion_rescale(prt, T(ring), torch.tensor(len(hist), dtype=torch.int32),
                                    torch.tensor(counter, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- the tracker

@pytest.fixture(scope="module")
def tracker_setup():
    prt, jrt = runtimes()
    tree, mt = flax_tree("hinge"), matcher_trees(D_SMALL)
    frames, gt = make_synthetic_sequence(n_frames=7, height=FRAME_HW[0], width=FRAME_HW[1],
                                         seed=7, box0=BOX0)
    theirs = jkt.KeepTrackTracker(jd.build_super_dimp50(), tree, jrt, matcher_params=mt)
    ours = kt.KeepTrackTracker(port_model("hinge", tree), "cpu", prt, draws=JaxDraws,
                               matcher=port_matcher(mt, D_SMALL))
    return {"prt": prt, "jrt": jrt, "tree": tree, "mt": mt, "frames": frames, "gt": gt,
            "theirs": theirs, "ours": ours}


def jax_branch(prev: dict, new: dict) -> str:
    """The branch a JAX step took, read from its states."""
    if not bool(new["mem_ok"]):
        return "low"
    if not bool(new["last_use_match"]):
        return "fresh"
    pv, ps = np.asarray(prev["peaks"]["peak_valid"]), np.asarray(prev["peaks"]["peak_scores"])
    cv, cs = np.asarray(new["peaks"]["peak_valid"]), np.asarray(new["peaks"]["peak_scores"])
    one = pv.sum() == 1 and cv.sum() == 1 and ps.max() > 0.5 and cs.max() > 0.5
    return "speedup" if one else "match"


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def port_state(js: dict) -> dict:
    """A fresh port copy of a JAX state (frame_num a Python int)."""
    ps = _to_torch(js)
    ps["frame_num"] = int(js["frame_num"])
    return ps


@pytest.fixture(scope="module")
def injected(tracker_setup):
    """(run, base JAX state): run(js, patch, filter) steps both runtimes
    from the JAX state js with the normalised patch and that filter, and
    returns (JAX state, JAX box, JAX score, port state, port box, port
    score, port aux)."""
    su = tracker_setup
    prt, jrt, theirs, ours = su["prt"], su["jrt"], su["theirs"], su["ours"]
    theirs.initialize(su["frames"][0], {"init_bbox": su["gt"][0].tolist()})
    base = jax.tree.map(np.asarray, theirs.state)
    im_hw = (float(FRAME_HW[0]), float(FRAME_HW[1]))
    jstep = jax.jit(lambda p, mp, st, patch, tl, cs, sp, ss: jkt.keeptrack_step_from_patch(
        jrt, theirs.model, theirs.bundle, p, mp, st, patch, tl, cs, sp, ss, im_hw))

    def run(js, patch, filt):
        # the JAX step splits its key PRNGKey(0) for the box jitter, as a
        # fresh JaxDraws does
        js = {**js, "filter": np.asarray(filt, np.float32),
              "rng": np.asarray(jax.random.PRNGKey(0))}
        ps = port_state(js)
        szl, tl, sp, ss = kt._sample_geometry(prt, ps["pos"], ps["target_scale"], im_hw=FRAME_HW)
        jitter = JaxDraws()("jitter", (prt.num_init_random_boxes, 4))
        new_j, jbox, jscore = jstep(theirs.params, theirs.matcher_params, js, jnp.asarray(patch),
                                    *(jnp.asarray(a.numpy()) for a in (tl, szl, sp, ss)))
        with torch.no_grad():
            new_p, pbox, pscore, aux = kt.keeptrack_step_from_patch(
                prt, ours.model, ours.matcher, ps, T(patch), tl, szl, sp, ss, im_hw, jitter)
        return jax.tree.map(np.asarray, new_j), jbox, jscore, new_p, pbox, pscore, aux

    return run, base


def _scaled(model, patch, filt, top):
    """filt scaled so that the port's score map of patch peaks at `top`."""
    with torch.no_grad():
        f = model.extract_classification_feat(model.extract_backbone(T(patch)[None]))
        m = float(model.classify(T(filt), f)[0].max())
    return np.float32(top / m) * np.asarray(filt, np.float32)


def _matched_filter(model, patch, top=0.9):
    """A filter of the patch's own features at one cell: one peak."""
    with torch.no_grad():
        f = model.extract_classification_feat(model.extract_backbone(T(patch)[None]))
    return _scaled(model, patch, f[0, 1:5, 2:6].numpy(), top)


BRANCH_CASES = ("low", "fresh", "match", "speedup", "lost_then_redetected")


@pytest.mark.parametrize("case", BRANCH_CASES)
def test_injected_patches_match_jax_on_each_branch(tracker_setup, injected, case):
    run, base = injected
    model = tracker_setup["ours"].model
    rng = np.random.RandomState(BRANCH_CASES.index(case) + 11)
    patches = [rng.randn(96, 96, 6).astype(np.float32) for _ in range(2)]
    filt = base["filter"]
    if case == "low":
        steps = [(base, patches[0], np.zeros_like(filt), "low")]
    elif case == "fresh":
        steps = [(base, patches[0], _scaled(model, patches[0], filt, 1.0), "fresh")]
    elif case == "match":
        first = run(base, patches[0], _scaled(model, patches[0], filt, 1.0))[0]
        # a top below the first frame's: a tie of the two would leave the
        # jump to a rounding
        steps = [(first, patches[1], _scaled(model, patches[1], filt, 0.7), "match")]
    elif case == "speedup":
        first = run(base, patches[0], _matched_filter(model, patches[0]))[0]
        assert np.asarray(first["peaks"]["peak_valid"]).sum() == 1
        steps = [(first, patches[1], _matched_filter(model, patches[1]), "speedup")]
    else:
        first = run(base, patches[0], _scaled(model, patches[0], filt, 1.0))[0]
        first = {**first, "peaks": {**first["peaks"],
                                    "selected_object_id": np.asarray(99, np.int32)}}
        steps = [(first, patches[1], _scaled(model, patches[1], filt, 0.2), "match"),
                 (None, patches[0], _scaled(model, patches[0], filt, 0.8), "match")]
    flags, prev = [], None
    for js, patch, f, want_branch in steps:
        js = prev if js is None else js
        new_j, jbox, jscore, new_p, pbox, pscore, aux = run(js, patch, f)
        branch = jax_branch(js, new_j)
        assert branch == want_branch, case
        assert kt.BRANCH_NAMES[int(aux["branch"])] == branch
        assert int(aux["flag"]) == int(new_j["last_flag"])
        assert int(aux["selected_id"]) == int(new_j["peaks"]["selected_object_id"])
        for k in ("object_ids", "peak_valid", "flag_not_found", "object_id_cntr"):
            np.testing.assert_array_equal(new_p["peaks"][k].numpy(), new_j["peaks"][k])
        assert np.abs(pbox.numpy() - np.asarray(jbox)).max() <= PX
        assert abs(float(pscore) - float(jscore)) <= 1e-4
        flags.append(int(new_j["last_flag"]))
        prev = new_j
    if case == "lost_then_redetected":
        assert flags == [kt.FLAG_NOT_FOUND, kt.FLAG_NORMAL]
        assert int(prev["peaks"]["selected_object_id"]) != 99


def test_free_run_matches_jax(tracker_setup):
    su = tracker_setup
    theirs, ours, frames, gt = su["theirs"], su["ours"], su["frames"], su["gt"]
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    j_boxes, j_scores, j_events, boxes, scores, events = [], [], [], [], [], []
    for f in frames[1:]:
        prev = theirs.state
        o = theirs.track(f)
        js = theirs.state
        j_boxes.append(o["target_bbox"])
        j_scores.append(o["best_score"])
        j_events.append((int(js["last_flag"]), jax_branch(prev, js),
                         int(js["peaks"]["selected_object_id"])))
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
        events.append((kt.FLAG_NAMES.index(o["flag"]), o["branch"], o["selected_id"]))
    res = compare_freerun(j_boxes, boxes, PX, ref_events=j_events, our_events=events)
    assert res["pass"], res
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-4)
    assert ours.branches["fresh"] >= 1 and ours.matcher_passes >= 1, ours.branches


# ---------------------------------------------------------------- the recipe

def test_keep_track_recipe_matches_jax(tmp_path):
    """keep_track: JAX's modality, family, composition and runtime; the
    hinge optimiser; a seeded matcher at 256 without matcher keys, the
    given one with them; a flax super_dimp .npz through run_ope's dimp
    bridge."""
    r, j = registry.TRACKER_REGISTRY["keep_track"], JAX_REGISTRY["keep_track"]
    assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
    tracker = registry.build_tracker("keep_track", device="cpu")
    assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jkt.KeepTrackRuntime())
    assert isinstance(tracker.model.classifier.filter_optimizer, dimp.SteepestDescentHinge)
    assert tracker.matcher.matcher.descriptor_dim == 256

    tree = flax_tree("hinge")
    path = str(tmp_path / "keep_track.npz")
    np.savez(path, params=np.asarray(tree["params"], dtype=object))
    sd = load_checkpoint(path, "dimp")
    matcher_sd = {k: v + 1.0 for k, v in tracker.matcher.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    built = registry.build_tracker("keep_track", params={**sd, **matcher_sd}, device="cpu")
    want = port_model("hinge", tree).state_dict()
    for k, v in built.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in matcher_sd.items():
        assert torch.equal(built.matcher.state_dict()[k], v), k
