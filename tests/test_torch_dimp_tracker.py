"""The DiMP tracker runtime of the port (trackers/dimp_tracker.py) against
the JAX package at f32, on bridged weights, and the family's registry
recipes.

Free runs from frame 0, 6 tracked frames of 120 x 160 synthetic frames,
96 px samples, a 20-slot memory and train_skipping 2 (so the filter
update runs on tracked frames 2, 4 and 6), against JAX's jitted
DiMPTracker: DeT-max with the augmented init, PrDiMP-50's runtime
(softmax scores, relative refinement, inside_major borders), DeT-conv
without augmentation and DeT-max classifier-only (use_iou_net False).
The port draws JAX's own uniforms (`JaxDraws` follows the threefry keys of
the JAX init and step). Bars: boxes within 0.05 px
(tools/parity/freerun.py::compare_freerun), scores within 1e-4, the
localisation flags equal frame by frame. Exact against the jitted JAX
functions (as the JAX tracker runs them): _sample_geometry in the three
border modes (the shrink's side one pixel short where XLA's reciprocal
product makes it so), _get_iounet_box, _localize_advanced on maps that
raise every flag (and a tied peak); _update_memory over fills,
replacements and masked frames, each update from JAX's state: the slot,
the counts and the memory exact, the weights within 4 ulps (XLA's CPU sum
adds the f32 weights left to right, PyTorch's vectorises, and they are
normalised twice). The registry: every name, JAX's less the two not
ported yet, builds on the CPU (MixFormer narrowed), the eight DiMP
recipes with JAX's names,
modalities, family, compositions and runtimes.
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
from mmtrack_tpu.trackers import dimp_tracker as jdt  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import dimp, mixformer  # noqa: E402
from mmtrack_torch.trackers import dimp_tracker as dt  # noqa: E402
from test_torch_dimp import flax_tree, port_model, strip_merge  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05
SMALL = dict(image_sample_size=96, sample_memory_size=20, train_skipping=2)
DIMP_RECIPES = ("dimp50", "det_dimp50_max", "det_dimp50_mean", "det_dimp50_mul",
                "det_dimp50_weightedsum", "det_dimp50_mc", "mfdimp", "prdimp50")


class JaxDraws:
    """The JAX tracker's uniforms: PRNGKey(0) split into (key, shift,
    dropout) at an augmented init, one split of the key per step."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, kind, shape):
        if kind == "shift":
            self.key, self.shift_key, self.drop_key = jax.random.split(self.key, 3)
            key = self.shift_key
        elif kind == "dropout":
            key = self.drop_key
        else:
            self.key, key = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


@pytest.fixture(scope="module")
def trees():
    return {"det_conv": flax_tree("det_conv"), "prdimp": flax_tree("prdimp")}


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- free runs

BOX0 = (50.0, 40.0, 30.0, 24.0)
# PrDiMP's search region is 6 x sqrt(w h): for BOX0, 161 px, wider than
# the 160 px frame, so inside_major's shrink would set the side to
# trunc(x / (x * (1 / 160))), on the integer boundary every frame, where
# one ulp of the scale moves the crop by a pixel (JAX's jit against its
# own eager run does that). Its free run starts from a smaller box, whose
# region fits; test_sample_geometry_matches_jax holds the shrink exactly.
PRDIMP_BOX0 = (50.0, 40.0, 20.0, 16.0)
RUNS = {  # name -> (merge or None for PrDiMP, runtime keywords, JAX runtime, first box)
    "det_max_augmented": ("max", dict(SMALL), jdt.DiMPRuntime, BOX0),
    "prdimp50": (None, dict(SMALL), jdt.prdimp50_runtime, PRDIMP_BOX0),
    "det_conv_plain": ("conv", dict(SMALL, use_augmentation=False), jdt.DiMPRuntime, BOX0),
    # use_iou_net=False: classifier-only, the scale re-quantised from the crop
    "det_max_classifier_only": ("max", dict(SMALL, use_augmentation=False, use_iou_net=False),
                                jdt.DiMPRuntime, BOX0),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_dimp_tracker_free_run_matches_jax(trees, run):
    merge, kw, jrt_factory, box0 = RUNS[run]
    if merge is None:
        params, jm = trees["prdimp"], jd.build_prdimp50()
        port = port_model("prdimp", params)
        prt = dt.prdimp50_runtime(**kw)
    else:
        params = trees["det_conv"] if merge == "conv" else strip_merge(trees["det_conv"])
        jm, port = jd.DiMPNet(merge_type=merge), port_model(merge, params)
        prt = dt.DiMPRuntime(**kw)
    jrt = jrt_factory(**kw)
    assert dataclasses.asdict(prt) == dataclasses.asdict(jrt)
    frames, gt = make_synthetic_sequence(n_frames=7, height=120, width=160, seed=7, box0=box0)
    theirs = jdt.DiMPTracker(jm, params, jrt)
    ours = dt.DiMPTracker(port, "cpu", prt, draws=JaxDraws)
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    j_boxes, j_scores, j_flags, boxes, scores, flags = [], [], [], [], [], []
    for f in frames[1:]:
        o = theirs.track(f)
        j_boxes.append(o["target_bbox"])
        j_scores.append(o["best_score"])
        j_flags.append((int(theirs.state["last_flag"]),))
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
        flags.append((dt.FLAG_NAMES.index(o["flag"]),))
    res = compare_freerun(j_boxes, boxes, PX, ref_events=j_flags, our_events=flags)
    assert res["pass"], res
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.state["sample_weights"].numpy(),
                               np.asarray(theirs.state["sample_weights"]), rtol=0, atol=1e-6)
    assert int(ours.state["num_stored"]) == int(theirs.state["num_stored"])
    assert sum(ours.flags.values()) == 6


# ---------------------------------------------------------------- exact pieces

@pytest.mark.parametrize("mode", ["replicate", "inside_major", "inside"])
def test_sample_geometry_matches_jax(mode):
    rng = np.random.RandomState(3)
    kw = dict(image_sample_size=288, border_mode=mode, patch_max_scale_change=1.5)
    prt, jrt = dt.DiMPRuntime(**kw), jdt.DiMPRuntime(**kw)
    geometry = jax.jit(partial(jdt._sample_geometry, jrt), static_argnames="im_hw")
    box = jax.jit(lambda p, a, b: jdt._get_iounet_box(jrt, p, jnp.asarray([30.0, 40.0]), a, b))
    sizes = [(120, 160), (480, 640)] + [(int(rng.randint(100, 500)), int(rng.randint(100, 700)))
                                        for _ in range(3)]
    for i in range(40):
        im_hw = sizes[i % len(sizes)]
        pos = rng.uniform(-20, max(im_hw) + 20, (2,)).astype(np.float32)
        scale = np.float32(rng.uniform(0.05, 2.5))
        hw = None if mode == "replicate" else im_hw
        want = geometry(jnp.asarray(pos), jnp.float32(scale), im_hw=hw)
        got = dt._sample_geometry(prt, T(pos), torch.tensor(scale), im_hw=hw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        box_g = dt._get_iounet_box(prt, T(pos), T([30.0, 40.0]), got[2], got[3])
        np.testing.assert_array_equal(box_g.numpy(), np.asarray(box(jnp.asarray(pos), *want[2:])))


LOC_RT = dict(image_sample_size=96, use_augmentation=False)


def _peaks(*cells):
    s = np.zeros((7, 7), np.float32)
    for (y, x), v in cells:
        s[y, x] = v
    return s


LOC_CASES = {  # name -> (score map, JAX flag)
    "normal": (_peaks(((3, 4), 1.0)), jdt.FLAG_NORMAL),
    "not_found": (np.full((7, 7), 0.1, np.float32), jdt.FLAG_NOT_FOUND),
    "hard_negative_far_distractor": (_peaks(((3, 3), 1.0), ((0, 0), 0.9)), jdt.FLAG_HARD_NEG),
    "hard_negative_near_distractor": (_peaks(((0, 0), 1.0), ((3, 3), 0.9)),
                                      jdt.FLAG_HARD_NEG),
    "uncertain": (_peaks(((0, 0), 1.0), ((6, 6), 0.9)), jdt.FLAG_UNCERTAIN),
    "hard_negative_second_peak": (_peaks(((3, 3), 1.0), ((0, 6), 0.6)), jdt.FLAG_HARD_NEG),
    # the first of two equal peaks is the target; the second, nearer the
    # previous position, makes a hard negative that moves to it
    "tied_peak": (_peaks(((1, 1), 1.0), ((5, 5), 1.0)), jdt.FLAG_HARD_NEG),
    "random": (np.random.RandomState(8).uniform(0, 1, (7, 7)).astype(np.float32), None),
}


@pytest.mark.parametrize("case", sorted(LOC_CASES))
def test_localize_advanced_matches_jax(case):
    scores, flag = LOC_CASES[case]
    prt, jrt = dt.DiMPRuntime(**LOC_RT), jdt.DiMPRuntime(**LOC_RT)
    pos, sz, sp = [50.0, 52.0], [20.0, 24.0], [49.0, 51.5]
    want = jdt._localize_advanced(jrt, jnp.asarray(scores),
                                  {"pos": jnp.asarray(pos), "target_sz": jnp.asarray(sz)},
                                  jnp.asarray(sp), jnp.float32(1.25))
    got = dt._localize_advanced(prt, T(scores), {"pos": T(pos), "target_sz": T(sz)}, T(sp),
                                torch.tensor(1.25))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if flag is not None:
        assert int(got[1]) == flag


@pytest.mark.parametrize("augmented", [True, False])
def test_update_memory_matches_jax(augmented):
    """25 frames into a 20-slot memory: fills, replacements of the
    min-weight slot, the init samples' minimum weight, and frames that do
    not update (the step's update_ok)."""
    kw = dict(image_sample_size=64, sample_memory_size=20, use_augmentation=augmented)
    prt, jrt = dt.DiMPRuntime(**kw), jdt.DiMPRuntime(**kw)
    M, S, C, N = 20, prt.feat_sz, 3, prt.num_init_samples
    rng = np.random.RandomState(9)
    sw0 = np.zeros(M, np.float32)
    sw0[:N] = 1.0 / N
    feat0 = np.zeros((M, S, S, C), np.float32)
    feat0[:N] = rng.randn(N, S, S, C)
    js = {"memory_feat": jnp.asarray(feat0), "memory_boxes": jnp.zeros((M, 4)),
          "sample_weights": jnp.asarray(sw0), "num_stored": jnp.asarray(N, jnp.int32),
          "prev_replace_ind": jnp.asarray(-1, jnp.int32)}
    for t in range(25):
        f, b = rng.randn(S, S, C).astype(np.float32), rng.uniform(0, 60, 4).astype(np.float32)
        lr = np.float32(0.02 if t % 3 == 1 else 0.01)
        ok = t % 5 != 4
        # each update from JAX's state, so only its own rounding differs
        ps = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
        upd = jdt._update_memory(jrt, js, jnp.asarray(f), jnp.asarray(b), jnp.asarray(lr))
        js = jax.tree.map(lambda a, b_: jnp.where(ok, a, b_), upd, js)
        ps = dt._update_memory(prt, ps, T(f), T(b), torch.tensor(lr), torch.tensor(ok))
        for k in js:
            if k == "sample_weights":
                np.testing.assert_array_max_ulp(ps[k].numpy(), np.asarray(js[k]), maxulp=4)
            else:
                np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]), err_msg=f"{k} {t}")
    assert int(ps["num_stored"]) == M


# ---------------------------------------------------------------- registry

JAX_RUNTIMES = {"prdimp50": jdt.prdimp50_runtime()}


# the JAX registry's recipes the port does not build yet (ROADMAP queue 1)
NOT_PORTED = {"lwl", "stm"}


def test_registry_builds_every_recipe_on_the_cpu(monkeypatch):
    """Every name of the registry, JAX's less the ones not ported yet,
    builds on the CPU (MixFormer-L narrowed); the DiMP recipes with JAX's
    names, modality, family, composition and runtime, their networks of
    the recipe's kind, optimizer at JAX's init. (The other families' tests
    check their own recipes.)"""
    monkeypatch.setattr(mixformer, "build_mixformer_rgbd",
                        lambda in_channels=6, device=None: mixformer.MixFormer(
                            in_channels=in_channels, stage_dims=(16, 32, 48),
                            stage_depths=(1, 1, 1), stage_heads=(1, 2, 3), head_channel=16))
    names = registry.list_trackers()
    assert set(names) == set(JAX_REGISTRY) - NOT_PORTED and set(DIMP_RECIPES) <= set(names)
    for name in names:
        tracker = registry.build_tracker(name, device="cpu")
        if name not in DIMP_RECIPES:
            continue
        r, j = registry.TRACKER_REGISTRY[name], JAX_REGISTRY[name]
        assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
        jrt = JAX_RUNTIMES.get(name, jdt.DiMPRuntime())
        assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jrt), name
        model = tracker.model
        want_merge = {"dimp50": None, "prdimp50": None, "det_dimp50_mc": "conv",
                      "det_dimp50_weightedsum": "weightedSum", "mfdimp": "mean"}.get(
                          name, name.rsplit("_", 1)[-1])
        assert model.merge_type == want_merge, name
        assert isinstance(model.classifier.filter_optimizer,
                          dimp.SteepestDescentNewtonKL if name == "prdimp50"
                          else dimp.SteepestDescentGN)
        del tracker


def test_dimp_npz_loads_through_the_entry(trees, tmp_path):
    """A flax .npz of a DeT-conv tree reaches the port through run_ope's
    loader (the 'dimp' family's bridge)."""
    params = trees["det_conv"]["params"]
    path = str(tmp_path / "det.npz")
    np.savez(path, params=np.asarray(params, dtype=object))
    sd = load_checkpoint(path, "dimp")
    fresh = dimp.DiMPNet(merge_type="conv")
    fresh.load_state_dict(sd)
    want = port_model("conv", trees["det_conv"]).state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
