"""ATOM in the port (models/atom.py, trackers/atom_tracker.py) against the
JAX package at f32, on bridged weights.

The flax ATOMNet trees' shapes come from jax.eval_shape of the init at
64 px (no compile), their values from a numpy seed; they reach the port
through models/convert.py::dimp_state_dict_from_flax (ATOM's family is
'dimp'). ATOMNet: extract_backbone for the four merges (max, mean, mul,
conv) and the IoU forward within 1e-4 of the largest |JAX value|.

The init's joint solve (6 Gauss-Newton steps of 10 CG iterations over
(filter, projection), the projection preconditioned by 1 / 1e-4) is
chaotic in f32: JAX against itself, its features scaled by 1 + 1e-7,
ends with P 15% and f 7% apart, and the port's own init then moves
det_atom_max's boxes by up to 19 px over 6 frames (scores by 0.26) while
atom's stay within 3e-5 px. So the solve is held in f64 on both sides
(within 1e-10: the same algorithm), and the init state in f32 where the
solve does not enter: labels, weights, the IoU modulation.

Free runs against JAX's jitted ATOMTracker, 6 tracked frames of 120 x
160 synthetic frames, 96 px samples, a 40-slot memory and
train_skipping 2 (so the CG update runs on tracked frames 2, 4 and 6),
the port starting from JAX's init state: det_atom_max with ATOM's full
augmented init (30 image augmentations and 7 dropout copies), atom and
det_atom_mc with a smaller augmentation set (the compile of JAX's init
grows with it). The port draws JAX's own numbers (`JaxDraws`: the
threefry keys of the JAX init, its normal inits of P and f, one key
split a step). Bars: boxes within 0.05 px
(tools/parity/freerun.py::compare_freerun), scores within 1e-4, the
final filter within 1e-4, the localisation flags (read from JAX's step
through a debug callback) equal frame by frame. Exact against the jitted JAX functions: _localize_atom on
288 x 288 maps that raise every flag, and _update_memory_atom over
fills, replacements and masked frames, each update from JAX's state (the
weights within 4 ulps, as for DiMP's memory).
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
from mmtrack_tpu.models import atom as ja  # noqa: E402
from mmtrack_tpu.trackers import atom_tracker as jat  # noqa: E402
from mmtrack_torch.models import atom  # noqa: E402
from mmtrack_torch.models.convert import dimp_state_dict_from_flax  # noqa: E402
from mmtrack_torch.trackers import atom_tracker as at  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05
SMALL = dict(image_sample_size=96, sample_memory_size=40, train_skipping=2)
FEW_AUGS = dict(aug_rotate=(10, -10, 45), aug_blur=((2, 0.2), (2, 2)), aug_dropout_num=3)


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"max |diff| / max |want| = {err:.3g} > {rel}"


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _leaf(rng, path, shape):
    name = path[-1].key
    if name == "kernel":
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    return 0.1 * rng.randn(*shape)


def flax_tree(merge, seed: int = 0) -> dict:
    """{'params': ...} of a JAX ATOMNet: eval_shape of the init, numpy-seeded
    values."""
    jm = ja.ATOMNet(merge_type=merge)
    im = jnp.zeros((1, 64, 64, 6))
    bb = jnp.asarray([[16.0, 16.0, 24.0, 24.0]])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), im, bb,
                                            jnp.stack([bb, bb], axis=1)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)


def port_model(merge, params) -> atom.ATOMNet:
    m = atom.ATOMNet(merge_type=merge)
    m.load_state_dict(dimp_state_dict_from_flax(params["params"]))
    return m.eval()


@pytest.fixture(scope="module")
def trees():
    conv = flax_tree("conv")
    plain = flax_tree(None, seed=1)
    strip = {"params": {k: v for k, v in conv["params"].items() if not k.startswith("merge")}}
    return {"conv": conv, None: plain, "max": strip, "mean": strip, "mul": strip}


@pytest.mark.parametrize("merge", ["max", "mean", "mul", "conv"])
def test_atomnet_matches_jax(trees, merge):
    params = trees[merge]
    jm, pm = ja.ATOMNet(merge_type=merge), port_model(merge, params)
    rng = np.random.RandomState(4)
    im = rng.randn(2, 64, 64, 6).astype(np.float32)
    bb = np.asarray([[14.0, 18.0, 26.0, 22.0], [20.0, 12.0, 18.0, 30.0]], np.float32)
    props = np.stack([bb, bb + 2.5, bb - 1.5], axis=1)
    want = jm.apply(params, jnp.asarray(im), method=ja.ATOMNet.extract_backbone)
    iou = jm.apply(params, jnp.asarray(im), jnp.asarray(bb), jnp.asarray(props))
    with torch.no_grad():
        got = pm.extract_backbone(T(im))
        got_iou = pm(T(im), T(bb), T(props))
    for k in ("layer2", "layer3"):
        close(got[k].numpy(), want[k], 1e-4)
    close(got_iou.numpy(), iou, 1e-4)


# ---------------------------------------------------------------- free runs

class JaxDraws:
    """The JAX ATOM tracker's numbers: PRNGKey(0) split into (key, shift,
    dropout) at init, the key split again into (key, P, f) for the normal
    inits, one split of the key per step for the box jitter."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, kind, shape):
        if kind == "shift":
            self.key, key, self.drop_key = jax.random.split(self.key, 3)
        elif kind == "dropout":
            key = self.drop_key
        elif kind == "projection":
            self.key, key, self.filt_key = jax.random.split(self.key, 3)
            return torch.from_numpy(np.array(jax.random.normal(key, shape)))
        elif kind == "filter":
            return torch.from_numpy(np.array(jax.random.normal(self.filt_key, shape)))
        else:
            self.key, key = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


RUNS = {  # name -> (merge, runtime keywords)
    "det_atom_max": ("max", dict(SMALL)),
    "atom": (None, dict(SMALL, **FEW_AUGS)),
    "det_atom_mc": ("conv", dict(SMALL, **FEW_AUGS)),
}


def _inject(ours, theirs) -> None:
    """The port tracker takes the JAX tracker's state."""
    for k, v in theirs.state.items():
        if k in ours.state and k != "frame_num":
            ours.state[k] = torch.from_numpy(np.array(v))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_atom_tracker_free_run_matches_jax(trees, run, monkeypatch):
    """Both trackers initialise on frame 0 from the same draws; the port's
    init state matches JAX's where the f32 init solve does not enter (the
    labels, the weights, the IoU modulation of the identity sample), then
    the port takes JAX's init state and both run free over 6 frames."""
    merge, kw = RUNS[run]
    params = trees[merge]
    prt, jrt = at.ATOMRuntime(**kw), jat.ATOMRuntime(**kw)
    assert dataclasses.asdict(prt) == dataclasses.asdict(jrt)
    j_flags = []
    localize = jat._localize_atom

    def recording(*args):
        out = localize(*args)
        jax.debug.callback(lambda f: j_flags.append(int(f)), out[1])
        return out

    monkeypatch.setattr(jat, "_localize_atom", recording)
    frames, gt = make_synthetic_sequence(n_frames=7, height=120, width=160, seed=7,
                                         box0=(50.0, 40.0, 30.0, 24.0))
    theirs = jat.ATOMTracker(ja.ATOMNet(merge_type=merge), params, jrt)
    ours = at.ATOMTracker(port_model(merge, params), "cpu", prt, draws=JaxDraws)
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    js, ps = theirs.state, ours.state
    N = prt.num_init_samples
    assert int(ps["num_stored"]) == int(js["num_stored"]) == N
    np.testing.assert_array_equal(ps["sample_weights"].numpy(), np.asarray(js["sample_weights"]))
    close(ps["memory_y"][:N].numpy(), np.asarray(js["memory_y"])[:N], 1e-6)
    for k in ("iou_mod3", "iou_mod4", "target_scale", "base_target_sz", "pos"):
        close(ps[k].numpy(), js[k], 1e-5)
    for k, v in js.items():
        if k in ps and k != "frame_num":
            ps[k] = torch.from_numpy(np.array(v))

    j_boxes, j_scores, boxes, scores, flags, cg = [], [], [], [], [], []
    for f in frames[1:]:
        o = theirs.track(f)
        j_boxes.append(o["target_bbox"])
        j_scores.append(o["best_score"])
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
        flags.append((at.FLAG_NAMES.index(o["flag"]),))
        cg.append(o["cg_iters"])
    res = compare_freerun(j_boxes, boxes, PX, ref_events=[(f,) for f in j_flags],
                          our_events=flags)
    assert res["pass"], res
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-4)
    close(ours.state["filter"].numpy(), theirs.state["filter"], 1e-4)
    np.testing.assert_allclose(ours.state["sample_weights"].numpy(),
                               np.asarray(theirs.state["sample_weights"]), rtol=0, atol=1e-6)
    assert int(ours.state["num_stored"]) == int(theirs.state["num_stored"])
    # the update on tracked frames 2, 4 and 6 (or on a hard negative)
    assert cg == [at.atom_num_cg(prt, t + 2, f[0]) for t, f in enumerate(flags)]
    assert sum(cg) >= 3 * prt.update_cg_iter and ours.cg_iters == sum(cg)
    assert sum(ours.flags.values()) == 6


def test_init_solve_is_jax_s_in_f64():
    """The joint init problem (6 Gauss-Newton steps of 10 CG iterations)
    and a filter update (1 step of 5 Polak-Ribiere iterations) in f64 on
    both sides, from the same features, labels and inits: within 1e-10.
    In f32 the init solve is chaotic (the module's docstring); in f64 it
    is JAX's."""
    rt_kw = dict(image_sample_size=96)
    prt, jrt = at.ATOMRuntime(**rt_kw), jat.ATOMRuntime(**rt_kw)
    rng = np.random.RandomState(0)
    N, S = 14, prt.feat_sz
    feats = 0.5 * rng.randn(N, S, S, 256)
    y0 = rng.uniform(0, 1, (N, S, S))
    sw = rng.uniform(0.5, 1, N) / N
    f0, P0 = rng.randn(4, 4, 64) / 1024, rng.randn(256, 64) / 16

    def jsolve(feats, y, sw, f0, P0):
        f, P = jat.gauss_newton_cg(
            partial(jat._residuals_joint, jrt, samples=feats, y=y, sw=sw), (f0, P0), 6, 10,
            precond=lambda t: (t[0] / jrt.filter_reg, t[1] / jrt.projection_reg))
        comp = feats @ P
        f2 = jat.gauss_newton_cg(partial(jat._residuals_filter, jrt, comp=comp, y=y, sw=sw),
                                 f, 1, 5, fletcher_reeves=False)
        return f, P, f2

    with jax.enable_x64(True):
        want = [np.asarray(w) for w in jax.jit(jsolve)(feats, y0, sw, f0, P0)]
    D = torch.from_numpy
    with torch.no_grad():
        f, P = at.gauss_newton_cg(
            partial(at._residuals_joint, prt, samples=D(feats), y=D(y0), sw=D(sw)),
            (D(f0), D(P0)), 6, 10, precond=lambda t: (t[0] / prt.filter_reg,
                                                        t[1] / prt.projection_reg))
        state = {"memory_comp": D(feats) @ P, "memory_y": D(y0), "sample_weights": D(sw),
                 "filter": f}
        f2 = at.atom_update_filter(prt, state, 5)["filter"]
    for g, w in zip((f, P, f2), want):
        assert g.dtype == torch.float64
        close(g.numpy(), w, 1e-10)


# ---------------------------------------------------------------- exact pieces

def _peaks(G, *cells):
    s = np.full((G, G), 0.01, np.float32)
    for (y, x), v in cells:
        s[y, x] = v
    return s


G = 288
LOC_CASES = {  # name -> (score map, JAX flag)
    "normal": (_peaks(G, ((150, 140), 1.0)), jat.FLAG_NORMAL),
    "not_found": (np.full((G, G), 0.1, np.float32), jat.FLAG_NOT_FOUND),
    "hard_negative_far_distractor": (_peaks(G, ((144, 144), 1.0), ((10, 10), 0.9)),
                                     jat.FLAG_HARD_NEG),
    "hard_negative_near_distractor": (_peaks(G, ((5, 5), 1.0), ((150, 150), 0.9)),
                                      jat.FLAG_HARD_NEG),
    "uncertain": (_peaks(G, ((5, 5), 1.0), ((280, 280), 0.9)), jat.FLAG_UNCERTAIN),
    "hard_negative_second_peak": (_peaks(G, ((144, 144), 1.0), ((10, 280), 0.6)),
                                  jat.FLAG_HARD_NEG),
    "tied_peak": (_peaks(G, ((20, 20), 1.0), ((150, 150), 1.0)), jat.FLAG_HARD_NEG),
    "random": (np.random.RandomState(8).uniform(0, 1, (G, G)).astype(np.float32), None),
}


@pytest.mark.parametrize("case", sorted(LOC_CASES))
def test_localize_atom_matches_jax(case):
    scores, flag = LOC_CASES[case]
    prt, jrt = at.ATOMRuntime(), jat.ATOMRuntime()
    sz = [40.0, 48.0]
    want = jax.jit(lambda s, t, sc: jat._localize_atom(jrt, s, {"target_sz": t}, sc))(
        jnp.asarray(scores), jnp.asarray(sz), jnp.float32(1.25))
    got = at._localize_atom(prt, T(scores), {"target_sz": T(sz)}, torch.tensor(1.25))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if flag is not None:
        assert int(got[1]) == flag


def test_update_memory_atom_matches_jax():
    """25 frames into a 20-slot memory: fills, replacements of the
    min-weight slot, the init samples' minimum weight, and frames that do
    not update."""
    kw = dict(image_sample_size=64, sample_memory_size=20, **FEW_AUGS)
    prt, jrt = at.ATOMRuntime(**kw), jat.ATOMRuntime(**kw)
    M, S, C, N = 20, prt.feat_sz, 3, prt.num_init_samples
    rng = np.random.RandomState(9)
    sw0 = np.zeros(M, np.float32)
    sw0[:N] = 1.0 / N
    comp0 = np.zeros((M, S, S, C), np.float32)
    comp0[:N] = rng.randn(N, S, S, C)
    js = {"memory_comp": jnp.asarray(comp0), "memory_y": jnp.zeros((M, S, S)),
          "sample_weights": jnp.asarray(sw0), "num_stored": jnp.asarray(N, jnp.int32),
          "prev_replace_ind": jnp.asarray(-1, jnp.int32)}
    update = jax.jit(partial(jat._update_memory_atom, jrt))
    for t in range(25):
        c, y = rng.randn(S, S, C).astype(np.float32), rng.uniform(0, 1, (S, S)).astype(np.float32)
        lr = np.float32(0.02 if t % 3 == 1 else 0.01)
        ok = t % 5 != 4
        ps = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
        upd = update(js, jnp.asarray(c), jnp.asarray(y), jnp.asarray(lr))
        js = jax.tree.map(lambda a, b_: jnp.where(ok, a, b_), upd, js)
        ps = at._update_memory_atom(prt, ps, T(c), T(y), torch.tensor(lr), torch.tensor(ok))
        for k in js:
            if k == "sample_weights":
                np.testing.assert_array_max_ulp(ps[k].numpy(), np.asarray(js[k]), maxulp=4)
            else:
                np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]), err_msg=f"{k} {t}")
    assert int(ps["num_stored"]) == M


def test_num_cg_follows_the_cadence():
    rt = at.ATOMRuntime()
    assert [at.atom_num_cg(rt, n, at.FLAG_NORMAL) for n in (2, 11, 12, 21)] == [0, 5, 0, 5]
    assert at.atom_num_cg(rt, 2, at.FLAG_HARD_NEG) == rt.hard_negative_cg_iter
    assert at.atom_num_cg(rt, 11, at.FLAG_NOT_FOUND) == rt.update_cg_iter
