"""ECO and C-COT in the port (models/backbones.py, trackers/eco_tracker.py,
trackers/ccot_tracker.py, the ECO weight bridge) against the JAX package
at f32.

The flax ResNetVGGm1 tree's shapes come from jax.eval_shape of the init
(no compile), its values from a numpy seed; it reaches the port through
models/convert.py::eco_state_dict_from_flax, whose state_dict goes back
through JAX's convert_eco_backbone_checkpoint to the tree leaf for leaf
(up to layer3, the port's deepest stage). ResNetVGGm1's taps (vggconv1
with its LRN, conv1, layer1, layer3) within 1e-5 of the largest |JAX
value|. eco_geometry's shapes and host constants equal to JAX's for
targets that give both sample sizes and the reg kernels' fallback; the
Hann windows within 1e-6. pca_projection within 1e-4 up to the sign of
each column (each eigensolver picks its own signs).

Free runs from frame 0 against JAX's jitted trackers on the shrunk
geometry of tests/test_eco.py (64-80 px samples, 3 Gauss-Newton steps of
4 CG iterations at init, 2 CG iterations a training frame, a 20-slot
memory for ECO, 6 for C-COT, a small augmentation set), 5 tracked frames
of 140 x 180 synthetic colour frames: ECO trains on frames 3 and 5 (its
carried CG direction crosses them), C-COT on every frame. The port draws
JAX's dropout uniforms (`JaxDraws`). Bars: boxes within 0.05 px
(tools/parity/freerun.py::compare_freerun) and scores within 1e-4; the
memory's weights within 1e-4; the projections, the final filters (a
projection column and its filter channel up to the eigensolver's sign,
which leaves the scores and boxes unchanged) and the carried CG state
(direction, rho, previous residual) within 1e-3: the init's f32 solve
amplifies rounding (tests/test_torch_atom.py measures it for ATOM), and
leaves ECO's projection 1.9e-4 apart, C-COT's carried state 2.1e-4.
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
from mmtrack_tpu.models import backbones as jb  # noqa: E402
from mmtrack_tpu.models.convert import convert_eco_backbone_checkpoint  # noqa: E402
from mmtrack_tpu.trackers import ccot_tracker as jcc  # noqa: E402
from mmtrack_tpu.trackers import eco_tracker as jeco  # noqa: E402
from mmtrack_torch.models import backbones  # noqa: E402
from mmtrack_torch.models.convert import eco_state_dict_from_flax  # noqa: E402
from mmtrack_torch.trackers import ccot_tracker as cc  # noqa: E402
from mmtrack_torch.trackers import eco_tracker as eco  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05
SHRUNK = dict(min_image_sample_size=64 ** 2, max_image_sample_size=80 ** 2)
ECO_RT = dict(SHRUNK, sample_memory_size=20, train_skipping=2, init_cg_iter=12, init_gn_iter=3,
              cg_iter=2, aug_rotate=(10, -10), aug_blur=((2, 2),), aug_dropout_num=2)
CCOT_RT = dict(SHRUNK, sample_memory_size=6, init_cg_iter=8, cg_iter=2)


def close(got, want, rel):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"max |diff| / max |want| = {err:.3g} > {rel}"


def T(a):
    return torch.from_numpy(np.array(a))


def _leaf(rng, path, shape):
    name = path[-1].key
    if name == "kernel":
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    return 0.1 * rng.randn(*shape)


@pytest.fixture(scope="module")
def tree():
    shapes = jax.eval_shape(lambda: jb.resnet18_vggmconv1().init(jax.random.PRNGKey(0),
                                                                 jnp.zeros((1, 64, 64, 3))))
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)


def port_model(tree) -> backbones.ResNetVGGm1:
    m = backbones.resnet18_vggmconv1()
    m.load_state_dict(eco_state_dict_from_flax(tree["params"]))
    return m.eval()


def test_resnet_vggm1_matches_jax(tree):
    im = np.random.RandomState(1).randn(2, 72, 72, 3).astype(np.float32)
    layers = ("vggconv1", "conv1", "layer1", "layer3")
    want = jax.jit(lambda p, x: jb.resnet18_vggmconv1().apply(p, x, out_layers=layers))(
        tree, jnp.asarray(im))
    with torch.no_grad():
        got = port_model(tree)(T(im), layers)
    assert list(got) == list(layers)
    for k in layers:
        close(got[k].numpy(), want[k], 1e-5)


def test_eco_bridge_goes_back_through_jax_s_converter(tree):
    sd = {k: v.numpy() for k, v in port_model(tree).state_dict().items()}
    back = convert_eco_backbone_checkpoint(sd)["params"]
    flat = _flat(back)
    want = {k: v for k, v in _flat(tree["params"]).items() if not k.startswith("layer4_")}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("target_hw", [(50.0, 60.0), (24.0, 30.0), (300.0, 300.0),
                                       (12.0, 200.0)])
def test_eco_geometry_matches_jax(target_hw):
    for kw in ({}, ECO_RT, CCOT_RT):
        factory = cc.ccot_runtime if kw is CCOT_RT else eco.ECORuntime
        jfactory = jcc.ccot_runtime if kw is CCOT_RT else jeco.ECORuntime
        prt, jrt = factory(**kw), jfactory(**kw)
        assert dataclasses.asdict(prt) == dataclasses.asdict(jrt)
        st, consts = eco.eco_geometry(prt, target_hw)
        jst, jconsts = jeco.eco_geometry(jrt, target_hw)
        assert dataclasses.asdict(st) == dataclasses.asdict(jst)
        if not kw:
            assert st.sample_sz in (208, 240)
        np.testing.assert_array_equal(consts["target_scale"].numpy(), jconsts["target_scale"])
        np.testing.assert_array_equal(consts["base_target_sz"].numpy(),
                                      np.asarray(jconsts["base_target_sz"]))
        for b in range(prt.n_blocks):
            ri = jconsts["interp"][b]
            np.testing.assert_array_equal(consts["interp"][b].numpy(), ri[..., 0] + 1j * ri[..., 1])
            np.testing.assert_array_equal(consts["yf"][b].numpy(), np.asarray(jconsts["yf"][b]))
            np.testing.assert_array_equal(consts["reg"][b].numpy(), np.asarray(jconsts["reg"][b]))
            assert float(consts["reg_energy"][b]) == float(jconsts["reg_energy"][b])
            close(consts["windows"][b].numpy(), jconsts["windows"][b], 1e-6)


def test_pca_projection_matches_jax_up_to_column_sign():
    rng = np.random.RandomState(2)
    mix = rng.randn(24, 24).astype(np.float32)
    feat = (rng.randn(6, 9, 9, 24).astype(np.float32) @ mix)
    want = np.asarray(jax.jit(partial(jeco.pca_projection, cdim=8))(jnp.asarray(feat)))
    got = eco.pca_projection(T(feat), 8).numpy()
    signs = np.sign(np.sum(got * want, axis=0))
    assert np.all(signs != 0)
    close(got * signs, want, 1e-4)


class JaxDraws:
    """The JAX ECO init's dropout keys: PRNGKey(0) split into (key, block 0,
    block 1)."""

    def __init__(self):
        self.keys = list(jax.random.split(jax.random.PRNGKey(0), 3)[1:])

    def __call__(self, kind, shape):
        assert kind == "dropout"
        return torch.from_numpy(np.array(jax.random.uniform(self.keys.pop(0), shape)))


RUNS = {  # name -> (JAX tracker, port tracker, port runtime, JAX runtime)
    "eco": (jeco.ECOTracker, eco.ECOTracker, eco.ECORuntime(**ECO_RT), jeco.ECORuntime(**ECO_RT)),
    "ccot": (jcc.CCOTTracker, cc.CCOTTracker, cc.ccot_runtime(**CCOT_RT),
             jcc.ccot_runtime(**CCOT_RT)),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_dcf_free_run_matches_jax(tree, run):
    jcls, pcls, prt, jrt = RUNS[run]
    frames, gt = make_synthetic_sequence(n_frames=6, height=140, width=180, seed=3)
    frames = [np.ascontiguousarray(f[..., :3]) for f in frames]
    theirs = jcls(jb.resnet18_vggmconv1(), tree, jrt)
    ours = (pcls(port_model(tree), "cpu", prt, draws=JaxDraws) if run == "eco"
            else pcls(port_model(tree), "cpu", prt))
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    j_boxes, j_scores, boxes, scores, cg = [], [], [], [], []
    for f in frames[1:]:
        o = theirs.track(f)
        j_boxes.append(o["target_bbox"])
        j_scores.append(o["best_score"])
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
        cg.append(o["cg_iters"])
    res = compare_freerun(j_boxes, boxes, PX)
    assert res["pass"], res
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-4)
    js, ps = theirs.state, ours.state
    for b in range(2):
        # a column of ECO's PCA projection has the eigensolver's sign, and
        # the matching filter channel follows it
        sign = np.ones(prt.compressed_dims[b], np.float32)
        if prt.use_projection:
            P, jP = ps["projections"][b].numpy(), np.asarray(js["projections"][b])
            sign = np.sign(np.sum(P * jP, axis=0))
            close(P * sign, jP, 1e-3)
        sign = sign[:, None, None, None]
        close(ps["filters"][b].numpy() * sign, js["filters"][b], 1e-3)
        close(ps["sample_weights"][b].numpy(), js["sample_weights"][b], 1e-4)
        p, rho, r_prev, has_p = ps["cg_state"][b]
        jp, jrho, jr_prev, jhas_p = js["cg_state"][b]
        close(p.numpy() * sign, jp, 1e-3)
        close(r_prev.numpy() * sign, jr_prev, 1e-3)
        close(rho.numpy(), jrho, 1e-3)
        assert bool(has_p) == bool(jhas_p)
    assert int(ps["num_stored"]) == int(js["num_stored"])
    trains = [t + 2 for t in range(5) if eco.eco_trains(prt, t + 2)]
    assert trains == ([2, 3, 4, 5, 6] if run == "ccot" else [3, 5])
    assert sum(cg) == ours.cg_iters == len(trains) * prt.cg_iter * 2
