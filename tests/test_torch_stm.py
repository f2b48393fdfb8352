"""STM in the port (models/stm.py, trackers/stm_tracker.py) against the JAX
package at f32 on the CPU.

The flax leaves are drawn from a numpy seed at the shapes of
jax.eval_shape of the init and reach the port through
models/convert.py::lwl_state_dict_from_flax (the family's bridge, which
tells an STMNet tree by its `encoder_q`); the way back goes through JAX's
convert_stm_checkpoint (the trunks' layer4, which STM never reads, left
out). JAX's module applies run jitted.

Bars: the memory encoder (conv1_add with and without the other objects'
mask) and the read and decoder within 1e-5 of their largest magnitude,
the read also with invalid slots; the geometry helpers exactly against
JAX's jitted forms on dyadic maps (seg->state in 'md_hack' and 'var'
mode, the size's sqrt within one ulp, the gate; the zero-fill paste
within 1e-6). Free runs of 6 frames against JAX's jitted STMTracker at
64 px crops with 3 memory slots and a commit every 2 frames (commits at
frames 3, 5 and 7, the last wraps the ring onto slot 1), from a box and
from an init mask: boxes within 0.05
px, the max probability within 1e-4, the masks equal but for pixels
whose JAX probability is within 1e-4 of 0.5, the ring's keys and values
within 1e-5. `run_ope --tracker stm --device cpu --synthetic` runs in a
process where jax, flax and mmtrack_tpu cannot be imported (the recipe's
runtime narrowed to 64 px crops).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import stm as js  # noqa: E402
from mmtrack_tpu.models.convert import convert_stm_checkpoint  # noqa: E402
from mmtrack_tpu.ops.crop import crop_at as jcrop_at  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import stm_tracker as jst  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import stm as ps  # noqa: E402
from mmtrack_torch.models.convert import lwl_state_dict_from_flax, lwl_topology  # noqa: E402
from mmtrack_torch.trackers import stm_tracker as pst  # noqa: E402
from test_torch_dimp import _leaf, close  # noqa: E402
from test_torch_lwl import T, _dyadic_map, _ellipse, japply  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX, PROB = 0.05, 1e-4
RT_KW = dict(image_sample_size=64, mem_slots=3, memory_skip_rate=2)
S = 64


@pytest.fixture(scope="module")
def nets():
    jm = js.build_stm()
    f, m = jnp.zeros((1, S, S, 3)), jnp.zeros((1, S, S))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), f, m))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    port = ps.build_stm()
    port.load_state_dict(lwl_state_dict_from_flax(tree["params"]))
    return jm, tree, port.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    x = rng.rand(2, S, S, 3).astype(np.float32)
    masks = (rng.rand(2, S, S) > 0.5).astype(np.float32)
    return x, masks


# ---------------------------------------------------------------- the network

@pytest.mark.parametrize("other", [False, True])
def test_memorize_matches_jax(nets, inputs, other):
    jm, tree, port = nets
    x, masks = inputs
    o = masks[::-1].copy() if other else None
    kj, vj = japply(jm, "memorize", tree, x, masks, o)
    with torch.no_grad():
        kp, vp = port.memorize(T(x), T(masks), None if o is None else T(o))
    assert tuple(kp.shape) == (2, S // 16, S // 16, 128) and tuple(vp.shape)[-1] == 512
    close(kp.numpy(), kj, 1e-5)
    close(vp.numpy(), vj, 1e-5)


@pytest.mark.parametrize("valid", [(1, 1, 1, 1), (1, 0, 1, 0), (1, 0, 0, 0)])
def test_segment_matches_jax(nets, inputs, valid):
    """The read over every slot, and with invalid slots folded out."""
    jm, tree, port = nets
    x, masks = inputs
    kj, vj = japply(jm, "memorize", tree, x, masks, None)
    kj2, vj2 = japply(jm, "memorize", tree, x, masks[::-1].copy(), masks)
    keys = np.concatenate([np.asarray(kj), np.asarray(kj2)])
    vals = np.concatenate([np.asarray(vj), np.asarray(vj2)])
    valid = np.asarray(valid, np.float32)
    want = japply(jm, "segment", tree, x[:1], keys, vals, valid)
    with torch.no_grad():
        got = port.segment(T(x[:1]), T(keys), T(vals), T(valid))
        kept = valid > 0
        only = port.segment(T(x[:1]), T(keys[kept]), T(vals[kept]), T(valid[kept]))
    close(got.numpy(), want, 1e-5)
    close(only.numpy(), want, 1e-5)


def test_stm_bridge_round_trip(nets):
    jm, tree, port = nets
    assert lwl_topology(tree["params"]) == "stm"
    back = convert_stm_checkpoint(port.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == {p for p in want if "layer4" not in jax.tree_util.keystr(p)}
    for path, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), want[path], err_msg=str(path))


def test_stm_npz_loads_through_the_entry(nets, tmp_path):
    jm, tree, port = nets
    path = str(tmp_path / "stm.npz")
    np.savez(path, params=np.asarray(tree["params"], dtype=object))
    sd = load_checkpoint(path, "lwl")
    built = registry.build_tracker("stm", params=sd, device="cpu")
    want = port.state_dict()
    assert set(built.model.state_dict()) == set(want)
    for k, v in built.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_stm_recipe_matches_jax():
    r, j = registry.TRACKER_REGISTRY["stm"], JAX_REGISTRY["stm"]
    assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
    tracker = registry.build_tracker("stm", device="cpu", seed=3)
    assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jst.STMRuntime())
    assert tracker.predicts_segmentation_mask
    again = registry.build_tracker("stm", device="cpu", seed=3).model.state_dict()
    for k, v in tracker.model.state_dict().items():
        assert torch.equal(v, again[k]), k


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("mode", ["md_hack", "var"])
def test_seg_to_state_matches_jitted_jax(mode):
    rt_p = pst.STMRuntime(seg_to_bb_mode=mode, min_mask_area=10.0)
    rt_j = jst.STMRuntime(seg_to_bb_mode=mode, min_mask_area=10.0)
    fn = jax.jit(partial(jst._seg_to_state, rt_j))
    pos0, sz0 = np.array([10.0, 11.0], np.float32), np.array([5.0, 6.0], np.float32)
    small = np.zeros((60, 80), np.float32)
    small[3, 3] = 1.0
    for m in (_dyadic_map(60, 80, 20, 30, 16, 12), _dyadic_map(60, 80, 3, 5, 4, 6), small):
        wp, ws = fn(m, pos0, sz0)
        gp, gs = pst._seg_to_state(rt_p, T(m), T(pos0), T(sz0))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        # the size's sqrt: PyTorch's vectorised CPU sqrt is off by one ulp at
        # near-ties, where JAX's (and CUDA's) rounds correctly
        np.testing.assert_array_max_ulp(gs.numpy(), np.asarray(ws), maxulp=1)
    np.testing.assert_array_equal(gp.numpy(), pos0)


def test_paste_prob_matches_jitted_jax():
    rt_p, rt_j = pst.STMRuntime(image_sample_size=32), jst.STMRuntime(image_sample_size=32)
    prob = np.random.RandomState(7).rand(32, 32).astype(np.float32)
    fn = jax.jit(partial(jst._paste_prob, rt_j, im_hw=(70, 90)))
    for pos, scale in (((30.0, 42.0), 1.375), ((5.5, 80.0), 2.25), ((60.0, 10.0), 0.8125)):
        pos, scale = np.asarray(pos, np.float32), np.float32(scale)
        want = np.asarray(fn(prob, pos, scale))
        got = pst._paste_prob(rt_p, T(prob), T(pos), T(scale), (70, 90)).numpy()
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- free runs

@pytest.fixture(scope="module")
def jax_tracker(nets):
    jm, tree, _ = nets
    frames, gt = make_synthetic_sequence(n_frames=7, height=120, width=160, seed=3)
    return jst.STMTracker(jm, tree, jst.STMRuntime(**RT_KW)), frames, gt


@pytest.mark.parametrize("init", ["box", "mask"])
def test_free_run_matches_jax(nets, jax_tracker, init):
    jm, tree, port = nets
    jt, frames, gt = jax_tracker
    pt = pst.STMTracker(port, "cpu", pst.STMRuntime(**RT_KW))
    info = {"init_bbox": gt[0].tolist()}
    if init == "mask":
        info["init_mask"] = _ellipse(gt[0], *frames.shape[1:3])
    jt.initialize(frames[0], info)
    pt.initialize(frames[0], info)
    close(pt.state["prev_key"].numpy(), jt.state["prev_key"], 1e-5)
    masks, prob_fn = 0, _jax_prob_fn(jm, jt.rt)
    for t, f in enumerate(frames[1:]):
        jprob = np.asarray(prob_fn(jt.params, jt.state, jnp.asarray(f)))
        a, b = jt.track(f), pt.track(f)
        assert np.abs(np.subtract(a["target_bbox"], b["target_bbox"])).max() <= PX, t
        assert abs(a["best_score"] - b["best_score"]) <= PROB, t
        assert b["segmentation"].dtype == bool and b["segmentation"].shape == f.shape[:2]
        assert pt.state["mem_valid"] == int(np.asarray(jt.state["mem_valid"]).sum())
        assert pt.state["mem_ptr"] == int(jt.state["mem_ptr"])
        n = pt.state["mem_valid"]
        close(pt.state["mem_keys"][:n].numpy(), np.asarray(jt.state["mem_keys"])[:n], 1e-5)
        close(pt.state["mem_vals"][:n].numpy(), np.asarray(jt.state["mem_vals"])[:n], 1e-5)
        masks += int(b["segmentation"].any())
        np.testing.assert_array_equal(a["segmentation"], jprob > 0.5)
        flipped = a["segmentation"] != b["segmentation"]
        assert (np.abs(jprob[flipped] - 0.5) <= PROB).all(), t
    assert pt.commits == 3 and pt.state["mem_ptr"] == 4 and pt.state["mem_valid"] == 3
    assert masks >= 1


def _jax_prob_fn(jm, rt):
    """JAX's pasted probability of a frame from the state before it: the
    first half of stm_track_step, from the JAX package's functions."""
    def fn(params, state, frame):
        S = rt.image_sample_size
        szl, tl, sample_pos, sample_scale = jst._crop_geometry(rt, state["pos"],
                                                               state["target_scale"])
        patch = jst._to_unit(jcrop_at(frame, state["pos"], szl, S, origin_yx=tl))
        keys = jnp.concatenate([state["mem_keys"], state["prev_key"][None]], 0)
        vals = jnp.concatenate([state["mem_vals"], state["prev_val"][None]], 0)
        valid = jnp.concatenate([state["mem_valid"], jnp.ones((1,))], 0)
        prob = jm.apply(params, patch[None], keys, vals, valid, method="segment")
        return jst._paste_prob(rt, prob, sample_pos, sample_scale, frame.shape[:2])
    return jax.jit(fn)


# ---------------------------------------------------------------- the entry

RUNNER = """
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmtrack_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
from mmtrack_torch import registry
from mmtrack_torch.trackers.stm_tracker import STMRuntime
build = registry.TRACKER_REGISTRY["stm"].build
def narrow(**kw):
    tracker = build(**kw)
    tracker.rt = STMRuntime(image_sample_size=64)
    return tracker
registry.TRACKER_REGISTRY["stm"].build = narrow
sys.argv = ["run_ope"] + sys.argv[1:]
runpy.run_module("mmtrack_torch.eval.run_ope", run_name="__main__")
"""


def test_run_ope_stm_synthetic_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUNNER, "--dataset", "SYNTH", "--tracker", "stm",
                           "--device", "cpu", "--synthetic", "--results_root", str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = np.loadtxt(tmp_path / "SYNTH" / "stm" / "synth_000.txt", delimiter=",")
    assert res.shape == (12, 4) and np.isfinite(res).all()
