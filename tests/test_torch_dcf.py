"""MOSSE and SCSRDCF in the port (trackers/mosse_tracker.py,
trackers/scsrdcf_tracker.py) against the JAX package at f32, and the
registry with the ATOM and DCF families.

Free runs from frame 0 against JAX's jitted trackers: a textured patch
moving 3 px right and 2 px down a frame over 5 frames at tests/test_eco.py's
shrunk geometry (48-64 px samples; both trackers follow it), and 5
tracked frames of a 180 x 240 synthetic sequence at the default geometry
(201 px grayscale samples). Bars: boxes within 0.05 px
(tools/parity/freerun.py::compare_freerun), scores within 1e-4, the
filter state (MOSSE's numerator and denominator, SCSRDCF's filter and
running means) within 1e-4 of its largest magnitude; the geometry's host
constants exact (the reg kernel with its centre tap moved into the
scalar regulariser).

The registry: the
eight recipes (atom, det_atom_{max,mean,mc}, eco, ccot, mosse,
scsrdcf) with JAX's name, modality, family, composition and runtime, the
ATOMs' networks of the recipe's merge. The entries: `run_ope --tracker
mosse` (and scsrdcf) refuses a --checkpoint by name; an ECO flax .npz
reaches the port through run_ope's 'eco' bridge; the VOT entry answers a
3-frame rectangle session of det_atom_max (rgbcolormap frames) and mosse
(colour frames) on the CPU (full size, seeded weights) in a process that
cannot import jax, flax or mmtrack_tpu. (ECO's full-size init takes ~40 s
on two CPU threads; chip_smoke.py phase 12 runs its entry on the card.)
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import os
import shlex
import subprocess
import sys

import cv2

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import backbones as jb  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import atom_tracker as jat  # noqa: E402
from mmtrack_tpu.trackers import ccot_tracker as jcc  # noqa: E402
from mmtrack_tpu.trackers import eco_tracker as jeco  # noqa: E402
from mmtrack_tpu.trackers import mosse_tracker as jmo  # noqa: E402
from mmtrack_tpu.trackers import scsrdcf_tracker as jsc  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval import run_ope, vot  # noqa: E402
from mmtrack_torch.models import backbones  # noqa: E402
from mmtrack_torch.trackers import mosse_tracker as mo  # noqa: E402
from mmtrack_torch.trackers import scsrdcf_tracker as sc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05
SHRUNK = dict(min_image_sample_size=48 ** 2, max_image_sample_size=64 ** 2)
NEW = ("atom", "det_atom_max", "det_atom_mean", "det_atom_mc", "eco", "ccot", "mosse",
       "scsrdcf")


def close(got, want, rel):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"max |diff| / max |want| = {err:.3g} > {rel}"


def translating_pattern():
    """tests/test_eco.py's rigid texture: 6 frames of 120 x 160, the patch
    at (40 + 3 t, 30 + 2 t)."""
    r = np.random.RandomState(0)
    H, W = 120, 160
    canvas = r.randint(0, 60, (H + 40, W + 40, 3)).astype(np.float32)
    patch = r.randint(120, 255, (24, 30, 3)).astype(np.float32)
    frames = []
    for t in range(6):
        f = canvas[20:20 + H, 20:20 + W].copy()
        f[30 + 2 * t:54 + 2 * t, 40 + 3 * t:70 + 3 * t] = patch
        frames.append(f)
    return frames, np.asarray([40.0, 30.0, 30.0, 24.0])


def synthetic():
    frames, gt = make_synthetic_sequence(n_frames=6, height=180, width=240, seed=5)
    return [np.ascontiguousarray(f[..., :3]) for f in frames], gt[0]


CASES = {  # name -> (JAX tracker, port tracker, runtime keywords, frames)
    "mosse_pattern": (jmo.MOSSETracker, mo.MOSSETracker, jmo.MOSSERuntime, mo.MOSSERuntime,
                      SHRUNK, translating_pattern),
    "mosse_default": (jmo.MOSSETracker, mo.MOSSETracker, jmo.MOSSERuntime, mo.MOSSERuntime,
                      {}, synthetic),
    "scsrdcf_pattern": (jsc.SCSRDCFTracker, sc.SCSRDCFTracker, jsc.SCSRDCFRuntime,
                        sc.SCSRDCFRuntime, SHRUNK, translating_pattern),
    "scsrdcf_default": (jsc.SCSRDCFTracker, sc.SCSRDCFTracker, jsc.SCSRDCFRuntime,
                        sc.SCSRDCFRuntime, {}, synthetic),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_form_free_run_matches_jax(case):
    jcls, pcls, jrt_cls, prt_cls, kw, make = CASES[case]
    prt, jrt = prt_cls(**kw), jrt_cls(**kw)
    assert dataclasses.asdict(prt) == dataclasses.asdict(jrt)
    frames, box0 = make()
    theirs, ours = jcls(jrt), pcls("cpu", prt)
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": list(map(float, box0))})
    assert ours.geom.sample_sz == theirs._geom.sample_sz
    if "default" in case:
        assert ours.geom.sample_sz % 2 == 1 and ours.geom.sample_sz >= 200
    j_boxes, j_scores, boxes, scores = [], [], [], []
    for f in frames[1:]:
        o = theirs.track(f)
        j_boxes.append(o["target_bbox"])
        j_scores.append(o["best_score"])
        o = ours.track(f)
        boxes.append(o["target_bbox"])
        scores.append(o["best_score"])
    res = compare_freerun(j_boxes, boxes, PX)
    assert res["pass"], res
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-4)
    keys = ("num", "den") if "mosse" in case else ("f", "rhs", "lhs_data")
    for k in keys:
        close(ours.state[k].numpy(), theirs.state[k], 1e-4)
    if "pattern" in case:   # both follow the patch
        for t, b in enumerate(boxes, start=1):
            assert abs(b[0] + b[2] / 2 - (55 + 3 * t)) + abs(b[1] + b[3] / 2 - (42 + 2 * t)) < 4


def test_scsrdcf_geometry_matches_jax():
    for target_hw in ((24.0, 30.0), (60.0, 40.0), (150.0, 90.0)):
        rt = sc.SCSRDCFRuntime()
        geom, consts = sc.scsrdcf_geometry(rt, target_hw)
        jgeom, jconsts = jsc.scsrdcf_geometry(jsc.SCSRDCFRuntime(), target_hw)
        assert geom.sample_sz == jgeom.sample_sz
        for k in ("reg_k", "reg_factor", "yf", "base_target_sz", "target_scale"):
            np.testing.assert_array_equal(consts[k].numpy(), np.asarray(jconsts[k]), err_msg=k)
        ri = jconsts["interp"]
        np.testing.assert_array_equal(consts["interp"].numpy(), ri[..., 0] + 1j * ri[..., 1])
        close(consts["window"].numpy(), jconsts["window"], 1e-6)


# ---------------------------------------------------------------- registry

JAX_RUNTIMES = {"atom": jat.ATOMRuntime(), "det_atom_max": jat.ATOMRuntime(),
                "det_atom_mean": jat.ATOMRuntime(), "det_atom_mc": jat.ATOMRuntime(),
                "eco": jeco.ECORuntime(), "ccot": jcc.ccot_runtime(),
                "mosse": jmo.MOSSERuntime(), "scsrdcf": jsc.SCSRDCFRuntime()}


def test_registry_builds_every_recipe_on_the_cpu():
    """The ATOM and DCF recipes build on the CPU with JAX's names, modality,
    family, composition and runtime (every name is built once, in
    tests/test_torch_dimp_tracker.py)."""
    assert set(NEW) <= set(registry.list_trackers()) <= set(JAX_REGISTRY)
    for name in NEW:
        tracker = registry.build_tracker(name, device="cpu")
        r, j = registry.TRACKER_REGISTRY[name], JAX_REGISTRY[name]
        assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
        assert type(tracker.rt).__name__ == type(JAX_RUNTIMES[name]).__name__
        assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(JAX_RUNTIMES[name]), name
        if name.startswith(("atom", "det_atom")):
            want = {"atom": None, "det_atom_max": "max", "det_atom_mean": "mean",
                    "det_atom_mc": "conv"}[name]
            assert tracker.model.merge_type == want
        if name in ("eco", "ccot"):
            assert isinstance(tracker.model, backbones.ResNetVGGm1)
        del tracker


@pytest.mark.parametrize("name", ["mosse", "scsrdcf"])
def test_weightless_recipes_refuse_a_checkpoint(name, tmp_path, capsys):
    with pytest.raises(SystemExit):
        run_ope.main(["--tracker", name, "--dataset", "SYNTH", "--synthetic", "--device", "cpu",
                      "--checkpoint", str(tmp_path / "x.npz")])
    assert f"{name} has no learned weights" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no learned weights"):
        registry.build_tracker(name, params={}, device="cpu")


def test_eco_npz_loads_through_the_entry(tmp_path):
    shapes = jax.eval_shape(lambda: jb.resnet18_vggmconv1().init(jax.random.PRNGKey(0),
                                                                 jnp.zeros((1, 64, 64, 3))))
    rng = np.random.RandomState(3)
    tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    path = str(tmp_path / "eco.npz")
    np.savez(path, params=np.asarray(tree["params"], dtype=object))
    sd = run_ope.load_checkpoint(path, registry.TRACKER_REGISTRY["eco"].family)
    tracker = registry.build_tracker("eco", params=sd, device="cpu")
    np.testing.assert_array_equal(tracker.model.vggmconv1.weight.numpy(),
                                  tree["params"]["vggmconv1"]["kernel"].transpose(3, 2, 0, 1))


BLOCKER = """
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmtrack_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
runpy.run_module("mmtrack_torch.eval.vot_entry", run_name="__main__")
"""


@pytest.mark.parametrize("name", ["det_atom_max", "mosse"])
def test_vot_entry_answers_a_session_without_jax(name, tmp_path):
    frames, gt = make_synthetic_sequence(n_frames=3, height=180, width=240, seed=6)
    colors, depths = [], []
    for t, f in enumerate(frames):
        c, d = str(tmp_path / f"c{t}.png"), str(tmp_path / f"d{t}.png")
        cv2.imwrite(c, cv2.cvtColor(np.ascontiguousarray(f[..., :3]), cv2.COLOR_RGB2BGR))
        cv2.imwrite(d, (2000 + 8 * f[..., 3].astype(np.uint16)))
        colors.append(c)
        depths.append(d)
    x, y, w, h = gt[0]
    lines = [f'@@TRAX:initialize "file://{colors[0]}" "file://{depths[0]}" '
             f'"{x:.4f},{y:.4f},{w:.4f},{h:.4f}"']
    lines += [f'@@TRAX:frame "file://{c}" "file://{d}"' for c, d in zip(colors[1:], depths[1:])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MMTRACK_DEVICE="cpu", MMTRACK_TRACKER=name, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=str(tmp_path), env=env,
                          input="\n".join(lines + ["@@TRAX:quit", ""]), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    states = [vot._decode_region(shlex.split(ln)[1]) for ln in proc.stdout.splitlines()
              if ln.startswith("@@TRAX:state")]
    assert len(states) == 3
    for s in states[1:]:
        assert isinstance(s, vot.Rectangle) and np.isfinite(list(s)).all() and s.width > 0
