"""The port's VOT entry (TraX server, composition, run_vot_exp, the entry
module) against the JAX package's, at f32 on the CPU.

  * the composition copy is bit-equal to mmtrack_tpu/data/composition.py,
    from arrays and from PNG files;
  * RLE and region codecs round-trip and write the JAX package's strings;
  * one TraX session (hello, initialize with a mask region, 5 frames,
    quit) runs through JAX `run_vot_exp` and the port's, with the tiny
    ViPTrack of tests/test_torch_tracker.py bridged from the same flax
    weights and Alpha-Refine at input size 64 (flax init, bridged):
    the rectangle protocol's states within 0.05 px (the trajectory bar of
    tests/test_torch_tracker.py); the mask protocol's state messages equal
    in number, the full-frame probabilities within 1e-4, and the binary
    masks equal except at pixels whose probability lies within 1e-4 of
    the 0.5 threshold;
  * `python -m mmtrack_torch.eval.vot_entry` answers the session in a
    subprocess where jax, flax and mmtrack_tpu cannot be imported (also a
    3-frame rectangle session of det_dimp50_max), and without a card
    (default device) fails before it answers.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import io
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

from mmtrack_tpu.data import composition as jax_comp  # noqa: E402
from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.eval import vot as jax_vot  # noqa: E402
from mmtrack_tpu.models import alpha_refine as jax_ar  # noqa: E402
from mmtrack_tpu.models.vipt import ViPTrack as JaxViPTrack  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTTracker as JaxTracker  # noqa: E402
from mmtrack_torch.data import composition  # noqa: E402
from mmtrack_torch.eval import vot  # noqa: E402
from mmtrack_torch.models import alpha_refine  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    alpha_refine_state_dict_from_flax,
    vipt_state_dict_from_flax,
)
from mmtrack_torch.models.vipt import ViPTrack  # noqa: E402
from mmtrack_torch.registry import TRACKER_REGISTRY, list_trackers  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16,
            template_size=32, search_size=64, ce_loc=(1,), head_channel=16)
RT_ARGS = dict(template_size=32, search_size=64, stride=16, ce_loc=(1,), ce_keep_ratio=(0.7,))
H, W, N_FRAMES = 96, 128, 6
BOX_BAR = 0.05
PROB_BAR = 1e-4


def _depth(rng, box):
    """16-bit depth: a far textured background, the target nearer."""
    d = rng.randint(2500, 4000, (H, W)).astype(np.uint16)
    x, y, w, h = np.round(box).astype(int)
    d[max(y, 0):y + h, max(x, 0):x + w] = 1500
    return d


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """(directory, color paths, depth paths, gt boxes) of a synthetic RGB-D
    sequence written as RGB PNG + 16-bit depth PNG."""
    root = tmp_path_factory.mktemp("vot_seq")
    frames, gt = make_synthetic_sequence(n_frames=N_FRAMES, height=H, width=W, seed=4)
    rng = np.random.RandomState(4)
    colors, depths = [], []
    for t in range(N_FRAMES):
        c, d = str(root / f"color_{t:03d}.png"), str(root / f"depth_{t:03d}.png")
        cv2.imwrite(c, cv2.cvtColor(np.ascontiguousarray(frames[t, ..., :3]), cv2.COLOR_RGB2BGR))
        cv2.imwrite(d, _depth(rng, gt[t]))
        colors.append(c)
        depths.append(d)
    return root, colors, depths, gt


def _script(colors, depths, region: str) -> str:
    lines = [f'@@TRAX:initialize "file://{colors[0]}" "file://{depths[0]}" "{region}"']
    lines += [f'@@TRAX:frame "file://{c}" "file://{d}"' for c, d in zip(colors[1:], depths[1:])]
    return "\n".join(lines + ["@@TRAX:quit", ""])


def _states(text: str, decode) -> list:
    return [decode(shlex.split(ln)[1]) for ln in text.splitlines()
            if ln.startswith("@@TRAX:state")]


def _mask_region(box) -> str:
    x, y, w, h = np.round(box).astype(int)
    return jax_vot._encode_region(jax_vot.Mask(x, y, np.ones((h, w), np.uint8)))


# -- composition ------------------------------------------------------------

def _xmaps(rng):
    depth = rng.randint(0, 9000, (24, 32)).astype(np.uint16)
    depth[3:9, 4:12] = 0
    thermal = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    return {"depth": depth, "thermal": thermal, "gray": thermal[..., 0].copy()}


@pytest.mark.parametrize("dtype,x,clip", [
    ("color", "depth", False), ("raw_x", "depth", True), ("colormap", "depth", False),
    ("3x", "depth", True), ("normalized_x", "depth", False), ("rgbcolormap", "depth", True),
    ("rgbcolormap", "depth", False), ("rgb3x", "depth", True), ("rgbd_blend", "depth", False),
    ("rgbrgb", "thermal", False), ("rgbrgb", "gray", False)])
def test_composition_bit_equal_to_jax(dtype, x, clip):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    xmap = _xmaps(rng)[x]
    got = composition.compose_x(rgb, xmap.copy(), dtype, x_clip=clip)
    want = jax_comp.compose_x(rgb, xmap.copy(), dtype, x_clip=clip)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if x == "depth":
        assert np.array_equal(composition.depth_index_u8(xmap, clip),
                              jax_comp.depth_index_u8(xmap, clip))
        assert composition._median(xmap) == jax_comp._median(xmap) == np.median(xmap)


def test_frames_from_files_bit_equal_to_jax(sequence):
    _, colors, depths, _ = sequence
    for dtype in ("rgbcolormap", "color", "rgbrgb"):
        for t in (0, N_FRAMES - 1):
            d = depths[t] if dtype != "rgbrgb" else colors[t]
            got = composition.get_x_frame(colors[t], d, dtype, depth_clip=dtype != "rgbrgb")
            want = jax_comp.get_x_frame(colors[t], d, dtype, depth_clip=dtype != "rgbrgb")
            assert np.array_equal(got, want)


# -- codecs -----------------------------------------------------------------

@pytest.mark.parametrize("first", [0, 1])
def test_rle_round_trip_and_jax_equal(first):
    rng = np.random.RandomState(first)
    m = (rng.rand(13, 17) > 0.6).astype(np.uint8)
    m.flat[0] = first
    runs = vot._rle_encode(m.reshape(-1))
    assert runs == jax_vot._rle_encode(m.reshape(-1))
    assert (runs[0] == 0) == (first == 1)
    assert np.array_equal(vot._rle_decode(runs, m.size).reshape(m.shape), m)
    assert vot._rle_encode(np.zeros(0)) == [0]


def test_region_codecs_round_trip_and_jax_equal():
    m = np.zeros((5, 7), np.uint8)
    m[1:4, 2:6] = 1
    pts = [(1.0, 2.0), (3.5, 2.0), (3.5, 7.0)]

    def regions(mod):             # each module checks its own region types
        return [mod.Rectangle(10.25, 20.5, 30.0, 40.125),
                mod.Polygon([mod.Point(*p) for p in pts]), mod.Mask(4, 6, m)]

    for r, jr in zip(regions(vot), regions(jax_vot)):
        s = vot._encode_region(r)
        assert s == jax_vot._encode_region(jr)
        back = vot._decode_region(s)
        assert type(back) is type(r)
        if isinstance(r, vot.Mask):
            assert (back.x, back.y) == (r.x, r.y) and np.array_equal(back.mask, m)
            assert vot.rect_from_mask(back) == vot.Rectangle(6.0, 7.0, 4.0, 3.0)
        else:
            assert vot._encode_region(back) == s


def test_registry_has_the_vipt_recipes():
    vipt = sorted(f"vipt_{k}_{m}" for k in ("deep", "shaw") for m in ("rgbd", "rgbt", "rgbe"))
    assert [n for n in list_trackers() if n.startswith("vipt_")] == vipt
    assert list_trackers("rgbt") == ["apfnet", "dafnet", "macnet", "mfdimp", "vipt_deep_rgbt",
                                     "vipt_shaw_rgbt"]
    assert all(TRACKER_REGISTRY[n].composition == "rgbcolormap"
               and TRACKER_REGISTRY[n].family == "vipt" for n in vipt)


# -- one TraX session through both entries -----------------------------------

@pytest.fixture(scope="module")
def models():
    """Tiny ViPTrack and Alpha-Refine at input size 64, flax-initialised,
    as (jax ViPT, flax params, port ViPT, jax AR, AR variables, port AR)."""
    jm = JaxViPTrack(**TINY)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6)),
                                       None, JaxRuntime(**RT_ARGS).ce_keep_lens))(
        jax.random.PRNGKey(7))
    port = ViPTrack(**TINY)
    port.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    jar = jax_ar.AlphaRefineNet(input_size=64)
    z = jnp.zeros((1, 64, 64, 3))
    ar_vars = jax.jit(lambda r: jar.init(r, z, jnp.asarray([[16.0, 16.0, 32.0, 32.0]]), z))(
        jax.random.PRNGKey(1))
    par = alpha_refine.build_alpha_refine(64, state_dict=alpha_refine_state_dict_from_flax(
        jax.tree.map(np.asarray, ar_vars["params"])))
    return jm, params, port, jar, ar_vars, par


class _Recording:
    """An ARcmSeg that keeps the probability map of every refined frame."""

    def __init__(self, seg):
        self.seg, self.rt, self.probs = seg, seg.rt, []

    def initialize(self, frame, box):
        self.seg.initialize(frame, box)

    def refine(self, frame, box):
        out = self.seg.refine(frame, box)
        self.probs.append(out[1])
        return out


def _run(run_vot_exp, tracker_factory, script, mask, refiner=None):
    fout = io.StringIO()
    run_vot_exp(tracker_factory, channels="rgbd", dtype="rgbcolormap", fin=io.StringIO(script),
                fout=fout, mask=mask, refine_factory=(lambda: refiner) if mask else None)
    return fout.getvalue()


def test_rectangle_session_matches_jax(sequence, models):
    _, colors, depths, gt = sequence
    jm, params, port, *_ = models
    x, y, w, h = gt[0]
    script = _script(colors, depths, f"{x:.4f},{y:.4f},{w:.4f},{h:.4f}")
    want = _run(jax_vot.run_vot_exp, lambda: JaxTracker(jm, params, JaxRuntime(**RT_ARGS)),
                script, mask=False)
    timings = {}
    fout = io.StringIO()
    vot.run_vot_exp(lambda: ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS)), channels="rgbd",
                    dtype="rgbcolormap", fin=io.StringIO(script), fout=fout, timings=timings)
    got = fout.getvalue()
    assert got.splitlines()[0].startswith("@@TRAX:hello")
    sw, sg = _states(want, jax_vot._decode_region), _states(got, vot._decode_region)
    assert len(sw) == len(sg) == N_FRAMES
    np.testing.assert_allclose(np.asarray(sg, np.float64), np.asarray(sw, np.float64),
                               rtol=0, atol=BOX_BAR)
    assert timings["frames"] == N_FRAMES - 1 and timings["refine"] < timings["track"]


def test_mask_session_matches_jax(sequence, models):
    _, colors, depths, gt = sequence
    jm, params, port, jar, ar_vars, par = models
    script = _script(colors, depths, _mask_region(gt[0]))
    jref = _Recording(jax_ar.ARcmSeg(jar, ar_vars, jax_ar.ARRuntime(input_size=64)))
    pref = _Recording(alpha_refine.ARcmSeg(par, "cpu", alpha_refine.ARRuntime(input_size=64)))
    want = _run(jax_vot.run_vot_exp, lambda: JaxTracker(jm, params, JaxRuntime(**RT_ARGS)),
                script, True, jref)
    got = _run(vot.run_vot_exp, lambda: ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS)),
               script, True, pref)
    sw, sg = _states(want, jax_vot._decode_region), _states(got, vot._decode_region)
    assert len(sw) == len(sg) == N_FRAMES
    assert len(jref.probs) == len(pref.probs) == N_FRAMES - 1
    for t, (a, b, pa, pb) in enumerate(zip(sw[1:], sg[1:], jref.probs, pref.probs)):
        assert isinstance(b, vot.Mask) and (b.x, b.y) == (0, 0) and b.mask.shape == (H, W)
        np.testing.assert_allclose(pb, pa, rtol=0, atol=PROB_BAR, err_msg=f"frame {t + 1}")
        flipped = a.mask != b.mask
        assert (np.abs(pa[flipped] - 0.5) <= PROB_BAR).all(), f"frame {t + 1}"


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


def test_entry_answers_a_session_without_jax(sequence, models, tmp_path):
    """The entry on the CPU with the full-width vipt_deep_rgbd recipe
    (seeded weights) and Alpha-Refine from a flax variables file, in a
    process where the JAX side cannot be imported."""
    _, colors, depths, gt = sequence
    *_, ar_vars, _ = models
    ckpt = tmp_path / "ar.npz"
    np.savez(ckpt, params=jax.tree.map(np.asarray, ar_vars["params"]))
    n = 3
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MMTRACK_DEVICE="cpu", MMTRACK_MASK="1",
               MMTRACK_AR_CKPT=str(ckpt), MMTRACK_TRACKER="vipt_deep_rgbd",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=str(tmp_path), env=env,
                          input=_script(colors[:n + 1], depths[:n + 1], _mask_region(gt[0])),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("@@TRAX:hello") and "trax.name=mmtrack_torch" in lines[0]
    states = _states(proc.stdout, vot._decode_region)
    assert len(states) == n + 1
    for s in states[1:]:
        assert isinstance(s, vot.Mask) and s.mask.shape == (H, W)


def test_entry_answers_a_det_dimp50_max_session_without_jax(sequence, tmp_path):
    """MMTRACK_TRACKER=det_dimp50_max on the CPU, rectangle protocol, 3
    frames: the full-width DeT recipe (seeded weights, the augmented init)
    answers every frame with a finite box, jax, flax and mmtrack_tpu
    blocked."""
    _, colors, depths, gt = sequence
    n = 3
    x, y, w, h = gt[0]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MMTRACK_DEVICE="cpu", MMTRACK_TRACKER="det_dimp50_max",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=str(tmp_path), env=env,
                          input=_script(colors[:n], depths[:n], f"{x:.4f},{y:.4f},{w:.4f},{h:.4f}"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    states = _states(proc.stdout, vot._decode_region)
    assert len(states) == n
    for s in states[1:]:
        assert isinstance(s, vot.Rectangle) and np.isfinite(list(s)).all() and s.width > 0


def test_entry_without_a_card_raises_before_answering(sequence, tmp_path):
    """With the default device and no CUDA the entry fails before it sends
    the TraX hello: no CPU fallback."""
    _, colors, depths, gt = sequence
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MMTRACK_DEVICE")}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "mmtrack_torch.eval.vot_entry"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          input=_script(colors[:2], depths[:2], "10,10,20,20"), timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA is not available" in proc.stderr


def test_importing_the_entry_starts_no_session(tmp_path):
    """Importing the entry module (as the traxpython protocol would) with
    stdin closed and the JAX side blocked starts no TraX session: exit 0
    and nothing on stdout. The session starts only under `python -m`
    (`protocol = trax`, README.md)."""
    importer = (BLOCKER.replace('runpy.run_module("mmtrack_torch.eval.vot_entry", '
                                'run_name="__main__")', "")
                + "import os\nos.close(0)\nimport mmtrack_torch.eval.vot_entry\n")
    assert "run_module" not in importer
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", importer], cwd=str(tmp_path), env=env,
                          stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == ""
