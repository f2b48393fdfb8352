"""SiamFC of the port against the JAX package at f32, on bridged weights,
and the OPE entry on a SiamFC recipe without JAX.

The full-width model (AlexNet embedding at 127 / 255) from flax init
crosses through models/convert.py::siamfc_state_dict_from_flax. Bars: the
17 -> 272 bilinear upsample within 1e-6 of jax.image.resize, edges
included; the mean-padded crop within 1e-4 on the 0-255 scale; score maps
within 1e-4; the tracker free from frame 0 within 0.05 px; `run_ope
--tracker siamfc` on a 3-frame DepthTrack fixture in a process that cannot
import jax, flax or mmtrack_tpu.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cv2  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models.siamfc import SiamFC as JaxSiamFC  # noqa: E402
from mmtrack_tpu.trackers import siamfc_tracker as jax_sf  # noqa: E402
from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope  # noqa: E402
from mmtrack_torch.eval.datasets import list_sequences, load_sequence  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models.convert import siamfc_state_dict_from_flax  # noqa: E402
from mmtrack_torch.models.siamfc import SiamFC  # noqa: E402
from mmtrack_torch.trackers import siamfc_tracker as sf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

PX = 0.05


@pytest.fixture(scope="module")
def siamfc():
    """(jax model, flax params, port model) on PRNGKey(2) weights."""
    jm = JaxSiamFC()
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 127, 127, 6)),
                                       jnp.zeros((1, 255, 255, 6))))(jax.random.PRNGKey(2))
    port = SiamFC()
    port.load_state_dict(siamfc_state_dict_from_flax(jax.tree.map(np.asarray,
                                                                  params["params"])))
    return jm, params, port.eval()


def test_upsample_matches_jax_image_resize():
    x = np.random.RandomState(0).randn(3, 17, 17).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 272, 272), "bilinear"))
    got = sf.resize_bilinear(torch.from_numpy(x), (272, 272)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the first and last 8 samples repeat the edge values
    np.testing.assert_allclose(got[:, :8, :8], np.broadcast_to(x[:, :1, :1], (3, 8, 8)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, -8:, -8:], np.broadcast_to(x[:, -1:, -1:], (3, 8, 8)),
                               rtol=0, atol=1e-6)


def test_mean_pad_crop_matches_jax():
    frame = np.random.RandomState(1).randint(0, 256, (60, 80, 6)).astype(np.uint8)
    rt = jax_sf.SiamFCRuntime()
    for cy, cx, side in ((30.2, 40.7, 51.3), (-4.0, 75.5, 90.0), (58.9, 1.2, 23.4)):
        center = np.asarray([cy, cx], np.float32)
        want = jax_sf._mean_pad_crop(rt, jnp.asarray(frame), jnp.asarray(center),
                                     jnp.float32(side), 127)
        got = sf.mean_pad_crop(torch.from_numpy(frame), torch.from_numpy(center),
                               torch.tensor(side), 127)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_siamfc_responses_match_jax(siamfc):
    jm, params, port = siamfc
    rng = np.random.RandomState(2)
    z = rng.rand(2, 127, 127, 6).astype(np.float32)
    x = rng.rand(2, 255, 255, 6).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(z), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    assert got.shape == (2, 17, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_siamfc_tracker_free_run_matches_jax(siamfc):
    jm, params, port = siamfc
    ours = sf.SiamFCTracker(port, "cpu")
    theirs = jax_sf.SiamFCTracker(jm, params)
    frames, gt = make_synthetic_sequence(n_frames=6, height=160, width=200, seed=3)
    boxes = {}
    for name, tr in (("ours", ours), ("theirs", theirs)):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
        boxes[name] = [tr.track(f)["target_bbox"] for f in frames[1:]]
    res = compare_freerun(boxes["theirs"], boxes["ours"], PX)
    assert res["pass"], res


def test_siamfc_npz_round_trips(siamfc, tmp_path):
    _, params, port = siamfc
    path = str(tmp_path / "siamfc.npz")
    np.savez(path, params=np.asarray(jax.tree.map(np.asarray, params["params"]), dtype=object))
    fresh = SiamFC()
    fresh.load_state_dict(load_checkpoint(path, "siamfc"))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


BLOCKER = """
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmtrack_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
sys.argv = ["run_ope"] + sys.argv[1:]
runpy.run_module("mmtrack_torch.eval.run_ope", run_name="__main__")
"""


def test_entry_runs_siamfc_without_jax(tmp_path):
    """`run_ope --tracker siamfc` on a 3-frame DepthTrack layout (colour
    JPEG + 16-bit depth PNG, composed rgbcolormap): result files and a
    report equal to the analysis of those files."""
    root = tmp_path / "depthtrack"
    seq = root / "seq0"
    (seq / "color").mkdir(parents=True)
    (seq / "depth").mkdir()
    frames, gt = make_synthetic_sequence(n_frames=3, height=120, width=160, seed=5)
    base = np.random.RandomState(5).randint(500, 4000, (120, 160)).astype(np.uint16)
    for t in range(3):
        cv2.imwrite(str(seq / "color" / f"{t:08d}.jpg"), frames[t][..., :3][..., ::-1])
        cv2.imwrite(str(seq / "depth" / f"{t:08d}.png"), (base + 7 * t).astype(np.uint16))
    np.savetxt(str(seq / "groundtruth.txt"), gt, delimiter=",")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    results = tmp_path / "results"
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER, "--device", "cpu", "--tracker", "siamfc",
         "--dataset", "DepthTrack", "--dataset_root", str(root), "--analyze",
         "--results_root", str(results)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    boxes = np.loadtxt(results / "DepthTrack" / "siamfc" / "seq0.txt", delimiter=",")
    assert boxes.shape == (3, 4) and np.isfinite(boxes).all()
    seqs = [load_sequence(d, "DepthTrack") for d in list_sequences(str(root), "DepthTrack")]
    report = json.loads((results / "DepthTrack" / "siamfc_report.json").read_text())
    ope = analyze_ope(seqs, str(results), "DepthTrack", "siamfc")["overall"]
    assert report["ope"] == {k: v for k, v in ope.items() if np.isscalar(v)}
    assert report["fscore"] == analyze_fscore(seqs, str(results), "DepthTrack", "siamfc")
