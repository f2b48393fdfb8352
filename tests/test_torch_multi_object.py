"""The port's multi-object wrapper (eval/multi_object.py) against the JAX
package's copy, the port's mask trackers under it, and the VOT entry's
mask protocol with a tracker that predicts its own masks.

  * the four cases of tests/test_multi_object.py (the info split with
    init_other, the labelled merge by argmax above the threshold, an
    object entering mid-sequence, the merge_results override) run on both
    copies with the same inputs: equal outputs;
  * two port LWL trackers (build_lwl at narrow widths, 96 px crops,
    memory 4) on a labelled init mask, merged over 4 frames: per-object
    boxes, the merged map labels each pixel with the first object whose
    mask holds it, background elsewhere;
  * `python -m mmtrack_torch.eval.vot_entry` with MMTRACK_TRACKER=lwl,
    MMTRACK_MASK=1 and MMTRACK_DEVICE=cpu answers a 3-frame mask session
    in a process where jax, flax and mmtrack_tpu cannot be imported and
    Alpha-Refine's builder raises (the recipe's runtime narrowed to 96 px
    crops and memory 4): every state is a full-frame mask; the init mask
    reaches the tracker verbatim.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_tpu.eval import multi_object as jmo  # noqa: E402
from mmtrack_tpu.eval import vot as jax_vot  # noqa: E402
from mmtrack_torch.eval import multi_object as pmo  # noqa: E402
from mmtrack_torch.eval import vot  # noqa: E402
from mmtrack_torch.models import lwl as pl  # noqa: E402
from mmtrack_torch.models.vipt import init_weights  # noqa: E402
from mmtrack_torch.trackers import lwl_tracker as plt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scripted(counter: list):
    """The scripted tracker of tests/test_multi_object.py: a fixed box step
    and a soft box mask whose level grows with the instance's index."""
    class Scripted:
        def __init__(self):
            counter[0] += 1
            self.idx = counter[0]
            self.inits = []

        def initialize(self, image, info):
            self.inits.append(info)
            self.box = list(map(float, info["init_bbox"]))

        def track(self, image):
            self.box = [self.box[0] + 1.0, self.box[1], self.box[2], self.box[3]]
            H, W = image.shape[:2]
            soft = np.zeros((H, W), np.float32)
            x, y, w, h = map(int, self.box)
            soft[y:y + h, x:x + w] = 0.4 + 0.1 * self.idx
            return {"target_bbox": list(self.box),
                    "segmentation": (soft > 0.5).astype(np.uint8),
                    "segmentation_soft": soft, "best_score": 0.9}
    return Scripted


def _frames(n=5, H=32, W=48):
    return [np.zeros((H, W, 3), np.uint8) for _ in range(n)]


def assert_same(a, b):
    """Deep equality of wrapper outputs: dicts, lists and arrays."""
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def _labels():
    labels = np.zeros((32, 48), np.uint8)
    labels[2:6, 2:6] = 1
    labels[10:14, 10:14] = 2
    return labels


def case_split(mod):
    counter = [0]
    w = mod.MultiObjectWrapper(scripted(counter))
    info = {"object_ids": ["1", "2"], "init_object_ids": ["1", "2"],
            "sequence_object_ids": ["1", "2"],
            "init_bbox": {"1": [2, 2, 4, 4], "2": [10, 10, 4, 4]}, "init_mask": _labels()}
    out = w.initialize(_frames()[0], info)
    inits = {k: t.inits for k, t in w.trackers.items()}
    return out, inits


def case_merge(mod):
    counter = [0]
    w = mod.MultiObjectWrapper(scripted(counter))
    frames = _frames()
    w.initialize(frames[0], {"object_ids": ["1", "2"], "init_object_ids": ["1", "2"],
                             "init_bbox": {"1": [4, 4, 8, 8], "2": [5, 4, 8, 8]}})
    return w.track(frames[1])


def case_mid_sequence(mod):
    counter = [0]
    frame_infos = [None, {"object_ids": ["1", "3"], "init_object_ids": ["3"],
                          "init_bbox": {"3": [20, 10, 6, 6]}}, None, None]
    return mod.run_multi_object_sequence(
        scripted(counter), _frames(), {"object_ids": ["1", "3"], "init_object_ids": ["1"],
                                       "init_bbox": {"1": [2, 2, 4, 4]}}, frame_infos)


def case_override(mod):
    counter = [0]
    base = scripted(counter)

    class Custom(base):
        def merge_results(self, out_all):
            return {"n_objects": len(out_all), "ids": list(out_all)}

    w = mod.MultiObjectWrapper(Custom)
    return w.initialize(_frames()[0], {"object_ids": ["1", "2"], "init_object_ids": ["1", "2"],
                                       "init_bbox": {"1": [2, 2, 4, 4], "2": [8, 8, 4, 4]}})


def _drop_times(out):
    """The merged outputs without the wall-clock 'time' entries."""
    if isinstance(out, dict):
        return {k: _drop_times(v) for k, v in out.items() if k != "time"}
    if isinstance(out, (tuple, list)):
        return type(out)(_drop_times(v) for v in out)
    return out


@pytest.mark.parametrize("case", [case_split, case_merge, case_mid_sequence, case_override])
def test_wrapper_cases_equal_jax(case):
    want, got = case(jmo), case(pmo)
    assert_same(_drop_times(got), _drop_times(want))


def test_wrapper_copy_is_numpy_only():
    src = open(pmo.__file__).read()
    assert "import torch" not in src and "mmtrack_tpu" not in src.split('"""', 2)[2]


# ---------------------------------------------------------------- LWL, two objects

NARROW = dict(num_filters=2, label_encoder_dims=(4, 8, 8), decoder_mdim=16, optim_iter=2)


def test_two_lwl_trackers_merge_a_labelled_mask():
    model = pl.build_lwl(**NARROW)
    init_weights(model, 0)
    with torch.no_grad():   # the decoder steered to masks of both signs
        model.decoder.project.conv2.weight.mul_(50.0)
    rt = plt.LWLRuntime(image_sample_size=96, sample_memory_size=4, net_opt_iter=3)
    made = []

    def factory():
        made.append(plt.LWLTracker(model, "cpu", rt))
        return made[-1]

    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 255, (120, 160, 3)).astype(np.uint8) for _ in range(4)]
    labels = np.zeros((120, 160), np.uint8)
    labels[30:60, 20:60] = 1
    labels[50:90, 90:140] = 2
    info = {"object_ids": ["1", "2"], "init_object_ids": ["1", "2"],
            "init_bbox": {"1": [20, 30, 40, 30], "2": [90, 50, 50, 40]}, "init_mask": labels}
    wrapper = pmo.MultiObjectWrapper(factory)
    out = wrapper.initialize(frames[0], info)
    assert np.array_equal(out["segmentation"], labels)
    for t in made:   # each tracker got its own binary mask
        assert t.state["memory_masks"][0].sum() > 0
    masks = []
    orig_track = plt.LWLTracker.track

    def recording(self, image, info=None):
        res = orig_track(self, image, info)
        masks.append(res["segmentation"])
        return res

    plt.LWLTracker.track = recording
    try:
        for f in frames[1:]:
            masks.clear()
            out = wrapper.track(f, {"previous_output": out})
            assert set(out["target_bbox"]) == {"1", "2"}
            m1, m2 = masks
            want = np.where(m1, 1, np.where(m2, 2, 0)).astype(np.uint8)
            np.testing.assert_array_equal(out["segmentation"], want)
    finally:
        plt.LWLTracker.track = orig_track
    assert len(made) == 2 and all(t.state["frame_num"] == 4 for t in made)


# ---------------------------------------------------------------- the VOT entry

RUNNER = """
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmtrack_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
from mmtrack_torch import registry
from mmtrack_torch.eval import vot_entry
from mmtrack_torch.trackers.lwl_tracker import LWLRuntime
def no_refiner(*a, **k):
    raise AssertionError("Alpha-Refine built for a mask tracker")
vot_entry.build_alpha_refine = no_refiner
build = registry.TRACKER_REGISTRY["lwl"].build
seen = []
def narrow(**kw):
    tracker = build(**kw)
    tracker.rt = LWLRuntime(image_sample_size=96, sample_memory_size=4)
    init = tracker.initialize
    def initialize(image, info):
        seen.append(info["init_mask"].sum())
        return init(image, info)
    tracker.initialize = initialize
    return tracker
registry.TRACKER_REGISTRY["lwl"].build = narrow
vot_entry.main()
print("init_mask_sum", seen[0], file=sys.stderr)
"""


def test_vot_entry_answers_an_lwl_mask_session_without_jax(tmp_path):
    H, W, n = 96, 128, 3
    rng = np.random.RandomState(4)
    colors, depths = [], []
    for t in range(n + 1):
        c, d = str(tmp_path / f"color_{t}.png"), str(tmp_path / f"depth_{t}.png")
        cv2.imwrite(c, rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
        cv2.imwrite(d, rng.randint(1000, 4000, (H, W)).astype(np.uint16))
        colors.append(c)
        depths.append(d)
    mask = np.zeros((20, 30), np.uint8)
    mask[3:17, 4:26] = 1
    region = jax_vot._encode_region(jax_vot.Mask(40, 30, mask))
    lines = [f'@@TRAX:initialize "file://{colors[0]}" "file://{depths[0]}" "{region}"']
    lines += [f'@@TRAX:frame "file://{c}" "file://{d}"' for c, d in zip(colors[1:], depths[1:])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MMTRACK_DEVICE="cpu", MMTRACK_MASK="1", MMTRACK_TRACKER="lwl",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=str(tmp_path), env=env,
                          input="\n".join(lines + ["@@TRAX:quit", ""]), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    states = [vot._decode_region(ln.split('"')[1]) for ln in proc.stdout.splitlines()
              if ln.startswith("@@TRAX:state")]
    assert len(states) == n + 1
    for s in states[1:]:
        assert isinstance(s, vot.Mask) and (s.x, s.y) == (0, 0) and s.mask.shape == (H, W)
    assert f"init_mask_sum {float(mask.sum())}" in proc.stderr
