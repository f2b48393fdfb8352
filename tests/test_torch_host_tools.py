"""The port's host tools against their JAX twins on the CPU:

- utils/tb.py: the tfevents files byte-equal to mmtrack_tpu/utils/tb.py's
  at a fixed wall time and host name (EventWriter and TensorboardWriter,
  one scalar, several scalars in one event, a negative step, NaN), and
  `read_scalars` equal on both files; the port's Trainer writes through a
  TensorboardWriter.
- eval/submission.py and `python -m mmtrack_torch.eval.transform_results`:
  the GOT-10k and TrackingNet zips equal to JAX's member by member (names
  and bytes) over one result tree (tab, comma and int boxes, _time.value,
  _time.txt and _confidence.value companions, an 'all' file).
- native.py: `polygon_iou`, `batch_iou_xywh` and `polygon_to_xywh` equal
  to mmtrack_tpu/native.py's on seeded polygons and boxes (one region.cc,
  built by each into its own place); `polygon_iou` equal to its numpy
  plain version and within 4 grid cells of 256 of JAX's matplotlib
  rasterisation (the grid's points rounded otherwise, matplotlib's own
  point test); the library is built under mmtrack_torch/kernels/_build.
- vis.py: draw_box, overlay_mask, score_map_heatmap, ce_token_mask
  bit-equal; TrackingVisualizer's files byte-equal; plot_curves' PNG
  pixels equal.
- utils/profiling.py: `flops_estimate` (torch's FlopCounterMode) against
  JAX's XLA cost analysis: equal on a matrix product and a VALID
  convolution, 2 per multiply-add. The conventions differ on a SAME
  convolution, where XLA leaves out the kernel taps that fall on the zero
  padding and FlopCounterMode counts every tap of every output (both held
  to their closed forms), and on elementwise work, which XLA counts and
  FlopCounterMode does not. `trace_profile` writes a Chrome trace on the
  CPU naming the ops it ran (the tracer: tests/test_torch_tracing.py).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import math
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu import native as jax_native  # noqa: E402
from mmtrack_tpu import vis as jax_vis  # noqa: E402
from mmtrack_tpu.eval import submission as jax_submission  # noqa: E402
from mmtrack_tpu.utils import profiling as jax_profiling  # noqa: E402
from mmtrack_tpu.utils import tb as jax_tb  # noqa: E402
from mmtrack_torch import native, vis  # noqa: E402
from mmtrack_torch.eval import submission, transform_results  # noqa: E402
from mmtrack_torch.utils import profiling, tb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ tfevents

class _Stat:
    def __init__(self, history):
        self.history = history
        self.has_new_data = True


def _write_events(mod, root, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    w = mod.EventWriter(os.path.join(root, "ev"))
    w.add_scalar("Loss/total", 0.125, 3)
    w.add_scalars([("a", 1.5), ("b", -2.0), ("nan", float("nan"))], 7)
    w.add_scalar("neg", 4.0, -5)
    w.close()
    t = mod.TensorboardWriter(os.path.join(root, "tb"), ["train", "val"])
    t.write_epoch({"train": {"Loss": _Stat([0.5, 0.25]), "fps": 12.0}, "val": None}, 2)
    t.close()
    return w.path, t.writer["train"].path


def test_tfevents_bytes_and_reader_match_jax(tmp_path, monkeypatch):
    ours = _write_events(tb, str(tmp_path / "port"), monkeypatch)
    theirs = _write_events(jax_tb, str(tmp_path / "jax"), monkeypatch)
    for a, b in zip(ours, theirs):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        ra, rb = tb.read_scalars(a), jax_tb.read_scalars(b)
        assert len(ra) == len(rb) > 0
        for (sa, ta, va), (sb, tb_, vb) in zip(ra, rb):
            assert (sa, ta) == (sb, tb_) and (va == vb or (math.isnan(va) and math.isnan(vb)))
    assert [(s, t) for s, t, _ in tb.read_scalars(ours[1])] == [(2, "Loss"), (2, "fps")]


def test_trainer_writes_tensorboard_scalars(tmp_path):
    from mmtrack_torch.train.trainer import Trainer

    class State:
        step = 0

    def step(state, batch):
        return state, {"Loss/total": torch.tensor(float(batch["search"][0]))}

    writer = tb.TensorboardWriter(str(tmp_path), ["train"])
    loader = [{"search": np.array([1.0])}, {"search": np.array([3.0])}]
    Trainer(step, State(), loader, None, log_fn=lambda *a: None, tb_writer=writer).train(2)
    writer.close()
    assert tb.read_scalars(writer.writer["train"].path) == [(1, "Loss/total", 2.0),
                                                          (2, "Loss/total", 2.0)]


# ----------------------------------------------------------- submission

def _result_tree(root, dataset):
    d = os.path.join(root, dataset, "run")
    os.makedirs(d)
    rng = np.random.RandomState(0)
    for i, delim in enumerate(["\t", ",", None]):
        boxes = rng.uniform(0, 300, (5, 4))
        np.savetxt(os.path.join(d, f"seq{i}.txt"), boxes, fmt="%.6f",
                   delimiter=delim if delim else " ")
        np.savetxt(os.path.join(d, f"seq{i}_confidence.value"), rng.rand(5), fmt="%.8f")
    np.savetxt(os.path.join(d, "seq0_time.value"), rng.rand(5), fmt="%.8f")
    np.savetxt(os.path.join(d, "seq1_time.txt"), rng.rand(5), fmt="%f", delimiter="\t")
    np.savetxt(os.path.join(d, "seq2_time.value"), rng.rand(5), fmt="%.8f")
    np.savetxt(os.path.join(d, "seq_all.txt"), rng.rand(2, 4))


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("server", ["got10k", "trackingnet"])
def test_submission_zips_match_jax(tmp_path, server, capsys):
    for side in ("port", "jax"):
        _result_tree(str(tmp_path / side), server)
    assert transform_results.main([server, "--results-root", str(tmp_path / "port"),
                                   "--config", "run"]) == 0
    ours = capsys.readouterr().out.split()
    fn = jax_submission.transform_got10k if server == "got10k" else \
        jax_submission.transform_trackingnet
    theirs = fn(str(tmp_path / "jax"), "run", dataset=server)
    assert [os.path.relpath(p, tmp_path / "port") for p in ours] == \
        [os.path.relpath(p, tmp_path / "jax") for p in theirs]
    for a, b in zip(ours, theirs):
        ma, mb = _members(a), _members(b)
        assert ma == mb and len(ma) >= 3
    assert not os.path.exists(tmp_path / "port" / server / "run")


def test_submission_keeps_the_trees_when_asked(tmp_path):
    _result_tree(str(tmp_path), "got10k")
    raw, sub = submission.transform_got10k(str(tmp_path), "run", cleanup=False)
    assert os.path.isdir(tmp_path / "got10k" / "run")
    assert os.path.isfile(tmp_path / "got10k_submit" / "run" / "seq0" / "seq0_001.txt")
    assert raw.endswith("run.zip") and sub.endswith("run.zip")


# ------------------------------------------------------------- native

def _polygons(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        c = rng.uniform(20, 80, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(3, 8)))
        r = rng.uniform(5, 30, len(ang))
        out.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1))
    return out


def test_native_builds_into_the_port_build_dir():
    native.load_region_lib()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "mmtrack_torch", "kernels", "_build")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygon_iou_matches_jax_and_plain(seed):
    polys = _polygons(seed)
    for a in polys:
        for b in polys:
            got = native.polygon_iou(a, b, samples=256)
            assert got == jax_native.polygon_iou(a, b, samples=256)
            assert got == native.polygon_iou_plain(a, b, samples=256)
            assert abs(got - jax_native._polygon_iou_np(a, b, 256)) <= 4 / 256
        np.testing.assert_array_equal(native.polygon_to_xywh(a), jax_native.polygon_to_xywh(a))
    sq = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], float)
    assert native.polygon_iou(sq, sq + [1.0, 0.0]) == pytest.approx(1 / 3, abs=5e-3)
    assert native.polygon_iou(sq, sq + [10.0, 0.0]) == 0.0


def test_batch_iou_matches_jax_and_metrics():
    from mmtrack_torch.eval.metrics import iou_xywh

    rng = np.random.RandomState(3)
    a = np.concatenate([rng.uniform(0, 50, (5000, 2)), rng.uniform(0, 30, (5000, 2))], 1)
    b = np.concatenate([rng.uniform(0, 50, (5000, 2)), rng.uniform(0, 30, (5000, 2))], 1)
    got = native.batch_iou_xywh(a, b, num_threads=3)
    np.testing.assert_array_equal(got, jax_native.batch_iou_xywh(a, b, num_threads=3))
    np.testing.assert_allclose(got, iou_xywh(a, b), atol=1e-12)


# --------------------------------------------------------------- vis

def test_vis_images_bit_equal_to_jax(tmp_path):
    rng = np.random.RandomState(4)
    frame = rng.randint(0, 255, (60, 80, 6)).astype(np.uint8)
    mask = rng.rand(60, 80) > 0.6
    smap = rng.rand(16, 16).astype(np.float32)
    box = (10.4, 12.6, 30.2, 20.7)
    np.testing.assert_array_equal(vis.draw_box(frame, box, label="0.5"),
                                  jax_vis.draw_box(frame, box, label="0.5"))
    np.testing.assert_array_equal(vis.overlay_mask(frame, mask), jax_vis.overlay_mask(frame, mask))
    np.testing.assert_array_equal(vis.score_map_heatmap(smap, (40, 40)),
                                  jax_vis.score_map_heatmap(smap, (40, 40)))
    removed = [np.array([1, 5, 9]), np.array([[2, 3]])]
    np.testing.assert_array_equal(vis.ce_token_mask(removed, 4), jax_vis.ce_token_mask(removed, 4))
    for mod, side in ((vis, "port"), (jax_vis, "jax")):
        v = mod.TrackingVisualizer(str(tmp_path / side), every=1)
        v.add_frame(0, frame, box, score_map=smap, gt_box=(9, 11, 30, 21), score=0.75)
        v.add_frame(1, frame, box, mask=mask)
        v.write_index()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def test_plot_curves_matches_jax(tmp_path):
    import cv2

    curves = {"a": np.linspace(1, 0, 21), "b": np.linspace(0.8, 0.1, 21) ** 2}
    ours = vis.plot_curves(curves, "overlap", "success", str(tmp_path / "port.png"))
    theirs = jax_vis.plot_curves(curves, "overlap", "success", str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(cv2.imread(ours), cv2.imread(theirs))


# --------------------------------------------------------- profiling

def test_flops_estimate_matches_xla_cost_analysis():
    rng = np.random.RandomState(5)
    a, b = rng.randn(8, 24).astype(np.float32), rng.randn(24, 12).astype(np.float32)
    assert profiling.flops_estimate(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == \
        jax_profiling.flops_estimate(jnp.matmul, jnp.asarray(a), jnp.asarray(b)) == 2 * 8 * 24 * 12
    x = rng.randn(2, 10, 12, 3).astype(np.float32)       # NHWC
    w = rng.randn(3, 3, 3, 5).astype(np.float32)         # HWIO
    per_tap = 2 * 2 * 3 * 5                              # 2 x N x Cin x Cout
    for pad, torch_taps, xla_taps in (("VALID", 8 * 10 * 9, 8 * 10 * 9),
                                      ("SAME", 10 * 12 * 9, (3 * 10 - 2) * (3 * 12 - 2))):
        want = jax_profiling.flops_estimate(
            lambda x, w: jax.lax.conv_general_dilated(
                x, w, (1, 1), pad, dimension_numbers=("NHWC", "HWIO", "NHWC")),
            jnp.asarray(x), jnp.asarray(w))
        got = profiling.flops_estimate(
            lambda x, w: torch.nn.functional.conv2d(x, w, padding=0 if pad == "VALID" else 1),
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1))
        assert (got, want) == (per_tap * torch_taps, per_tap * xla_taps), pad
    assert profiling.flops_estimate(lambda: 1 / 0) is None


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with profiling.trace_profile(str(tmp_path)) as prof:
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(r.key == "aten::mm" for r in prof.key_averages())
