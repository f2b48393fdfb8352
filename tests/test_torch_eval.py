"""The port's OPE evaluation modules against the JAX package's, on the CPU.

mmtrack_torch/eval/{datasets,metrics,analysis,ope}.py and utils/env.py are
copies of their JAX twins (which import no JAX but live in a package that
does). Held here on fixtures the tests write: every dataset layout loads
into equal EvalSequence fields, the metric and analysis outputs agree
within 1e-12, result files are byte-identical in each format, and the
sequential driver resumes as the JAX one does.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from mmtrack_tpu.eval import analysis as jax_analysis  # noqa: E402
from mmtrack_tpu.eval import datasets as jax_datasets  # noqa: E402
from mmtrack_tpu.eval import metrics as jax_metrics  # noqa: E402
from mmtrack_tpu.eval import ope as jax_ope  # noqa: E402
from mmtrack_torch.eval import analysis, datasets, metrics, ope  # noqa: E402

TOL = 1e-12


def _touch(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").close()
    return path


def _gt(n: int, seed: int, nan_rows=()) -> np.ndarray:
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.uniform(0, 200, (n, 2)), rng.uniform(5, 60, (n, 2))], 1)
    gt[list(nan_rows)] = np.nan
    return gt


def _pair_layout(rgb_dir, x_dir, rgb_ext, x_ext, gt_name, delim=","):
    def make(seq: str, n: int):
        for t in range(n):
            _touch(os.path.join(seq, rgb_dir, f"{t:05d}{rgb_ext}"))
            _touch(os.path.join(seq, x_dir, f"{t:05d}{x_ext}"))
        np.savetxt(os.path.join(seq, gt_name), _gt(n, n), delimiter=delim, fmt="%.3f")
    return make


def _depthtrack(seq, n):
    for t in range(n):
        _touch(os.path.join(seq, "color", f"{t:08d}.jpg"))
        _touch(os.path.join(seq, "depth", f"{t:08d}.png"))
    np.savetxt(os.path.join(seq, "groundtruth.txt"), _gt(n, n, nan_rows=(2,)), delimiter=",")


def _gtot(seq, n):
    _pair_layout("v", "i", ".png", ".png", "unused.txt")(seq, n)
    corners = _gt(n, 3)
    corners[:, 2:] += corners[:, :2]
    np.savetxt(os.path.join(seq, "groundTruth_v.txt"), corners[:, [2, 1, 0, 3]], delimiter=" ")


def _visevent(seq, n):
    _pair_layout("vis_imgs", "event_imgs", ".bmp", ".bmp", "groundtruth.txt")(seq, n)
    absent = np.ones(n)
    absent[:2] = 0
    absent[4] = 0
    np.savetxt(os.path.join(seq, "absent_label.txt"), absent, fmt="%d")


def _lasot(seq, n):
    for t in range(1, n + 1):
        _touch(os.path.join(seq, "img", f"{t:08d}.jpg"))
    np.savetxt(os.path.join(seq, "groundtruth.txt"), _gt(n, 5), delimiter=",", fmt="%d")
    occ = np.zeros(n, int)
    occ[3] = 1
    np.savetxt(os.path.join(seq, "full_occlusion.txt"), occ[None], delimiter=",", fmt="%d")
    np.savetxt(os.path.join(seq, "out_of_view.txt"), np.roll(occ, 1)[None], delimiter=",",
               fmt="%d")


def _got10k(seq, n):
    for t in range(1, n + 1):
        _touch(os.path.join(seq, f"{t:08d}.jpg"))
    np.savetxt(os.path.join(seq, "groundtruth.txt"), _gt(1, 6), delimiter=",")


def _trackingnet(seq, n):
    frames = os.path.join(seq, "frames", "s")
    for t in range(n):
        _touch(os.path.join(frames, f"{t}.jpg"))
    os.makedirs(os.path.join(seq, "anno"), exist_ok=True)
    np.savetxt(os.path.join(seq, "anno", "s.txt"), _gt(n, 7), delimiter=",")
    return frames


def _otb(seq, n):
    for t in range(1, n + 3):
        _touch(os.path.join(seq, "img", f"{t:04d}.jpg"))
    np.savetxt(os.path.join(seq, "groundtruth_rect.txt"), _gt(n, 8), delimiter="\t", fmt="%d")


LAYOUTS = {
    "DepthTrack": _depthtrack,
    "CDTB": _depthtrack,
    "LasHeR": _pair_layout("visible", "infrared", ".jpg", ".jpg", "visible.txt"),
    "RGBT234": _pair_layout("visible", "infrared", ".jpg", ".jpg", "visible.txt"),
    "GTOT": _gtot,
    "VTUAV": _pair_layout("rgb", "ir", ".jpg", ".jpg", "rgb.txt", delim=" "),
    "VisEvent": _visevent,
    "LaSOT": _lasot,
    "GOT10k_test": _got10k,
    "TrackingNet": _trackingnet,
    "OTB": _otb,
}


def _assert_same_sequence(a, b):
    assert type(a).__name__ == type(b).__name__ == "EvalSequence"
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray) or isinstance(fb[k], np.ndarray):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
            assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("dataset", list(LAYOUTS))
def test_load_sequence_equals_jax(tmp_path, dataset):
    root = tmp_path / dataset
    paths = []
    for i, n in enumerate((7, 5)):
        seq = str(root / f"seq{i}")
        made = LAYOUTS[dataset](seq, n)
        paths.append(made or seq)
    assert datasets.list_sequences(str(root), dataset) == \
        jax_datasets.list_sequences(str(root), dataset)
    for p in paths:
        _assert_same_sequence(datasets.load_sequence(p, dataset),
                              jax_datasets.load_sequence(p, dataset))


def test_unknown_dataset_raises_as_jax(tmp_path):
    for mod in (datasets, jax_datasets):
        with pytest.raises(ValueError, match="unknown eval dataset"):
            mod.load_sequence(str(tmp_path), "nope")


def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    gt = _gt(n, seed)
    pred = gt + rng.normal(0, 8, gt.shape)
    pred[::7, 2:] = 0.0                        # degenerate boxes
    return pred, gt


def _close(a, b, path="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, str):
        assert a == b, path
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=TOL, err_msg=path)


METRICS = {
    "iou_xywh": lambda m, p, g: m.iou_xywh(p, g),
    "center_error": lambda m, p, g: m.center_error(p, g),
    "norm_center_error": lambda m, p, g: m.norm_center_error(p, g),
    "success_curve": lambda m, p, g: m.success_curve(m.iou_xywh(p, g)),
    "precision_curve": lambda m, p, g: m.precision_curve(m.center_error(p, g)),
    "norm_precision_curve": lambda m, p, g: m.norm_precision_curve(m.norm_center_error(p, g)),
    "evaluate_ope": lambda m, p, g: m.evaluate_ope(p, g),
    "evaluate_ope_valid": lambda m, p, g: m.evaluate_ope(p, g, valid=np.arange(len(g)) % 3 > 0),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_metrics_equal_jax(name):
    pred, gt = _boxes(60, 1)
    gt[5] = np.nan
    _close(METRICS[name](metrics, pred, gt), METRICS[name](jax_metrics, pred, gt))


def test_prre_fscore_equal_jax():
    out = []
    for m in (metrics, jax_metrics):
        acc = m.PrReFScore()
        for seed in (2, 3):
            pred, gt = _boxes(40, seed)
            conf = np.random.RandomState(seed).uniform(0, 1, 39)
            vis = np.random.RandomState(seed + 9).uniform(0, 1, 40) > 0.2
            acc.add_sequence(pred[1:], conf, gt, vis)
        out.append((acc.value(), acc.fscore()))
    _close(out[0], out[1])


def _results(tmp_path, n_seqs=3):
    """Sequences with visibility and saved results (via the JAX writer) under
    tmp_path/res/DS/cfg."""
    seqs = []
    for i in range(n_seqs):
        n = 30 + 5 * i
        pred, gt = _boxes(n, 10 + i)
        vis = np.ones(n, bool)
        if i:
            vis[10 + i:14 + i] = False
        seq = jax_datasets.EvalSequence(f"s{i}", [None] * n, [None] * n, gt, visible=vis)
        res = {"boxes": pred, "confidences": np.random.RandomState(i).uniform(0, 1, n - 1),
               "elapsed": 0.5 + i}
        jax_ope.save_result(jax_ope.result_path(str(tmp_path / "res"), "DS", "cfg", seq.name),
                            res)
        seqs.append(seq)
    return seqs


def _attributes(seqs):
    rng = np.random.RandomState(4)
    return {s.name: {"occlusion": rng.uniform(0, 1, len(s)) > 0.5,
                     "fast_motion": rng.uniform(0, 1, len(s)) > 0.7} for s in seqs}


ANALYSES = {
    "analyze_ope": lambda a, seqs, r: a.analyze_ope(seqs, r, "DS", "cfg"),
    "analyze_fscore": lambda a, seqs, r: a.analyze_fscore(seqs, r, "DS", "cfg"),
    "analyze_attributes": lambda a, seqs, r: a.analyze_attributes(seqs, r, "DS", "cfg",
                                                                  _attributes(seqs)),
    "analyze_depth_quality": lambda a, seqs, r: a.analyze_depth_quality(
        seqs, r, "DS", "cfg", {s.name: np.linspace(0, 1, len(s)) for s in seqs}),
    "analyze_longterm": lambda a, seqs, r: a.analyze_longterm(seqs, r, "DS", "cfg"),
    "analyze_speed": lambda a, seqs, r: a.analyze_speed(seqs, r, "DS", "cfg"),
    "load_result": lambda a, seqs, r: a.load_result(r, "DS", "cfg", seqs[1].name),
    "print_results": lambda a, seqs, r: a.print_results(a.analyze_ope(seqs, r, "DS", "cfg"),
                                                        "cfg"),
}


@pytest.mark.parametrize("name", list(ANALYSES))
def test_analysis_equals_jax(tmp_path, name):
    seqs = _results(tmp_path)
    root = str(tmp_path / "res")
    _close(ANALYSES[name](analysis, seqs, root), ANALYSES[name](jax_analysis, seqs, root))


FORMATS = [("%.14f", ",", "value"), ("%.18e", " ", "value"), ("%d", "\t", "txt")]


@pytest.mark.parametrize("fmt,delimiter,time_style", FORMATS)
def test_save_result_byte_identical(tmp_path, fmt, delimiter, time_style):
    pred, _ = _boxes(12, 5)
    res = {"boxes": pred, "confidences": np.linspace(0, 1, 11), "elapsed": 1.25,
           "times": np.linspace(0.01, 0.02, 12)}
    files = []
    for mod, sub in ((ope, "port"), (jax_ope, "jax")):
        path = mod.result_path(str(tmp_path / sub), "DS", "cfg", "seq")
        mod.save_result(path, res, fmt=fmt, delimiter=delimiter, time_style=time_style)
        d = os.path.dirname(path)
        files.append({f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))})
    assert files[0].keys() == files[1].keys() and len(files[0]) == 3
    assert files[0] == files[1]


class _FixedTracker:
    """Boxes that drift by a fixed step: the same trajectory in either
    package's driver."""

    def initialize(self, image, info):
        self.box = np.asarray(info["init_bbox"], np.float64)
        self.shape = image.shape

    def track(self, image):
        assert image.shape == self.shape
        self.box = self.box + [1.5, -0.5, 0.25, 0.0]
        return {"target_bbox": self.box.tolist(), "best_score": float(self.box[0] % 1)}


def _disk_sequences(mod, tmp_path):
    import cv2

    rng = np.random.RandomState(0)
    seqs = []
    for i, n in enumerate((4, 3)):
        seq = tmp_path / "data" / f"seq{i}"
        for t in range(n):
            _touch(str(seq / "color" / f"{t:08d}.jpg"))
            cv2.imwrite(str(seq / "color" / f"{t:08d}.jpg"),
                        rng.randint(0, 255, (24, 32, 3)).astype(np.uint8))
            _touch(str(seq / "depth" / f"{t:08d}.png"))
            cv2.imwrite(str(seq / "depth" / f"{t:08d}.png"),
                        rng.randint(500, 3000, (24, 32)).astype(np.uint16))
        np.savetxt(str(seq / "groundtruth.txt"), _gt(n, i), delimiter=",")
        seqs.append(mod.load_sequence(str(seq), "DepthTrack"))
    return seqs


def test_run_dataset_resumes_as_jax(tmp_path, capsys):
    outs = {}
    for name, d, o in (("port", datasets, ope), ("jax", jax_datasets, jax_ope)):
        seqs = _disk_sequences(d, tmp_path)
        root = str(tmp_path / name)
        first = o.run_dataset(_FixedTracker, seqs, root, "DepthTrack", "cfg")
        again = o.run_dataset(_FixedTracker, seqs, root, "DepthTrack", "cfg")
        assert again == []
        printed = capsys.readouterr().out.splitlines()
        outs[name] = (first, printed, root)
    (pf, pp, proot), (jf, jp, jroot) = outs["port"], outs["jax"]
    assert [r["name"] for r in pf] == [r["name"] for r in jf]
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["confidences"], b["confidences"])
    assert [ln.split(" ,")[0] for ln in pp] == [ln.split(" ,")[0] for ln in jp]
    assert pp[-2:] == jp[-2:] == ["-1 seq0", "-1 seq1"]
    for seq in ("seq0", "seq1"):
        for suffix in (".txt", "_confidence.value"):
            rel = os.path.join("DepthTrack", "cfg", seq + suffix)
            assert open(os.path.join(proot, rel), "rb").read() == \
                open(os.path.join(jroot, rel), "rb").read()


def test_env_settings_read_the_jax_file(tmp_path):
    """One local.yaml serves both packages; the port never writes one."""
    from mmtrack_torch.utils.env import load_env_settings
    from mmtrack_tpu.utils.env import load_env_settings as jax_load

    import yaml

    path = str(tmp_path / "local.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"workspace_dir": "/ws", "datasets": {"depthtrack_dir": "/d/dt",
                                                              "lasher_dir": "/d/lasher"}}, f)
    ours, theirs = load_env_settings(path), jax_load(path)
    assert ours.workspace_dir == theirs.workspace_dir == "/ws"
    for name in ("DepthTrack", "LasHeR", "lasher_test"):
        assert ours.dataset_root(name) == theirs.dataset_root(name)
    with pytest.raises(FileNotFoundError, match="visevent_dir"):
        ours.dataset_root("VisEvent")
    missing = str(tmp_path / "none" / "local.yaml")
    assert load_env_settings(missing).datasets == theirs.__class__().datasets
    assert not os.path.exists(missing)
