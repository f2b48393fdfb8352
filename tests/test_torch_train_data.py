"""The port's on-disk training corpora against the JAX package's, on small
trees written here in each corpus's own layout (64 x 48 frames, 24 frames
a sequence).

Tolerances: none. For each of the eleven readers, `seq_info` (bbox, valid,
visible) and `get_frames` (frames and boxes) equal JAX's bit for bit; the
registry has JAX's names; and batches from sampler + processing + loader
over DepthTrack, LasHeR, VisEvent, the RGB mix (LaSOT + GOT-10k at 1:1)
and COCO equal JAX's sampler / processing / collate from the same seed,
bit for bit. The corpus writers here also serve tests/test_torch_lmdb.py
and tests/test_torch_train_disk.py.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import sys
import types

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_tpu.config import vipt_experiment_config as jax_config  # noqa: E402
from mmtrack_tpu.data import datasets as jax_datasets  # noqa: E402
from mmtrack_tpu.data import loader as jax_loader  # noqa: E402
from mmtrack_tpu.data import processing as jax_processing  # noqa: E402
from mmtrack_tpu.data import rgb_datasets as jax_rgb  # noqa: E402
from mmtrack_tpu.data import sampler as jax_sampler  # noqa: E402
from mmtrack_torch.config import vipt_experiment_config  # noqa: E402
from mmtrack_torch.data import datasets, loader, processing, rgb_datasets, sampler  # noqa: E402

H, W, N = 48, 64, 24


def _rgb(seed: int) -> np.ndarray:
    """A smooth RGB image with noise (JPEG-like content)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([yy * 4, xx * 3, (yy + xx) * 2], -1) + rng.randint(0, 40, (H, W, 3))
    return base.clip(0, 255).astype(np.uint8)


def _write(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    assert cv2.imwrite(path, img), path


def _depth(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(200, 6000, (H, W)).astype(np.uint16)


def _boxes(seed: int, n: int = N) -> np.ndarray:
    rng = np.random.RandomState(seed)
    xy = rng.uniform(4, 20, (n, 2))
    wh = rng.uniform(14, 24, (n, 2))
    return np.concatenate([xy, wh], 1)


def _gt(path: str, boxes: np.ndarray) -> None:
    np.savetxt(path, boxes, delimiter=",", fmt="%.4f")


def write_depthtrack(root: str, n_seqs: int = 2) -> None:
    """<seq>/color/*.jpg, 16-bit <seq>/depth/*.png, groundtruth.txt with a
    nan row, a 10-px box (not valid) and an 11-px one (valid)."""
    for s in range(n_seqs):
        seq = os.path.join(root, f"seq{s}")
        for t in range(N):
            _write(os.path.join(seq, "color", f"{t + 1:08d}.jpg"), _rgb(100 * s + t))
            _write(os.path.join(seq, "depth", f"{t + 1:08d}.png"), _depth(100 * s + t))
        gt = _boxes(s)
        gt[3] = np.nan
        gt[5, 2] = 10.0
        gt[6, 2:] = 11.0
        _gt(os.path.join(seq, "groundtruth.txt"), gt)


def write_lasher(root: str, n_seqs: int = 2) -> None:
    for s in range(n_seqs):
        seq = os.path.join(root, f"seq{s}")
        for t in range(N):
            _write(os.path.join(seq, "visible", f"v{t:05d}.jpg"), _rgb(100 * s + t))
            _write(os.path.join(seq, "infrared", f"i{t:05d}.jpg"), _rgb(100 * s + t + 50))
        _gt(os.path.join(seq, "visible.txt"), _boxes(10 + s))


def write_visevent(root: str, n_seqs: int = 2) -> None:
    """vis_imgs/frame{t}.bmp for t = 1..N, event_imgs/frame{t}.bmp for
    t = 0..N: the extra first event frame misaligns a second directory
    listing, not the derived names. absent_label.txt marks frame 2
    absent; frame 4's box is 5 px wide (not valid), frame 7's 6 px."""
    for s in range(n_seqs):
        seq = os.path.join(root, f"seq{s}")
        for t in range(N + 1):
            _write(os.path.join(seq, "event_imgs", f"frame{t:04d}.bmp"), _rgb(700 + 100 * s + t))
            if t:
                _write(os.path.join(seq, "vis_imgs", f"frame{t:04d}.bmp"), _rgb(100 * s + t))
        gt = _boxes(20 + s)
        gt[4, 2] = 5.0
        gt[7, 3] = 6.0
        _gt(os.path.join(seq, "groundtruth.txt"), gt)
        present = np.ones(N, np.int64)
        present[2] = 0
        np.savetxt(os.path.join(seq, "absent_label.txt"), present, fmt="%d")


def _occlusion_files(seq: str, occ: list, oov: list) -> None:
    for name, idx in (("full_occlusion.txt", occ), ("out_of_view.txt", oov)):
        flags = np.zeros((1, N), np.int64)
        flags[0, idx] = 1
        np.savetxt(os.path.join(seq, name), flags, delimiter=",", fmt="%d")


def write_lasot(root: str, n_seqs: int = 2) -> None:
    """<class>/<class>-<k>/img/*.jpg, groundtruth.txt, and occlusion /
    out-of-view flags on frames 1 and 2."""
    for s in range(n_seqs):
        seq = os.path.join(root, "cat" if s % 2 == 0 else "dog",
                           f"{'cat' if s % 2 == 0 else 'dog'}-{s + 1}")
        for t in range(N):
            _write(os.path.join(seq, "img", f"{t + 1:08d}.jpg"), _rgb(300 + 100 * s + t))
        _gt(os.path.join(seq, "groundtruth.txt"), _boxes(30 + s))
        _occlusion_files(seq, [1], [2])


def write_got10k(root: str, n_seqs: int = 2) -> None:
    """<seq>/*.jpg, groundtruth.txt, absence.label (frame 2 absent),
    cover.label (frame 3 fully covered) and list.txt."""
    names = [f"GOT-10k_Train_{s + 1:06d}" for s in range(n_seqs)]
    for s, name in enumerate(names):
        seq = os.path.join(root, name)
        for t in range(N):
            _write(os.path.join(seq, f"{t + 1:08d}.jpg"), _rgb(500 + 100 * s + t))
        _gt(os.path.join(seq, "groundtruth.txt"), _boxes(40 + s))
        absence = np.zeros(N, np.int64)
        absence[2] = 1
        cover = np.full(N, 8, np.int64)
        cover[3] = 0
        np.savetxt(os.path.join(seq, "absence.label"), absence, fmt="%d")
        np.savetxt(os.path.join(seq, "cover.label"), cover, fmt="%d")
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def write_trackingnet(root: str) -> None:
    for sid, name in ((0, "seqA"), (1, "seqB")):
        for t in range(N):
            _write(os.path.join(root, f"TRAIN_{sid}", "frames", name, f"{t}.jpg"),
                   _rgb(900 + 50 * sid + t))
        os.makedirs(os.path.join(root, f"TRAIN_{sid}", "anno"), exist_ok=True)
        _gt(os.path.join(root, f"TRAIN_{sid}", "anno", f"{name}.txt"), _boxes(50 + sid))


def write_coco(root: str, depth: bool = False) -> None:
    """annotations/instances_train2017.json over three images; one crowd
    and one tiny annotation that the reader leaves out. With `depth`,
    train2017/{color,depth}/ (COCOSeqDepth), else train2017/*.jpg."""
    images, anns = [], []
    for i in range(3):
        name = f"{i:012d}.jpg"
        images.append({"id": i + 1, "file_name": name})
        if depth:
            _write(os.path.join(root, "train2017", "color", name), _rgb(1000 + i))
            _write(os.path.join(root, "train2017", "depth", name[:-4] + ".png"), _depth(1000 + i))
        else:
            _write(os.path.join(root, "train2017", name), _rgb(1000 + i))
        anns.append({"id": 10 + i, "image_id": i + 1, "bbox": [5.0 + i, 6.0, 20.0, 16.0],
                     "area": 320.0, "iscrowd": 0})
    anns.append({"id": 20, "image_id": 1, "bbox": [1.0, 1.0, 30.0, 30.0], "area": 900.0,
                 "iscrowd": 1})
    anns.append({"id": 21, "image_id": 2, "bbox": [1.0, 1.0, 5.0, 5.0], "area": 25.0,
                 "iscrowd": 0})
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations", "instances_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def write_lasot_depth(root: str) -> None:
    seq = os.path.join(root, "cat", "cat-1")
    for t in range(N):
        _write(os.path.join(seq, "color", f"{t + 1:08d}.jpg"), _rgb(1100 + t))
        _write(os.path.join(seq, "depth", f"{t + 1:08d}.png"), _depth(1100 + t))
    _gt(os.path.join(seq, "groundtruth.txt"), _boxes(60))
    _occlusion_files(seq, [4], [5])


def write_imagenetvid(root: str) -> None:
    """One video, two tracks: track 0 in every frame (occluded at frame
    2), track 1 entering at frame 5."""
    data = os.path.join(root, "Data", "VID", "train", "a", "seq0")
    anno = os.path.join(root, "Annotations", "VID", "train", "a", "seq0")
    os.makedirs(anno, exist_ok=True)
    for t in range(N):
        _write(os.path.join(data, f"{t:06d}.JPEG"), _rgb(1200 + t))
        objs = [(0, 5 + t % 3, 6, 25, 21, int(t == 2))]
        if t >= 5:
            objs.append((1, 30, 10, 50, 30, 0))
        body = "".join(
            f"<object><trackid>{k}</trackid><occluded>{occ}</occluded><bndbox>"
            f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
            f"</bndbox></object>" for k, x1, y1, x2, y2, occ in objs)
        with open(os.path.join(anno, f"{t:06d}.xml"), "w") as f:
            f.write(f"<annotation>{body}</annotation>")


class _COCO:
    """The part of pycocotools.coco.COCO that COCOSeq reads: `anns` in the
    file's order and `loadImgs`."""

    def __init__(self, path):
        with open(path) as f:
            d = json.load(f)
        self.anns = {a["id"]: a for a in d["annotations"]}
        self.imgs = {i["id"]: i for i in d["images"]}

    def loadImgs(self, ids):
        return [self.imgs[i] for i in ids]


@pytest.fixture
def coco_api(monkeypatch):
    """pycocotools is not installed here: both packages get the stand-in."""
    pkg, mod = types.ModuleType("pycocotools"), types.ModuleType("pycocotools.coco")
    mod.COCO = _COCO
    pkg.coco = mod
    monkeypatch.setitem(sys.modules, "pycocotools", pkg)
    monkeypatch.setitem(sys.modules, "pycocotools.coco", mod)


# name -> (writer, port class, JAX class, {frame ids by seq}, expected visible of seq 0)
READERS = {
    "DepthTrack": (write_depthtrack, datasets.DepthTrackTrain, jax_datasets.DepthTrackTrain,
                   [0, 5, 6, 23], {3: False, 5: False, 6: True}),
    "LasHeR": (write_lasher, datasets.LasHeRTrain, jax_datasets.LasHeRTrain, [0, 9, 23], {}),
    "VisEvent": (write_visevent, datasets.VisEventTrain, jax_datasets.VisEventTrain,
                 [0, 2, 23], {2: False, 4: False, 7: True}),
    "LaSOT": (write_lasot, rgb_datasets.LaSOT, jax_rgb.LaSOT, [0, 1, 2, 23],
              {1: False, 2: False, 3: True}),
    "GOT10k": (write_got10k, rgb_datasets.GOT10k, jax_rgb.GOT10k, [0, 2, 3, 23],
               {2: False, 3: False, 4: True}),
    "TrackingNet": (write_trackingnet, rgb_datasets.TrackingNet, jax_rgb.TrackingNet,
                    [0, 23], {}),
    "COCOSeq": (write_coco, rgb_datasets.COCOSeq, jax_rgb.COCOSeq, [0, 0], {}),
    "Got10kDepth": (write_depthtrack, rgb_datasets.Got10kDepth, jax_rgb.Got10kDepth,
                    [1, 22], {5: False}),
    "LaSOTDepth": (write_lasot_depth, rgb_datasets.LaSOTDepth, jax_rgb.LaSOTDepth, [0, 4, 9],
                   {4: False, 5: False, 6: True}),
    "COCOSeqDepth": (lambda root: write_coco(root, depth=True), rgb_datasets.COCOSeqDepth,
                     jax_rgb.COCOSeqDepth, [0], {}),
    "ImageNetVID": (write_imagenetvid, rgb_datasets.ImageNetVID, jax_rgb.ImageNetVID,
                    [0, 2, 5, 23], {2: False, 3: True}),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_match_jax(tmp_path, coco_api, name):
    write, ours_cls, theirs_cls, ids, expect = READERS[name]
    root = str(tmp_path / name)
    write(root)
    ours = ours_cls(root)
    if name == "ImageNetVID":           # the port enumerates the tracks itself
        os.unlink(os.path.join(root, ".mmtrack_vid_tracks.json"))
    theirs = theirs_cls(root)
    assert ours.num_sequences() == theirs.num_sequences() > 0
    assert ours.is_video == theirs.is_video == (name not in ("COCOSeq", "COCOSeqDepth"))
    for seq in range(ours.num_sequences()):
        a, b = ours.seq_info(seq), theirs.seq_info(seq)
        for k in ("bbox", "valid", "visible"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} seq {seq} {k}")
            assert a[k].dtype == b[k].dtype, (name, k)
        fa, ba = ours.get_frames(seq, ids)
        fb, bb = theirs.get_frames(seq, ids)
        np.testing.assert_array_equal(ba, bb)
        assert ba.dtype == bb.dtype == np.float32
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape
            np.testing.assert_array_equal(x, y, err_msg=f"{name} seq {seq}")
    visible = ours.seq_info(0)["visible"]
    for t, v in expect.items():
        assert bool(visible[t]) == v, (name, t)


def test_visevent_event_frames_follow_the_vis_names(tmp_path):
    write_visevent(str(tmp_path))
    ds = datasets.VisEventTrain(str(tmp_path))
    frames, _ = ds.get_frames(0, [0])
    # vis frame0001 pairs with event frame0001, not with the listing's first
    event = cv2.cvtColor(cv2.imread(str(tmp_path / "seq0" / "event_imgs" / "frame0001.bmp")),
                         cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(frames[0][..., 3:], event)


def test_imagenetvid_reads_the_track_cache(tmp_path):
    write_imagenetvid(str(tmp_path))
    first = rgb_datasets.ImageNetVID(str(tmp_path))
    with open(tmp_path / ".mmtrack_vid_tracks.json") as f:
        assert json.load(f) == {"a/seq0": ["0", "1"]}
    again = rgb_datasets.ImageNetVID(str(tmp_path))
    assert again._seqs == first._seqs and again.num_sequences() == 2
    np.testing.assert_array_equal(again.seq_info(1)["visible"], np.arange(N) >= 5)


def test_registry_matches_jax():
    ours = {**datasets.TRAIN_DATASET_REGISTRY, **datasets._rgb_registry()}
    theirs = {**jax_datasets.TRAIN_DATASET_REGISTRY, **jax_datasets._rgb_registry()}
    assert sorted(ours) == sorted(theirs)
    for n in ours:
        assert ours[n].__name__ == theirs[n].__name__, n
    for fn in (datasets.names2datasets, jax_datasets.names2datasets):
        with pytest.raises(KeyError, match="NOPE"):
            fn(["NOPE"], {})
    syn = datasets.names2datasets(["Synthetic"], {})[0]
    assert isinstance(syn, datasets.SyntheticVideoDataset) and syn.num_sequences() == 4


def test_dataset_root_keys_follow_jax(tmp_path):
    """The root key is the name's first word + '_dir' in both packages.
    The training names of the six experiments and of the RGB mix find
    their keys among the defaults; COCO17 (coco17_dir), IMAGENETVID
    (imagenetvid_dir) and Synthetic do not: the defaults list coco_dir
    and imagenet_dir. A local.yaml that adds the keys works in both."""
    import yaml

    from mmtrack_torch.utils.env import _DATASET_KEYS, load_env_settings
    from mmtrack_tpu.utils.env import load_env_settings as jax_load

    names = sorted({**jax_datasets.TRAIN_DATASET_REGISTRY, **jax_datasets._rgb_registry()})
    unlisted = [n for n in names if n.lower().split("_")[0] + "_dir" not in _DATASET_KEYS]
    assert unlisted == ["COCO17", "COCO17_Depth", "IMAGENETVID", "Synthetic"]
    path = str(tmp_path / "local.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"datasets": {"coco_dir": "/d/coco", "imagenet_dir": "/d/vid",
                                     "lasot_dir": "/d/lasot", "got10k_dir": "/d/got"}}, f)
    ours, theirs = load_env_settings(path), jax_load(path)
    for n in ("LASOT", "GOT10K_vottrain", "GOT10K_Depth"):
        assert ours.dataset_root(n) == theirs.dataset_root(n)
    for n, key in (("COCO17", "coco17_dir"), ("IMAGENETVID", "imagenetvid_dir")):
        with pytest.raises(FileNotFoundError):
            theirs.dataset_root(n)
        with pytest.raises(FileNotFoundError, match=f"datasets.{key} in {path}"):
            ours.dataset_root(n)
    with open(path, "w") as f:
        yaml.safe_dump({"datasets": {"coco17_dir": "/d/coco", "imagenetvid_dir": "/d/vid"}}, f)
    ours, theirs = load_env_settings(path), jax_load(path)
    for n in ("COCO17", "COCO17_Depth", "IMAGENETVID"):
        assert ours.dataset_root(n) == theirs.dataset_root(n) != ""


# corpus -> (writers by dataset name, ratios)
PIPELINES = {
    "depthtrack": ({"DepthTrack_train": write_depthtrack}, [1]),
    "lasher": ({"LasHeR_all": write_lasher}, [1]),
    "visevent": ({"VisEvent_train": write_visevent}, [1]),
    "rgb_mix": ({"LASOT": write_lasot, "GOT10K_vottrain": write_got10k}, [1, 1]),
    "coco": ({"COCO17": write_coco}, [1]),
}


def build_corpus(root: str, corpus: str) -> tuple[list, dict, list]:
    """(names, roots, ratios) of `corpus` written under root."""
    writers, ratios = PIPELINES[corpus]
    roots = {}
    for n, write in writers.items():
        roots[n] = os.path.join(root, n)
        write(roots[n])
    return list(writers), roots, ratios


@pytest.mark.parametrize("corpus", sorted(PIPELINES))
def test_disk_batches_bit_equal_to_jax(tmp_path, coco_api, corpus):
    names, roots, ratios = build_corpus(str(tmp_path), corpus)
    cfg, jcfg = vipt_experiment_config("deep_rgbd"), jax_config("deep_rgbd")
    ours = sampler.TrackingSampler(datasets.names2datasets(names, roots), ratios, 8,
                                   cfg.DATA.MAX_SAMPLE_INTERVAL,
                                   processing=processing.from_config(cfg), seed=7)
    theirs = jax_sampler.TrackingSampler(jax_datasets.names2datasets(names, roots), ratios, 8,
                                         jcfg.DATA.MAX_SAMPLE_INTERVAL,
                                         processing=jax_processing.from_config(jcfg), seed=7)
    got = list(loader.BatchLoader(ours, 4))
    want = [jax_loader.collate([theirs.sample() for _ in range(4)]) for _ in range(2)]
    assert len(got) == 2
    channels = 3 if corpus in ("rgb_mix", "coco") else 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{corpus} {k}")
        assert g["search"].shape == (4, 256, 256, channels)
        assert g["template"].shape == (4, 128, 128, channels)
