"""The port's LMDB twins against the JAX package's.

Each package's pure-python reader (data/minilmdb.py) reads the fixture
file the other package's writer makes, byte for byte: small values, empty
values, values on overflow pages and a two-level tree (a branch root over
several leaves). The backend (data/lmdb_backend.py) decodes the same
images and text as JAX's, and a corpus wrapped by wrap_dataset_with_lmdb
gives frames equal to its directory twin read by the decoder the backend
uses (cv2). Tolerances: none.
"""

import os

import cv2
import numpy as np
import pytest

from mmtrack_tpu.data import lmdb_backend as jax_backend
from mmtrack_tpu.data import minilmdb as jax_minilmdb
from mmtrack_tpu.data import rgb_datasets as jax_rgb
from mmtrack_torch.data import lmdb_backend, minilmdb, rgb_datasets
from mmtrack_torch.data.image_loader import opencv_loader
from test_torch_train_data import write_got10k, write_lasot

PACKAGES = {"port": minilmdb, "jax": jax_minilmdb}


def _items(n_small: int) -> dict:
    rng = np.random.RandomState(0)
    items = {"small": b"hello", "empty": b"", "anno/groundtruth.txt": "10,20,30,40\n11,21,31,41\n",
             "big": rng.bytes(3 * 4096 + 123), "big2": rng.bytes(10000)}
    for i in range(n_small):
        items[f"k{i:04d}"] = (f"value-{i}" * 3).encode()
    return items


@pytest.mark.parametrize("n_small,depth", [(0, 1), (300, 2)], ids=["one_leaf", "two_levels"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_each_reader_reads_the_other_writer(tmp_path, writer, reader, n_small, depth):
    items = _items(n_small)
    path = PACKAGES[writer].write_fixture(str(tmp_path / "corpus"), items)
    other = PACKAGES["jax" if writer == "port" else "port"].write_fixture(
        str(tmp_path / "twin"), items)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()          # the writers are copies
    env = PACKAGES[reader].Env(path)
    assert env.depth == depth and env.entries == len(items)
    for k, v in items.items():
        assert env.get(k) == (v.encode() if isinstance(v, str) else v), k
    assert env.get("missing") is None
    assert env.keys() == sorted(k.encode() for k in items)
    env.close()


def test_backend_decodes_as_jax(tmp_path):
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([yy * 5, xx * 3, (yy + xx) * 2], -1).astype(np.uint8)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    png = cv2.imencode(".png", img)[1].tobytes()
    minilmdb.write_fixture(str(tmp_path / "c"), {"seq/img/1.jpg": jpg, "seq/img/2.png": png,
                                                 "seq/gt.txt": "1,2,3,4\n5,6,7,8\n"})
    ours = lmdb_backend.LmdbBackend(str(tmp_path / "c"))
    theirs = jax_backend.LmdbBackend(str(tmp_path / "c"))
    assert ours.reader == "minilmdb"        # no C lmdb package here
    for key in ("seq/img/1.jpg", "seq/img/2.png"):
        np.testing.assert_array_equal(ours.decode_image(key), theirs.decode_image(key))
    np.testing.assert_array_equal(ours.decode_image("seq/img/2.png"), img[..., ::-1])
    np.testing.assert_array_equal(ours.loadtxt("seq/gt.txt"), theirs.loadtxt("seq/gt.txt"))
    assert ours.decode_text("seq/gt.txt") == "1,2,3,4\n5,6,7,8\n"
    with pytest.raises(KeyError, match="nope"):
        ours.read_bytes("nope")


def _lmdb_of(root: str, path: str) -> None:
    """Every image file under root, by its root-relative key."""
    items = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".jpg"):
                full = os.path.join(d, f)
                with open(full, "rb") as fh:
                    items[os.path.relpath(full, root)] = fh.read()
    minilmdb.write_fixture(path, items)


@pytest.mark.parametrize("name,write,ours_cls,theirs_cls", [
    ("LaSOT", write_lasot, rgb_datasets.LaSOT, jax_rgb.LaSOT),
    ("GOT10k", write_got10k, rgb_datasets.GOT10k, jax_rgb.GOT10k)], ids=["LaSOT", "GOT10k"])
def test_wrapped_dataset_equals_its_directory_twin(tmp_path, name, write, ours_cls, theirs_cls):
    root = str(tmp_path / name)
    write(root)
    db = str(tmp_path / f"{name}_lmdb")
    _lmdb_of(root, db)
    wrapped = lmdb_backend.wrap_dataset_with_lmdb(ours_cls, db, root)
    jax_wrapped = jax_backend.wrap_dataset_with_lmdb(theirs_cls, db, root)
    twin = ours_cls(root, image_loader=opencv_loader)
    assert wrapped.num_sequences() == twin.num_sequences() == 2
    for seq in range(2):
        np.testing.assert_array_equal(wrapped.seq_info(seq)["visible"],
                                      twin.seq_info(seq)["visible"])
        ids = [0, 5, 23]
        frames, boxes = wrapped.get_frames(seq, ids)
        want, want_boxes = twin.get_frames(seq, ids)
        jax_frames, _ = jax_wrapped.get_frames(seq, ids)
        np.testing.assert_array_equal(boxes, want_boxes)
        for a, b, c in zip(frames, want, jax_frames):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
