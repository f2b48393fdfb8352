"""LMDB-backed dataset storage, a copy of mmtrack_tpu/data/lmdb_backend.py
(the reference's *_lmdb dataset twins and lib/utils/lmdb_utils.py).

Image bytes and annotation text sit under corpus-relative keys in one LMDB
environment per corpus. Reads go through the C `lmdb` package when it is
installed, else through the pure-python reader of data/minilmdb.py;
`LmdbBackend.reader` says which.
"""

from __future__ import annotations

import io

import numpy as np


class LmdbBackend:
    """Key-value reader: read_bytes, decode_image, decode_text, loadtxt."""

    def __init__(self, lmdb_path: str):
        try:
            import lmdb

            env = lmdb.open(lmdb_path, readonly=True, lock=False, readahead=False,
                            meminit=False)
            self._get = lambda k: env.begin(write=False).get(k)
            self.reader = "lmdb"
        except ImportError:
            from mmtrack_torch.data.minilmdb import Env

            env = Env(lmdb_path)
            self._get = env.get
            self.reader = "minilmdb"
        self._env = env

    def read_bytes(self, key: str) -> bytes:
        val = self._get(key.encode())
        if val is None:
            raise KeyError(f"lmdb key not found: {key}")
        return bytes(val)

    def decode_image(self, key: str) -> np.ndarray:
        import cv2

        buf = np.frombuffer(self.read_bytes(key), np.uint8)
        return cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)

    def decode_text(self, key: str) -> str:
        return self.read_bytes(key).decode()

    def loadtxt(self, key: str, delimiter: str = ",") -> np.ndarray:
        return np.loadtxt(io.StringIO(self.decode_text(key)), delimiter=delimiter)


def wrap_dataset_with_lmdb(dataset_cls, lmdb_path: str, *args, **kwargs):
    """A `dataset_cls` whose image loader reads from LMDB (the *_lmdb twin
    pattern): file paths under the corpus root become keys relative to it.
    The annotations are still read from the root."""
    backend = LmdbBackend(lmdb_path)
    root = args[0] if args else kwargs["root"]

    def lmdb_loader(path: str):
        return backend.decode_image(path[len(root):].lstrip("/"))

    kwargs["image_loader"] = lmdb_loader
    return dataset_cls(*args, **kwargs)
