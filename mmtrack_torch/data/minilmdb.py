"""Minimal pure-python LMDB: read-only environment access + a tiny writer,
a copy of mmtrack_tpu/data/minilmdb.py.

The reference ships LMDB-backed dataset twins (ViPT/lib/train/dataset/
*_lmdb.py reading through lib/utils/lmdb_utils.py); data/lmdb_backend.py
reads through the C `lmdb` package when it is installed and through this
module when it is not. The on-disk format (LMDB data version 1, the format
every released liblmdb 0.9.x writes) is stable and read-only access needs
no locking, so this module implements it directly:

  - `Env(path).get(key)` — B+tree lookup in the main database, including
    F_BIGDATA values on overflow pages (image blobs are larger than one
    page). Opens `data.mdb` inside a directory path or the file itself
    (subdir=False layout), mmap'd read-only.
  - `write_fixture(path, items)` — writes a spec-conformant single-level
    or two-level tree (meta pages 0/1, leaf pages, overflow chains, one
    branch root when needed) so the backend is testable without the C
    library, and the files remain readable by real liblmdb.

Layout facts used (lmdb.h / mdb.c, stable across 0.9.x):
  page header: pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
  (overflow pages store the page count as u32 at offset 12);
  meta page: header + magic 0xBEEFC0DE, version 1, address u64, mapsize
  u64, two MDB_db (pad u32, flags u16, depth u16, branch/leaf/overflow
  pages u64 x3, entries u64, root u64), last_pg u64, txnid u64 — the
  page size lives in mm_dbs[0].md_pad;
  node: lo u16 | hi u16 | flags u16 | ksize u16 | key [| data];
  leaf data size = lo | hi<<16 (F_BIGDATA=0x01 -> data is overflow pgno
  u64); branch child pgno = lo | hi<<16 | flags<<32; node pointer array
  of u16 offsets sits right after the page header.
"""

from __future__ import annotations

import mmap
import os
import struct

MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF


class Env:
    """Read-only LMDB environment (main database only)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        metas = []
        for pg in (0, 1):
            off = pg * 4096  # meta pages are written before psize matters;
            # real lmdb puts meta 1 at `psize`, so re-read after psize known
            metas.append(self._read_meta(off))
        # page size from meta 0 (mm_dbs[0].md_pad); re-read meta 1 at psize
        psize = metas[0]["psize"] if metas[0] else None
        if psize and psize != 4096:
            metas[1] = self._read_meta(psize)
        valid = [m for m in metas if m]
        if not valid:
            raise ValueError(f"not an LMDB data file: {path}")
        meta = max(valid, key=lambda m: m["txnid"])
        self.psize = meta["psize"]
        self._root = meta["root"]
        self.entries = meta["entries"]
        self.depth = meta["depth"]

    def _read_meta(self, off: int):
        m = self._m
        if off + PAGEHDRSZ + 112 > len(m):
            return None
        flags = struct.unpack_from("<H", m, off + 10)[0]
        if not flags & P_META:
            return None
        magic, version = struct.unpack_from("<II", m, off + PAGEHDRSZ)
        if magic != MAGIC or version != VERSION:
            return None
        base = off + PAGEHDRSZ + 24          # skip magic/version/address/...
        psize = struct.unpack_from("<I", m, base)[0]
        # main db = mm_dbs[1] at base + 48
        depth = struct.unpack_from("<H", m, base + 48 + 6)[0]
        entries, root = struct.unpack_from("<QQ", m, base + 48 + 32)
        txnid = struct.unpack_from("<Q", m, base + 96 + 8)[0]
        return {"psize": psize, "depth": depth, "entries": entries,
                "root": root, "txnid": txnid}

    # ---------------------------------------------------------------- pages

    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _nodes(self, off: int):
        lower = struct.unpack_from("<H", self._m, off + 12)[0]
        n = (lower - PAGEHDRSZ) // 2
        return struct.unpack_from(f"<{n}H", self._m, off + PAGEHDRSZ) \
            if n else ()

    def _node(self, page_off: int, ptr: int):
        off = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._m, off)
        key = self._m[off + 8:off + 8 + ksize]
        return lo, hi, flags, ksize, key, off + 8 + ksize

    # ---------------------------------------------------------------- reads

    def get(self, key: bytes):
        """Value bytes for `key` in the main DB, or None."""
        if isinstance(key, str):
            key = key.encode()
        if self._root == P_INVALID:
            return None
        pgno = self._root
        m = self._m
        while True:
            off = self._page(pgno)
            flags = struct.unpack_from("<H", m, off + 10)[0]
            ptrs = self._nodes(off)
            if flags & P_BRANCH:
                # descend: rightmost child whose key <= target (node 0's
                # key is implicit -inf)
                child = None
                for i, p in enumerate(ptrs):
                    lo, hi, nflags, ksize, nkey, _ = self._node(off, p)
                    if i > 0 and nkey > key:
                        break
                    child = lo | (hi << 16) | (nflags << 32)
                pgno = child
                continue
            if flags & P_LEAF:
                for p in ptrs:
                    lo, hi, nflags, ksize, nkey, doff = self._node(off, p)
                    if nkey == key:
                        dsize = lo | (hi << 16)
                        if nflags & F_BIGDATA:
                            (opg,) = struct.unpack_from("<Q", m, doff)
                            ooff = self._page(opg) + PAGEHDRSZ
                            return bytes(m[ooff:ooff + dsize])
                        return bytes(m[doff:doff + dsize])
                return None
            raise ValueError(f"unexpected page flags {flags:#x} at {pgno}")

    def keys(self):
        """All keys, in order (walks the whole tree)."""
        out = []

        def walk(pgno):
            off = self._page(pgno)
            flags = struct.unpack_from("<H", self._m, off + 10)[0]
            for i, p in enumerate(self._nodes(off)):
                lo, hi, nflags, ksize, nkey, _ = self._node(off, p)
                if flags & P_BRANCH:
                    walk(lo | (hi << 16) | (nflags << 32))
                else:
                    out.append(bytes(nkey))

        if self._root != P_INVALID:
            walk(self._root)
        return out

    def close(self):
        self._m.close()
        self._f.close()


# -------------------------------------------------------------------- writer

def write_fixture(path: str, items: dict, psize: int = 4096) -> str:
    """Write a minimal spec-conformant LMDB data file holding `items`
    ({key bytes/str: value bytes}). Supports one branch level (enough for
    thousands of keys) and overflow values of any size. Returns the file
    path (creates `path/data.mdb` when `path` is a directory or has no
    extension)."""
    enc = {k.encode() if isinstance(k, str) else bytes(k):
           v.encode() if isinstance(v, str) else bytes(v)
           for k, v in items.items()}
    keys = sorted(enc)

    pages: list[bytes] = [b"", b""]  # meta 0/1 filled last

    def add_page(buf: bytes) -> int:
        pages.append(buf)
        return len(pages) - 1

    def page_hdr(pgno, flags, lower, upper):
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    def overflow_chain(data: bytes) -> int:
        npg = (PAGEHDRSZ + len(data) + psize - 1) // psize
        first = len(pages)
        blob = struct.pack("<QHHI", first, 0, P_OVERFLOW, npg) + data
        blob += b"\0" * (npg * psize - len(blob))
        for i in range(npg):
            add_page(blob[i * psize:(i + 1) * psize])
        return first

    # build leaves: fill pages front-to-back, nodes packed from the top
    max_inline = (psize - PAGEHDRSZ) // 2 - 16  # conservative MDB_MAXDATA-ish
    leaves = []          # (first_key, pgno)
    cur: list[tuple] = []  # (key, node_bytes)
    cur_size = 0

    def flush_leaf():
        nonlocal cur, cur_size
        if not cur:
            return
        pgno = len(pages)
        n = len(cur)
        lower = PAGEHDRSZ + 2 * n
        offs = []
        upper = psize
        for _k, nb in reversed(cur):
            upper -= len(nb)
            offs.append(upper)
        offs.reverse()  # offs[i] is cur[i]'s offset; offs[0] is the lowest
        buf = bytearray(psize)
        buf[:PAGEHDRSZ] = page_hdr(pgno, P_LEAF, lower,
                                   offs[0] if offs else psize)
        struct.pack_into(f"<{n}H", buf, PAGEHDRSZ, *offs)
        for (_k, nb), o in zip(cur, offs):
            buf[o:o + len(nb)] = nb
        add_page(bytes(buf))
        leaves.append((cur[0][0], pgno))
        cur, cur_size = [], 0

    n_overflow = 0
    for k in keys:
        v = enc[k]
        if len(v) > max_inline:
            first = overflow_chain(v)
            n_overflow += (PAGEHDRSZ + len(v) + psize - 1) // psize
            node = struct.pack("<HHHH", len(v) & 0xFFFF, len(v) >> 16,
                               F_BIGDATA, len(k)) + k + struct.pack("<Q", first)
        else:
            node = struct.pack("<HHHH", len(v) & 0xFFFF, len(v) >> 16,
                               0, len(k)) + k + v
        if len(node) % 2:
            node += b"\0"
        need = len(node) + 2
        if cur and PAGEHDRSZ + cur_size + need > psize:
            flush_leaf()
        cur.append((k, node))
        cur_size += need
    flush_leaf()

    if not leaves:
        root, depth = P_INVALID, 0
    elif len(leaves) == 1:
        root, depth = leaves[0][1], 1
    else:
        # one branch root: node 0 key empty, others = first key of leaf
        pgno = len(pages)
        nodes = []
        for i, (fk, lpg) in enumerate(leaves):
            kb = b"" if i == 0 else fk
            nb = struct.pack("<HHHH", lpg & 0xFFFF, (lpg >> 16) & 0xFFFF,
                             (lpg >> 32) & 0xFFFF, len(kb)) + kb
            if len(nb) % 2:
                nb += b"\0"
            nodes.append(nb)
        n = len(nodes)
        buf = bytearray(psize)
        offs = []
        upper = psize
        for nb in reversed(nodes):
            upper -= len(nb)
            offs.append(upper)
        offs.reverse()
        buf[:PAGEHDRSZ] = page_hdr(pgno, P_BRANCH, PAGEHDRSZ + 2 * n, offs[0])
        struct.pack_into(f"<{n}H", buf, PAGEHDRSZ, *offs)
        for nb, o in zip(nodes, offs):
            buf[o:o + len(nb)] = nb
        add_page(bytes(buf))
        root, depth = pgno, 2

    # meta pages (mm_dbs[0].md_pad = psize; main db = mm_dbs[1])
    def meta(txnid):
        free_db = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = struct.pack("<IHHQQQQQ", 0, 0, depth, 1 if depth == 2 else 0,
                              len(leaves), n_overflow, len(enc), root)
        body = struct.pack("<IIQQ", MAGIC, VERSION, 0, psize * len(pages)) \
            + free_db + main_db \
            + struct.pack("<QQ", len(pages) - 1, txnid)
        hdr = page_hdr(0 if txnid == 0 else 1, P_META, 0, 0)
        return (hdr + body).ljust(psize, b"\0")

    pages[0] = meta(0)
    pages[1] = meta(1)

    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    with open(path, "wb") as f:
        for p in pages:
            f.write(p)
    return path
