"""TensorBoard event-file writer, dependency-free; a copy of
mmtrack_tpu/utils/tb.py, its files held byte-equal to the JAX
module's by tests/test_torch_host_tools.py (importing the JAX module runs
mmtrack_tpu/utils/__init__.py, which imports jax).

Rebuild of ViPT/lib/train/admin/tensorboard.py:10-27 (TensorboardWriter:
one SummaryWriter per loader, write_epoch pushes each stat's latest
history value as a scalar) without torch.utils.tensorboard, whose
protobuf dependency neither machine is asked to have. The tfevents format
is written directly:

  - TFRecord framing: u64-LE length, masked crc32c(length), payload,
    masked crc32c(payload) - mask(crc) = ((crc >> 15) | (crc << 17)) +
    0xa282ead8 (TensorFlow's record_writer mask);
  - payload = an `Event` protobuf, hand-encoded: wall_time (field 1,
    double), step (field 2, int64), file_version (field 3, string, first
    record "brain.Event:2"), summary (field 5) holding Summary.Value
    {tag (1, string), simple_value (2, float)}.

Any TensorBoard build reads the result (`tensorboard --logdir <dir>`);
`read_scalars` parses the files back. The port's Trainer takes a
TensorboardWriter as `tb_writer` (train/trainer.py).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from collections import OrderedDict

# -- crc32c (Castagnoli, reflected poly 0x82F63B78) ----------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding --------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    if v < 0:  # int64 negatives are 10-byte two's-complement varints
        v += 1 << 64
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, pairs) -> bytes:
    summary = b"".join(
        _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_float(2, float(val)))
        for tag, val in pairs)
    return _pb_double(1, wall_time) + _pb_int(2, step) + _pb_bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


class EventWriter:
    """One events.out.tfevents.* file (SummaryWriter's file layer)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_scalar_event(time.time(), step, [(tag, value)]))

    def add_scalars(self, pairs, step: int) -> None:
        """One event carrying several Summary.Values (fewer records)."""
        self._write_record(_scalar_event(time.time(), step, list(pairs)))

    def close(self) -> None:
        self._f.close()


class TensorboardWriter:
    """Reference API (tensorboard.py:10-27): per-loader subdirectories,
    write_epoch pushes each stat's latest history value at `epoch`."""

    def __init__(self, directory: str, loader_names):
        self.directory = directory
        self.writer = OrderedDict(
            (name, EventWriter(os.path.join(directory, name)))
            for name in loader_names)

    def write_epoch(self, stats: OrderedDict, epoch: int, ind: int = -1) -> None:
        for loader_name, loader_stats in stats.items():
            if loader_stats is None or loader_name not in self.writer:
                continue
            pairs = []
            for var_name, val in loader_stats.items():
                history = getattr(val, "history", None)
                if history and getattr(val, "has_new_data", True):
                    pairs.append((var_name, history[ind]))
                elif isinstance(val, (int, float)):
                    pairs.append((var_name, val))
            if pairs:
                self.writer[loader_name].add_scalars(pairs, epoch)

    def close(self) -> None:
        for w in self.writer.values():
            w.close()


# -- reader (tests / offline analysis) -----------------------------------

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def read_scalars(path: str) -> list[tuple[int, str, float]]:
    """Parse one tfevents file -> [(step, tag, value)], verifying CRCs."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        if hcrc != _masked_crc(header):
            raise ValueError("header crc mismatch")
        payload = data[i + 12:i + 12 + length]
        (pcrc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError("payload crc mismatch")
        i += 16 + length

        step, values = 0, []
        for field, wire, v in _parse_fields(payload):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:
                for f1, w1, sv in _parse_fields(v):
                    if f1 == 1 and w1 == 2:
                        tag, val = None, None
                        for f2, w2, vv in _parse_fields(sv):
                            if f2 == 1 and w2 == 2:
                                tag = vv.decode()
                            elif f2 == 2 and w2 == 5:
                                (val,) = struct.unpack("<f", vv)
                        if tag is not None and val is not None:
                            values.append((tag, val))
        out.extend((step, t, v) for t, v in values)
    return out
