"""VOT toolkit integration: a TraX protocol server, dependency-free, and the
VOT entry loop. A copy of mmtrack_tpu/eval/vot.py with the port's
composition and trackers.

TraX text protocol (v3, stdin/stdout transport): hello -> initialize
(region + images) -> frame/state loop -> quit. The VOT class exposes the
reference's region()/frame()/report() API (ViPT lib/test/vot/vot.py:22-110);
`run_vot_exp` is the entry loop (vipt_class.py:50-114). The entry itself
is `python -m mmtrack_torch.eval.vot_entry`.
"""

from __future__ import annotations

import re
import shlex
import sys
import time
from collections import namedtuple

import numpy as np

from mmtrack_torch.data.composition import get_x_frame

Rectangle = namedtuple("Rectangle", ["x", "y", "width", "height"])
Point = namedtuple("Point", ["x", "y"])
Polygon = namedtuple("Polygon", ["points"])
Mask = namedtuple("Mask", ["x", "y", "mask"])  # offset + binary (h, w) array


def _rle_encode(flat) -> list[int]:
    """Run lengths of a flat binary array, starting with the zero run
    (TraX mask payload convention, VOT2020+). Vectorized — this runs once
    per reported frame, and a per-pixel Python loop over a 640x480 mask
    costs tens of milliseconds on the serving host."""
    a = (np.asarray(flat).reshape(-1) != 0).astype(np.int8)
    if a.size == 0:
        return [0]
    edges = np.flatnonzero(np.diff(a)) + 1
    bounds = np.concatenate(([0], edges, [a.size]))
    runs = np.diff(bounds).tolist()
    if a[0] != 0:  # convention: the zero run comes first
        runs = [0] + runs
    return runs


def _rle_decode(runs, n: int):
    out = np.zeros(n, np.uint8)
    pos, val = 0, 0
    for r in runs:
        if val:
            out[pos:pos + r] = 1
        pos += r
        val ^= 1
    return out


def _encode_region(region) -> str:
    if isinstance(region, Polygon):
        return ",".join(f"{p.x:.4f},{p.y:.4f}" for p in region.points)
    if isinstance(region, Mask):
        h, w = region.mask.shape
        runs = _rle_encode(region.mask.reshape(-1))
        return "m" + ",".join(
            str(v) for v in [int(region.x), int(region.y), w, h] + runs)
    return f"{region.x:.4f},{region.y:.4f},{region.width:.4f},{region.height:.4f}"


def _decode_region(s: str):
    if s.startswith("m"):
        vals = [int(float(v)) for v in s[1:].split(",")]
        x, y, w, h = vals[:4]
        mask = _rle_decode(vals[4:], h * w).reshape(h, w)
        return Mask(x, y, np.asarray(mask))
    vals = [float(v) for v in s.split(",")]
    if len(vals) == 4:
        return Rectangle(*vals)
    pts = [Point(vals[i], vals[i + 1]) for i in range(0, len(vals), 2)]
    return Polygon(pts)


def rect_from_mask(m: Mask) -> Rectangle:
    """Axis-aligned bounds of a mask region (vot20_utils.rect_from_mask)."""
    ys, xs = np.nonzero(m.mask)
    if len(xs) == 0:
        return Rectangle(float(m.x), float(m.y), 1.0, 1.0)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return Rectangle(float(m.x + x0), float(m.y + y0),
                     float(x1 - x0 + 1), float(y1 - y0 + 1))


def _strip_uri(token: str) -> str:
    for prefix in ("file://", "file:"):
        if token.startswith(prefix):
            return token[len(prefix):]
    return token


class TraxServer:
    """Minimal TraX v3 server over stdio (one message per line)."""

    def __init__(self, name: str = "mmtrack_torch", region_format: str = "rectangle",
                 channels=("color",), fin=None, fout=None):
        self._fin = fin or sys.stdin
        self._fout = fout or sys.stdout
        self.channels = tuple(channels)
        self._send(
            "hello",
            [],
            {
                "trax.version": "3",
                "trax.name": name,
                "trax.region": region_format,
                "trax.image": "path;url",
                "trax.channels": ";".join(self.channels),
            },
        )

    def _send(self, mtype: str, args: list[str], props: dict | None = None) -> None:
        parts = [f"@@TRAX:{mtype}"]
        parts += ['"%s"' % a.replace('"', '\\"') for a in args]
        for k, v in (props or {}).items():
            parts.append(f"{k}={v}")
        self._fout.write(" ".join(parts) + "\n")
        self._fout.flush()

    def _recv(self):
        while True:
            line = self._fin.readline()
            if not line:
                return None, [], {}
            line = line.strip()
            if not line.startswith("@@TRAX:"):
                continue
            tokens = shlex.split(line)
            mtype = tokens[0][len("@@TRAX:"):]
            args, props = [], {}
            for tok in tokens[1:]:
                # a property token is key=value with a plain identifier
                # key — a URL/query-string image path ("http://h/f.jpg?id=3")
                # also contains '=' but its pre-'=' part has '/' or ':'
                k, sep, v = tok.partition("=")
                if sep and re.fullmatch(r"[A-Za-z0-9_.\-]+", k):
                    props[k] = v
                else:
                    args.append(tok)
            return mtype, args, props

    def wait_initialize(self):
        """-> (region, {channel: path}) or (None, None) on quit. The
        toolkit BLOCKS on a state reply to the initialize request before
        sending frame 1 (reference vot.py:55 self._trax.status(region)) —
        echo the init region back."""
        mtype, args, props = self._recv()
        if mtype != "initialize":
            return None, None
        paths = {c: _strip_uri(a) for c, a in zip(self.channels, args[:-1])}
        region = _decode_region(args[-1])
        self._send("state", [_encode_region(region)], {})
        return region, paths

    def wait_frame(self):
        """-> {channel: path} or None on quit."""
        mtype, args, props = self._recv()
        if mtype != "frame":
            return None
        return {c: _strip_uri(a) for c, a in zip(self.channels, args)}

    def report_state(self, region, confidence: float | None = None) -> None:
        props = {} if confidence is None else {"confidence": f"{confidence:.6f}"}
        self._send("state", [_encode_region(region)], props)


class VOT:
    """Reference-compatible facade (ViPT/lib/test/vot/vot.py API)."""

    def __init__(self, region_format: str = "rectangle", channels=None,
                 fin=None, fout=None):
        if channels is None:
            channels = ("color",)
        elif channels == "rgbd":
            channels = ("color", "depth")
        elif channels == "rgbt":
            channels = ("color", "ir")
        self._server = TraxServer(region_format=region_format,
                                  channels=channels, fin=fin, fout=fout)
        self._region, self._paths = self._server.wait_initialize()

    def region(self):
        return self._region

    def frame(self):
        """First call returns the init frame paths; then next frames.
        Single-channel setups get a bare path string (the reference API
        unwraps 1-element lists, vot.py:100-102 — ported entries do
        cv2.imread(handle.frame()) directly)."""
        if self._paths is not None:
            paths, self._paths = self._paths, None
            vals = list(paths.values())
        else:
            nxt = self._server.wait_frame()
            if nxt is None:
                return None
            vals = list(nxt.values())
        return vals[0] if len(vals) == 1 else vals

    def report(self, region, confidence: float | None = None) -> None:
        self._server.report_state(region, confidence)


def run_vot_exp(tracker_factory, channels: str, dtype: str = "rgbcolormap",
                fin=None, fout=None, mask: bool = False,
                refine_factory=None, timings: dict | None = None) -> None:
    """VOT entry loop (run_vot_exp analog, vipt_class.py:50-114):
    tracker_factory() -> object with initialize(image, info)/track(image).

    With mask=True the entry speaks the VOT2020+ mask protocol: the init
    region may arrive as a mask (bounding rect seeds the tracker,
    vot20_utils.rect_from_mask) and every state is reported as a
    segmentation mask. Trackers that natively predict masks
    (tracker.predicts_segmentation_mask, the reference's lwl.py:19-20
    flag) report their own mask and receive the init mask verbatim;
    others go through the Alpha-Refine plug-in (refine_factory() ->
    models/alpha_refine.py::ARcmSeg; MIXFORMER_ALPHA_SEG pattern,
    promix_vot2022_rgbd.py:24-60). The plug-in gets the composed frame's
    uint8 colour channels: the JAX loop casts them to f32 first, which
    holds the same integers, so the crop is the same.

    `timings`, when given, accumulates the seconds of each tracked frame's
    parts under 'read_compose', 'track', 'refine' and 'encode' (the
    tracker and the plug-in return host arrays, so their calls end when
    the device work does) and counts the frames under 'frames'.
    """
    clock = dict.fromkeys(("read_compose", "track", "refine", "encode", "frames"), 0.0)
    handle = VOT("mask" if mask else "rectangle", channels=channels,
                 fin=fin, fout=fout)
    region = handle.region()
    paths = handle.frame()
    if paths is None:
        return
    if isinstance(paths, str):  # single channel -> bare path (VOT API)
        paths = [paths]
    depth_clip = channels == "rgbd"
    image = get_x_frame(paths[0], paths[1] if len(paths) > 1 else None,
                        dtype, depth_clip=depth_clip)
    if isinstance(region, Mask):
        rect = rect_from_mask(region)
    else:
        rect = region
    init_box = [rect.x, rect.y, rect.width, rect.height]
    tracker = tracker_factory()
    native_mask = mask and getattr(tracker, "predicts_segmentation_mask",
                                   False)
    info = {"init_bbox": init_box}
    if native_mask and isinstance(region, Mask):
        full = np.zeros(image.shape[:2], np.float32)
        mh, mw = region.mask.shape
        y0, x0 = int(region.y), int(region.x)
        full[y0:y0 + mh, x0:x0 + mw] = region.mask
        info["init_mask"] = full
    tracker.initialize(image, info)
    refiner = None
    if mask and not native_mask:
        refiner = refine_factory()
        refiner.initialize(image[..., :3], init_box)
    while True:
        t0 = time.perf_counter()
        paths = handle.frame()
        if paths is None:
            break
        if isinstance(paths, str):
            paths = [paths]
        image = get_x_frame(paths[0], paths[1] if len(paths) > 1 else None,
                            dtype, depth_clip=depth_clip)
        t1 = time.perf_counter()
        out = tracker.track(image)
        b = out["target_bbox"]
        t2 = time.perf_counter()
        if native_mask:
            binary = np.asarray(out["segmentation"]).astype("uint8")
            region = Mask(0, 0, binary)
        elif refiner is not None:
            _, m = refiner.refine(image[..., :3], b)
            binary = (np.asarray(m) > refiner.rt.mask_threshold).astype("uint8")
            region = Mask(0, 0, binary)
        else:
            region = Rectangle(b[0], b[1], b[2], b[3])
        t3 = time.perf_counter()
        handle.report(region, out.get("best_score", 1.0))
        t4 = time.perf_counter()
        for key, dt in (("read_compose", t1 - t0), ("track", t2 - t1), ("refine", t3 - t2),
                        ("encode", t4 - t3), ("frames", 1)):
            clock[key] += dt
    if timings is not None:
        for key, value in clock.items():
            timings[key] = timings.get(key, 0.0) + value
