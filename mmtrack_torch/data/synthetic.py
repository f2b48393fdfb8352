"""Synthetic multi-modal sequences for training without datasets, port of
mmtrack_tpu/data/synthetic.py::make_synthetic_sequence (:14-121) with its
`distractor` option (not its delayed start nor the distractor's own
boxes): the same seed gives the same frames and boxes bit for bit."""

from __future__ import annotations

import numpy as np


def make_synthetic_sequence(n_frames: int = 20, height: int = 240, width: int = 320,
                            box0=(120.0, 90.0, 48.0, 36.0), velocity=(3.0, 2.0),
                            seed: int = 0, channels: int = 6,
                            target_rgb: float | None = 220,
                            target_aux: float | None = 180,
                            distractor: bool = False):
    """A bright textured square moving over a textured background, bouncing
    off the frame edges.

    Returns (frames (N, H, W, C) uint8, gt_boxes (N, 4) float64 xywh).
    `target_rgb=None` / `target_aux=None` leaves the target undrawn in that
    modality triplet (the aux-only form is the ViPT new-modality setting).
    The texture is drawn over the whole box every frame, so the random
    stream does not depend on the modality options. `distractor=True`
    adds a second square of the same size and look on the mirrored path
    (start reflected through the frame's centre, velocity negated),
    drawn first from its own generator, so the two cross mid-sequence;
    the boxes stay the target's.
    """
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 80, (height, width, channels), np.uint8)
    frames = np.empty((n_frames, height, width, channels), np.uint8)
    gt = np.empty((n_frames, 4), np.float64)

    x, y, w, h = box0
    vx, vy = velocity
    if distractor:
        drng = np.random.RandomState(seed + 7777)
        dx, dy, dvx, dvy = width - x - w, height - y - h, -vx, -vy

    def draw(f, bx, by, tex_rng):
        xi, yi = int(round(bx)), int(round(by))
        x2, y2 = min(xi + int(w), width), min(yi + int(h), height)
        xi, yi = max(xi, 0), max(yi, 0)
        if target_rgb is not None:
            f[yi:y2, xi:x2, :3] = target_rgb
        if target_aux is not None:
            f[yi:y2, xi:x2, 3:] = target_aux
        tex = tex_rng.randint(-20, 20, f[yi:y2, xi:x2].shape)
        if target_rgb is None:
            tex[..., :3] = 0
        if target_aux is None:
            tex[..., 3:] = 0
        f[yi:y2, xi:x2] = np.clip(
            f[yi:y2, xi:x2].astype(np.int16) + tex, 0, 255).astype(np.uint8)

    for t in range(n_frames):
        f = bg.copy()
        if distractor:
            draw(f, dx, dy, drng)
            dx += dvx
            dy += dvy
            if not (0 <= dx <= width - w):
                dvx = -dvx
            if not (0 <= dy <= height - h):
                dvy = -dvy
        draw(f, x, y, rng)
        frames[t] = f
        gt[t] = (x, y, w, h)
        x += vx
        y += vy
        if not (0 <= x <= width - w):
            vx = -vx
        if not (0 <= y <= height - h):
            vy = -vy
    return frames, gt
