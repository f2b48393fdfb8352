"""DiMP's first-frame augmentations as one batch, port of
mmtrack_tpu/ops/augment.py.

The 2x-expanded init crop becomes a fixed (N, S, S, C) batch: the
identity, 4 relative shifts (+-0.6), the horizontal flip, 3 anisotropic
Gaussian blurs and 4 rotations (DeT_DiMP50_Max's set), each taken as an
S x S window of the expanded patch whose content moves by its shift.

The random shifts come from caller-given uniforms (n_rand, 2), on the
host: ((u - 0.5) * S * factor) in f32, truncated toward 0 as JAX's
astype(int32) does, so the windows are host slices. A window's start is
taken as `lax.dynamic_slice` takes it: a negative start counts from the
patch's end, then the start is clamped so the window fits (a shift past
S / 2, which the default factor 1/3 never draws). The blur is a
separable depthwise convolution with zero SAME padding. A rotation is one
bilinear gather over the window with JAX's map_coordinates(order=1,
mode='nearest') semantics: each tap's index is clamped to the patch while
its weight comes from the unclamped coordinate, and the four taps sum in
JAX's order. `feature_dropout` keeps a channel where its uniform is below
1 - prob (jax.random.bernoulli is `uniform < p`) and scales it by the f32
reciprocal of 1 - prob, as the jitted JAX init divides by that constant.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


RELATIVE_SHIFTS = ((0.6, 0.6), (-0.6, 0.6), (0.6, -0.6), (-0.6, -0.6))
BLUR_SIGMAS = ((3.0, 1.0), (1.0, 3.0), (2.0, 2.0))
ROTATE_ANGLES = (10.0, -10.0, 45.0, -45.0)


def num_image_augmentations(fliplr: bool = True, relative_shifts=RELATIVE_SHIFTS,
                            blur_sigmas=BLUR_SIGMAS, rotate_angles=ROTATE_ANGLES) -> int:
    return 1 + len(relative_shifts) + int(fliplr) + len(blur_sigmas) + len(rotate_angles)


def num_random_shifts(fliplr: bool = True, blur_sigmas=BLUR_SIGMAS,
                      rotate_angles=ROTATE_ANGLES) -> int:
    """Rows of uniforms `dimp_init_augmentations` takes: one per flip, blur
    and rotation."""
    return int(fliplr) + len(blur_sigmas) + len(rotate_angles)


def _slice_start(start: int, size: int, out_sz: int) -> int:
    """lax.dynamic_slice's start: a negative one counts from the end, then
    it is clamped so the window fits."""
    if start < 0:
        start += size
    return min(max(start, 0), size - out_sz)


def _window(expanded: torch.Tensor, out_sz: int, shift_yx) -> torch.Tensor:
    """The centred out_sz window of the expanded (E, E, C) patch, content
    moved by +shift (host ints), its start as dynamic_slice takes it."""
    base = out_sz // 2
    y0 = _slice_start(base - int(shift_yx[0]), expanded.shape[0], out_sz)
    x0 = _slice_start(base - int(shift_yx[1]), expanded.shape[1], out_sz)
    return expanded[y0:y0 + out_sz, x0:x0 + out_sz]


def _gauss_kernel(sigma: float, device) -> torch.Tensor:
    fs = math.ceil(2 * sigma)
    x = torch.arange(-fs, fs + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _blur(expanded: torch.Tensor, sigma_yx) -> torch.Tensor:
    """Separable Gaussian blur of (E, E, C), zero SAME padding."""
    C = expanded.shape[-1]
    x = expanded.permute(2, 0, 1)[None]
    for axis, sigma in enumerate(sigma_yx):
        k = _gauss_kernel(float(sigma), expanded.device)
        kern = k.reshape(1, 1, -1, 1) if axis == 0 else k.reshape(1, 1, 1, -1)
        pad = (k.shape[0] // 2, 0) if axis == 0 else (0, k.shape[0] // 2)
        x = F.conv2d(x, kern.expand(C, 1, -1, -1), padding=pad, groups=C)
    return x[0].permute(1, 2, 0)


def _rotated_window(expanded: torch.Tensor, out_sz: int, angle_deg: float,
                    shift_yx) -> torch.Tensor:
    """Rotate the expanded patch about its centre (replicate border) and
    take the shifted window, as one bilinear gather over the window. The
    map dst -> src is R^T of the reference's forward rotation, which
    cv2.warpAffine inverts."""
    E, W = expanded.shape[0], expanded.shape[1]
    base = out_sz // 2
    c = (E - 1) / 2.0
    theta = math.radians(angle_deg)
    cos, sin = math.cos(theta), math.sin(theta)
    i = torch.arange(out_sz, dtype=torch.float32, device=expanded.device)
    py = ((base - int(shift_yx[0])) + i[:, None]) - c
    px = ((base - int(shift_yx[1])) + i[None, :]) - c
    sy = sin * px + cos * py + c
    sx = cos * px - sin * py + c

    def taps(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.long()
        return ((index.clamp(0, size - 1), 1 - upper_w),
                ((index + 1).clamp(0, size - 1), upper_w))

    out = None
    for yi, wy in taps(sy, E):
        for xi, wx in taps(sx, W):
            term = (wy * wx)[..., None] * expanded[yi, xi]
            out = term if out is None else out + term
    return out


def dimp_init_augmentations(expanded: torch.Tensor, out_sz: int, uniforms=None,
                            random_shift_factor: float = 1.0 / 3.0,
                            relative_shifts=RELATIVE_SHIFTS, blur_sigmas=BLUR_SIGMAS,
                            rotate_angles=ROTATE_ANGLES, fliplr: bool = True):
    """expanded (2 out_sz, 2 out_sz, C) f32 -> (patches (N, out_sz, out_sz, C),
    shifts (N, 2) f32 (y, x) content shifts for the target boxes).
    `uniforms` (num_random_shifts(), 2) in [0, 1), read on the host; None
    or a zero factor gives no random shifts."""
    n_rand = num_random_shifts(fliplr, blur_sigmas, rotate_angles)
    if random_shift_factor > 0 and n_rand:
        u = torch.as_tensor(uniforms, dtype=torch.float32).cpu().reshape(n_rand, 2)
        rand_shifts = ((u - 0.5) * out_sz * random_shift_factor).to(torch.int32).tolist()
    else:
        rand_shifts = [[0, 0]] * n_rand
    r = iter(rand_shifts)
    patches, shifts = [], []

    def add(patch, shift):
        patches.append(patch)
        shifts.append([float(shift[0]), float(shift[1])])

    add(_window(expanded, out_sz, (0, 0)), (0, 0))
    for rel in relative_shifts:
        t = (int(rel[0] * out_sz / 2), int(rel[1] * out_sz / 2))
        add(_window(expanded, out_sz, t), t)
    if fliplr:
        s = next(r)
        add(_window(torch.flip(expanded, dims=(1,)), out_sz, s), s)
    for sigma in blur_sigmas:
        s = next(r)
        add(_window(_blur(expanded, sigma), out_sz, s), s)
    for angle in rotate_angles:
        s = next(r)
        add(_rotated_window(expanded, out_sz, angle, s), s)
    return (torch.stack(patches),
            torch.tensor(shifts, dtype=torch.float32, device=expanded.device))


def feature_dropout(feat: torch.Tensor, uniforms: torch.Tensor, prob: float) -> torch.Tensor:
    """Channel-dropout copies of one feature map (S, S, C): `uniforms`
    (num, 1, 1, C); a channel survives where its uniform < 1 - prob, scaled
    by 1 / (1 - prob). Returns (num, S, S, C)."""
    keep = (uniforms.to(feat.device) < 1.0 - prob).to(feat.dtype)
    return feat[None] * keep * float(np.float32(1.0) / np.float32(1.0 - prob))
