"""Batched target-centred square crop + bilinear resize + normalisation.

Port of mmtrack_tpu/ops/crop.py::crop_resize_normalized (gather semantics,
crop.py:25-83 and :132-167) batched over sequences, with the hand-written
kernel `csrc/crop.cu` in place of the TPU's single-image Pallas kernel
(mmtrack_tpu/ops/pallas_preproc.py::crop_resize_normalize_pallas).

Geometry (sample_target, ViPT processing_utils.py:32-41): crop side
ceil(sqrt(w h) * factor) (at least 1), origin round(centre - side/2) with
half-to-even rounding, cv2's half-pixel source coordinates clipped to
[0, side - 1], four bilinear taps where image row H-1 and column W-1 are
never sampled (constant padding instead), then (x / 255 - mean) / std.

The plain version below performs every step as one correctly rounded f32
operation in the kernel's order. Divisions are tensor-by-tensor on purpose:
PyTorch's CUDA division by a Python scalar multiplies by the reciprocal,
which would round differently from the kernel's `__fdiv_rn`.

The kernel runs one block per four output rows of a sequence. It stages
their source rows in shared memory, cut to the columns the rows can read,
and writes each row through a shared copy of it; `crop_plan` sizes both. The wrapper copies nothing: boxes, mean and
std must already be f32 tensors on the frames' card, so a step can be
captured in a CUDA graph (trackers/vipt_tracker.py::make_track_scan).

Three more crop helpers are plain PyTorch, as the JAX package computes
them outside any kernel: `crop_resize`, the same crop of N boxes per image
without the normalisation (crop.py:25-83; MDNet's training patches),
`crop_att_mask`, STARK's padded-pixel mask for the
crop's geometry (crop.py:217-252), and `crop_at`, the crop of a given
centre and side with a replicate or zero border (crop.py:170-215; SiamFC's
pyramid).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mmtrack_torch.kernels.build import load_library, stream_handle
from mmtrack_torch.utils import profiling

CROP_MAX_THREADS = 256                # csrc/crop.cu: __launch_bounds__(256)
CROP_ROWS = 4                         # csrc/crop.cu: output rows per block (kRows)
CROP_MAX_SMEM = 227 * 1024            # shared memory a block can use on Hopper


class CropPlan(NamedTuple):
    threads: int        # per block: one output pixel each, looping past 256
    row_bytes: int      # staged bytes of one source row at most (a multiple of 16)
    smem_bytes: int     # CROP_ROWS stages of two source rows + the f32 output row (S * C)


def crop_plan(H: int, W: int, C: int, S: int) -> CropPlan:
    """Block shape and shared memory of the crop kernel for (B, H, W, C)
    uint8 frames and S x S crops.

    A staged source row holds the aligned 16-byte chunks of the frame that
    cover the sampled columns a row of crops can read: at most W - 1 of C
    bytes, behind up to 15 bytes of the chunk that holds the first
    (csrc/crop.cu). A block of CROP_ROWS output rows requests all their
    source rows at once. Raises ValueError where one frame holds
    2^31 bytes or more (32-bit indices) or the block would need more shared
    memory than Hopper gives one."""
    if min(H, W, C, S) < 1:
        raise ValueError(f"crop needs positive sizes, got H={H} W={W} C={C} S={S}")
    if H * W * C >= 2 ** 31:
        raise ValueError(f"crop kernel indexes a frame with 32 bits: H*W*C={H * W * C}")
    row_bytes = -(-(15 + (W - 1) * C) // 16) * 16
    smem = 2 * CROP_ROWS * row_bytes + 4 * S * C
    if smem > CROP_MAX_SMEM:
        raise ValueError(f"crop kernel needs {smem} bytes of shared memory for W={W} C={C} "
                         f"S={S}, more than {CROP_MAX_SMEM}")
    return CropPlan(min(CROP_MAX_THREADS, -(-S // 32) * 32), row_bytes, smem)


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, search_area_factor: float,
                out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Square crops of N boxes per image, resized, not normalised: the
    JAX package's `crop_resize` (crop.py:25-83) batched over images and
    boxes, plain PyTorch on any device.

    images (B, H, W, C) any real dtype, boxes (B, N, 4) xywh. Returns
    (crops (B, N, out, out, C) f32, resize_factor (B, N) f32). The factor
    is rounded to f32 first, where JAX rounds a Python float."""
    B, H, W, C = images.shape
    dev = images.device
    f32 = torch.float32
    x, y, w, h = boxes.to(f32).unbind(-1)                          # (B, N)
    crop_sz = torch.ceil(torch.sqrt(w * h) * float(np.float32(search_area_factor)))
    crop_sz = torch.clamp(crop_sz, min=1.0)
    x1 = torch.round(x + 0.5 * w - crop_sz * 0.5)
    y1 = torch.round(y + 0.5 * h - crop_sz * 0.5)
    size = torch.full_like(crop_sz, float(out_size))
    resize_factor = size / crop_sz

    j = torch.arange(out_size, dtype=f32, device=dev) + 0.5
    s = j * (crop_sz / size)[..., None] - 0.5                       # (B, N, S)
    s = torch.minimum(torch.clamp(s, min=0.0), (crop_sz - 1.0)[..., None])
    xs = x1[..., None] + s
    ys = y1[..., None] + s
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None, :, None]                              # (B, N, 1, S, 1)
    fy = (ys - y0)[..., :, None, None]                              # (B, N, S, 1, 1)
    x0 = x0.long()
    y0 = y0.long()
    bidx = torch.arange(B, device=dev)[:, None, None, None]

    def tap(yi, xi):
        valid = (((yi >= 0) & (yi < H - 1))[..., :, None]
                 & ((xi >= 0) & (xi < W - 1))[..., None, :])        # (B, N, S, S)
        v = images[bidx, yi.clamp(0, H - 1)[..., :, None], xi.clamp(0, W - 1)[..., None, :]]
        return torch.where(valid[..., None], v.to(f32), 0.0)

    gy, gx = 1 - fy, 1 - fx
    out = (gy * gx * tap(y0, x0) + gy * fx * tap(y0, x0 + 1)
           + fy * gx * tap(y0 + 1, x0) + fy * fx * tap(y0 + 1, x0 + 1))
    return out, resize_factor


def crop_resize_normalized_plain(frames: torch.Tensor, boxes: torch.Tensor,
                                 search_area_factor: float, out_size: int,
                                 mean: torch.Tensor, std: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `crop_resize_normalized`, any device:
    `crop_resize` of one box per frame, then (x / 255 - mean) / std."""
    C, dev, f32 = frames.shape[-1], frames.device, torch.float32
    out, resize_factor = crop_resize(frames, boxes[:, None], search_area_factor, out_size)
    den = torch.full((C,), 255.0, dtype=f32, device=dev)
    out = (out[:, 0] / den - mean.to(device=dev, dtype=f32)) / std.to(device=dev, dtype=f32)
    return out, resize_factor[:, 0]


def crop_resize_normalized(frames: torch.Tensor, boxes: torch.Tensor,
                           search_area_factor: float, out_size: int,
                           mean: torch.Tensor, std: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop, resize and normalise one box per frame.

    frames (B, H, W, C) uint8, boxes (B, 4) f32 xywh, mean/std (C,) f32.
    Returns (crops (B, out, out, C) f32, resize_factor (B,) f32).

    CPU frames take the plain version. CUDA frames launch the crop kernel,
    which needs boxes, mean and std as contiguous f32 tensors on the same
    card (nothing is copied or converted here), or raise.
    """
    if frames.device.type == "cpu":
        return crop_resize_normalized_plain(frames, boxes, search_area_factor, out_size,
                                            mean, std)
    B, H, W, C = frames.shape
    dev = frames.device
    if frames.dtype != torch.uint8 or not frames.is_contiguous():
        raise TypeError(f"crop kernel needs contiguous uint8 frames, got {frames.dtype}")
    for name, t, shape in (("boxes", boxes, (B, 4)), ("mean", mean, (C,)), ("std", std, (C,))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"crop kernel needs {name} as a contiguous f32 tensor on {dev}, "
                            f"got {t.dtype} on {t.device}")
    plan = crop_plan(H, W, C, out_size)
    out = torch.empty((B, out_size, out_size, C), dtype=torch.float32, device=dev)
    rf = torch.empty((B,), dtype=torch.float32, device=dev)
    load_library().launch(
        "mmt_crop_resize_normalize", frames.data_ptr(), boxes.data_ptr(), mean.data_ptr(),
        std.data_ptr(), out.data_ptr(), rf.data_ptr(), B, H, W, C, out_size,
        float(search_area_factor), plan.threads, plan.row_bytes, plan.smem_bytes,
        stream_handle(dev))
    profiling.count("launches.crop_resize_normalized")
    return out, rf



def div_rn(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as one correctly rounded division per element, tensor by
    tensor: PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal, which the JAX functions ported here do not."""
    return a / torch.full_like(a, float(b))


def crop_at(image: torch.Tensor, center_yx: torch.Tensor, crop_sz, out_size: int,
            border: str = "replicate", origin_yx=None) -> torch.Tensor:
    """Square crop of side `crop_sz` centred at `center_yx` (y, x), resized
    to out_size x out_size with cv2's half-pixel bilinear taps (crop.py:170-215).

    image (H, W, C) any real dtype; center_yx (2,) and crop_sz () f32
    tensors. Without `origin_yx` the side is rounded (at least 2) and the
    top-left is round(centre - side / 2), half to even; with it,
    `origin_yx` (2,) is the exact integer top-left and `crop_sz` the
    integer side. border 'replicate' clamps the taps to the image, 'zero'
    reads 0 outside it. Returns (out_size, out_size, C) f32."""
    H, W = image.shape[0], image.shape[1]
    dev = image.device
    crop_sz = torch.as_tensor(crop_sz, dtype=torch.float32, device=dev)
    if origin_yx is None:
        crop_sz = torch.clamp(torch.round(crop_sz), min=2.0)
        y1 = torch.round(center_yx[0] - 0.5 * crop_sz)
        x1 = torch.round(center_yx[1] - 0.5 * crop_sz)
    else:
        y1, x1 = origin_yx[0], origin_yx[1]
    j = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    s = j * div_rn(crop_sz, out_size) - 0.5
    s = torch.minimum(torch.clamp(s, min=0.0), crop_sz - 1.0)
    ys, xs = y1 + s, x1 + s
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    y0, x0 = y0.long(), x0.long()
    img = image.float()

    def tap(yi, xi):
        v = img[yi.clamp(0, H - 1)][:, xi.clamp(0, W - 1)]
        if border == "replicate":
            return v
        valid = ((yi >= 0) & (yi < H))[:, None, None] & ((xi >= 0) & (xi < W))[None, :, None]
        return torch.where(valid, v, 0.0)

    return ((1 - fy) * (1 - fx) * tap(y0, x0) + (1 - fy) * fx * tap(y0, x0 + 1)
            + fy * (1 - fx) * tap(y0 + 1, x0) + fy * fx * tap(y0 + 1, x0 + 1))


def crop_att_mask(boxes: torch.Tensor, search_area_factor: float, out_size: int,
                  H: int, W: int) -> torch.Tensor:
    """STARK's attention mask for `crop_resize_normalized`'s geometry
    (crop.py:217-252): True where an output pixel's bilinear footprint
    touches the constant padding (sample_target's att_mask, a {0, 1} image
    resized by cv2 and cast to bool). The valid region is a rectangle, so
    the mask is the OR of a row mask and a column mask.

    boxes (B, 4) f32 xywh -> (B, out_size, out_size) bool; every step is
    the JAX function's f32 operation in its order."""
    f32 = torch.float32
    x, y, w, h = boxes.to(f32).unbind(1)                                  # (B,)
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * search_area_factor), min=1.0)
    x1 = torch.round(x + 0.5 * w - crop_sz * 0.5)
    y1 = torch.round(y + 0.5 * h - crop_sz * 0.5)
    x1_pad = torch.clamp(-x1, min=0.0)
    x2_pad = torch.clamp(x1 + crop_sz - W + 1, min=0.0)
    y1_pad = torch.clamp(-y1, min=0.0)
    y2_pad = torch.clamp(y1 + crop_sz - H + 1, min=0.0)

    j = torch.arange(out_size, dtype=f32, device=boxes.device) + 0.5
    s = j[None, :] * div_rn(crop_sz, out_size)[:, None] - 0.5               # (B, S)
    lo = torch.floor(s)
    frac = s - lo
    top = (crop_sz - 1.0)[:, None]
    t0 = torch.minimum(torch.clamp(lo, min=0.0), top)
    t1 = torch.minimum(torch.clamp(lo + 1.0, min=0.0), top)

    def axis_mask(p1, p2):
        p1, p2 = p1[:, None], p2[:, None]

        def padded(t):
            return (t < p1) | (t >= crop_sz[:, None] - p2)
        return (((1.0 - frac) > 0) & padded(t0)) | ((frac > 0) & padded(t1))

    my = axis_mask(y1_pad, y2_pad)
    mx = axis_mask(x1_pad, x2_pad)
    return my[:, :, None] | mx[:, None, :]
