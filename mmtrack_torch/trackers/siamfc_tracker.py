"""SiamFC tracker runtime, port of mmtrack_tpu/trackers/siamfc_tracker.py
(:25-149): the classic OTB protocol of the SiamFC paper.

Context-padded exemplar crop at init; per frame a 3-scale search pyramid
(1.0375^-1, 1, 1.0375), each crop padded with the frame's channel mean
(subtract the mean, crop with a zero border, add it back), embedded and
correlated in one batch; the 17 x 17 responses upsampled 16x with
jax.image.resize's bilinear weights (`resize_bilinear`); the off-centre
scales penalised by 0.9745; the chosen response normalised and blended
with a normalised Hann window (influence 0.176); the peak's displacement
mapped back to the image; the scale damped by 0.59. Every step is plain
PyTorch (the crops are `ops/crop.py::crop_at`), on the tracker's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mmtrack_torch.models.siamfc import SiamFC
from mmtrack_torch.ops.crop import crop_at, div_rn
from mmtrack_torch.ops.window import hann2d
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class SiamFCRuntime:
    exemplar_size: int = 127
    instance_size: int = 255
    context: float = 0.5
    num_scales: int = 3
    scale_step: float = 1.0375
    scale_penalty: float = 0.9745
    scale_lr: float = 0.59
    window_influence: float = 0.176
    response_up: int = 16
    total_stride: int = 8

    @property
    def response_sz(self) -> int:
        return (self.instance_size - self.exemplar_size) // self.total_stride + 1

    @property
    def upsampled_sz(self) -> int:
        return self.response_sz * self.response_up

    @property
    def scale_factors(self) -> tuple[float, ...]:
        half = (self.num_scales - 1) / 2
        return tuple(self.scale_step ** (i - half) for i in range(self.num_scales))


def bilinear_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) interpolation matrix of jax.image.resize's 'bilinear'
    (jax/_src/image/scale.py::compute_weight_mat, no translation): triangle
    weights at half-pixel sample positions, each column normalised by its
    sum, zero for samples outside the input. When upsampling, the edges
    thus repeat the first and last input."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (N, oh, ow), 'bilinear') of x (N, h, w) f32:
    both axes contracted with `bilinear_weights`."""
    wy = bilinear_weights(x.shape[1], out_hw[0], x.device)
    wx = bilinear_weights(x.shape[2], out_hw[1], x.device)
    return torch.einsum("nij,ia,jb->nab", x, wy, wx)


def mean_pad_crop(frame: torch.Tensor, center_yx: torch.Tensor, crop_sz: torch.Tensor,
                  out_size: int, mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A crop of (H, W, C) `frame` padded with its channel mean: the mean
    subtracted, cropped with a zero border (crop_at), the mean added back.
    Returns (out_size, out_size, C) f32 on the 0-255 scale."""
    f = frame.float()
    if mean is None:
        mean = f.mean(dim=(0, 1))
    return crop_at(f - mean, center_yx, crop_sz, out_size, border="zero") + mean


def siamfc_init_state(rt: SiamFCRuntime, model: SiamFC, frame: torch.Tensor,
                      init_box: torch.Tensor) -> dict:
    """State from the first (H, W, C) frame and box (4,) xywh f32: centre
    (y, x), target size (h, w), exemplar and instance sides, and the
    template embedding (6, 6, 256)."""
    x, y, w, h = init_box.unbind(0)
    center = torch.stack([y + h / 2, x + w / 2])
    target_sz = torch.stack([h, w])
    context = rt.context * target_sz.sum()
    z_sz = torch.sqrt(torch.prod(target_sz + context))
    x_sz = div_rn(z_sz * rt.instance_size, rt.exemplar_size)
    patch = mean_pad_crop(frame, center, z_sz, rt.exemplar_size)
    z_feat = model.embed((patch / 255.0)[None])[0]
    return {"center": center, "target_sz": target_sz, "z_sz": z_sz, "x_sz": x_sz,
            "z_feat": z_feat}


def siamfc_track_step(rt: SiamFCRuntime, model: SiamFC, state: dict, frame: torch.Tensor):
    """One (H, W, C) frame. Returns (new_state, box (4,) xywh, score ())."""
    H, W = frame.shape[0], frame.shape[1]
    dev = frame.device
    scales = torch.tensor(rt.scale_factors, dtype=torch.float32, device=dev)
    mean = frame.float().mean(dim=(0, 1))
    patches = torch.stack([mean_pad_crop(frame, state["center"], state["x_sz"] * s,
                                         rt.instance_size, mean) for s in scales])
    responses = model.correlate(state["z_feat"], model.embed(patches / 255.0))  # (S, 17, 17)
    up = rt.upsampled_sz
    responses = resize_bilinear(responses, (up, up))

    penalty = torch.full((rt.num_scales,), rt.scale_penalty, device=dev)
    penalty[rt.num_scales // 2] = 1.0
    scale_ind = torch.argmax(responses.amax(dim=(1, 2)) * penalty)
    response = responses[scale_ind]
    response = response - response.min()
    response = response / torch.clamp(response.sum(), min=1e-12)
    window = hann2d(up, up, device=dev)
    window = window / window.sum()
    response = (1 - rt.window_influence) * response + rt.window_influence * window

    idx = torch.argmax(response)
    disp = torch.stack([torch.div(idx, up, rounding_mode="floor"), idx % up]).float() \
        - (up - 1) / 2
    scale = scales[scale_ind]
    disp_img = div_rn(disp * rt.total_stride / rt.response_up * (state["x_sz"] * scale),
                      rt.instance_size)
    center = state["center"] + disp_img
    center = torch.minimum(torch.clamp(center, min=0.0),
                           torch.tensor([H - 1.0, W - 1.0], device=dev))

    new_scale = (1 - rt.scale_lr) * 1.0 + rt.scale_lr * scale
    target_sz = state["target_sz"] * new_scale
    new_state = {**state, "center": center, "target_sz": target_sz,
                 "z_sz": state["z_sz"] * new_scale, "x_sz": state["x_sz"] * new_scale}
    box = torch.cat([(center - target_sz / 2).flip(0), target_sz.flip(0)])
    return new_state, box, response.max()


class SiamFCTracker:
    """Single-sequence facade (BaseTracker API). `model` must hold its
    weights; it is moved to `device`."""

    def __init__(self, model: SiamFC, device, runtime: Optional[SiamFCRuntime] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.rt = runtime or SiamFCRuntime()
        self.state = None

    @torch.inference_mode()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self.state = siamfc_init_state(self.rt, self.model, as_frames(image, self.device), box)

    @torch.inference_mode()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, score = siamfc_track_step(self.rt, self.model, self.state,
                                                   as_frames(image, self.device))
        return {"target_bbox": box.cpu().numpy().tolist(), "best_score": float(score)}
