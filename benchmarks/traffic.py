"""The one generator of every cell's inputs, from a traffic file's
parameters and the run's seed, on the device.

Frames: per lane, a smooth random background (uniform noise on a coarse
grid, bilinearly upsampled) and one textured target of a random size that
moves at a constant speed and bounces off the frame's borders; each frame
adds sensor noise. Training batches: normalised template and search
crops of the same kind of texture, and target boxes drawn as the training
sampler's jitter places them in the search crop. The same seed gives the
same inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference.vipt import norm_stats
from benchmarks.seeds import generator


def _uniform(n, lo, hi, g, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def _bounce(p0, v, t, span):
    """Position at frame t of a point moving at v on [0, span], reflected."""
    span = span.clamp(min=1e-3)
    x = torch.remainder(p0 + v * t, 2 * span)
    return torch.where(x > span, 2 * span - x, x)


def render(p: dict, channels: int, seed: int, device, tag: str = "frames"):
    """(frames (N, lanes, H, W, C) uint8, boxes (N, lanes, 4) xywh f32) of
    N = sequences x (1 + sequence_frames) frames per lane: one moving
    clip, which the modes cut into sequences."""
    g = generator(seed, tag, device)
    n = p["sequences"] * (p["sequence_frames"] + 1)
    B, H, W, C = p["lanes"], p["height"], p["width"], channels
    cell, tex_n = p["background_cell_px"], p["target_texture"]
    lo = torch.randint(0, 256, (B, C, H // cell + 2, W // cell + 2), generator=g,
                       device=device).float()
    bg = F.interpolate(lo, size=(H, W), mode="bilinear", align_corners=False)
    tex = torch.randint(0, 256, (B, C, tex_n * tex_n), generator=g, device=device).float()
    side_lo, side_hi = p["target_side_px"]
    w = _uniform(B, side_lo, side_hi, g, device)
    h = _uniform(B, side_lo, side_hi, g, device)
    x0 = torch.rand(B, generator=g, device=device) * (W - w)
    y0 = torch.rand(B, generator=g, device=device) * (H - h)
    sp_lo, sp_hi = p["target_speed_px"]
    speed = _uniform(B, sp_lo, sp_hi, g, device)
    angle = _uniform(B, 0.0, 2 * math.pi, g, device)
    vx, vy = speed * torch.cos(angle), speed * torch.sin(angle)
    X = torch.arange(W, device=device, dtype=torch.float32)
    Y = torch.arange(H, device=device, dtype=torch.float32)
    frames = torch.empty((n, B, H, W, C), dtype=torch.uint8, device=device)
    boxes = torch.empty((n, B, 4), dtype=torch.float32, device=device)
    for t in range(n):
        x = _bounce(x0, vx, t, W - w)
        y = _bounce(y0, vy, t, H - h)
        boxes[t] = torch.stack([x, y, w, h], 1)
        u = (X[None] - x[:, None]) / w[:, None]                     # (B, W)
        v = (Y[None] - y[:, None]) / h[:, None]                     # (B, H)
        inside = (((v >= 0) & (v < 1))[:, :, None] & ((u >= 0) & (u < 1))[:, None, :])
        ui = (u.clamp(0, 1 - 1e-6) * tex_n).long()
        vi = (v.clamp(0, 1 - 1e-6) * tex_n).long()
        idx = (vi[:, :, None] * tex_n + ui[:, None, :]).reshape(B, 1, H * W).expand(-1, C, -1)
        target = torch.gather(tex, 2, idx).view(B, C, H, W)
        img = torch.where(inside[:, None], target, bg)
        noise = torch.randint(-p["noise"], p["noise"] + 1, (B, C, H, W), generator=g,
                              device=device)
        frames[t] = (img + noise).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return frames, boxes


def train_batches(p: dict, cfg: dict, seed: int, device) -> list[dict]:
    """`p['pool_batches']` batches of `p['batch']` rows: normalised template
    and search crops (B, T, T, C) / (B, S, S, C) f32 and the target's box
    in the search crop (B, 4) xywh in [0, 1]. The box is the training
    sampler's: the crop is centred on the target's box jittered by
    exp(N(0, 1) * scale_jitter) in size and by up to centre_jitter / 2 of
    the jittered box's side in centre (ViPT processing.py
    _get_jittered_box), and spans search factor times that side."""
    g = generator(seed, "train", device)
    B, C = p["batch"], cfg["model"]["channels"]
    tr = cfg["train"]
    mean, std = norm_stats(C, device)
    out = []
    for _ in range(p["pool_batches"]):
        crops = {}
        for key, size in (("template", cfg["template"]["size"]),
                          ("search", cfg["search"]["size"])):
            cells = size // p["texture_cell_px"]
            lo = torch.randint(0, 256, (B, C, cells, cells), generator=g, device=device).float()
            img = F.interpolate(lo, size=(size, size), mode="bilinear", align_corners=False)
            img = img + torch.randint(-p["noise"], p["noise"] + 1, img.shape, generator=g,
                                      device=device)
            img = img.clamp(0, 255).round().permute(0, 2, 3, 1)
            crops[key] = ((img / 255.0 - mean) / std).contiguous()
        aspect = torch.exp(_uniform(B, -p["aspect_log_range"], p["aspect_log_range"], g,
                                    device))
        jit = torch.exp(torch.randn((B, 2), generator=g, device=device) * tr["scale_jitter"])
        side = cfg["search"]["factor"] * torch.sqrt(jit[:, 0] * jit[:, 1])   # crop side / target
        w = torch.sqrt(aspect) / side
        h = 1.0 / torch.sqrt(aspect) / side
        shift = (torch.rand((B, 2), generator=g, device=device) - 0.5) * tr["center_jitter"]
        cx = 0.5 - shift[:, 0] * torch.sqrt(jit[:, 0] * jit[:, 1]) / side
        cy = 0.5 - shift[:, 1] * torch.sqrt(jit[:, 0] * jit[:, 1]) / side
        crops["search_anno"] = torch.stack([cx - w / 2, cy - h / 2, w, h], 1)
        out.append(crops)
    return out
