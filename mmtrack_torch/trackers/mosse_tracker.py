"""MOSSE, the closed-form Fourier correlation filter, port of
mmtrack_tpu/trackers/mosse_tracker.py: per frame the crop, the grayscale
feature (the channel mean of im / 255 - 0.5), the Hann window, the centred
spectrum and its bicubic Fourier interpolation, the score H X, wraparound
localisation, and the exponential filter update

    H = num / (den + reg),  num <- (1 - lr) num + lr y conj(X),
                            den <- (1 - lr) den + lr sum_c |X|^2

from a fresh sample at the new position. The constants are the MOSSE
paper's (grayscale, one scale, lr 0.125) on ECO's sample geometry (an odd
square search area between 200^2 and 250^2 pixels). No learned weights.
A frame reads the card once, for its box and score.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.ops.fourier import (
    bicubic_interp_spectrum,
    cfft2,
    div_real,
    gauss_label_spectrum,
    max2d_wrapped,
    sample_scores,
)
from mmtrack_torch.ops.window import hann2d
from mmtrack_torch.trackers.eco_tracker import _crop
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class MOSSERuntime:
    search_area_scale: float = 4.5
    min_image_sample_size: int = 200 ** 2
    max_image_sample_size: int = 250 ** 2
    stride: int = 1
    learning_rate: float = 0.125
    reg_factor: float = 0.01
    output_sigma_factor: float = 1.0 / 16.0
    interp_bicubic_a: float = -0.75
    score_upsample: int = 1
    # the reference's float32 evaluation of the interpolation kernel
    interp_f32_parity: bool = False


@dataclass(frozen=True)
class MOSSEGeom:
    sample_sz: int


def mosse_geometry(rt: MOSSERuntime, target_hw, device=None) -> tuple[MOSSEGeom, dict]:
    """The per-sequence geometry (mosse_tracker.py:66-98) on the host and
    its constants on `device`."""
    ts = np.asarray(target_hw, np.float64)
    search_area = float(np.prod(ts * rt.search_area_scale))
    if search_area > rt.max_image_sample_size:
        scale = np.sqrt(search_area / rt.max_image_sample_size)
    elif search_area < rt.min_image_sample_size:
        scale = np.sqrt(search_area / rt.min_image_sample_size)
    else:
        scale = 1.0
    base = ts / scale
    S = int(round(np.sqrt(np.prod(base * rt.search_area_scale))))
    # the odd-ification makes the feature grid S / stride odd
    S += rt.stride - S % (2 * rt.stride)
    Fg = S // rt.stride
    Ff = Fg + (Fg + 1) % 2
    sigma = np.sqrt(np.prod(base)) * rt.output_sigma_factor * (Ff / S)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    consts = {
        "target_scale": t(np.float32(scale)),
        "base_target_sz": t(base.astype(np.float32)),
        "window": hann2d(Fg, device=device),
        "interp": t(bicubic_interp_spectrum(Ff, rt.interp_bicubic_a,
                                            f32_parity=rt.interp_f32_parity)),
        "yf": t(gauss_label_spectrum(Ff, sigma, sigma)),
    }
    return MOSSEGeom(S), consts


def _gray_window_spectrum(consts: dict, patch: torch.Tensor) -> torch.Tensor:
    """Grayscale (the channel mean of patch / 255 - 0.5), window, centred
    spectrum, interpolation: (S, S, 3) in [0, 255] -> (1, 1, F, F)."""
    gray = div_const(torch.sum(div_const(patch, 255.0) - 0.5, dim=-1), 3)
    return cfft2((gray * consts["window"])[None, None]) * consts["interp"][None, None]


def _gray_spectrum(consts: dict, frame: torch.Tensor, pos, side, S: int) -> torch.Tensor:
    return _gray_window_spectrum(consts, _crop(frame, pos, side, S)[..., :3])


def mosse_init_state(rt: MOSSERuntime, geom: MOSSEGeom, consts: dict, frame: torch.Tensor,
                     init_box_xywh: torch.Tensor) -> dict:
    x, y, w, h = init_box_xywh.unbind()
    pos = torch.stack([y + (h - 1) / 2, x + (w - 1) / 2])
    target_scale = consts["target_scale"]
    xf = _gray_spectrum(consts, frame, pos, target_scale * geom.sample_sz, geom.sample_sz)
    return {"pos": pos, "target_scale": target_scale.clone(),
            "num": consts["yf"][None, None] * torch.conj(xf),
            "den": torch.sum(torch.abs(xf) ** 2, dim=1), "frame_num": 1}


def _mosse_localize(rt: MOSSERuntime, geom: MOSSEGeom, state: dict, xf: torch.Tensor):
    """Score and wraparound localisation: (max score, new position)."""
    S = geom.sample_sz
    H = div_real(state["num"], state["den"][:, None] + rt.reg_factor)
    sf = torch.sum(H * xf, dim=1, keepdim=True)
    G = S * rt.score_upsample
    G += (G + 1) % 2
    s = sample_scores(sf[0, 0], G)
    max_score, disp = max2d_wrapped(s)
    return max_score, torch.round(state["pos"]) + disp * (S / G) * state["target_scale"]


def _mosse_finish(rt: MOSSERuntime, consts: dict, state: dict, new_pos, xf_u, max_score):
    """The filter update with the fresh sample, and the box."""
    lr = rt.learning_rate
    num = (1 - lr) * state["num"] + lr * (consts["yf"][None, None] * torch.conj(xf_u))
    den = (1 - lr) * state["den"] + lr * torch.sum(torch.abs(xf_u) ** 2, dim=1)
    state = {**state, "pos": new_pos, "num": num, "den": den,
             "frame_num": state["frame_num"] + 1}
    target_sz = consts["base_target_sz"] * state["target_scale"]
    box = torch.cat([(new_pos - (target_sz - 1) / 2).flip(0), target_sz.flip(0)])
    return state, box, max_score


def mosse_track_step(rt: MOSSERuntime, geom: MOSSEGeom, consts: dict, state: dict,
                     frame: torch.Tensor):
    """One frame: localise at the current position, update with a fresh
    sample at the new one."""
    S = geom.sample_sz
    side = state["target_scale"] * S
    max_score, new_pos = _mosse_localize(rt, geom, state,
                                         _gray_spectrum(consts, frame, state["pos"], side, S))
    xf_u = _gray_spectrum(consts, frame, new_pos, side, S)
    return _mosse_finish(rt, consts, state, new_pos, xf_u, max_score)


class MOSSETracker:
    """Single-sequence facade (BaseTracker API); no model."""

    geometry = staticmethod(mosse_geometry)
    init_state = staticmethod(mosse_init_state)
    track_step = staticmethod(mosse_track_step)

    def __init__(self, device, runtime: MOSSERuntime | None = None):
        self.device = torch.device(device)
        self.rt = runtime or MOSSERuntime()
        self.state = self.geom = self.consts = None

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = np.asarray(info["init_bbox"], np.float32)
        self.geom, self.consts = self.geometry(self.rt, (box[3], box[2]), self.device)
        self.state = self.init_state(self.rt, self.geom, self.consts,
                                     as_frames(image, self.device),
                                     torch.tensor(box, device=self.device))

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, score = self.track_step(self.rt, self.geom, self.consts, self.state,
                                                 as_frames(image, self.device))
        out = torch.cat([box, score.reshape(1)]).cpu().numpy()
        return {"target_bbox": out[:4].tolist(), "best_score": float(out[4])}
