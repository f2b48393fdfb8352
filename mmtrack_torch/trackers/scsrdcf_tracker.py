"""SCSRDCF, the spatially regularised DCF solved by frequency-domain SOR,
port of mmtrack_tpu/trackers/scsrdcf_tracker.py: the regularisation
window enters as a small sparsified kernel W convolved over the filter
spectrum, and each frame runs num_gs_iter successive over-relaxation
sweeps on the normal equations

    (D + reg^2 + W^T W) f = rhs,  D = EMA |X|^2,  rhs = EMA y conj(X):
    g <- W f;  f <- tau Dinv(rhs) + (1 - tau) f - tau Dinv(W^T g + 2 reg g).

W is a 'same' convolution of the real and imaginary planes with the real
kernel, whose centre tap moves into the scalar regulariser. On the init
frame the sweep starts from f_bias = tau Dinv(rhs). MOSSE's grayscale
geometry and crops; no learned weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.ops.fourier import div_real, max2d_wrapped, reg_filter, sample_scores
from mmtrack_torch.trackers.mosse_tracker import (
    MOSSEGeom,
    MOSSERuntime,
    MOSSETracker,
    _gray_spectrum,
    mosse_geometry,
)


@dataclass(frozen=True)
class SCSRDCFRuntime(MOSSERuntime):
    learning_rate: float = 0.025
    reg_factor: float = 1.0
    num_gs_iter: int = 5
    sor_weight: float = 1.0
    reg_window_min: float = 1e-4
    reg_window_edge: float = 1e-2
    reg_window_power: float = 2.0
    reg_sparsity_threshold: float = 0.05


def scsrdcf_geometry(rt: SCSRDCFRuntime, target_hw, device=None):
    geom, consts = mosse_geometry(rt, target_hw, device)
    S = geom.sample_sz
    rk = reg_filter((S, S), consts["base_target_sz"].cpu().numpy(), rt.reg_window_min,
                    rt.reg_window_edge, rt.reg_window_power, rt.reg_sparsity_threshold,
                    pad_to=15)
    # the kernel's centre tap moves into the scalar regulariser
    cy, cx = rk.shape[0] // 2, rk.shape[1] // 2
    reg_factor = np.float32(rt.reg_factor + rk[cy, cx])
    rk = rk.copy()
    rk[cy, cx] = 0.0
    consts["reg_k"] = torch.from_numpy(rk).to(device)
    consts["reg_factor"] = torch.from_numpy(np.array(reg_factor)).to(device)
    return geom, consts


def _w_op(h: torch.Tensor, reg_k: torch.Tensor) -> torch.Tensor:
    """The 'same' convolution of each real and imaginary plane of (C, F, F)
    complex with the real kernel."""
    C, Fs = h.shape[0], h.shape[-1]
    x = torch.stack([h.real, h.imag], dim=1).reshape(C * 2, 1, Fs, Fs)
    y = F.conv2d(x, reg_k[None, None], padding="same").reshape(C, 2, Fs, Fs)
    return torch.complex(y[:, 0], y[:, 1])


def _run_opt(rt: SCSRDCFRuntime, consts: dict, f, rhs, lhs_data, first: bool = False):
    """num_gs_iter SOR sweeps, unrolled; the init frame starts from f_bias."""
    tau, reg = rt.sor_weight, consts["reg_factor"]
    lhs = lhs_data + reg ** 2
    f_bias = tau * div_real(rhs, lhs)
    if first:
        f = f_bias
    for _ in range(rt.num_gs_iter):
        g = _w_op(f, consts["reg_k"])
        f = f_bias + (1 - tau) * f - tau * div_real(_w_op(g, consts["reg_k"]) + 2 * reg * g,
                                                     lhs)
    return f


def scsrdcf_init_state(rt: SCSRDCFRuntime, geom: MOSSEGeom, consts: dict, frame: torch.Tensor,
                       init_box_xywh: torch.Tensor) -> dict:
    x, y, w, h = init_box_xywh.unbind()
    pos = torch.stack([y + (h - 1) / 2, x + (w - 1) / 2])
    target_scale = consts["target_scale"]
    xf = _gray_spectrum(consts, frame, pos, target_scale * geom.sample_sz, geom.sample_sz)[0]
    rhs = consts["yf"][None] * torch.conj(xf)
    lhs_data = torch.abs(xf) ** 2
    f = _run_opt(rt, consts, torch.zeros_like(rhs), rhs, lhs_data, first=True)
    return {"pos": pos, "target_scale": target_scale.clone(), "rhs": rhs,
            "lhs_data": lhs_data, "f": f, "frame_num": 1}


def _scsrdcf_localize(geom: MOSSEGeom, state: dict, xf: torch.Tensor):
    S = geom.sample_sz
    sf = torch.sum(state["f"] * xf, dim=0)
    G = S + (S + 1) % 2
    max_score, disp = max2d_wrapped(sample_scores(sf, G))
    return max_score, torch.round(state["pos"]) + disp * (S / G) * state["target_scale"]


def scsrdcf_track_step(rt: SCSRDCFRuntime, geom: MOSSEGeom, consts: dict, state: dict,
                       frame: torch.Tensor):
    """One frame: localise, then the memory's running means from a fresh
    sample at the new position and the SOR re-optimisation."""
    S = geom.sample_sz
    side = state["target_scale"] * S
    max_score, new_pos = _scsrdcf_localize(geom, state,
                                           _gray_spectrum(consts, frame, state["pos"], side,
                                                          S)[0])
    xf_u = _gray_spectrum(consts, frame, new_pos, side, S)[0]
    lr = rt.learning_rate
    rhs = (1 - lr) * state["rhs"] + lr * (consts["yf"][None] * torch.conj(xf_u))
    lhs_data = (1 - lr) * state["lhs_data"] + lr * torch.abs(xf_u) ** 2
    f = _run_opt(rt, consts, state["f"], rhs, lhs_data)
    state = {**state, "pos": new_pos, "rhs": rhs, "lhs_data": lhs_data, "f": f,
             "frame_num": state["frame_num"] + 1}
    target_sz = consts["base_target_sz"] * state["target_scale"]
    box = torch.cat([(new_pos - (target_sz - 1) / 2).flip(0), target_sz.flip(0)])
    return state, box, max_score


class SCSRDCFTracker(MOSSETracker):
    """Single-sequence facade (BaseTracker API); no model."""

    geometry = staticmethod(scsrdcf_geometry)
    init_state = staticmethod(scsrdcf_init_state)
    track_step = staticmethod(scsrdcf_track_step)

    def __init__(self, device, runtime: SCSRDCFRuntime | None = None):
        super().__init__(device, runtime or SCSRDCFRuntime())
