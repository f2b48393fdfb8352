"""C-COT, port of mmtrack_tpu/trackers/ccot_tracker.py: ECO's Fourier
machinery without the factorised projection (per-channel filters over the
full 96 + 256 feature channels), a plain min-weight memory, and the
preconditioned filter CG every frame. The init is one unaugmented sample,
Fourier-shifted onto the integer grid, that seeds the memory; the filter
is solved from zero by init_cg_iter carried-direction CG iterations per
block, whose final direction seeds the online carry.

The constants inherit ECO's default.py, with C-COT's single top-level
learning rate (0.0075), label sigma factor (1/16) and regularisation
window (the shallow block's), an unweighted block sum, C-COT's
second-sample weight split and a 30-slot memory. The step is ECO's
(trackers/eco_tracker.py::eco_track_step).
"""

from __future__ import annotations

import math
from functools import partial

import torch

from mmtrack_torch.ops.fourier import conj_symmetrize, shift_spectrum
from mmtrack_torch.ops.optimization import (
    cg_state_init,
    conjugate_gradient_stateful,
    normal_equations,
)
from mmtrack_torch.trackers.eco_tracker import (
    ECOGeom,
    ECORuntime,
    ECOTracker,
    _cplx,
    _crop,
    _extract_features,
    _filter_precond,
    _filter_residuals_block,
    _ri,
    _to_spectrum,
)


def ccot_runtime(**overrides) -> ECORuntime:
    base = dict(use_projection=False, train_every_frame=True, sample_memory_size=30,
                compressed_dims=(96, 256), learning_rates=(0.0075, 0.0075),
                output_sigma_factors=(1 / 16, 1 / 16), translation_weights=(1.0, 1.0),
                reg_window_min=(1e-4, 1e-4), reg_window_edge=(10e-3, 10e-3),
                reg_sparsity_threshold=(0.05, 0.05), ccot_weight_update=True)
    base.update(overrides)
    return ECORuntime(**base)


def ccot_init_state(rt: ECORuntime, model, st: ECOGeom, consts: dict, frame: torch.Tensor,
                    init_box_xywh: torch.Tensor) -> dict:
    """First frame (ccot_tracker.py:67-146)."""
    S = st.sample_sz
    x0, y0, w, h = init_box_xywh.unbind()
    pos = torch.stack([y0 + (h - 1) / 2, x0 + (w - 1) / 2])
    target_scale, base_target_sz = consts["target_scale"], consts["base_target_sz"]
    dev = pos.device

    patch = _crop(frame, pos, target_scale * S, S)
    feats = _extract_features(model, patch[None], rt.blocks)
    shift = 2 * math.pi * (pos - torch.round(pos)) / (target_scale * S)
    X = tuple(shift_spectrum(_to_spectrum(feats[b], consts["windows"][b],
                                          consts["interp"][b])[0], shift[None])
              for b in range(rt.n_blocks))

    M = rt.sample_memory_size
    memory, sws = [], []
    for b in range(rt.n_blocks):
        mem = torch.zeros((M,) + X[b].shape, dtype=torch.complex64, device=dev)
        mem[0] = X[b]
        memory.append(mem)
        sw = torch.zeros((M,), device=dev)
        sw[0] = 1.0
        sws.append(sw)
    se = tuple(torch.abs(x) ** 2 for x in X)
    diags = _filter_precond(rt, se, consts["reg_energy"])

    filters, cg_state = [], []
    for b in range(rt.n_blocks):
        h0 = _ri(torch.zeros_like(X[b]))
        A, rhs = normal_equations(partial(_filter_residuals_block, rt, mem=memory[b],
                                          yf=consts["yf"][b], sw=sws[b],
                                          reg_k=consts["reg"][b]), h0)
        dx, cg_b = conjugate_gradient_stateful(
            A, rhs, torch.zeros_like(h0), rt.init_cg_iter, cg_state_init(h0),
            precond=lambda x, d=diags[b]: x / d, fletcher_reeves=rt.fletcher_reeves,
            direction_forget_factor=rt.direction_forget_factor)
        filters.append(_ri(conj_symmetrize(_cplx(h0 + dx))))
        cg_state.append(cg_b)
    i32 = dict(dtype=torch.int32, device=dev)
    return {"pos": pos, "target_scale": target_scale.clone(),
            "target_sz": base_target_sz * target_scale, "base_target_sz": base_target_sz,
            "filters": tuple(filters), "memory": tuple(memory), "sample_weights": tuple(sws),
            "prev_replace_ind": tuple(torch.tensor(0, **i32) for _ in filters),
            "num_stored": torch.tensor(1, **i32), "sample_energy": se, "frame_num": 1,
            "cg_state": tuple(cg_state)}


class CCOTTracker(ECOTracker):
    """The facade (BaseTracker API); the step is ECO's with C-COT's runtime
    (no projection, the filter CG every frame). C-COT draws nothing."""

    def __init__(self, model, device, runtime: ECORuntime | None = None, seed: int = 0):
        super().__init__(model, device, runtime or ccot_runtime(), seed)

    def _init_state(self, frame, box) -> dict:
        return ccot_init_state(self.rt, self.model, self.geom, self.consts, frame, box)
