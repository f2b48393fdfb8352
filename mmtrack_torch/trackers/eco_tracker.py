"""ECO online tracker, port of mmtrack_tpu/trackers/eco_tracker.py:
factorised Fourier-domain correlation filters over two feature blocks of
one ResNetVGGm1 pass (vggconv1 at stride 4 through a 2 x 2 average pool,
layer3 at stride 16), each power-normalised, PCA-projected (96 -> 16,
256 -> 64) and correlated in the Fourier domain against its filter.

  - Init: 23 augmented crops and 7 feature-dropout copies, the PCA
    projection, then per block the joint (filter, projection) problem by
    10 Gauss-Newton steps of 10 preconditioned CG iterations from a zero
    filter, and the compressed sample memory.
  - A step: 5 scale crops, the blocks' score spectra fused 0.4 / 0.6 on
    the shallow grid, wraparound localisation at the sample size, the
    winning scale's sample Fourier-shifted onto the new position into the
    200-slot memory, and every train_skipping-th frame the filter-only CG
    (5 Polak-Ribiere iterations per block, the direction carried from the
    previous optimisation and decayed).

Spectra are full centred complex64 series (ops/fourier.py). The filters
and projections that the solvers move are real tensors, a filter as its
(C, F, F, 2) real / imaginary pair (torch.view_as_real's layout), as
JAX's: the CG inner products and the Jacobian products then run over real
variables, in JAX's arithmetic. The memory, samples and constants are
complex tensors.

The train_skipping cadence depends on the frame number alone, a host int,
so the port decides it on the host (JAX by a `lax.cond`); a frame reads
the card once, for its box and score.

`ECORuntime(train_every_frame=True, use_projection=False, ...)` is C-COT
(trackers/ccot_tracker.py), whose step is this one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.models.backbones import ResNetVGGm1
from mmtrack_torch.models.dimp import div_const
from mmtrack_torch.ops.augment import dimp_init_augmentations, feature_dropout
from mmtrack_torch.ops.crop import crop_at
from mmtrack_torch.ops.fourier import (
    bicubic_interp_spectrum,
    cfft2,
    conj_symmetrize,
    embed_spectrum,
    gauss_label_spectrum,
    max2d_wrapped,
    reg_filter,
    sample_scores,
    shift_spectrum,
)
from mmtrack_torch.ops.optimization import (
    cg_state_init,
    conjugate_gradient_stateful,
    gauss_newton_cg,
    normal_equations,
)
from mmtrack_torch.ops.window import hann2d
from mmtrack_torch.trackers.dimp_tracker import TorchDraws, _to_device, _vec
from mmtrack_torch.trackers.vipt_tracker import as_frames

# ImageNet statistics (the reference's features/deep.py)
MEAN3 = np.asarray([0.485, 0.456, 0.406], np.float32)
STD3 = np.asarray([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class ECORuntime:
    """parameter/eco/default.py's constants (eco_tracker.py:69-140); block 0
    is the shallow vggconv1 tap, block 1 the deep layer3."""
    search_area_scale: float = 4.5
    min_image_sample_size: int = 200 ** 2
    max_image_sample_size: int = 250 ** 2
    strides: tuple = (4, 16)
    blocks: tuple = ("vggconv1", "layer3")
    feat_dims: tuple = (96, 256)
    compressed_dims: tuple = (16, 64)
    learning_rates: tuple = (0.025, 0.0075)
    output_sigma_factors: tuple = (1 / 16, 1 / 4)
    translation_weights: tuple = (0.4, 0.6)
    sample_memory_size: int = 200
    train_skipping: int = 10
    cg_iter: int = 5
    init_cg_iter: int = 100
    init_gn_iter: int = 10
    post_init_cg_iter: int = 0
    precond_data_param: float = 0.3
    precond_reg_param: float = 0.15
    precond_proj_param: float = 35.0
    projection_reg: float = 5e-8
    num_scales: int = 5
    scale_step: float = 1.02
    interp_bicubic_a: float = -0.75
    reg_window_min: tuple = (1e-4, 10e-4)
    reg_window_edge: tuple = (10e-3, 50e-3)
    reg_window_power: float = 2.0
    reg_sparsity_threshold: tuple = (0.05, 0.1)
    target_inside_ratio: float = 0.2
    aug_shifts: tuple = ((6, 6), (-6, 6), (6, -6), (-6, -6))
    aug_rotate: tuple = (5, -5, 10, -10, 20, -20, 30, -30, 45, -45, -60, 60)
    aug_blur: tuple = ((2, 0.2), (0.2, 2), (3, 1), (1, 3), (2, 2))
    aug_dropout_num: int = 7
    aug_dropout_prob: float = 0.2
    # C-COT: full-dimensional filters updated every frame, its own
    # second-sample weight split
    use_projection: bool = True
    train_every_frame: bool = False
    ccot_weight_update: bool = False
    fletcher_reeves: bool = False
    cg_forgetting_rate: int = 75

    @property
    def n_blocks(self) -> int:
        return len(self.strides)

    @property
    def direction_forget_factor(self) -> float:
        return (1.0 - max(self.learning_rates)) ** self.cg_forgetting_rate

    @property
    def scale_factors(self) -> np.ndarray:
        e = np.arange(self.num_scales) - (self.num_scales - 1) // 2
        return (self.scale_step ** e).astype(np.float32)

    @property
    def num_init_samples(self) -> int:
        return (1 + len(self.aug_shifts) + 1 + len(self.aug_blur)
                + len(self.aug_rotate) + self.aug_dropout_num)


@dataclass(frozen=True)
class ECOGeom:
    """The per-sequence shapes: sample side (208 or 240 at the default
    bounds), feature and filter sizes per block."""
    sample_sz: int
    feat_sz: tuple
    filt_sz: tuple


def eco_geometry(rt: ECORuntime, target_hw, device=None) -> tuple[ECOGeom, dict]:
    """The per-sequence geometry (eco_tracker.py:150-197), on the host in
    numpy, and its constants on `device`: the init scale and base size,
    the blocks' Hann windows, interpolation spectra (complex64), label
    spectra, sparsified regularisation kernels (15 x 15 where they fit)
    and their energies."""
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
    S += max(rt.strides) - S % (2 * max(rt.strides))

    feat_sz = tuple(S // s for s in rt.strides)
    filt_sz = tuple(f + (f + 1) % 2 for f in feat_sz)
    sigmas = [(F_ / S) * np.sqrt(np.prod(base)) * osf
              for F_, osf in zip(filt_sz, rt.output_sigma_factors)]
    regs = []
    for b in range(rt.n_blocks):
        args = ((S, S), base, rt.reg_window_min[b], rt.reg_window_edge[b],
                rt.reg_window_power, rt.reg_sparsity_threshold[b])
        try:
            regs.append(reg_filter(*args, pad_to=15))
        except ValueError:      # a pathological aspect ratio: its own size
            regs.append(reg_filter(*args))

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    consts = {
        "target_scale": t(np.float32(scale)),
        "base_target_sz": t(base.astype(np.float32)),
        "windows": tuple(hann2d(f, device=device) for f in feat_sz),
        "interp": tuple(t(bicubic_interp_spectrum(F_, rt.interp_bicubic_a)) for F_ in filt_sz),
        "yf": tuple(t(gauss_label_spectrum(F_, sg, sg)) for F_, sg in zip(filt_sz, sigmas)),
        "reg": tuple(t(r) for r in regs),
        "reg_energy": tuple(t(np.float32(np.sum(r ** 2))) for r in regs),
    }
    return ECOGeom(S, feat_sz, filt_sz), consts


def _norm3(patches: torch.Tensor) -> torch.Tensor:
    mean = _vec(tuple(float(v) for v in MEAN3), patches.device)
    inv_std = _vec(tuple(float(np.float32(1.0) / v) for v in STD3), patches.device)
    return (div_const(patches, 255.0) - mean) * inv_std


def _crop(frame: torch.Tensor, pos, side, out_sz: int) -> torch.Tensor:
    """sample_patch's integer geometry: the centre truncated, the side
    rounded (at least 2), tl = posl - (szl - 1) // 2."""
    szl = torch.clamp(torch.round(side), min=2.0)
    tl = torch.trunc(pos) - torch.floor((szl - 1) / 2)
    return crop_at(frame, pos, szl, out_sz, origin_yx=tl)


def _extract_features(model: ResNetVGGm1, patches: torch.Tensor, blocks) -> tuple:
    """The feature blocks of raw (N, S, S, 3) patches: vggconv1 average-
    pooled 2 x 2 (its four taps added in XLA's window order), then each
    block power-normalised per sample."""
    out = model(_norm3(patches), tuple(dict.fromkeys(blocks)))
    feats = []
    for name in blocks:
        f = out[name]
        if name == "vggconv1":
            h, w = f.shape[1] // 2 * 2, f.shape[2] // 2 * 2
            f = (f[:, 0:h:2, 0:w:2] + f[:, 0:h:2, 1:w:2] + f[:, 1:h:2, 0:w:2]
                 + f[:, 1:h:2, 1:w:2]) * 0.25
        n = div_const(torch.sum(f * f, dim=(1, 2, 3), keepdim=True),
                      f.shape[1] * f.shape[2] * f.shape[3])
        feats.append(f / torch.sqrt(n + 1e-10))
    return tuple(feats)


def _to_spectrum(feat: torch.Tensor, window: torch.Tensor, interp: torch.Tensor) -> torch.Tensor:
    """Window, centred Fourier series, interpolation: (n, h, w, c) ->
    (n, c, F, F) complex."""
    x = (feat * window[None, :, :, None]).permute(0, 3, 1, 2)
    return cfft2(x) * interp[None, None]


def _ri(h: torch.Tensor) -> torch.Tensor:
    return torch.stack([h.real, h.imag], dim=-1)


def _cplx(h_ri: torch.Tensor) -> torch.Tensor:
    return torch.complex(h_ri[..., 0], h_ri[..., 1])


def _reg_residual(h_ri: torch.Tensor, reg_k: torch.Tensor) -> torch.Tensor:
    """The full linear convolution of each real and imaginary plane of the
    filter with the (real, symmetric) regularisation kernel: the spatial
    regularisation residual, (2C, 1, F + R - 1, F + R - 1)."""
    C, Fs = h_ri.shape[0], h_ri.shape[1]
    R0, R1 = reg_k.shape
    x = h_ri.permute(0, 3, 1, 2).reshape(C * 2, 1, Fs, Fs)
    return F.conv2d(x, reg_k[None, None], padding=(R0 - 1, R1 - 1))


def _apply_filter_spectrum(X: torch.Tensor, h_ri: torch.Tensor) -> torch.Tensor:
    """sum_c h_c X_c: X (n, c, F, F) complex, h (c, F, F, 2) -> (n, F, F)."""
    return torch.einsum("ncyx,cyx->nyx", X, _cplx(h_ri))


def _project(X: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ndyx,dc->ncyx", X, P.to(torch.complex64))


def _joint_residuals_block(rt: ECORuntime, hp, X, yf, sw, reg_k):
    """One block's factorised-convolution residuals over (filter,
    projection): the data term, the filter's spatial regularisation and
    the projection's regularisation."""
    h, P = hp
    r = _apply_filter_spectrum(_project(X, P), h) - yf[None]
    return {"data": _ri(torch.sqrt(sw)[:, None, None] * r),
            "reg": _reg_residual(h, reg_k),
            "proj": math.sqrt(rt.projection_reg) * P}


def _filter_residuals_block(rt: ECORuntime, h, mem, yf, sw, reg_k):
    """One block's filter-only residuals over the sample memory."""
    r = _apply_filter_spectrum(mem, h) - yf[None]
    return {"data": _ri(torch.sqrt(sw)[:, None, None] * r),
            "reg": _reg_residual(h, reg_k)}


def _filter_precond(rt: ECORuntime, sample_energy, reg_energy) -> list:
    """The diagonal preconditioner per block: each filter coefficient over
    the blend of its data energy, the channel mean's and the kernel's."""
    diags = []
    for b in range(rt.n_blocks):
        se = sample_energy[b]
        diag = (1 - rt.precond_reg_param) * (
            rt.precond_data_param * se
            + (1 - rt.precond_data_param) * se.mean(dim=0, keepdim=True)
        ) + rt.precond_reg_param * reg_energy[b]
        diags.append(diag[..., None])
    return diags


def pca_projection(feat: torch.Tensor, cdim: int) -> torch.Tensor:
    """The projection's PCA init: the top-cdim eigenvectors of the channel
    covariance of the mean-centred features (their signs are the
    eigensolver's)."""
    d = feat.shape[-1]
    mat = feat.reshape(-1, d)
    mat = mat - mat.mean(dim=0, keepdim=True)
    _, vecs = torch.linalg.eigh(mat.T @ mat)
    return vecs.flip(1)[:, :cdim]


def eco_init_state(rt: ECORuntime, model: ResNetVGGm1, st: ECOGeom, consts: dict,
                   frame: torch.Tensor, init_box_xywh: torch.Tensor, draw: Callable) -> dict:
    """First-frame optimisation (eco_tracker.py:325-432). `draw` gives the
    two blocks' dropout uniforms."""
    S = st.sample_sz
    x0, y0, w, h = init_box_xywh.unbind()
    pos = torch.stack([y0 + (h - 1) / 2, x0 + (w - 1) / 2])
    target_scale, base_target_sz = consts["target_scale"], consts["base_target_sz"]
    dev = pos.device

    # the expanded 2S crop -> the augmented set; the shifts are pixels,
    # relative to the S / 2 half side
    expanded = _crop(frame, pos, 2.0 * S * target_scale, 2 * S)
    rel_shifts = tuple((sy / (S / 2), sx / (S / 2)) for sy, sx in rt.aug_shifts)
    patches, shifts = dimp_init_augmentations(
        expanded, S, None, random_shift_factor=0.0, relative_shifts=rel_shifts,
        blur_sigmas=rt.aug_blur, rotate_angles=rt.aug_rotate)
    feats = _extract_features(model, patches, rt.blocks)
    feats = tuple(torch.cat([f, feature_dropout(
        f[0], _to_device(draw("dropout", (rt.aug_dropout_num, 1, 1, f.shape[-1])), dev),
        rt.aug_dropout_prob)]) for f in feats)
    N = feats[0].shape[0]
    all_shifts = torch.cat([shifts, shifts.new_zeros((rt.aug_dropout_num, 2))])
    P_init = tuple(pca_projection(f, c) for f, c in zip(feats, rt.compressed_dims))

    # the full training spectra, the augmentation shifts and the sub-pixel
    # offset compensated
    sub_px = 2 * math.pi * (pos - torch.round(pos)) / (target_scale * S)
    shift = div_const(2 * math.pi * all_shifts, S) + sub_px[None]
    X_full = tuple(shift_spectrum(_to_spectrum(feats[b], consts["windows"][b],
                                               consts["interp"][b]), shift[:, None, :])
                   for b in range(rt.n_blocks))
    sample_energy = tuple(torch.mean(torch.abs(_project(X, P)) ** 2, dim=0)
                          for X, P in zip(X_full, P_init))
    sw = torch.full((N,), 1.0 / N, device=dev)
    diags = _filter_precond(rt, sample_energy, consts["reg_energy"])
    cg_per_gn = max(rt.init_cg_iter // max(rt.init_gn_iter, 1), 1)
    hs, Ps = [], []
    for b in range(rt.n_blocks):
        pdiag = rt.precond_proj_param * (
            div_const(2 * torch.sum(consts["yf"][b] ** 2), rt.feat_dims[b]) + rt.projection_reg)
        h0 = torch.zeros((rt.compressed_dims[b], st.filt_sz[b], st.filt_sz[b], 2), device=dev)
        h_b, P_b = gauss_newton_cg(
            partial(_joint_residuals_block, rt, X=X_full[b], yf=consts["yf"][b], sw=sw,
                    reg_k=consts["reg"][b]),
            (h0, P_init[b]), rt.init_gn_iter, cg_per_gn,
            precond=lambda hp, d=diags[b], pd=pdiag: (hp[0] / d, hp[1] / pd))
        hs.append(_ri(conj_symmetrize(_cplx(h_b))))
        Ps.append(P_b)

    # the compressed memory with the optimised projection
    M = rt.sample_memory_size
    memory, sws = [], []
    for b in range(rt.n_blocks):
        comp = _project(X_full[b], Ps[b])
        mem = torch.zeros((M,) + comp.shape[1:], dtype=torch.complex64, device=dev)
        mem[:N] = comp
        memory.append(mem)
        sw_b = torch.zeros((M,), device=dev)
        sw_b[:N] = 1.0 / N
        sws.append(sw_b)
    i32 = dict(dtype=torch.int32, device=dev)
    return {"pos": pos, "target_scale": target_scale.clone(),
            "target_sz": base_target_sz * target_scale, "base_target_sz": base_target_sz,
            "filters": tuple(hs), "projections": tuple(Ps), "memory": tuple(memory),
            "sample_weights": tuple(sws),
            "prev_replace_ind": tuple(torch.tensor(-1, **i32) for _ in hs),
            "num_stored": torch.tensor(N, **i32), "sample_energy": sample_energy,
            "frame_num": 1, "cg_state": tuple(cg_state_init(h) for h in hs)}


def _update_weights_eco(rt: ECORuntime, sw, prev_ind, num_stored, lr: float):
    """ECO's min-weight replacement, no protected init mass. Returns the
    normalised weights and the slot (1,)."""
    M = rt.sample_memory_size
    slot = torch.arange(M, device=sw.device)
    cand = torch.where(slot < num_stored, sw, math.inf)
    r_ind = torch.where(num_stored < M, num_stored, torch.argmin(cand).to(torch.int32))
    first = prev_ind < 0
    sw1 = torch.where(first, div_const(sw, 1 - lr), sw)
    prev_w = sw1.gather(0, torch.clamp(prev_ind, min=0).long().reshape(1))[0]
    new_w = torch.where(first, lr, div_const(prev_w, 1 - lr))
    sw1 = sw1.index_put((r_ind.long().reshape(1),), new_w.reshape(1))
    return sw1 / sw1.sum(), r_ind


def _update_weights_ccot(rt: ECORuntime, sw, prev_ind, num_stored, lr: float):
    """C-COT's replacement: the second sample is set to {prev: 1 - lr,
    new: lr} explicitly, later ones as ECO's."""
    M = rt.sample_memory_size
    slot = torch.arange(M, device=sw.device)
    cand = torch.where(slot < num_stored, sw, math.inf)
    r_ind = torch.where(num_stored < M, num_stored, torch.argmin(cand).to(torch.int32))
    second = num_stored == 1
    prev = prev_ind.long().reshape(1)
    base = torch.where(second, sw.index_put((prev,), sw.new_full((1,), 1 - lr)), sw)
    new_w = torch.where(second, lr, div_const(sw.gather(0, prev)[0], 1 - lr))
    sw1 = base.index_put((r_ind.long().reshape(1),), new_w.reshape(1))
    return sw1 / sw1.sum(), r_ind


def eco_track_step(rt: ECORuntime, model: ResNetVGGm1, st: ECOGeom, consts: dict,
                   state: dict, frame: torch.Tensor):
    """One frame (H, W, 3) uint8: the num_scales crops, then
    `eco_step_from_patches`."""
    S = st.sample_sz
    sfac = _vec(tuple(float(v) for v in rt.scale_factors), frame.device)
    sample_scales = state["target_scale"] * sfac
    patches = torch.stack([_crop(frame, state["pos"], sample_scales[i] * S, S)
                           for i in range(rt.num_scales)])
    return eco_step_from_patches(rt, model, st, consts, state, patches,
                                 (frame.shape[0], frame.shape[1]))


def eco_step_from_patches(rt: ECORuntime, model: ResNetVGGm1, st: ECOGeom, consts: dict,
                          state: dict, patches: torch.Tensor, img_hw):
    """The step from (num_scales, S, S, 3) raw patches (eco_tracker.py:
    482-611). Returns (state, box (4,) xywh, max score), tensors."""
    S = st.sample_sz
    H, W = img_hw
    dev = patches.device
    state = {**state, "frame_num": state["frame_num"] + 1}
    sample_pos = torch.round(state["pos"])
    sfac = _vec(tuple(float(v) for v in rt.scale_factors), dev)
    sample_scales = state["target_scale"] * sfac

    feats = _extract_features(model, patches, rt.blocks)
    test_X = tuple(_to_spectrum(feats[b] @ state["projections"][b] if rt.use_projection
                                else feats[b], consts["windows"][b], consts["interp"][b])
                   for b in range(rt.n_blocks))
    F_out = max(st.filt_sz)
    sf = torch.zeros((rt.num_scales, F_out, F_out), dtype=torch.complex64, device=dev)
    for b in range(rt.n_blocks):
        resp = _apply_filter_spectrum(test_X[b], state["filters"][b])
        sf = sf + embed_spectrum(rt.translation_weights[b] * resp, F_out)
    scores = sample_scores(sf, S)

    max_vals, disp = max2d_wrapped(scores)
    scale_ind = torch.argmax(max_vals).reshape(1)
    max_score = max_vals.index_select(0, scale_ind)[0]
    sf_win = sfac.index_select(0, scale_ind)[0]
    translation = disp.index_select(0, scale_ind)[0] * state["target_scale"] * sf_win

    img_sz = _vec((float(H), float(W)), dev)
    min_sf = torch.max(torch.full_like(state["base_target_sz"], 10.0) / state["base_target_sz"])
    max_sf = torch.min(img_sz / state["base_target_sz"])
    new_scale = torch.minimum(torch.maximum(state["target_scale"] * sf_win, min_sf), max_sf)
    target_sz = state["base_target_sz"] * new_scale
    new_pos = sample_pos + translation
    inside_offset = (rt.target_inside_ratio - 0.5) * target_sz
    new_pos = torch.maximum(torch.minimum(new_pos, img_sz - inside_offset), inside_offset)
    state = {**state, "pos": new_pos, "target_scale": new_scale, "target_sz": target_sz}

    # the winning scale's sample, re-centred on the new position, into each
    # block's memory (written in place)
    shift = 2 * math.pi * (new_pos - sample_pos) / (sample_scales.index_select(0, scale_ind)[0]
                                                      * S)
    update_w = _update_weights_ccot if rt.ccot_weight_update else _update_weights_eco
    sws, prevs, se_new = [], [], []
    for b in range(rt.n_blocks):
        xf = shift_spectrum(test_X[b].index_select(0, scale_ind)[0], shift[None])
        sw1, r_ind = update_w(rt, state["sample_weights"][b], state["prev_replace_ind"][b],
                              state["num_stored"], rt.learning_rates[b])
        state["memory"][b].index_copy_(0, r_ind.long().reshape(1), xf[None])
        sws.append(sw1)
        prevs.append(r_ind)
        se_new.append((1 - rt.learning_rates[b]) * state["sample_energy"][b]
                      + rt.learning_rates[b] * torch.abs(xf) ** 2)
    state = {**state, "sample_weights": tuple(sws), "prev_replace_ind": tuple(prevs),
             "num_stored": torch.clamp(state["num_stored"] + 1,
                                       max=rt.sample_memory_size).to(torch.int32)}

    # the filter-only optimisation every train_skipping-th frame (C-COT:
    # every frame); the energy's running mean advances only then
    if eco_trains(rt, state["frame_num"]):
        filters, cgs = eco_filter_cg(rt, consts, state, se_new)
        state = {**state, "filters": filters, "sample_energy": tuple(se_new), "cg_state": cgs}

    box = torch.cat([(state["pos"] - (state["target_sz"] - 1) / 2).flip(0),
                     state["target_sz"].flip(0)])
    return state, box, max_score


def eco_trains(rt: ECORuntime, frame_num: int) -> bool:
    """Whether frame `frame_num` (1 the init frame) optimises the filter."""
    return rt.train_every_frame or frame_num % rt.train_skipping == 1


def eco_filter_cg(rt: ECORuntime, consts: dict, state: dict, sample_energy) -> tuple:
    """The filter-only CG per block (the blocks are independent problems):
    the residuals are linear in the filter, so one linearisation gives the
    normal equations; cg_iter preconditioned Polak-Ribiere iterations from
    zero, the direction carried in the state's `cg_state` and decayed.
    Returns (filters, CG states)."""
    diags = _filter_precond(rt, sample_energy, consts["reg_energy"])
    filters, cgs = [], []
    for b in range(rt.n_blocks):
        h = state["filters"][b]
        A, rhs = normal_equations(partial(_filter_residuals_block, rt, mem=state["memory"][b],
                                          yf=consts["yf"][b], sw=state["sample_weights"][b],
                                          reg_k=consts["reg"][b]), h)
        dx, cg_b = conjugate_gradient_stateful(
            A, rhs, torch.zeros_like(h), rt.cg_iter, state["cg_state"][b],
            precond=lambda x, d=diags[b]: x / d, fletcher_reeves=rt.fletcher_reeves,
            direction_forget_factor=rt.direction_forget_factor)
        filters.append(_ri(conj_symmetrize(_cplx(h + dx))))
        cgs.append(cg_b)
    return tuple(filters), tuple(cgs)


class ECOTracker:
    """Single-sequence facade (BaseTracker API). `model` must hold its
    weights; it is moved to `device` and frozen. `draws` is a factory of
    draw sources (default TorchDraws(seed)), called at every initialize.
    A frame reads the card once, for its box and score; `cg_iters` counts
    the filter CG iterations run (both blocks')."""

    def __init__(self, model: ResNetVGGm1, device, runtime: Optional[ECORuntime] = None,
                 seed: int = 0, draws: Optional[Callable[[], Callable]] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or ECORuntime()
        self.draws = draws or (lambda: TorchDraws(seed))
        self.state = self.geom = self.consts = None
        self.cg_iters = 0

    def _init_state(self, frame, box) -> dict:
        return eco_init_state(self.rt, self.model, self.geom, self.consts, frame, box,
                              self.draws())

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = np.asarray(info["init_bbox"], np.float32)
        self.geom, self.consts = eco_geometry(self.rt, (box[3], box[2]), self.device)
        self.state = self._init_state(as_frames(image, self.device)[..., :3],
                                      torch.tensor(box, device=self.device))

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        frame = as_frames(image, self.device)[..., :3]
        self.state, box, score = eco_track_step(self.rt, self.model, self.geom, self.consts,
                                                self.state, frame)
        cg = self.rt.cg_iter * self.rt.n_blocks * eco_trains(self.rt, self.state["frame_num"])
        self.cg_iters += cg
        out = torch.cat([box, score.reshape(1)]).cpu().numpy()
        return {"target_bbox": out[:4].tolist(), "best_score": float(out[4]), "cg_iters": cg}
