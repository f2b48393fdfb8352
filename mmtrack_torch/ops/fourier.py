"""Fourier-series machinery of the DCF trackers (ECO, C-COT, MOSSE,
SCSRDCF) and of ATOM's score interpolation, port of
mmtrack_tpu/ops/fourier.py.

Every spectrum is the FULL centred Fourier series as a complex64 tensor
over the last two axes, of odd size F: an even N input is sampled at
k = -N/2 .. N/2, the real Nyquist bin duplicated (`cfft2`). Conjugate
symmetry then makes every inner product of the reference's half-spectrum
bookkeeping a plain sum over the grid.

The transforms are torch.fft's (pocketfft on the CPU, cuFFT on the card);
the per-sequence constants (`bicubic_interp_spectrum`,
`gauss_label_spectrum`, `reg_filter`) are host numpy, computed once at
init, copied from the JAX module.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def centered_freqs(F: int, device=None) -> torch.Tensor:
    """Integer frequencies k = -(F-1)/2 .. (F-1)/2 (F odd), f32."""
    return torch.arange(F, dtype=torch.float32, device=device) - (F - 1) // 2


@functools.lru_cache(maxsize=None)
def _centered_index(F: int, N: int, device: torch.device) -> torch.Tensor:
    """(k - (F - 1) // 2) mod N for k < F, made once per device (a pageable
    host-to-device copy a call would wait for the stream)."""
    with torch.inference_mode(False):
        return torch.from_numpy((np.arange(F) - (F - 1) // 2) % N).to(device)


def cfft2(x: torch.Tensor) -> torch.Tensor:
    """Centred full Fourier series of a real signal over the last two axes:
    (..., N, N) -> (..., F, F) complex64, F = N + (N + 1) % 2 (the even-N
    Nyquist row and column duplicated)."""
    N = x.shape[-1]
    F = N + (N + 1) % 2
    X = torch.fft.fft2(x.float())
    k = _centered_index(F, N, X.device)
    return X.index_select(-2, k).index_select(-1, k).to(torch.complex64)


def sample_scores(S: torch.Tensor, grid: int) -> torch.Tensor:
    """The series evaluated on a grid x grid spatial grid (sum-of-series
    convention): (..., F, F) complex -> (..., grid, grid) real; spatial
    index 0 is zero displacement, displacements wrap around mod grid."""
    F = S.shape[-1]
    if F > grid:
        raise ValueError(f"series size {F} larger than grid {grid}")
    k = _centered_index(F, grid, S.device)
    Z = S.new_zeros(S.shape[:-2] + (grid, grid), dtype=torch.complex64)
    Z[..., k[:, None], k[None, :]] = S.to(torch.complex64)
    return torch.fft.ifft2(Z).real * (grid * grid)


def shift_spectrum(S: torch.Tensor, shift_yx: torch.Tensor) -> torch.Tensor:
    """Translate the underlying signal so content at +delta moves to 0:
    S * exp(i shift k), shift = 2 pi delta_px / support; shift_yx (..., 2)
    f32 broadcasting against S's leading axes."""
    k = centered_freqs(S.shape[-1], S.device)
    ay, ax = shift_yx[..., 0:1] * k, shift_yx[..., 1:2] * k
    py = torch.complex(torch.cos(ay), torch.sin(ay))
    px = torch.complex(torch.cos(ax), torch.sin(ax))
    return S * py[..., :, None] * px[..., None, :]


def embed_spectrum(S: torch.Tensor, F_out: int) -> torch.Tensor:
    """Zero-pad a centred series to a larger odd size (the aligned sum of
    multi-resolution score spectra)."""
    F = S.shape[-1]
    pad = (F_out - F) // 2
    if pad < 0:
        raise ValueError(f"cannot embed {F} into {F_out}")
    if pad == 0:
        return S
    out = S.new_zeros(S.shape[:-2] + (F_out, F_out))
    out[..., pad:pad + F, pad:pad + F] = S
    return out


def div_real(S: torch.Tensor, d) -> torch.Tensor:
    """A complex tensor over a real one (or a real number), part by part:
    (a + bi) / (c + 0i) = a / c + (b / c) i, the quotient XLA's complex
    division gives for a real divisor."""
    return torch.complex(S.real / d, S.imag / d)


def bicubic_interp_spectrum(F: int, a: float = -0.75, centering: bool = True,
                            f32_parity: bool = False) -> np.ndarray:
    """Fourier coefficients of the bicubic interpolation kernel: (F, F)
    complex64 numpy, the separable product of the per-dimension kernels
    with the half-pixel centring phase. Float64 by default; `f32_parity`
    evaluates in float32 as the reference does (whose O(f^4) numerator
    cancels catastrophically at small nonzero f)."""
    dt = np.float32 if f32_parity else np.float64
    k = (np.arange(F, dtype=np.float64) - (F - 1) // 2).astype(dt)
    f = (k / dt(F)).astype(dt)
    # python-float scalar subexpressions evaluate in double and convert
    # once at the array op, as the reference's torch scalars do
    with np.errstate(divide="ignore", invalid="ignore"):
        bf = (dt(6) * (dt(1) - np.cos(dt(2 * math.pi) * f))
              + dt(3 * a) * (dt(1) - np.cos(dt(4 * math.pi) * f))
              - dt((6 + 8 * a) * math.pi) * f * np.sin(dt(2 * math.pi) * f)
              - dt(2 * a * math.pi) * f * np.sin(dt(4 * math.pi) * f)) \
            / (dt(4 * math.pi ** 4) * (f ** dt(4)))
    bf[f == 0] = 1.0
    d = (bf / dt(F)).astype(np.float64)
    if centering:
        d = d * np.exp(-1j * np.pi * k.astype(np.float64) / F)
    return np.outer(d, d).astype(np.complex64)


def gauss_label_spectrum(F: int, sigma_y: float, sigma_x: float) -> np.ndarray:
    """Fourier series of a centred Gaussian label: real (F, F) float32
    numpy."""
    def g(sigma):
        k = np.arange(F, dtype=np.float64) - (F - 1) // 2
        return (math.sqrt(2 * math.pi) * sigma / F) * \
            np.exp(-2 * (math.pi * sigma * k / F) ** 2)
    return np.outer(g(float(sigma_y)), g(float(sigma_x))).astype(np.float32)


def conj_symmetrize(S: torch.Tensor) -> torch.Tensor:
    """Project onto the conjugate-symmetric subspace (a real underlying
    signal): (S + conj(S flipped over the last two axes)) / 2."""
    return (S + torch.conj(torch.flip(S, dims=(-2, -1)))) / 2


def reg_filter(support_hw, base_target_hw, reg_window_min: float,
               reg_window_edge: float, reg_window_power: float,
               reg_sparsity_threshold: float,
               pad_to: int | None = None) -> np.ndarray:
    """The spatial regularisation filter in the Fourier domain: a
    polynomial window over the support, its DFT sparsified, the spatial
    minimum corrected back to reg_window_min, cropped to the nonzero box
    and mirrored to a full small real kernel (float32 numpy). `pad_to`
    zero-pads both sides to a fixed odd size; zeros leave the linear
    convolutions unchanged."""
    sz = np.asarray(support_hw, np.float64)
    reg_scale = 0.5 * np.asarray(base_target_hw, np.float64)
    wrg = np.arange(-int((sz[0] - 1) / 2), int(sz[0] / 2 + 1))[:, None]
    wcg = np.arange(-int((sz[1] - 1) / 2), int(sz[1] / 2 + 1))[None, :]
    win = (reg_window_edge - reg_window_min) * \
        (np.abs(wrg / reg_scale[0]) ** reg_window_power +
         np.abs(wcg / reg_scale[1]) ** reg_window_power) + reg_window_min

    dft = np.fft.rfft2(win) / sz.prod()
    mag = np.abs(dft)
    dft[mag < reg_sparsity_threshold * mag.max()] = 0
    sparse = np.fft.irfft2(dft, s=win.shape)
    dft[0, 0] += reg_window_min - sz.prod() * sparse.min()

    # centre the rows (rfftshift2) and keep the real part
    H = dft.shape[0]
    h2 = H + 2
    cent = np.concatenate([dft[(h2 - 1) // 2:], dft[:h2 // 2]], axis=0).real

    nz = np.argwhere(cent != 0)
    mid = (cent.shape[0] - 1) // 2
    top = nz[:, 0].max() + 1
    bottom = 2 * mid - nz[:, 0].max()
    right = nz[:, 1].max() + 1
    cent = cent[bottom:top, :right]
    if cent.shape[1] > 1:
        cent = np.concatenate([cent[::-1, ::-1][:, :-1], cent], axis=1)
    out = cent.astype(np.float32)

    if pad_to is not None:
        if out.shape[0] > pad_to or out.shape[1] > pad_to:
            raise ValueError(f"reg filter {out.shape} exceeds pad_to={pad_to}")
        py = (pad_to - out.shape[0]) // 2
        px = (pad_to - out.shape[1]) // 2
        out = np.pad(out, [(py, pad_to - out.shape[0] - py),
                           (px, pad_to - out.shape[1] - px)])
    return out


def max2d_wrapped(scores: torch.Tensor):
    """argmax over the last two axes (the first of tied maxima) and its
    wraparound displacement: (..., G, G) -> (max (...,), disp_yx (..., 2)
    f32 in grid cells from zero displacement)."""
    G = scores.shape[-1]
    flat = scores.reshape(scores.shape[:-2] + (G * G,))
    idx = torch.argmax(flat, dim=-1)
    max_val = torch.gather(flat, -1, idx[..., None])[..., 0]
    dy = torch.div(idx, G, rounding_mode="floor").float()
    dx = (idx % G).float()
    disp = torch.stack([(dy + G / 2) % G - G / 2, (dx + G / 2) % G - G / 2], dim=-1)
    return max_val, disp
