"""Cross-correlation ops for Siamese heads, port of mmtrack_tpu/ops/xcorr.py.

`xcorr` is SiamFC's score map (the template correlated over the search
embedding, summed over channels); the JAX package computes it with an XLA
convolution, and so does this port (`F.conv2d`).

`depthwise_xcorr` is the per-channel VALID correlation. The JAX package has
it twice: an XLA grouped convolution (`depthwise_xcorr`, which Alpha-Refine
calls) and the Pallas kernel `depthwise_xcorr_pallas` (:50-80) that
computes the same function. Here the function is the hand-written kernel
`csrc/xcorr.cu` on CUDA tensors, with its plain version below: the Pallas
body's loop in its order (acc = 0; for a in fh, for b in fw:
acc = acc + x[a:a+oh, b:b+ow, :] * z[a, b, :]), the product and the sum
as separate f32 operations, which the kernel repeats bit for bit.

Two extensions over the Pallas kernel, both used by Alpha-Refine:

  * the filter may be per sample, (N, fh, fw, C), as well as shared,
    (fh, fw, C) (alpha_refine.py:81-83 vmaps a different 3x3 filter per
    sample);
  * `pad` zero-pads the search feature on each spatial side inside the
    kernel (alpha_refine.py:82 pads by one with jnp.pad), so the padded
    copy is never written. The padded values take part in the products as
    +0.0, exactly as in the padded tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmtrack_torch.kernels.build import load_library, stream_handle
from mmtrack_torch.ops.plain_grad import launch_with_plain_grad
from mmtrack_torch.utils import profiling


def xcorr(z_feat: torch.Tensor, x_feat: torch.Tensor) -> torch.Tensor:
    """SiamFC correlation, summed over channels.

    z_feat (fh, fw, C), x_feat (N, H, W, C) -> (N, H-fh+1, W-fw+1) f32."""
    w = z_feat.float().permute(2, 0, 1)[None]                     # (1, C, fh, fw)
    return F.conv2d(x_feat.float().permute(0, 3, 1, 2), w)[:, 0]


def _check(z_feat: torch.Tensor, x_feat: torch.Tensor, pad: int) -> tuple[int, ...]:
    if x_feat.dim() != 4:
        raise ValueError(f"x_feat must be (N, H, W, C), got {tuple(x_feat.shape)}")
    N, H, W, C = x_feat.shape
    if z_feat.dim() == 3:
        fh, fw, zc = z_feat.shape
    elif z_feat.dim() == 4 and z_feat.shape[0] == N:
        _, fh, fw, zc = z_feat.shape
    else:
        raise ValueError(f"z_feat must be (fh, fw, C) or ({N}, fh, fw, C), "
                         f"got {tuple(z_feat.shape)}")
    oh, ow = H + 2 * pad - fh + 1, W + 2 * pad - fw + 1
    if zc != C or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"no VALID correlation of {tuple(z_feat.shape)} over "
                         f"{tuple(x_feat.shape)} with pad {pad}")
    return N, H, W, C, fh, fw, oh, ow


def depthwise_xcorr_plain(z_feat: torch.Tensor, x_feat: torch.Tensor,
                          pad: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `depthwise_xcorr`, any device."""
    _, _, _, _, fh, fw, oh, ow = _check(z_feat, x_feat, pad)
    x = x_feat.float()
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    z = z_feat.float()
    if z.dim() == 4:
        z = z[:, None, None]                     # (N, 1, 1, fh, fw, C)
    acc = torch.zeros((x.shape[0], oh, ow, x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for a in range(fh):
        for b in range(fw):
            acc = acc + x[:, a:a + oh, b:b + ow, :] * z[..., a, b, :]
    return acc


def _launch(z_feat: torch.Tensor, x_feat: torch.Tensor, pad: int = 0) -> torch.Tensor:
    N, H, W, C, fh, fw, oh, ow = _check(z_feat, x_feat, pad)
    dev = x_feat.device
    if z_feat.device != dev:
        raise ValueError(f"z_feat on {z_feat.device}, x_feat on {dev}")
    if H * W * C >= 2 ** 31:
        raise ValueError(f"one search feature of {H * W * C} elements exceeds 32-bit indexing")
    x = x_feat.detach().float().contiguous()
    z = z_feat.detach().float().contiguous()
    out = torch.empty((N, oh, ow, C), dtype=torch.float32, device=dev)
    load_library().launch(
        "mmt_depthwise_xcorr", x.data_ptr(), z.data_ptr(), out.data_ptr(), N, H, W, C, fh,
        fw, pad, int(z.dim() == 4), stream_handle(dev))
    profiling.count("launches.depthwise_xcorr")
    return out


def depthwise_xcorr(z_feat: torch.Tensor, x_feat: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Per-channel VALID correlation of x_feat, zero-padded by `pad` on each
    spatial side, with z_feat.

    z_feat (fh, fw, C) shared or (N, fh, fw, C) per sample; x_feat
    (N, H, W, C) -> (N, H + 2 pad - fh + 1, W + 2 pad - fw + 1, C) f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. Under autograd the gradient is the plain version's.
    """
    if x_feat.device.type == "cpu":
        return depthwise_xcorr_plain(z_feat, x_feat, pad)
    return launch_with_plain_grad(_launch, depthwise_xcorr_plain, (z_feat, x_feat), pad=pad)

