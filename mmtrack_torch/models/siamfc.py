"""SiamFC: fully-convolutional Siamese tracker, port of
mmtrack_tpu/models/siamfc.py (:21-78).

An AlexNet-style embedding (VALID convolutions, total stride 8,
FrozenBatchNorm after conv1-4, a bare grouped conv5) maps a 127 x 127
template to 6 x 6 x 256 and a 255 x 255 search crop to 22 x 22 x 256; the
template embedding correlated over the search embedding
(`ops/xcorr.py::xcorr`, an `F.conv2d` as JAX's is an XLA convolution),
times a learned scale plus a bias, is the 17 x 17 score map. The stem
takes 6-channel crops (the RGB-E composition feeds both triplets).

Parameter names follow the flax tree (`embedding.conv1_conv.weight`,
`embedding.conv1_bn.running_mean`, ..., `response_scale`), which
`models/convert.py::siamfc_state_dict_from_flax` carries across. NHWC at
the module boundary; f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.heads import FrozenBatchNorm
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.ops.xcorr import xcorr

# (name, out channels, kernel, stride, groups) of conv1-conv5
_CONVS = (("conv1", 96, 11, 2, 1), ("conv2", 256, 5, 1, 2), ("conv3", 384, 3, 1, 1),
          ("conv4", 384, 3, 1, 2), ("conv5", 256, 3, 1, 2))


class AlexNetEmbed(nn.Module):
    """SiamFC's embedding (siamfc.py:21-49): conv-BN-ReLU x 4 with 3 x 3
    stride-2 max pools after conv1 and conv2, then conv5 alone."""

    def __init__(self, in_channels: int = 6, out_channels: int = 256, device=None):
        super().__init__()
        c = in_channels
        for name, ch, k, s, g in _CONVS:
            ch = out_channels if name == "conv5" else ch
            self.add_module(f"{name}_conv", Conv2d(c, ch, k, stride=s, groups=g, device=device))
            if name != "conv5":
                self.add_module(f"{name}_bn", FrozenBatchNorm(ch, device=device))
            c = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().permute(0, 3, 1, 2)
        for name, *_ in _CONVS[:-1]:
            y = torch.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(y)))
            if name in ("conv1", "conv2"):
                y = F.max_pool2d(y, 3, stride=2)
        return self.conv5_conv(y).permute(0, 2, 3, 1)


class SiamFC(nn.Module):
    """Embedding + correlation with a learned output scale (siamfc.py:52-78).

    forward(template (N, 127, 127, C), search (N, 255, 255, C)) -> (N, 17, 17)
    score maps, sample i's template over sample i's search; the tracker
    calls `embed` and `correlate` itself (the template is embedded once)."""

    def __init__(self, in_channels: int = 6, device=None):
        super().__init__()
        self.embedding = AlexNetEmbed(in_channels, device=device)
        self.response_scale = nn.Parameter(torch.full((1,), 1e-3, device=device))
        self.response_bias = nn.Parameter(torch.zeros(1, device=device))

    def embed(self, im: torch.Tensor) -> torch.Tensor:
        return self.embedding(im)

    def correlate(self, z_feat: torch.Tensor, x_feat: torch.Tensor) -> torch.Tensor:
        """z_feat (fh, fw, C), x_feat (N, H, W, C) -> (N, H', W') scaled scores."""
        return self.response_scale[0] * xcorr(z_feat, x_feat) + self.response_bias[0]

    def forward(self, template: torch.Tensor, search: torch.Tensor) -> torch.Tensor:
        z, x = self.embed(template), self.embed(search)
        return torch.cat([self.correlate(z[i], x[i:i + 1]) for i in range(z.shape[0])])
