"""The control's precision: operands of every product rounded to fp8.

One step below the configurations' bfloat16 is float8 (e4m3, the format
of an fp8 forward): each operand of a product or convolution is scaled so
that the largest magnitude of each row of its last axis maps to 448,
rounded to float8_e4m3fn and scaled back. Rows are tokens, query and key
rows, and output channels of a linear weight: the finest scaling such a
path uses, so that the control is as close to the program as fp8 gets.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8_e4m3fn, one scale per row of the last axis;
    the gradient passes straight through the rounding."""
    d = x.detach()
    scale = d.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return x + ((d / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale - d)
