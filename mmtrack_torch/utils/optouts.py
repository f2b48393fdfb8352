"""The serving opt-outs of the JAX package, mapped to the port's own
switches.

The JAX package reads three variables wherever its layers and its crop
run. The port's modules read no environment: a model picks its kernels
when it is built (`models/vipt.py::build_viptrack(use_kernels=, fuse=)`)
and a tracking loop its crop when it is made (`crop=` of
`trackers/vipt_tracker.py::make_track_scan` and `vipt_init_state`). Only
`kernels/ab_kernels.py`, the A/B tool that JAX drives through them, reads
the variables, with JAX's values so that a JAX command line works there
unchanged, and maps them here to those arguments. Every other entry point
of the port, and chip_smoke.py, refuses to start with any of them set
(`refuse`): no run takes a kernel off its path without saying so.

  MMTRACK_ATTN  fused (default) | xla. `xla`: the plain `flash_mhsa_qkv`
                and JAX's unfused layers in place of both half-block
                kernels (mmtrack_tpu/models/layers.py:127-131, :252-256):
                use_kernels=False, fuse=False.
  MMTRACK_MLP   fused (default) | xla. `xla`: the unfused layers, with
                `flash_mhsa_qkv` on its kernel: fuse=False.
  MMTRACK_CROP  unset | gather | pallas. `gather`: the plain crop on any
                device (plain_crop=True); `pallas`: the crop kernel, which
                is what unset gives on the card, and which a CPU device
                cannot run (it raises); `mxu` is on ROADMAP.md's "Do not
                port" list and raises (mmtrack_tpu/ops/crop.py:141-166).

On the port `xla` means "the plain PyTorch version". Any other value
raises and names the variable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

ATTN, MLP, CROP = "MMTRACK_ATTN", "MMTRACK_MLP", "MMTRACK_CROP"
VALUES = {ATTN: ("fused", "xla"), MLP: ("fused", "xla"), CROP: ("gather", "pallas", "mxu")}


@dataclass(frozen=True)
class OptOuts:
    """The port's switches for one choice of JAX's opt-outs: `use_kernels`
    (the attention kernel and, when fused, the half-block kernels), `fuse`
    (the half-blocks at all; False runs JAX's unfused layers) and
    `plain_crop`."""
    use_kernels: bool = True
    fuse: bool = True
    plain_crop: bool = False

    def model_kwargs(self) -> dict:
        return {"use_kernels": self.use_kernels, "fuse": self.fuse}


def resolve(attn: str | None = None, mlp: str | None = None, crop: str | None = None,
            device=None) -> OptOuts:
    """The switches for JAX's values (None: unset). A value outside
    VALUES raises ValueError naming its variable, and so do `mxu` and
    `pallas` for a CPU `device`."""
    for name, value in ((ATTN, attn), (MLP, mlp), (CROP, crop)):
        if value is not None and value not in VALUES[name]:
            raise ValueError(f"{name}={value!r}: expected one of {', '.join(VALUES[name])}")
    if crop == "mxu":
        raise ValueError("MMTRACK_CROP=mxu: the TPU's separable crop is not ported (ROADMAP.md, "
                         "'Do not port'); use gather or pallas")
    if crop == "pallas" and device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"MMTRACK_CROP=pallas launches the crop kernel, which needs a CUDA "
                         f"device; got {device}")
    plain_attn = attn == "xla"
    return OptOuts(use_kernels=not plain_attn, fuse=not plain_attn and mlp != "xla",
                   plain_crop=crop == "gather")


def set_names() -> list[str]:
    """The opt-outs set in the environment, whatever their values."""
    return [name for name in VALUES if name in os.environ]


def refuse(entry: str) -> None:
    """Raise SystemExit when an opt-out is set: `entry` runs the hand
    kernels and honours none of them."""
    names = set_names()
    if names:
        raise SystemExit(f"{entry}: unset {', '.join(names)}; it runs the hand kernels and "
                         f"honours no opt-out (only `python -m mmtrack_torch.kernels.ab_kernels` "
                         f"reads them: mmtrack_torch/utils/optouts.py)")
