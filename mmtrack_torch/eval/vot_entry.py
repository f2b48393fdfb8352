"""VOT toolkit entry of the port: `python -m mmtrack_torch.eval.vot_entry`,
launched by `vot evaluate` per sequence through a trackers.ini stanza with
`protocol = trax` and `command = python -m mmtrack_torch.eval.vot_entry`
(README.md). It speaks TraX over stdin/stdout and starts a session only
when run as a program: importing the module answers nothing.

Environment (the same variables as tools/run_vot_entry.py, plus the device):

  MMTRACK_TRACKER   recipe of mmtrack_torch/registry.py, any of
                    list_trackers() (default vipt_deep_rgbd)
  MMTRACK_DTYPE     frame composition (default: the recipe's, rgbcolormap)
  MMTRACK_CHANNELS  TraX image channels: rgbd (colour, depth) or rgbt
                    (colour, ir); default rgbd
  MMTRACK_MASK      1: the VOT2020+ mask protocol. The mask trackers (lwl,
                    stm) get the init mask verbatim and report their own
                    masks, and Alpha-Refine is never built; the other
                    recipes' masks come from Alpha-Refine
  MMTRACK_AR_CKPT   flax Alpha-Refine variables (.npz, models/convert.py::
                    load_flax_npz); seeded random weights otherwise
  MMTRACK_DEVICE    cuda (default) or cpu

Precision: every model runs in full f32. TF32 is turned off for matrix
products and cuDNN convolutions, so the card computes what the JAX
package's f32 models compute. Without CUDA and with the default device
the entry raises before it answers.
"""

from __future__ import annotations

import os
import sys

import torch

from mmtrack_torch.eval.vot import run_vot_exp
from mmtrack_torch.models.alpha_refine import ARcmSeg, ARRuntime, build_alpha_refine
from mmtrack_torch.models.convert import alpha_refine_state_dict_from_flax, load_flax_npz
from mmtrack_torch.registry import TRACKER_REGISTRY, build_tracker
from mmtrack_torch.utils import optouts
from mmtrack_torch.utils.device import require_cuda, set_f32_precision

AR_INPUT_SIZE = 256


def refiner_factory(device, ckpt: str | None = None, seed: int = 0):
    """() -> ARcmSeg at input size 256: the converted flax file `ckpt`, or
    seeded random weights."""
    def factory():
        sd = alpha_refine_state_dict_from_flax(load_flax_npz(ckpt)) if ckpt else None
        model = build_alpha_refine(AR_INPUT_SIZE, seed=seed, state_dict=sd)
        return ARcmSeg(model, device, ARRuntime(input_size=AR_INPUT_SIZE))
    return factory


def main(fin=None, fout=None) -> int:
    optouts.refuse("mmtrack_torch.eval.vot_entry")
    name = os.environ.get("MMTRACK_TRACKER", "vipt_deep_rgbd")
    recipe = TRACKER_REGISTRY.get(name)
    dtype = os.environ.get("MMTRACK_DTYPE", recipe.composition if recipe else "rgbcolormap")
    channels = os.environ.get("MMTRACK_CHANNELS", "rgbd")
    mask = os.environ.get("MMTRACK_MASK", "0") == "1"
    device = torch.device(os.environ.get("MMTRACK_DEVICE", "cuda"))
    if device.type == "cuda":
        device = require_cuda()
    set_f32_precision()
    refine = refiner_factory(device, os.environ.get("MMTRACK_AR_CKPT")) if mask else None
    run_vot_exp(lambda: build_tracker(name, device=device), channels=channels, dtype=dtype,
                fin=fin, fout=fout, mask=mask, refine_factory=refine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
