"""Tracker recipes the port can build: one name -> (build, modality,
composition), port of mmtrack_tpu/registry.py (:19-44, :378-383; the ViPT
family so far).

`build(seed, params, device)` returns a tracker with the reference
BaseTracker API (initialize / track). Weights are seeded random
(`models/vipt.py::init_weights`) unless `params` gives a state_dict (for
instance `models/convert.py::vipt_state_dict_from_flax` of a JAX tree).
Models are f32, as the JAX registry builds them. Entry points run on the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from mmtrack_torch.config import vipt_experiment_config


@dataclass
class TrackerRecipe:
    build: Callable      # (seed, params, device) -> tracker object
    modality: str        # rgbd | rgbt | rgbe
    family: str
    # frame composition the recipe expects (data/composition.py X_DTYPES)
    composition: str = "rgbcolormap"


def _vipt(config_name: str) -> Callable:
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.vipt import build_viptrack
        from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker
        cfg = vipt_experiment_config(config_name)
        model = build_viptrack(cfg, seed=None if params is not None else seed)
        if params is not None:
            model.load_state_dict(params)
        return ViPTTracker(model, device, ViPTRuntime.from_config(cfg))
    return build


TRACKER_REGISTRY: dict[str, TrackerRecipe] = {
    f"vipt_{kind}_{modality}": TrackerRecipe(_vipt(f"{kind}_{modality}"), modality, "vipt")
    for kind in ("deep", "shaw") for modality in ("rgbd", "rgbt", "rgbe")
}


def build_tracker(name: str, seed: int = 0, params: Optional[dict] = None, device="cuda"):
    if name not in TRACKER_REGISTRY:
        raise KeyError(f"unknown tracker '{name}'; options: {sorted(TRACKER_REGISTRY)}")
    return TRACKER_REGISTRY[name].build(seed=seed, params=params, device=device)


def list_trackers(modality: str | None = None) -> list[str]:
    return sorted(n for n, r in TRACKER_REGISTRY.items()
                  if modality is None or r.modality == modality)
