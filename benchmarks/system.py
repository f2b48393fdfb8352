"""The system under test: the port's model, runtime and entry points,
built from a configuration file. The only place that names the port's
constructors."""

from __future__ import annotations

import torch


def model(cfg: dict, device, train: bool = False):
    """The port's ViPTrack for `cfg`: the inference dtype, or for training
    the compute dtype over float32 parameters with drop path. Parameters
    are uninitialised: load them with `load`."""
    from mmtrack_torch.models.vipt import ViPTrack, drop_prompt_embed

    m, dt = cfg["model"], cfg["dtype"]
    kw = dict(dtype=getattr(torch, dt["inference"]))
    if train:
        kw = dict(dtype=getattr(torch, dt["train_compute"]),
                  param_dtype=getattr(torch, dt["train_params"]),
                  drop_path_rate=cfg["train"]["drop_path_rate"])
    net = ViPTrack(embed_dim=m["embed_dim"], depth=m["depth"], num_heads=m["num_heads"],
                   template_size=cfg["template"]["size"], search_size=cfg["search"]["size"],
                   patch_size=m["patch_size"], ce_loc=tuple(cfg["ce"]["loc"]),
                   prompt_type=m["prompt_type"], head_channel=m["head_channel"],
                   head_type=m["head_type"], device=device, **kw)
    if m["prompt_type"] == "none":
        drop_prompt_embed(net)
    return net if train else net.eval()


def load(net, params: dict) -> None:
    """The benchmark's weights into the program, by name, all of them."""
    net.load_state_dict(params, strict=True)


def runtime(cfg: dict):
    from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime

    ce = cfg["ce"]
    return ViPTRuntime(template_factor=cfg["template"]["factor"],
                       template_size=cfg["template"]["size"],
                       search_factor=cfg["search"]["factor"],
                       search_size=cfg["search"]["size"], stride=cfg["model"]["patch_size"],
                       margin=cfg["runtime"]["margin"], ce_template_range=ce["template_range"],
                       ce_loc=tuple(ce["loc"]), ce_keep_ratio=tuple(ce["keep_ratio"]))


def load_kernels() -> None:
    """Build (first run in a checkout) or load the program's kernel library."""
    from mmtrack_torch.kernels.build import load_library

    load_library()
