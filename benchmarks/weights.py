"""Random weights from a run's seed, made on the device in one draw.

Every parameter of the reference's list (`reference/vipt.py::
param_shapes`) is a slice of one normal draw on the device, scaled by its
kind; the same dict is loaded into the program by name and handed to the
reference unchanged. What the draws stand for is in each configuration's
`assumed`.

Candidate elimination is then given a decisive vote (`ce_vote`), as a
trained tracker's is: with plain random weights the template centre
attends almost evenly to every search token, and rounding decides which
tokens it keeps. Each search position is given a level (a random
permutation of the positions, cut by the keep schedule: the tokens that
the first elimination drops are level 0, the ones kept to the end level
3), its position embedding gains `level_scale` x level along a random unit
direction e, the template centre's gains `center_scale` along a direction
f orthogonal to e, and in each eliminating block every head's query gains
`qk_scale` x u_h f^T and its key `qk_scale` x u_h e^T (u_h a random unit
vector of the head). The centre's vote then ranks the levels far apart,
and within a level nothing is decided.
"""

from __future__ import annotations

import math

import torch

from benchmarks.reference import vipt as ref
from benchmarks.seeds import generator

SIZE_WEIGHT_SCALE = 0.25


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = ref.param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    size_bias = math.log(1.0 / (cfg["search"]["factor"] - 1.0))   # logit(1 / factor)
    params, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if "pos_embed" in name:
            p = (0.02 * v).clamp(-0.04, 0.04)
        elif name.endswith("fovea.smooth"):
            p = torch.full(shape, 10.0, device=device)
        elif name.endswith("running_var"):
            p = torch.exp(0.1 * v)
        elif name.endswith("running_mean"):
            p = 0.1 * v
        elif name == "box_head.conv5_size.bias":
            p = torch.full(shape, size_bias, device=device)
        elif len(shape) == 1 and name.endswith(".weight"):
            p = 1.0 + 0.1 * v
        elif len(shape) == 1:
            p = 0.02 * v
        else:
            p = v / math.sqrt(math.prod(shape[1:]))
            if name == "box_head.conv5_size.weight":
                p = p * SIZE_WEIGHT_SCALE
        params[name] = p.contiguous()
    del flat
    if "ce_vote" in cfg:
        _ce_vote(cfg, params, seed, device)
    return params


def _ce_vote(cfg: dict, params: dict, seed: int, device) -> None:
    v = cfg["ce_vote"]
    g = generator(seed, "ce_vote", device)
    geo = ref.geometry(cfg)
    C, heads = cfg["model"]["embed_dim"], cfg["model"]["num_heads"]
    D = C // heads
    counts = [geo["lens_x"]] + geo["kept"]
    order = torch.randperm(geo["lens_x"], generator=g, device=device)
    level = torch.empty(geo["lens_x"], device=device)
    start = 0
    for lev, n in enumerate([a - b for a, b in zip(counts, counts[1:])] + [counts[-1]]):
        level[order[start:start + n]] = float(lev)
        start += n
    e = torch.randn(C, generator=g, device=device)
    e = e / e.norm()
    f = torch.randn(C, generator=g, device=device)
    f = f - (f @ e) * e
    f = f / f.norm()
    params["backbone.pos_embed_x"][0] += v["level_scale"] * level[:, None] * e[None]
    centre = (geo["feat_z"] - 1) // 2 * (geo["feat_z"] + 1)
    params["backbone.pos_embed_z"][0, centre] += v["center_scale"] * f
    for i in cfg["ce"]["loc"]:
        w = params[f"backbone.blocks.{i}.attn.qkv.weight"]
        u = torch.randn(heads, D, generator=g, device=device)
        u = (u / u.norm(dim=1, keepdim=True)).reshape(C, 1)
        w[:C] += v["qk_scale"] * u * f[None]
        w[C:2 * C] += v["qk_scale"] * u * e[None]
