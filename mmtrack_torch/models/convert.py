"""Weight bridge: the JAX package's flax parameters -> the port's state_dict.

Exact inverse of mmtrack_tpu/models/convert.py::convert_vipt_checkpoint
(:43-183, CENTER head): the port's modules use the reference torch names
that converter reads, so the bridge only relabels and re-lays out:

  Dense kernel (I, O)            -> weight (O, I)
  conv kernel (kh, kw, I, O)     -> weight (O, I, kh, kw)
  PromptBlock Dense kernel (I,O) -> 1x1 conv weight (O, I, 1, 1)
  LayerNorm scale                -> weight
  FrozenBatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var

`alpha_refine_state_dict_from_flax` does the same for Alpha-Refine
(mmtrack_tpu/models/alpha_refine.py), with torchvision's ResNet names, and
`load_flax_npz` reads a flax variables file for it.

Works on numpy arrays; no jax or flax import.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf_name(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    p = "/".join(path)
    if m := re.fullmatch(r"backbone/(patch_embed(?:_prompt)?)/proj/(kernel|bias)", p):
        mod, leaf = m.groups()
        if leaf == "kernel":
            return f"backbone.{mod}.proj.weight", value.transpose(3, 2, 0, 1)
        return f"backbone.{mod}.proj.bias", value
    if m := re.fullmatch(r"backbone/(pos_embed_[zx])", p):
        return f"backbone.{m.group(1)}", value
    if m := re.fullmatch(r"backbone/blocks_(\d+)/(norm[12])/(scale|bias)", p):
        i, ln, leaf = m.groups()
        return f"backbone.blocks.{i}.{ln}.{'weight' if leaf == 'scale' else 'bias'}", value
    if m := re.fullmatch(r"backbone/blocks_(\d+)/(attn/qkv|attn/proj|mlp/fc1|mlp/fc2)/"
                         r"(kernel|bias)", p):
        i, mod, leaf = m.groups()
        mod = mod.replace("/", ".")
        if leaf == "kernel":
            return f"backbone.blocks.{i}.{mod}.weight", value.T
        return f"backbone.blocks.{i}.{mod}.bias", value
    if m := re.fullmatch(r"backbone/prompt_blocks_(\d+)/(conv0_0|conv0_1|conv1x1)/"
                         r"(kernel|bias)", p):
        i, conv, leaf = m.groups()
        if leaf == "kernel":
            return f"backbone.prompt_blocks.{i}.{conv}.weight", value.T[:, :, None, None]
        return f"backbone.prompt_blocks.{i}.{conv}.bias", value
    if m := re.fullmatch(r"backbone/prompt_blocks_(\d+)/fovea/smooth", p):
        return f"backbone.prompt_blocks.{m.group(1)}.fovea.smooth", value
    if m := re.fullmatch(r"backbone/(prompt_norms_(\d+)|norm)/(scale|bias)", p):
        mod, i, leaf = m.groups()
        mod = f"prompt_norms.{i}" if i is not None else "norm"
        return f"backbone.{mod}.{'weight' if leaf == 'scale' else 'bias'}", value
    if m := re.fullmatch(r"box_head/(ctr|offset|size)/conv5/(kernel|bias)", p):
        branch, leaf = m.groups()
        if leaf == "kernel":
            return f"box_head.conv5_{branch}.weight", value.transpose(3, 2, 0, 1)
        return f"box_head.conv5_{branch}.bias", value
    if m := re.fullmatch(r"box_head/(ctr|offset|size)/conv([1-4])/(conv|bn)/"
                         r"(kernel|bias|scale|mean|var)", p):
        branch, k, mod, leaf = m.groups()
        base = f"box_head.conv{k}_{branch}"
        if mod == "conv":
            if leaf == "kernel":
                return f"{base}.0.weight", value.transpose(3, 2, 0, 1)
            return f"{base}.0.bias", value
        bn = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}[leaf]
        return f"{base}.1.{bn}", value
    raise KeyError(f"no port counterpart for flax leaf {p}")


def vipt_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a CENTER-head ViPTrack -> the port's
    ViPTrack state_dict (f32 CPU tensors; load_state_dict casts)."""
    out = {}
    for path, value in _flatten(params).items():
        name, v = _leaf_name(path, value)
        out[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _ar_leaf(path: tuple[str, ...], value: np.ndarray):
    """(port name, value) of one AlphaRefineNet flax leaf; None for the
    ResNet stages the port does not build (layer3, layer4)."""
    p = "/".join(path)
    if re.fullmatch(r"backbone/layer[34]_\d+/.*", p):
        return None
    p = re.sub(r"^backbone/layer(\d)_(\d+)/", r"backbone.layer\1.\2.", p)
    p = re.sub(r"downsample_conv/", "downsample.0.", p)
    p = re.sub(r"downsample_bn/", "downsample.1.", p)
    p = re.sub(r"^corner_head/(tl|br)/conv(\d)/conv/", r"corner_head.conv\2_\1.0.", p)
    p = re.sub(r"^corner_head/(tl|br)/conv(\d)/bn/", r"corner_head.conv\2_\1.1.", p)
    p = re.sub(r"^corner_head/(tl|br)/conv5/", r"corner_head.conv5_\1.", p)
    *mod, leaf = p.replace("/", ".").split(".")
    mod = ".".join(mod)
    if leaf == "kernel":
        return f"{mod}.weight", value.transpose(3, 2, 0, 1)
    if leaf in _BN:                       # a conv's bias keeps its name too
        return f"{mod}.{_BN[leaf]}", value
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")


def alpha_refine_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of an AlphaRefineNet -> the port's
    AlphaRefineNet state_dict (f32 CPU tensors). Conv kernels (kh, kw, I, O)
    become (O, I, kh, kw); FrozenBatchNorm scale/bias/mean/var become
    weight/bias/running_mean/running_var; the JAX trunk's layer3/layer4
    leaves, which Alpha-Refine never reads, are left out."""
    out = {}
    for path, value in _flatten(params).items():
        item = _ar_leaf(path, value)
        if item is not None:
            out[item[0]] = torch.from_numpy(np.array(item[1], dtype=np.float32))
    return out


def load_flax_npz(path: str) -> dict:
    """The `params` tree of a flax variables file written with
    `np.savez(path, **variables)`: each top-level collection is one
    pickled tree."""
    with np.load(path, allow_pickle=True) as f:
        return f["params"].item()
