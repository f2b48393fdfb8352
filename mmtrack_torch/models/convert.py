"""Weight bridge: the JAX package's flax parameters -> the port's state_dict.

Exact inverse of mmtrack_tpu/models/convert.py::convert_vipt_checkpoint
(:43-183, the CENTER, CORNER and MLP heads): the port's modules use the
reference torch names that converter reads, so the bridge only relabels
and re-lays out:

  Dense kernel (I, O)            -> weight (O, I)
  conv kernel (kh, kw, I, O)     -> weight (O, I, kh, kw)
  PromptBlock Dense kernel (I,O) -> 1x1 conv weight (O, I, 1, 1)
  LayerNorm scale                -> weight
  FrozenBatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var

`alpha_refine_state_dict_from_flax` does the same for Alpha-Refine
(mmtrack_tpu/models/alpha_refine.py), with torchvision's ResNet names, and
`load_flax_npz` reads a flax variables file for it. The zoo's families:

  OSTrack           `vipt_state_dict_from_flax` (a prompt-free tree has no
                    prompt leaves; a 3-channel one no patch_embed_prompt)
  ScoreTransformer  `score_head_state_dict_from_flax`, the inverse of
                    convert_score_head_checkpoint without its `cls_head.`
                    prefix
  STARK / SPT       `stark_state_dict_from_flax`, the inverse of
                    convert_stark_checkpoint (q, k, v Dense leaves are
                    stacked into nn.MultiheadAttention's in_proj)
  SiamFC            `siamfc_state_dict_from_flax` (the port keeps the flax
                    names; the JAX package has no torch converter for it)
  MixFormer         `mixformer_state_dict_from_flax`, the inverse of
                    convert_mixformer_checkpoint
  DiMP / DeT        `dimp_state_dict_from_flax`, the inverse of
                    convert_dimp_checkpoint (the backbones stop at layer3,
                    so the JAX trunks' layer4 leaves are left out); an
                    ATOMNet tree (ResNet-18 trunks, no classifier, the
                    (128, 256) IoUNet) takes the same names; a KYSNet tree
                    (`dimp` and `predictor`) goes to
                    `kys_state_dict_from_flax`, the inverse of
                    convert_kys_checkpoint (the upstream kys.pth names)
  KeepTrack matcher `peak_matching_state_dict_from_flax`, the inverse of
                    convert_peak_matching_checkpoint (the attention's
                    head-major channels back to d-major, batch_stats to
                    the BatchNorm1d running statistics)
  ECO / C-COT       `eco_state_dict_from_flax` (ResNetVGGm1), the inverse
                    of convert_eco_backbone_checkpoint up to layer3
  LWL / STM         `lwl_state_dict_from_flax`: an LWLNet tree (the inverse
                    of convert_lwl_checkpoint; the box encoder, which the
                    converter does not read, under `box_label_encoder.`)
                    or, by `lwl_topology`, an STMNet tree (the inverse of
                    convert_stm_checkpoint; the trunks stop at layer3)
  MDNet family      `mdnet_state_dict_from_flax`: MDNet single / dual and
                    MANet (the inverses of convert_mdnet_checkpoint and
                    convert_manet_checkpoint), APFNet (of
                    convert_apfnet_checkpoint), DAFNet and MaCNet (flax
                    names); fc4's input rows go from the JAX package's HWC
                    conv3 flatten to the port's CHW one, and so do those
                    of VITAL's G (`gnet_state_dict_from_flax`)

Works on numpy arrays; no jax or flax import.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mmtrack_torch.models.apfnet import ATTRIBUTES
from mmtrack_torch.models.peak_matching import HEADS


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
    if m := re.fullmatch(r"box_head/(ctr|offset|size|tl|br)/conv5/(kernel|bias)", p):
        branch, leaf = m.groups()
        if leaf == "kernel":
            return f"box_head.conv5_{branch}.weight", value.transpose(3, 2, 0, 1)
        return f"box_head.conv5_{branch}.bias", value
    if m := re.fullmatch(r"box_head/layers_(\d+)/(kernel|bias)", p):
        i, leaf = m.groups()
        return (f"box_head.layers.{i}.{'weight' if leaf == 'kernel' else 'bias'}",
                value.T if leaf == "kernel" else value)
    if m := re.fullmatch(r"box_head/bn_(\d+)/(scale|bias|mean|var)", p):
        return f"box_head.bn.{m.group(1)}.{_BN[m.group(2)]}", value
    if m := re.fullmatch(r"box_head/(ctr|offset|size|tl|br)/conv([1-4])/(conv|bn)/"
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
    """flax `params['params']` tree of a ViPTrack with any head (CENTER,
    CORNER's `conv{k}_{tl,br}`, MLP's `layers.{i}`) -> the port's ViPTrack
    state_dict (f32 CPU tensors; load_state_dict casts)."""
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


def _tensors(pairs) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in pairs}


def _dense(prefix: str, leaf: str, value: np.ndarray):
    """(name, value) of a flax Dense leaf as a torch Linear's."""
    return (f"{prefix}.weight", value.T) if leaf == "kernel" else (f"{prefix}.bias", value)


def _norm(prefix: str, leaf: str, value: np.ndarray):
    """(name, value) of a flax LayerNorm or FrozenBatchNorm leaf."""
    return f"{prefix}.{_BN[leaf]}", value


def _conv(prefix: str, leaf: str, value: np.ndarray):
    """(name, value) of a flax Conv leaf: kernel (kh, kw, I, O) -> (O, I, kh, kw)."""
    if leaf == "kernel":
        return f"{prefix}.weight", value.transpose(3, 2, 0, 1)
    return f"{prefix}.bias", value


def _score_head_leaf(p: str, value: np.ndarray):
    if m := re.fullmatch(r"cls_proj/(kernel|bias)", p):
        return _dense("cls_proj", m.group(1), value)
    if m := re.fullmatch(r"norm/(scale|bias)", p):
        return _norm("norm", m.group(1), value)
    if m := re.fullmatch(r"score_head_(\d+)/(kernel|bias)", p):
        return _dense(f"score_head.layers.{m.group(1)}", m.group(2), value)
    if m := re.fullmatch(r"blocks_(\d+)/(norm[12])/(scale|bias)", p):
        return _norm(f"blocks.{m.group(1)}.{m.group(2)}", m.group(3), value)
    if m := re.fullmatch(r"blocks_(\d+)/(qkv|proj|fc1|fc2)/(kernel|bias)", p):
        i, mod, leaf = m.groups()
        return _dense(f"blocks.{i}.{'attn' if mod in ('qkv', 'proj') else 'mlp'}.{mod}", leaf,
                      value)
    raise KeyError(f"no port counterpart for flax leaf {p}")


def score_head_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a ScoreTransformer -> the port's
    ScoreTransformer state_dict (the reference's `cls_head.` names without
    the prefix; f32 CPU tensors)."""
    return _tensors(_score_head_leaf("/".join(path), v) for path, v in _flatten(params).items())


def _resnet_leaf(body: str, rest: str, value: np.ndarray):
    """A JAX ResNet leaf under a backbone -> torchvision's name under `body`."""
    rest = re.sub(r"^layer(\d)_(\d+)/", r"layer\1.\2.", rest)
    rest = rest.replace("downsample_conv/", "downsample.0.").replace("downsample_bn/",
                                                                     "downsample.1.")
    *mod, leaf = rest.replace("/", ".").split(".")
    mod = f"{body}.{'.'.join(mod)}"
    return _conv(mod, leaf, value) if leaf == "kernel" else _norm(mod, leaf, value)


def _repvgg_leaf(body: str, rest: str, value: np.ndarray, last: int = 4):
    """A JAX RepVGG leaf -> the reference's name under `body` (repvgg.py:
    `stage0.*`, `stage{s}.{b}.*`; `rbr_dense` / `rbr_1x1` = conv + `bn`,
    `rbr_identity` a BatchNorm's leaves, `rbr_reparam` the deploy conv);
    None for a stage deeper than `last`."""
    m = re.fullmatch(r"stage(\d)(?:_(\d+))?/(.+)", rest)
    if int(m.group(1)) > last:
        return None
    block = f"{body}.stage{m.group(1)}" + (f".{m.group(2)}" if m.group(2) else "")
    sub = m.group(3)
    if m2 := re.fullmatch(r"(dense|one_by_one)/conv/kernel", sub):
        branch = "rbr_dense" if m2.group(1) == "dense" else "rbr_1x1"
        return _conv(f"{block}.{branch}.conv", "kernel", value)
    if m2 := re.fullmatch(r"(dense|one_by_one)/bn_(scale|bias|mean|var)", sub):
        branch = "rbr_dense" if m2.group(1) == "dense" else "rbr_1x1"
        return _norm(f"{block}.{branch}.bn", m2.group(2), value)
    if m2 := re.fullmatch(r"id_(scale|bias|mean|var)", sub):
        return _norm(f"{block}.rbr_identity", m2.group(1), value)
    if m2 := re.fullmatch(r"reparam/(kernel|bias)", sub):
        return _conv(f"{block}.rbr_reparam", m2.group(1), value)
    raise KeyError(f"no port counterpart for RepVGG leaf {rest}")


def _swin_leaf(body: str, rest: str, value: np.ndarray, last: int = 3):
    """A JAX Swin leaf -> the reference's name under `body`
    (swin_transformer.py); None for a stage, merge or tap norm past the
    deepest stage `last` the port builds."""
    if m := re.fullmatch(r"patch_embed/(kernel|bias)", rest):
        return _conv(f"{body}.patch_embed.proj", m.group(1), value)
    if m := re.fullmatch(r"patch_norm/(scale|bias)", rest):
        return _norm(f"{body}.patch_embed.norm", m.group(1), value)
    if m := re.fullmatch(r"out_norm(\d)/(scale|bias)", rest):
        return _norm(f"{body}.norm{m.group(1)}", m.group(2), value) if int(
            m.group(1)) <= last else None
    if m := re.fullmatch(r"merge(\d)/(norm|reduction)/(\w+)", rest):
        s, mod, leaf = m.groups()
        if int(s) >= last:
            return None
        base = f"{body}.layers.{s}.downsample.{mod}"
        return _dense(base, leaf, value) if mod == "reduction" else _norm(base, leaf, value)
    m = re.fullmatch(r"stage(\d)_(\d+)/(.+)", rest)
    if int(m.group(1)) > last:
        return None
    base = f"{body}.layers.{m.group(1)}.blocks.{m.group(2)}"
    sub = m.group(3)
    if sub == "attn/relative_position_bias_table":
        return f"{base}.attn.relative_position_bias_table", value.T
    if m2 := re.fullmatch(r"(norm[12])/(scale|bias)", sub):
        return _norm(f"{base}.{m2.group(1)}", m2.group(2), value)
    if m2 := re.fullmatch(r"(attn/qkv|attn/proj|mlp_fc1|mlp_fc2)/(kernel|bias)", sub):
        mod = m2.group(1).replace("/", ".").replace("mlp_", "mlp.")
        return _dense(f"{base}.{mod}", m2.group(2), value)
    raise KeyError(f"no port counterpart for Swin leaf {rest}")


_SWIN = re.compile(r"patch_embed/|patch_norm/|merge\d/|out_norm\d/|stage\d_\d+/"
                   r"(norm[12]|attn|mlp_fc[12])/")
_REPVGG = re.compile(r"stage\d(_\d+)?/(dense|one_by_one|reparam|id_)")


def _stark_trunk_leaf(body: str, rest: str, value: np.ndarray):
    """A leaf of STARK's Swin, RepVGG or ResNet trunk (told apart by its
    path); the Swin and RepVGG trunks stop at their stride-16 taps, Swin's
    stage2 and RepVGG's stage3."""
    if _SWIN.match(rest):
        return _swin_leaf(body, rest, value, last=2)
    if _REPVGG.match(rest):
        return _repvgg_leaf(body, rest, value, last=3)
    return _resnet_leaf(body, rest, value)


def repvgg_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a RepVGG (three-branch or deploy) ->
    the port's RepVGG state_dict (the reference's names, f32 CPU tensors)."""
    pairs = (_repvgg_leaf("", "/".join(k), v) for k, v in _flatten(params).items())
    return _tensors((name[1:], v) for name, v in pairs)


def swin_state_dict_from_flax(params: dict, last_stage: int = 3) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a SwinTransformer -> the port's
    SwinTransformer state_dict built to `last_stage` (deeper leaves left
    out; the reference's names, f32 CPU tensors)."""
    pairs = (_swin_leaf("", "/".join(k), v, last_stage) for k, v in _flatten(params).items())
    return _tensors((p[0][1:], p[1]) for p in pairs if p is not None)


def mobilenet_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a MobileNetV3 -> the port's
    MobileNetV3 state_dict (the flax names: `layer{s}_{b}` as
    `layer{s}.{b}`, `se/fc{1,2}` as `se.fc{1,2}`; f32 CPU tensors)."""
    out = []
    for path, value in _flatten(params).items():
        *mod, leaf = path
        mod = re.sub(r"^layer(\d)_(\d+)/", r"layer\1.\2/", "/".join(mod)).replace("/", ".")
        if mod.endswith(("se.fc1", "se.fc2")):
            out.append(_dense(mod, leaf, value))
        elif leaf in ("kernel", "bias") and not mod.endswith("_bn"):
            out.append(_conv(mod, leaf, value))
        else:
            out.append(_norm(mod, leaf, value))
    return _tensors(out)


def attention_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of an Attention (rpe or not) or an
    AttentionTalkingHead -> the port's state_dict: `qkv` and `proj` Dense,
    the (heads, buckets) `relative_position_bias_table` as it is, and the
    head-mixing `proj_l` / `proj_w` (an (in, out) kernel) as Linear
    weights."""
    out = []
    for path, value in _flatten(params).items():
        p = "/".join(path)
        if m := re.fullmatch(r"(qkv|proj)/(kernel|bias)", p):
            out.append(_dense(m.group(1), m.group(2), value))
        elif p == "relative_position_bias_table":
            out.append((p, value))
        elif m := re.fullmatch(r"(proj_[lw])(_bias)?", p):
            out.append((f"{m.group(1)}.bias", value) if m.group(2)
                       else (f"{m.group(1)}.weight", value.T))
        else:
            raise KeyError(f"no port counterpart for flax leaf {p}")
    return _tensors(out)


def _corner_head_leaf(p: str, value: np.ndarray):
    m = re.fullmatch(r"box_head/(tl|br)/conv(\d)/(?:(conv|bn)/)?(\w+)", p)
    if not m:
        return None
    branch, k, mod, leaf = m.groups()
    base = f"box_head.conv{k}_{branch}"
    if mod is None:                                        # conv5: a bare conv
        return _conv(base, leaf, value)
    return _conv(f"{base}.0", leaf, value) if mod == "conv" else _norm(f"{base}.1", leaf, value)


def stark_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a STARK (S, ST or SPT) -> the port's
    STARK state_dict, named as the reference's (f32 CPU tensors). A tree
    with `backbone_x` is SPT: its trunks become `backbone_color` /
    `backbone_depth` and its encoders `encoder_color` / `encoder_depth` /
    `fusion`. The trunks are ResNet-50, RepVGG-A0 or Swin-T, told apart by
    their leaves; the RepVGG and Swin stages past the stride-16 tap, which
    the JAX trunk runs and STARK never reads, are left out."""
    flat = {"/".join(k): v for k, v in _flatten(params).items()}
    spt = any(k.startswith("backbone_x/") for k in flat)
    suffix = "_color" if spt else ""
    backbones = {"backbone": f"backbone{suffix}.0.body", "backbone_x": "backbone_depth.0.body"}
    bottlenecks = {"bottleneck": f"bottleneck{suffix}", "bottleneck_x": "bottleneck_depth"}
    encoders = {"enc": f"transformer.encoder{suffix}.layers",
                "enc_d": "transformer.encoder_depth.layers",
                "fus": "transformer.fusion.layers", "dec": "transformer.decoder.layers"}
    out, qkv = [], {}
    for p, value in flat.items():
        top, _, rest = p.partition("/")
        if top in backbones:
            if (item := _stark_trunk_leaf(backbones[top], rest, value)) is not None:
                out.append(item)
        elif top in bottlenecks:
            out.append(_conv(bottlenecks[top], rest, value))
        elif top == "query_embed":
            out.append(("query_embed.weight", value))
        elif top == "neck":
            out.append(("transformer.neck.weight", value.T[:, :, None]) if rest == "kernel"
                       else ("transformer.neck.bias", value))
        elif top == "dec_norm":
            out.append(_norm("transformer.decoder.norm", rest, value))
        elif m := re.fullmatch(r"cls_(\d)", top):
            out.append(_dense(f"cls_head.layers.{m.group(1)}", rest, value))
        elif top == "box_head" and (item := _corner_head_leaf(p, value)) is not None:
            out.append(item)
        elif m := re.fullmatch(r"(enc_d|enc|fus|dec)_(\d+)", top):
            base = f"{encoders[m.group(1)]}.{m.group(2)}"
            if m2 := re.fullmatch(r"(self_attn|cross_attn)/(q|k|v|proj)/(kernel|bias)", rest):
                attn, part, leaf = m2.groups()
                attn = f"{base}.{'multihead_attn' if attn == 'cross_attn' else 'self_attn'}"
                if part == "proj":
                    out.append(_dense(f"{attn}.out_proj", leaf, value))
                else:
                    qkv.setdefault((attn, leaf), {})[part] = value.T if leaf == "kernel" else value
            elif m2 := re.fullmatch(r"(linear[12])/(kernel|bias)", rest):
                out.append(_dense(f"{base}.{m2.group(1)}", m2.group(2), value))
            elif m2 := re.fullmatch(r"(norm[123])/(scale|bias)", rest):
                out.append(_norm(f"{base}.{m2.group(1)}", m2.group(2), value))
            else:
                raise KeyError(f"no port counterpart for flax leaf {p}")
        else:
            raise KeyError(f"no port counterpart for flax leaf {p}")
    for (attn, leaf), parts in qkv.items():
        name = f"{attn}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
        out.append((name, np.concatenate([parts["q"], parts["k"], parts["v"]], axis=0)))
    return _tensors(out)


def siamfc_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a SiamFC -> the port's SiamFC
    state_dict (the flax names, f32 CPU tensors)."""
    out = []
    for path, value in _flatten(params).items():
        p = "/".join(path)
        if p in ("response_scale", "response_bias"):
            out.append((p, value))
        elif m := re.fullmatch(r"embedding/(conv\d_conv)/(kernel|bias)", p):
            out.append(_conv(f"embedding.{m.group(1)}", m.group(2), value))
        elif m := re.fullmatch(r"embedding/(conv\d_bn)/(scale|bias|mean|var)", p):
            out.append(_norm(f"embedding.{m.group(1)}", m.group(2), value))
        else:
            raise KeyError(f"no port counterpart for flax leaf {p}")
    return _tensors(out)


def _mixformer_leaf(p: str, value: np.ndarray):
    """(port name, value) of one MixFormer flax leaf: the path's module
    names become the reference's (`blocks_{j}` -> `blocks.{j}`, the score
    branch's `{mod}_{i}` -> `{mod}.{i}`, `score_head_{i}` ->
    `score_head.layers.{i}`)."""
    if p == "score_branch/score_token":
        return "score_branch.score_token", value
    if p.startswith("box_head/"):
        item = _corner_head_leaf(p, value)
        if item is None:
            raise KeyError(f"no port counterpart for flax leaf {p}")
        return item
    q = re.sub(r"/blocks_(\d+)/", r"/blocks.\1/", p)
    q = re.sub(r"^score_branch/score_head_(\d)/", r"score_branch/score_head/layers.\1/", q)
    q = re.sub(r"^score_branch/(norm2|proj_[qkv]|proj)_(\d)/", r"score_branch/\1.\2/", q)
    if not re.fullmatch(r"(backbone(_depth)?/stage\d/[\w./]+|score_branch/[\w./]+)", q):
        raise KeyError(f"no port counterpart for flax leaf {p}")
    mod, _, leaf = q.replace("/", ".").rpartition(".")
    if leaf == "kernel":
        return _conv(mod, leaf, value) if value.ndim == 4 else _dense(mod, leaf, value)
    return _norm(mod, leaf, value)


def mixformer_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a MixFormer (3 or 6 channels) -> the
    port's MixFormer state_dict, named as the reference's (f32 CPU
    tensors); the inverse of convert_mixformer_checkpoint."""
    return _tensors(_mixformer_leaf("/".join(path), v) for path, v in _flatten(params).items())


# the IoUNet's LinearBlocks and the side of the pooled map they flatten
_DIMP_LINEAR_POOL = {"fc3_rt": 5, "fc4_rt": 3}
_DIMP_BIN_KERNELS = {"label_map_kernel": "label_map_predictor.weight",
                     "target_mask_kernel": "target_mask_predictor.0.weight",
                     "spatial_weight_kernel": "spatial_weight_predictor.weight"}


def _dimp_leaf(p: str, value: np.ndarray, hinge: bool):
    """(port name, value) of one DiMPNet flax leaf; None for a trunk's
    layer4, which the port's backbones do not build."""
    top, _, rest = p.partition("/")
    if top in ("backbone", "backbone_x"):
        if rest.startswith("layer4_"):
            return None
        body = "feature_extractor" if top == "backbone" else "feature_extractor_depth"
        return _resnet_leaf(body, rest, value)
    if m := re.fullmatch(r"merge_conv(\d)", top):
        return _conv(f"merge_layer{m.group(1)}", rest, value)
    if p == "clf_features/final_conv/kernel":
        return _conv("classifier.feature_extractor.0", "kernel", value)
    if m := re.fullmatch(r"filter_initializer/filter_conv/(kernel|bias)", p):
        return _conv("classifier.filter_initializer.filter_conv", m.group(1), value)
    if top == "filter_optimizer":
        opt = "classifier.filter_optimizer"
        if rest in _DIMP_BIN_KERNELS:
            return f"{opt}.{_DIMP_BIN_KERNELS[rest]}", value.reshape(1, -1, 1, 1)
        if rest == "filter_reg" and hinge:
            return f"{opt}.residual_module.filter_reg", value.reshape(1)
        if rest in ("log_step_length", "filter_reg"):
            return f"{opt}.{rest}", value.reshape(1)
    if top == "bb_regressor":
        mod, _, sub = rest.partition("/")
        base = f"bb_regressor.{mod}"
        if mod == "iou_predictor":
            return _dense(base, sub, value)
        if mod in _DIMP_LINEAR_POOL and sub == "linear/kernel":
            # (sz * sz * C, O) over the NHWC flatten -> (O, C * sz * sz) over CHW
            sz = _DIMP_LINEAR_POOL[mod]
            o = value.shape[1]
            w = value.T.reshape(o, sz, sz, -1).transpose(0, 3, 1, 2).reshape(o, -1)
            return f"{base}.linear.weight", w
        if m := re.fullmatch(r"(conv|linear|bn)/(\w+)", sub):
            kind, leaf = m.groups()
            if kind == "bn":
                return _norm(f"{base}.{'bn' if mod in _DIMP_LINEAR_POOL else '1'}", leaf, value)
            if kind == "linear":
                return _dense(f"{base}.linear", leaf, value)
            return _conv(f"{base}.0", leaf, value)
    raise KeyError(f"no port counterpart for flax leaf {p}")


def dimp_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a DiMPNet (DiMP-50, DeT with any
    merge, PrDiMP or super_dimp) -> the port's DiMPNet state_dict, named
    as the reference's (f32 CPU tensors); the inverse of
    convert_dimp_checkpoint. A filter optimizer without `log_step_length`
    is the hinge's, whose regularisation sits under `residual_module`. A
    KYSNet tree (a `dimp` and a `predictor` subtree, the same family) goes
    to `kys_state_dict_from_flax`."""
    if "predictor" in params:
        return kys_state_dict_from_flax(params)
    flat = {"/".join(k): v for k, v in _flatten(params).items()}
    hinge = "filter_optimizer/log_step_length" not in flat
    return _tensors(item for p, v in flat.items()
                    if (item := _dimp_leaf(p, v, hinge)) is not None)


# KYSNet's DiMP modules under the upstream kys.pth names
_KYS_BASE = {"feature_extractor.": "backbone_feature_extractor.",
             "classifier.": "dimp_classifier."}


def kys_base_from_dimp(state_dict: dict) -> dict:
    """A DiMPNet state_dict under KYSNet's upstream names of its DiMP base
    (`feature_extractor.` -> `backbone_feature_extractor.`, `classifier.`
    -> `dimp_classifier.`, `bb_regressor.` as it is)."""
    out = {}
    for k, v in state_dict.items():
        pre = next((p for p in _KYS_BASE if k.startswith(p)), None)
        out[_KYS_BASE[pre] + k[len(pre):] if pre else k] = v
    return out


def _kys_predictor_leaf(p: str, value: np.ndarray):
    """(port name, value) of one ResponsePredictor flax leaf: the conv
    blocks' `conv` / `bn` as the Sequential children `.0` / `.1`."""
    pre = "predictor.predictor."
    if m := re.fullmatch(r"state_predictor/(conv_reset|conv_update|conv_state_new)/(\w+)", p):
        return _conv(f"{pre}state_predictor.{m.group(1)}", m.group(2), value)
    m = re.fullmatch(r"(cost_volume_proc[12]|representation_predictor|is_target_predictor)_(\d+)"
                     r"/(conv|bn)/(\w+)", p)
    if m:
        mod, i, kind, leaf = m.groups()
    elif m := re.fullmatch(r"(response_predictor|init_hidden_state_predictor)/(conv|bn)/(\w+)",
                           p):
        (mod, kind, leaf), i = m.groups(), "0"
    else:
        raise KeyError(f"no port counterpart for flax leaf predictor/{p}")
    base = f"{pre}{mod}.{i}"
    return _conv(f"{base}.0", leaf, value) if kind == "conv" else _norm(f"{base}.1", leaf, value)


def kys_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a KYSNet ({'dimp', 'predictor'}) ->
    the port's KYSNet state_dict, named as the upstream kys.pth (f32 CPU
    tensors); the inverse of convert_kys_checkpoint. The DiMP base goes
    through `dimp_state_dict_from_flax` and is renamed."""
    out = kys_base_from_dimp(dimp_state_dict_from_flax(params["dimp"]))
    out.update(_tensors(_kys_predictor_leaf("/".join(path), v)
                        for path, v in _flatten(params["predictor"]).items()))
    return out


def _head_perm(dim: int) -> np.ndarray:
    """perm[c'] = the d-major channel (d * HEADS + h) of the head-major
    channel c' = h * head_dim + d."""
    hd = dim // HEADS
    return np.asarray([(c % hd) * HEADS + c // hd for c in range(dim)])


def _mlp_leaf(prefix: str, p: str, value: np.ndarray):
    """A flax MLPBlock leaf `lin{j}/...` or `bn{j}/...` -> the Conv1d
    (child 3j) or BatchNorm1d (child 3j + 1) of the port's MLP."""
    m = re.fullmatch(r"(lin|bn)(\d+)/(\w+)", p)
    kind, j, leaf = m.group(1), int(m.group(2)), m.group(3)
    if kind == "lin":
        return _dense_1d(f"{prefix}.{3 * j}", leaf, value)
    return _norm(f"{prefix}.{3 * j + 1}", leaf, value)


def _matcher_leaf(p: str, value: np.ndarray):
    """(port name, value) of one PeakMatcher flax leaf (params or
    batch_stats). The attention's q / k / v outputs and merge inputs go
    from flax's head-major channels to the port's d-major ones."""
    if p == "bin_score":
        return "matcher.bin_score", value
    if m := re.fullmatch(r"final_proj/(kernel|bias)", p):
        return _dense_1d("matcher.final_proj", m.group(1), value)
    if m := re.fullmatch(r"kenc/encoder/(.+)", p):
        return _mlp_leaf("matcher.kenc.encoder", m.group(1), value)
    m = re.fullmatch(r"gnn/layer(\d+)/(attn|mlp)/(.+)", p)
    base = f"matcher.gnn.layers.{m.group(1)}.update"
    if m.group(2) == "mlp":
        return _mlp_leaf(f"{base}.mlp", m.group(3), value)
    mod, leaf = m.group(3).split("/")
    if mod == "merge":
        name, v = _dense_1d(f"{base}.attn.merge", leaf, value)
        # its inputs are the heads' channels; a bias is per output
        return name, v[:, np.argsort(_head_perm(v.shape[1]))] if leaf == "kernel" else v
    name, v = _dense_1d(f"{base}.attn.proj.{'qkv'.index(mod[-1])}", leaf, value)
    return name, v[np.argsort(_head_perm(v.shape[0]))]


def _dense_1d(prefix: str, leaf: str, value: np.ndarray):
    """(name, value) of a flax Dense leaf as a k=1 Conv1d's."""
    return (f"{prefix}.weight", value.T[:, :, None]) if leaf == "kernel" \
        else (f"{prefix}.bias", value)


def peak_matching_state_dict_from_flax(trees: dict) -> dict[str, torch.Tensor]:
    """KeepTrack's matcher trees {'desc': {'params'}, 'matcher': {'params',
    'batch_stats'}} -> the port's PeakMatchingNetwork state_dict (f32 CPU
    tensors), named as the reference's; the inverse of
    convert_peak_matching_checkpoint. The batch statistics become the
    BatchNorm1d running statistics."""
    pairs = [_conv("descriptor_extractor.conv", path[-1], v)
             for path, v in _flatten(trees["desc"]["params"]).items()]
    for coll in ("params", "batch_stats"):
        pairs += [_matcher_leaf("/".join(path), v)
                  for path, v in _flatten(trees["matcher"].get(coll, {})).items()]
    return _tensors(pairs)


def _eco_leaf(p: str, value: np.ndarray):
    """(port name, value) of one ResNetVGGm1 flax leaf; None for layer4,
    which the port's trunk does not build."""
    if p.startswith("layer4_"):
        return None
    if m := re.fullmatch(r"vggmconv1/(kernel|bias)", p):
        return _conv("vggmconv1", m.group(1), value)
    name, v = _resnet_leaf("net", p, value)
    return name[len("net."):], v


def eco_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of a ResNetVGGm1 (ECO's and C-COT's
    feature net) -> the port's state_dict, named as the reference's
    resnet18_vggmconv1 (f32 CPU tensors); the inverse of
    convert_eco_backbone_checkpoint up to layer3."""
    return _tensors(item for path, v in _flatten(params).items()
                    if (item := _eco_leaf("/".join(path), v)) is not None)


def _hwc_rows_to_chw(kernel: np.ndarray, blocks: tuple[int, ...], hw: int = 3) -> np.ndarray:
    """A Dense kernel (I, O) whose leading input rows are HWC flattens of
    hw x hw maps of `blocks` channels each -> the Linear weight (O, I) with
    those rows in CHW order; the remaining rows keep theirs."""
    parts, off = [], 0
    for C in blocks:
        n = hw * hw * C
        parts.append(kernel[off:off + n].reshape(hw, hw, C, -1).transpose(2, 0, 1, 3)
                     .reshape(n, -1))
        off += n
    return np.concatenate(parts + [kernel[off:]]).T


_APF_ROLES = {"enc_vis": "encoder1", "enc_inf": "encoder2", "enc_agg": "encoder3",
              "dec_vis": "decoder1", "dec_inf": "decoder2"}


def _mdnet_fc_leaf(p: str, value: np.ndarray, fc: dict, blocks: tuple[int, ...]):
    """fc4 / fc5 / fc6 leaves under the port names of `fc` (layer -> module)."""
    if m := re.fullmatch(r"fc4/(kernel|bias)", p):
        if m.group(1) == "kernel":
            return f"{fc['fc4']}.weight", _hwc_rows_to_chw(value, blocks)
        return f"{fc['fc4']}.bias", value
    if m := re.fullmatch(r"(fc5|fc6)/(kernel|bias)", p):
        return _dense(fc[m.group(1)], m.group(2), value)
    if m := re.fullmatch(r"fc6_(\d+)/(kernel|bias)", p):
        return _dense(f"branches.{m.group(1)}.1", m.group(2), value)
    return None


def _mdnet_leaf(p: str, value: np.ndarray, topology: str):
    """(port name, value) of one flax leaf of an MDNet-family model."""
    fc = {"mdnet": {"fc4": "layers.fc4.0", "fc5": "layers.fc5.1"},
          "manet": {"fc4": "layers.fc4.1", "fc5": "layers.fc5.1"},
          "apfnet": {"fc4": "fc.fc4.0", "fc5": "fc.fc5.1"}}.get(
              topology, {"fc4": "fc4", "fc5": "fc5", "fc6": "fc6"})
    blocks = {"mdnet": (512,), "dafnet": (512,), "macnet": (512, 512)}.get(topology, (1024,))
    if (item := _mdnet_fc_leaf(p, value, fc, blocks)) is not None:
        return item
    if m := re.fullmatch(r"(features|layers_[vi])/(conv\d)/(kernel|bias)", p):
        trunk, conv, leaf = m.groups()
        return _conv(f"{'layers' if trunk == 'features' else trunk}.{conv}.0", leaf, value)
    if m := re.fullmatch(r"adapt(\d)_(rgb|x)/(conv|bn)/(\w+)", p):
        s, stream, part, leaf = m.groups()
        k = 3 if s == "1" else 1
        tag = "RGB" if stream == "rgb" else "T"
        mod = f"{tag}_para{s}_{k}x{k}.{tag[0]}conv{s}"
        return _conv(f"{mod}.0", leaf, value) if part == "conv" else _norm(f"{mod}.2", leaf, value)
    if m := re.fullmatch(r"attr(\d)_(\w+)/(conv\d|sk_fc\d)/(kernel|bias)", p):
        st, attr, part, leaf = m.groups()
        s, a = int(st) + 1, ATTRIBUTES.index(attr)
        if part.startswith("conv"):
            return _conv(f"parallel{s}.{a}.parallel{s}_{part}.0", leaf, value)
        return _conv(f"parallel{s}_skconv.{a}.parallel{s}_skconv_fc{part[-1]}.0", leaf, value)
    if m := re.fullmatch(r"agg(\d)/sk_fc(\d)/kernel", p):
        s = int(m.group(1)) + 1
        return _conv(f"ensemble{s}_skconv.ensemble{s}_skconv_fc{m.group(2)}.0", "kernel", value)
    if m := re.fullmatch(r"agg(\d)/(\w+)/(WK|WV|reduce|rise)/(kernel|bias)", p):
        st, role, part, leaf = m.groups()
        pre = f"transformer{int(st) + 1}_{_APF_ROLES[role]}"
        if part in ("WK", "WV"):
            return _dense(f"{pre}.{pre}_{part}.0", leaf, value)
        return _conv(f"{pre}.{pre}_fc_{part}.0", leaf, value)
    if m := re.fullmatch(r"(fuse\d/squeeze|fuse\d/excite|att_[vi]\d|cross\d)/(kernel|bias)", p):
        return _dense(m.group(1).replace("/", "."), m.group(2), value)
    raise KeyError(f"no port counterpart for flax leaf {p}")


def mdnet_topology(params: dict) -> str:
    """The MDNet-family model a flax params tree belongs to, by its keys."""
    for key, topology in (("adapt1_rgb", "manet"), ("attr0_FM", "apfnet"), ("fuse1", "dafnet"),
                          ("att_v0", "macnet")):
        if key in params:
            return topology
    if "features" in params and "fc4" in params:
        return "mdnet"
    raise ValueError(f"not an MDNet-family tree: {sorted(params)[:8]}")


def mdnet_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of an MDNet-family model (MDNet single,
    dual or adapter, APFNet, DAFNet, MaCNet; the topology from the tree's
    keys) -> the port's state_dict (f32 CPU tensors)."""
    topology = mdnet_topology(params)
    return _tensors(_mdnet_leaf("/".join(path), v, topology)
                    for path, v in _flatten(params).items())


def gnet_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of VITAL's GNet -> the port's GNet
    state_dict (fc1's input rows from HWC to CHW)."""
    flat = {"/".join(k): v for k, v in _flatten(params).items()}
    k1 = flat["fc1/kernel"]
    return _tensors([("fc1.weight", _hwc_rows_to_chw(k1, (k1.shape[0] // 9,))),
                     ("fc1.bias", flat["fc1/bias"]), _dense("fc2", "kernel", flat["fc2/kernel"]),
                     _dense("fc2", "bias", flat["fc2/bias"])])


def _leaf_at(prefix: str, leaf: str, value: np.ndarray):
    """(name, value) of a conv or FrozenBatchNorm leaf under `prefix`."""
    return _conv(prefix, leaf, value) if leaf in ("kernel", "bias") else _norm(prefix, leaf, value)


# (flax module path, port module name) rewrites of LWLNet's heads
_LWL_MODULES = (
    (r"label_encoder/(conv_block|label_pred)/conv", r"label_encoder.\1.0"),
    (r"label_encoder/(conv_block|label_pred)/bn", r"label_encoder.\1.1"),
    (r"(box_label_encoder)/label_pred/conv", r"\1.label_pred.0"),
    (r"(box_label_encoder)/label_pred/bn", r"\1.label_pred.1"),
    (r"decoder/TSE_(\w+)/(reduce|transform)_(\d)", r"decoder.TSE.\1.\2.\3"),
    (r"decoder/(RRB[12])_(\w+)/bblock_0", r"decoder.\1.\2.bblock.0"),
    (r"decoder/(RRB[12])_(\w+)/bblock_bn", r"decoder.\1.\2.bblock.1"),
    (r"decoder/(RRB[12])_(\w+)/bblock_2", r"decoder.\1.\2.bblock.3"),
    (r"decoder/(RRB[12])_(\w+)/conv1x1", r"decoder.\1.\2.conv1x1"),
    (r"decoder/CAB_(\w+)/convreluconv_(\d)", r"decoder.CAB.\1.convreluconv.\2"),
    (r"decoder/proj_(\w+)", r"decoder.proj.\1.0"),
    (r"decoder/project_(conv[12])", r"decoder.project.\1"),
    (r"(label_encoder/(?:res[12]|samp_w_pred)|box_label_encoder/res_\d+)(/\w+)?", None),
)


def _lwl_leaf(p: str, value: np.ndarray):
    """(port name, value) of one LWLNet flax leaf."""
    top, _, rest = p.partition("/")
    if top == "feature_extractor":
        return _resnet_leaf("feature_extractor", rest, value)
    if p == "filter_reg":
        return "target_model.filter_optimizer.residual_module.filter_reg", value.reshape(1)
    if p == "tm_features/final_conv/kernel":
        return _conv("target_model.feature_extractor.0", "kernel", value)
    mod, _, leaf = p.rpartition("/")
    for pattern, name in _LWL_MODULES:
        if re.fullmatch(pattern, mod):
            return _leaf_at(mod.replace("/", ".") if name is None
                            else re.sub(pattern, name, mod), leaf, value)
    raise KeyError(f"no port counterpart for flax leaf {p}")


def _stm_leaf(p: str, value: np.ndarray):
    """(port name, value) of one STMNet flax leaf; None for a trunk's
    layer4, which the port's trunks do not build."""
    top, _, rest = p.partition("/")
    if top in ("encoder_m", "encoder_q"):
        if rest.startswith("layer4_"):
            return None
        return _resnet_leaf("Encoder_M" if top == "encoder_m" else "Encoder_Q", rest, value)
    if m := re.fullmatch(r"conv1_(m|o)/kernel", p):
        return _conv(f"Encoder_M.conv1_{m.group(1)}", "kernel", value)
    if m := re.fullmatch(r"KV_(M|Q)_(Key|Value)/(kernel|bias)", p):
        return _conv(f"KV_{m.group(1)}_r4.{m.group(2)}", m.group(3), value)
    if m := re.fullmatch(r"dec_(.+)/(kernel|bias)", p):
        return _conv("Decoder." + m.group(1).replace("/", "."), m.group(2), value)
    raise KeyError(f"no port counterpart for flax leaf {p}")


def lwl_topology(params: dict) -> str:
    """'stm' for an STMNet flax tree (it has `encoder_q`), else 'lwl'."""
    return "stm" if "encoder_q" in params else "lwl"


def lwl_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax `params['params']` tree of the LWL family -> the port's state_dict
    (f32 CPU tensors): an LWLNet's (the inverse of convert_lwl_checkpoint,
    the box encoder too) or, by `lwl_topology`, an STMNet's (the inverse of
    convert_stm_checkpoint without the trunks' layer4)."""
    flat = {"/".join(k): v for k, v in _flatten(params).items()}
    if lwl_topology(params) == "stm":
        return _tensors(item for p, v in flat.items() if (item := _stm_leaf(p, v)) is not None)
    return _tensors(_lwl_leaf(p, v) for p, v in flat.items())


def load_flax_collections(path: str) -> dict:
    """Every collection of a flax variables file written with
    `np.savez(path, **variables)`, by name: each one is a pickled tree."""
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k].item() for k in f.files}


def load_flax_npz(path: str) -> dict:
    """The `params` tree of a flax variables file."""
    return load_flax_collections(path)["params"]
