"""Plain PyTorch reference of the ViPT / OSTrack tracker (float32).

Written from the published descriptions (ViPT lib/models/vipt/
vit_ce_prompt.py, ostrack_prompt.py, layers/head.py, lib/test/tracker/
vipt.py; OSTrack lib/models/ostrack/vit_ce.py), with no kernel, cache or
batching trick, and importing nothing of the program under test. The
parameters are a flat dict of tensors under the reference's own
state_dict names (`param_shapes`), which the benchmark loads into the
program unchanged.

Departures from the published code, each on purpose:
- the crop is the static-shape gather of the port's JAX lineage: the same
  square-crop geometry and cv2 half-pixel bilinear taps as sample_target,
  with image row H-1 and column W-1 never sampled (constant padding
  instead);
- the CE ranking is a stable descending sort (torch.topk is not stable);
- every product's operands and result, and the token stream after each
  residual add, go through `q`, a rounding (identity for the float32
  reference; fp8 for the control, which so holds its activations in fp8
  where the program holds them in bf16; see `quant.py`).

The caller sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False before calling (`no_tf32`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
LN_EPS = 1e-6
HEAD_BRANCHES = (("ctr", 1), ("offset", 2), ("size", 2))


def _ident(x):
    return x


@contextlib.contextmanager
def no_tf32():
    """Full float32 products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- parameters

def geometry(cfg: dict) -> dict:
    """Token counts and the CE schedule of a configuration."""
    m, p = cfg["model"], cfg["model"]["patch_size"]
    fz, fx = cfg["template"]["size"] // p, cfg["search"]["size"] // p
    lz, lx = fz * fz, fx * fx
    kept, cur = [], lx
    for r in cfg["ce"]["keep_ratio"]:
        cur = math.ceil(r * cur)
        kept.append(cur)
    # search tokens entering each block
    entering, cur, k = [], lx, 0
    for i in range(m["depth"]):
        entering.append(cur)
        if i in cfg["ce"]["loc"]:
            cur = kept[k]
            k += 1
    return {"feat_z": fz, "feat_x": fx, "lens_z": lz, "lens_x": lx, "kept": kept,
            "entering": entering}


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter of the model under its state_dict name, in order."""
    m = cfg["model"]
    C, p, depth = m["embed_dim"], m["patch_size"], m["depth"]
    g = geometry(cfg)
    prompt = m["prompt_type"]
    shapes: dict[str, tuple] = {}
    bb = "backbone."
    shapes[bb + "pos_embed_z"] = (1, g["lens_z"], C)
    shapes[bb + "pos_embed_x"] = (1, g["lens_x"], C)
    embeds = ["patch_embed"] + (["patch_embed_prompt"] if prompt == "vipt_deep" else [])
    for e in embeds:
        shapes[f"{bb}{e}.proj.weight"] = (C, 3, p, p)
        shapes[f"{bb}{e}.proj.bias"] = (C,)
    if prompt == "vipt_deep":
        hide = m["prompt_hidden"]
        for i in range(depth):
            pb = f"{bb}prompt_blocks.{i}."
            shapes[pb + "conv0_0.weight"] = (hide, C, 1, 1)
            shapes[pb + "conv0_0.bias"] = (hide,)
            shapes[pb + "conv0_1.weight"] = (hide, C, 1, 1)
            shapes[pb + "conv0_1.bias"] = (hide,)
            shapes[pb + "conv1x1.weight"] = (C, hide, 1, 1)
            shapes[pb + "conv1x1.bias"] = (C,)
            shapes[pb + "fovea.smooth"] = (1,)
        for i in range(depth):
            shapes[f"{bb}prompt_norms.{i}.weight"] = (C,)
            shapes[f"{bb}prompt_norms.{i}.bias"] = (C,)
    hidden = m["mlp_ratio"] * C
    for i in range(depth):
        b = f"{bb}blocks.{i}."
        for n, shp in (("norm1.weight", (C,)), ("norm1.bias", (C,)),
                       ("attn.qkv.weight", (3 * C, C)), ("attn.qkv.bias", (3 * C,)),
                       ("attn.proj.weight", (C, C)), ("attn.proj.bias", (C,)),
                       ("norm2.weight", (C,)), ("norm2.bias", (C,)),
                       ("mlp.fc1.weight", (hidden, C)), ("mlp.fc1.bias", (hidden,)),
                       ("mlp.fc2.weight", (C, hidden)), ("mlp.fc2.bias", (C,))):
            shapes[b + n] = shp
    shapes[bb + "norm.weight"] = (C,)
    shapes[bb + "norm.bias"] = (C,)
    ch = m["head_channel"]
    widths = [C, ch, ch // 2, ch // 4, ch // 8]
    for branch, out in HEAD_BRANCHES:
        for k in range(1, 5):
            h = f"box_head.conv{k}_{branch}."
            shapes[h + "0.weight"] = (widths[k], widths[k - 1], 3, 3)
            shapes[h + "0.bias"] = (widths[k],)
            for s in ("weight", "bias", "running_mean", "running_var"):
                shapes[h + "1." + s] = (widths[k],)
        shapes[f"box_head.conv5_{branch}.weight"] = (out, widths[4], 1, 1)
        shapes[f"box_head.conv5_{branch}.bias"] = (out,)
    return shapes


def trainable(name: str) -> bool:
    """Prompt tuning trains the parameters with 'prompt' in their name
    (ViPT lib/train/base_functions.py)."""
    return "prompt" in name


# ---------------------------------------------------------------- layers

def layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], LN_EPS)


def linear(x, P, name, q):
    return q(q(x) @ q(P[name + ".weight"]).t() + P[name + ".bias"])


def conv(x, P, name, q, stride=1, padding=0):
    return q(F.conv2d(q(x), q(P[name + ".weight"]), P[name + ".bias"], stride, padding))


def patch_embed(img, P, name, q, patch):
    """(B, H, W, 3) -> (B, H/p * W/p, C)."""
    y = conv(img.permute(0, 3, 1, 2), P, name + ".proj", q, stride=patch)
    return y.flatten(2).transpose(1, 2)


def prompt_block(a, b, P, name, q):
    """Prompt_block in token space: two 1x1 convs to the hidden width, the
    Fovea gate (softmax over the tokens of x * smooth, times x) on the first
    branch, their sum, a 1x1 conv back."""
    def dense(x, n):
        w = P[f"{name}.{n}.weight"][:, :, 0, 0]
        return q(q(x) @ q(w).t() + P[f"{name}.{n}.bias"])
    x0 = dense(a, "conv0_0")
    x1 = dense(b, "conv0_1")
    x0 = torch.softmax(x0 * P[name + ".fovea.smooth"], dim=1) * x0 + x1
    return dense(x0, "conv1x1")


def attention(x, P, name, heads, q, return_attn):
    B, L, C = x.shape
    D = C // heads
    qkv = linear(x, P, name + ".qkv", q).view(B, L, 3, heads, D).permute(2, 0, 3, 1, 4)
    qh, kh, vh = qkv[0], qkv[1], qkv[2]
    logits = q(qh * D ** -0.5) @ q(kh).transpose(-1, -2)
    attn = q(torch.softmax(logits, dim=-1))
    out = q((attn @ q(vh)).transpose(1, 2).reshape(B, L, C))
    return linear(out, P, name + ".proj", q), (attn if return_attn else None)


def candidate_elimination(attn, tokens, lens_z, keep, gidx, mask_z, q=_ident):
    """Keep the `keep` search tokens the masked template rows attend most
    (attn_blocks.py candidate_elimination), ranked by a stable sort; the
    per-head votes and their mean go through `q`."""
    attn_t = attn[:, :, :lens_z, lens_z:]                       # (B, H, Lz, Ls)
    w = mask_z / mask_z.sum(1, keepdim=True).clamp(min=1e-9)
    score = q(q(torch.einsum("bhts,bt->bhs", attn_t, w)).mean(1))   # (B, Ls)
    order = torch.argsort(-score, dim=1, stable=True)[:, :keep]
    C = tokens.shape[-1]
    kept = torch.gather(tokens[:, lens_z:], 1, order[..., None].expand(-1, -1, C))
    return torch.cat([tokens[:, :lens_z], kept], 1), torch.gather(gidx, 1, order)


def recover(xs, gidx, lens_x):
    """Surviving search tokens scattered back to the grid, zeros elsewhere."""
    B, _, C = xs.shape
    return xs.new_zeros(B, lens_x, C).scatter(1, gidx[..., None].expand(-1, -1, C), xs)


def gather_tokens(full, gidx):
    return torch.gather(full, 1, gidx[..., None].expand(-1, -1, full.shape[-1]))


def ctr_mask(feat_z: int, device) -> torch.Tensor:
    """CTR_POINT: the template's centre token votes alone."""
    m = torch.zeros(feat_z, feat_z, device=device)
    c = (feat_z - 1) // 2
    m[c, c] = 1.0
    return m.reshape(1, -1)


def backbone(P, cfg, z, x, q: Callable = _ident, drop: Optional[Callable] = None):
    """ViT with deep prompts and candidate elimination -> (B, Lz + Lx, C)
    tokens, pruned search positions zero. `drop(i, branch, y)` applies drop
    path to block i's branch output (training)."""
    m = cfg["model"]
    g = geometry(cfg)
    lz, lx, p = g["lens_z"], g["lens_x"], m["patch_size"]
    B = x.shape[0]
    deep = m["prompt_type"] == "vipt_deep"
    bb = "backbone."
    z_tok = patch_embed(z[..., :3], P, bb + "patch_embed", q, p)
    x_tok = patch_embed(x[..., :3], P, bb + "patch_embed", q, p)
    if deep:
        z_dte = patch_embed(z[..., 3:], P, bb + "patch_embed_prompt", q, p)
        x_dte = patch_embed(x[..., 3:], P, bb + "patch_embed_prompt", q, p)
        n0 = bb + "prompt_norms.0"
        z_prompted = prompt_block(layer_norm(z_tok, P, n0), layer_norm(z_dte, P, n0), P,
                                  bb + "prompt_blocks.0", q)
        x_prompted = prompt_block(layer_norm(x_tok, P, n0), layer_norm(x_dte, P, n0), P,
                                  bb + "prompt_blocks.0", q)
        z_tok = z_tok + z_prompted
        x_tok = x_tok + x_prompted
    tokens = q(torch.cat([z_tok + P[bb + "pos_embed_z"], x_tok + P[bb + "pos_embed_x"]], 1))
    mask_z = ctr_mask(g["feat_z"], x.device).expand(B, -1)
    gidx = torch.arange(lx, device=x.device)[None].expand(B, -1)
    pruned = False
    ce_loc = cfg["ce"]["loc"]
    k = 0
    for i in range(m["depth"]):
        blk = f"{bb}blocks.{i}"
        if deep and i >= 1:
            xs_full = recover(tokens[:, lz:], gidx, lx) if pruned else tokens[:, lz:]
            full = layer_norm(torch.cat([tokens[:, :lz], xs_full], 1), P,
                              f"{bb}prompt_norms.{i - 1}")
            pn = f"{bb}prompt_norms.{i}"
            z_prompted = prompt_block(full[:, :lz], layer_norm(z_prompted, P, pn), P,
                                      f"{bb}prompt_blocks.{i}", q)
            x_prompted = prompt_block(full[:, lz:], layer_norm(x_prompted, P, pn), P,
                                      f"{bb}prompt_blocks.{i}", q)
            x_sel = gather_tokens(x_prompted, gidx) if pruned else x_prompted
            tokens = q(tokens + torch.cat([z_prompted, x_sel], 1))
        ce = i in ce_loc
        y, attn = attention(layer_norm(tokens, P, blk + ".norm1"), P, blk + ".attn",
                            m["num_heads"], q, ce)
        tokens = q(tokens + (drop(i, "attn", y) if drop else y))
        if ce:
            tokens, gidx = candidate_elimination(attn, tokens, lz, g["kept"][k], gidx, mask_z, q)
            k += 1
            pruned = True
        h = linear(layer_norm(tokens, P, blk + ".norm2"), P, blk + ".mlp.fc1", q)
        y = linear(F.gelu(h), P, blk + ".mlp.fc2", q)
        tokens = q(tokens + (drop(i, "mlp", y) if drop else y))
    tokens = layer_norm(tokens, P, bb + "norm")
    xs = recover(tokens[:, lz:], gidx, lx) if pruned else tokens[:, lz:]
    return torch.cat([tokens[:, :lz], xs], 1)


def center_head(P, feat, q: Callable = _ident):
    """CenterPredictor: per branch four 3x3 conv + frozen BN + ReLU, a 1x1
    conv; (B, S, S, C) -> score (B, S, S), size (B, S, S, 2), offset."""
    x0 = feat.permute(0, 3, 1, 2)
    outs = {}
    for branch, _ in HEAD_BRANCHES:
        x = x0
        for k in range(1, 5):
            h = f"box_head.conv{k}_{branch}"
            x = conv(x, P, h + ".0", q, padding=1)
            inv = P[h + ".1.weight"] / torch.sqrt(P[h + ".1.running_var"] + BN_EPS)
            shift = P[h + ".1.bias"] - P[h + ".1.running_mean"] * inv
            x = torch.relu(x * inv[:, None, None] + shift[:, None, None])
        outs[branch] = conv(x, P, f"box_head.conv5_{branch}", q)
    clamp = lambda v: torch.sigmoid(v).clamp(1e-4, 1 - 1e-4)  # noqa: E731
    return (clamp(outs["ctr"][:, 0]), clamp(outs["size"]).permute(0, 2, 3, 1),
            outs["offset"].permute(0, 2, 3, 1))


def forward(P, cfg, z, x, q: Callable = _ident, drop: Optional[Callable] = None):
    """Model outputs: score_map, size_map, offset_map and pred_boxes (the
    decode at the score map's argmax, cx cy w h in [0, 1])."""
    S = cfg["search"]["size"] // cfg["model"]["patch_size"]
    tokens = backbone(P, cfg, z, x, q, drop)
    feat = tokens[:, -S * S:].reshape(x.shape[0], S, S, -1)
    score, size, offset = center_head(P, feat, q)
    return {"score_map": score, "size_map": size, "offset_map": offset,
            "pred_boxes": decode(score, size, offset)[0]}


# ---------------------------------------------------------------- tracker

def decode(score, size, offset, idx=None):
    """cx, cy, w, h in [0, 1] at the flat cell `idx` (the argmax, first
    index, when None), and the score there (head.py cal_bbox)."""
    B, S, _ = score.shape
    flat = score.reshape(B, S * S)
    if idx is None:
        idx = flat.argmax(1)
    iy = torch.div(idx, S, rounding_mode="floor").float()
    ix = (idx % S).float()
    g = idx[:, None, None].expand(-1, 1, 2)
    sz = torch.gather(size.reshape(B, S * S, 2), 1, g)[:, 0]
    off = torch.gather(offset.reshape(B, S * S, 2), 1, g)[:, 0]
    box = torch.stack([(ix + off[:, 0]) / S, (iy + off[:, 1]) / S, sz[:, 0], sz[:, 1]], 1)
    return box, torch.gather(flat, 1, idx[:, None])[:, 0]


def hann2d(n: int, device) -> torch.Tensor:
    k = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    w = 0.5 * (1.0 - torch.cos(2.0 * math.pi * k / (n + 1)))
    return w[:, None] * w[None, :]


def clip_box(box, H, W, margin):
    x1, y1, w, h = box.unbind(-1)
    x2, y2 = x1 + w, y1 + h
    x1 = x1.clamp(0.0, W - margin)
    x2 = x2.clamp(margin, W)
    y1 = y1.clamp(0.0, H - margin)
    y2 = y2.clamp(margin, H)
    return torch.stack([x1, y1, (x2 - x1).clamp(min=margin), (y2 - y1).clamp(min=margin)], -1)


def map_back(box01, prev, resize_factor, search_size, H, W, margin):
    """A crop box (cx, cy, w, h in [0, 1]) in image xywh, clipped
    (vipt.py map_box_back + clip_box). box01 (..., 4) with prev and
    resize_factor broadcasting over the leading axes."""
    rf = resize_factor[..., None]
    pred = box01 * search_size / rf
    half = 0.5 * search_size / resize_factor
    cx = pred[..., 0] + (prev[..., 0] + 0.5 * prev[..., 2] - half)
    cy = pred[..., 1] + (prev[..., 1] + 0.5 * prev[..., 3] - half)
    box = torch.stack([cx - 0.5 * pred[..., 2], cy - 0.5 * pred[..., 3],
                       pred[..., 2], pred[..., 3]], -1)
    return clip_box(box, H, W, margin)


def crop(frames, boxes, factor, out, mean, std):
    """Square crop around each box, bilinear resize, normalise:
    (B, H, W, C) uint8, (B, 4) xywh -> ((B, out, out, C), resize factor (B,)).
    Side ceil(sqrt(w h) * factor) (at least 1); origin round(centre - side
    / 2), half to even; cv2's half-pixel source coordinates clipped to
    [0, side - 1]; taps on row H-1, column W-1 or outside read 0."""
    B, H, W, C = frames.shape
    dev = frames.device
    x, y, w, h = boxes.float().unbind(-1)
    side = torch.clamp(torch.ceil(torch.sqrt(w * h) * factor), min=1.0)
    x1 = torch.round(x + 0.5 * w - side * 0.5)
    y1 = torch.round(y + 0.5 * h - side * 0.5)
    j = torch.arange(out, dtype=torch.float32, device=dev) + 0.5
    s = j[None] * (side / out)[:, None] - 0.5
    s = torch.minimum(s.clamp(min=0.0), (side - 1.0)[:, None])
    xs, ys = x1[:, None] + s, y1[:, None] + s
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx = (xs - x0)[:, None, :, None]
    fy = (ys - y0)[:, :, None, None]
    x0, y0 = x0.long(), y0.long()
    b = torch.arange(B, device=dev)[:, None, None]

    def tap(yi, xi):
        ok = ((yi >= 0) & (yi < H - 1))[:, :, None] & ((xi >= 0) & (xi < W - 1))[:, None, :]
        v = frames[b, yi.clamp(0, H - 1)[:, :, None], xi.clamp(0, W - 1)[:, None, :]].float()
        return torch.where(ok[..., None], v, 0.0)

    img = ((1 - fy) * (1 - fx) * tap(y0, x0) + (1 - fy) * fx * tap(y0, x0 + 1)
           + fy * (1 - fx) * tap(y0 + 1, x0) + fy * fx * tap(y0 + 1, x0 + 1))
    return (img / 255.0 - mean) / std, out / side


def norm_stats(channels: int, device):
    mean = torch.tensor((MEAN * 2)[:channels], device=device)
    std = torch.tensor((STD * 2)[:channels], device=device)
    return mean, std


def template(cfg, frames, boxes):
    """The normalised template crops of the first frames."""
    mean, std = norm_stats(frames.shape[-1], frames.device)
    t = cfg["template"]
    return crop(frames, boxes, t["factor"], t["size"], mean, std)[0]


def track_step(P, cfg, z, frames, prev, q: Callable = _ident):
    """One tracked frame per row: (B, H, W, C) uint8 frames, previous boxes
    (B, 4) xywh, templates z. Returns a dict: `box` (B, 4) and `score` (B,)
    at the Hann-windowed argmax (the tracker's answer), `cell_boxes`
    (B, S*S, 4) the answer decoded at every cell, `windowed` (B, S*S)."""
    H, W = frames.shape[1], frames.shape[2]
    s = cfg["search"]
    mean, std = norm_stats(frames.shape[-1], frames.device)
    x, rf = crop(frames, prev, s["factor"], s["size"], mean, std)
    out = forward(P, cfg, z, x, q)
    score, size, offset = out["score_map"], out["size_map"], out["offset_map"]
    B, S, _ = score.shape
    win = hann2d(S, score.device)[None] * score
    margin = cfg["runtime"]["margin"]
    cells = torch.arange(S * S, device=score.device)
    iy = torch.div(cells, S, rounding_mode="floor").float()
    ix = (cells % S).float()
    off = offset.reshape(B, S * S, 2)
    sz = size.reshape(B, S * S, 2)
    per_cell = torch.stack([(ix + off[..., 0]) / S, (iy + off[..., 1]) / S,
                            sz[..., 0], sz[..., 1]], -1)                 # (B, S*S, 4)
    cell_boxes = map_back(per_cell, prev[:, None], rf[:, None], s["size"], H, W, margin)
    best, best_score = decode(win, size, offset)
    box = map_back(best, prev, rf, s["size"], H, W, margin)
    return {"box": box, "score": best_score, "cell_boxes": cell_boxes,
            "windowed": win.reshape(B, S * S)}


# ---------------------------------------------------------------- training

def gaussian_radius(w, h, min_overlap=0.7):
    """CornerNet's radius with the reference's kept quadratic roots
    (heapmap_utils.py)."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / (2 * a3)
    return torch.minimum(r1, torch.minimum(r2, r3))


def heatmap(boxes01, S):
    """CenterNet target: a Gaussian of sigma (2r + 1) / 6 at the rounded
    centre, cut at |d| > r (heapmap_utils.py generate_heatmap)."""
    bb = boxes01 * S
    c = torch.round(bb[:, :2] + bb[:, 2:] / 2)
    r = gaussian_radius(bb[:, 2], bb[:, 3]).clamp(min=0.0).floor()
    ar = torch.arange(S, dtype=torch.float32, device=boxes01.device)
    dx = ar[None, None, :] - c[:, 0, None, None]
    dy = ar[None, :, None] - c[:, 1, None, None]
    r = r[:, None, None]
    sigma = (2 * r + 1) / 6
    g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    return torch.where((dx.abs() <= r) & (dy.abs() <= r), g, torch.zeros_like(g))


def xyxy(b):
    return torch.stack([b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], 1)


def cxcywh_to_xyxy(b):
    return torch.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                        b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1)


def giou(a, b):
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])  # noqa: E731
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    inter = (rb - lt).clamp(min=0).prod(1)
    union = area(a) + area(b) - inter
    iou = inter / union.clamp(min=1e-9)
    lt = torch.minimum(a[:, :2], b[:, :2])
    rb = torch.maximum(a[:, 2:], b[:, 2:])
    enc = (rb - lt).clamp(min=0).prod(1).clamp(min=1e-9)
    return iou - (enc - union) / enc


def loss(out, anno, weights, S):
    """ViPTActor's objective: GIoU and L1 on the clamped xyxy boxes, the
    focal loss of the centre map against the Gaussian target."""
    pred = cxcywh_to_xyxy(out["pred_boxes"])
    gt = xyxy(anno).clamp(0.0, 1.0)
    l_giou = (1 - giou(pred, gt)).mean()
    l_l1 = (pred - gt).abs().mean()
    target = heatmap(anno, S)
    p = out["score_map"].clamp(min=1e-12)
    pos = (target == 1).float()
    neg = (target < 1).float()
    pos_l = (torch.log(p) * (1 - p) ** 2 * pos).sum()
    neg_l = (torch.log((1 - p).clamp(min=1e-12)) * p ** 2 * (1 - target) ** 4 * neg).sum()
    n = pos.sum()
    focal = torch.where(n == 0, -neg_l, -(pos_l + neg_l) / n.clamp(min=1.0))
    return weights["giou"] * l_giou + weights["l1"] * l_l1 + weights["focal"] * focal


def drop_path_masks(seed: int, step: int, batch: int, depth: int, rate: float, device):
    """The drop-path draws of one training step: a generator on `device`
    seeded from (seed, step) by numpy's SeedSequence, then per block
    i = 1 .. depth-1 (rate * i / (depth - 1) > 0) a (batch, 1, 1) Bernoulli
    keep mask for the attention branch and one for the MLP branch, in that
    order. Returns {(i, branch): (mask, keep)}."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    g = torch.Generator(device=device).manual_seed(s)
    masks = {}
    for i in range(depth):
        r = rate * i / max(depth - 1, 1)
        if r == 0.0:
            continue
        for branch in ("attn", "mlp"):
            m = torch.empty((batch, 1, 1), device=device).bernoulli_(1.0 - r, generator=g)
            masks[(i, branch)] = (m, 1.0 - r)
    return masks


class AdamW:
    """optax chain(clip_by_global_norm, adamw) over a dict of leaves, as
    torch.optim.AdamW steps it (decay lr * wd * p first, then the Adam
    step with bias corrections, eps outside the square root)."""

    def __init__(self, params: dict, lr, weight_decay, clip, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.clip, self.b1, self.b2, self.eps = lr, weight_decay, clip, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            p = p * (1 - self.lr * self.wd)
            out[k] = p - self.lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)
        return out


def _clipped(grads: dict, clip: float) -> dict:
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    return {k: g * scale for k, g in grads.items()}


def _grad(value, leaves: dict, retain: bool = False) -> dict:
    grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True,
                                retain_graph=retain)
    return {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}


def tied_cells(score, band: float, most: int):
    """The rows whose score map's best two cells lie within `band` (at most
    `most` of them, the closest first), and those two cells of every row."""
    top = score.flatten(1).topk(2, dim=1)
    margin = top.values[:, 0] - top.values[:, 1]
    rows = [int(r) for r in torch.argsort(margin)[:most] if float(margin[r]) < band]
    return rows, top.indices


def train_steps(P, cfg, batches, seed, q: Callable = _ident, band: float = 0.0, most: int = 0):
    """Prompt-only training from the parameters P through the given
    batches: one optimizer step each. Returns per step the loss, the first
    step's clipped gradient and the parameters after the last, by leaf of
    the trainable set. With a `band`, `first_grads` also holds the first
    step's clipped gradient for every choice of the box loss's cell in the
    rows (at most `most`) whose best two score cells lie within `band`: an
    argmax that rounding may take either way."""
    tr = cfg["train"]
    S = cfg["search"]["size"] // cfg["model"]["patch_size"]
    train_keys = [k for k in P if trainable(k)]
    params = {k: P[k].clone() for k in train_keys}
    opt = AdamW(params, tr["lr"], tr["weight_decay"], tr["grad_clip_norm"])
    losses, first_grads = [], None
    for step, batch in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        full = {**P, **leaves}
        masks = drop_path_masks(seed, step, batch["search"].shape[0],
                                cfg["model"]["depth"], tr["drop_path_rate"],
                                batch["search"].device)

        def drop(i, branch, y):
            if (i, branch) not in masks:
                return y
            m, keep = masks[(i, branch)]
            return y * m / keep

        out = forward(full, cfg, batch["template"], batch["search"], q, drop)
        value = loss(out, batch["search_anno"], tr["loss_weights"], S)
        rows = []
        if first_grads is None and band > 0:
            rows, top = tied_cells(out["score_map"].detach(), band, most)
        grads = _grad(value, leaves, retain=bool(rows))
        if first_grads is None:
            first_grads = [_clipped(grads, tr["grad_clip_norm"])]
            for choice in range(1, 2 ** len(rows)):
                idx = top[:, 0].clone()
                for bit, r in enumerate(rows):
                    if choice >> bit & 1:
                        idx[r] = top[r, 1]
                alt = dict(out, pred_boxes=decode(out["score_map"], out["size_map"],
                                                  out["offset_map"], idx)[0])
                v = loss(alt, batch["search_anno"], tr["loss_weights"], S)
                first_grads.append(_clipped(_grad(v, leaves, retain=True),
                                            tr["grad_clip_norm"]))
        losses.append(float(value.detach()))
        params = opt.step({k: v.detach() for k, v in params.items()}, grads)
    return {"losses": losses, "first_grad": first_grads[0], "first_grads": first_grads,
            "params": params}
