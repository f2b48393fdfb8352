"""MDNet online tracking protocol, port of mmtrack_tpu/trackers/mdnet_tracker.py:
candidate scoring with online fine-tuning of fc4-fc6 and hard-negative
mining, for every model of the MDNet family (models/mdnet.py MDNet in its
three modes, models/apfnet.py APFNet, models/rgbt_fusion.py DAFNet and
MaCNet).

Init (pyMDNet run_tracker.py:120-186): 500 positives and 5000 negatives
around the first box, 50 SGD iterations on their features, the ridge
bounding-box regressor on 1000 samples and the memories; pyVITAL also
pretrains its mask generator G. A step: 256 Gaussian candidates (MANet
512) scored by fc6, the top-5 mean box refined by the regressor on
success, 50 positives and 200 negatives stored on success, and 15 SGD
iterations on a failure (short-term) or every 10th frame (long-term).

The port keeps JAX's arithmetic and the order of its draws; where JAX masks
arithmetic to stay one compiled program, the port decides on the host.
A step reads the card once, after scoring: the mean top-5 score, the
refined box and the top-5 mean box in one copy. From it the host decides
success, the reported and sampling boxes, the candidate spread, the
memory writes (in place at the ring slot, only on success), the number
of SGD iterations (15 or 0) and whether G steps. The SGD iterations are
a Python loop without a host read. The positive pool is the init entry
and the ring, indexed in place (JAX concatenates the 5,500 rows every
frame); the validity of each row, and with it the sampling weights, is
known on the host.

Random draws go through a draw source with JAX's key calculus: `key()`,
`split(key, n)`, `fold_in(key, data)`, and `normal`, `uniform`,
`randint`, `permutation`, `bernoulli` and `choice(key, p, shape)` that
return CPU tensors. The default `TorchDraws` ignores the keys and draws
every number from one CPU `torch.Generator` seeded with the recipe's
seed at every initialize, so a CPU run and a card run draw the same
numbers; tests inject a source that follows JAX's keys. Each sampler is
its draws (`gaussian_draws`, `uniform_draws`, `whole_draws`) and a
deterministic transform of them (`_gaussian_boxes`, ...).

Ties: `_topk` breaks them by the lower index, as lax.top_k does, for the
mining and the top 5 (torch.topk promises no order on CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.models.vital import GNet, one_cell_masks
from mmtrack_torch.trackers.dimp_tracker import _to_device, _vec
from mmtrack_torch.trackers.vipt_tracker import as_frames


@dataclass(frozen=True)
class MDNetRuntime:
    """The protocol's constants (pyMDNet tracking/options.yaml), field for
    field the JAX package's MDNetRuntime; see its comments for the sources."""
    img_size: int = 107
    padding: int = 16
    batch_test: int = 256
    n_samples: int = 256
    trans: float = 0.6
    trans_f_expand: float = 1.5
    scale_f: float = 1.05
    n_init_pos: int = 500
    n_init_neg: int = 5000
    extract_chunk: int = 512
    overlap_pos: tuple = (0.7, 1.0)
    overlap_neg: tuple = (0.0, 0.5)
    init_iters: int = 50
    update_iters: int = 15
    lr_init: float = 5e-4
    lr_update: float = 1e-3
    lr_mult_fc6: float = 10.0
    momentum: float = 0.9
    weight_decay: float = 5e-4
    batch_pos: int = 32
    batch_neg: int = 96
    batch_neg_cand: int = 1024
    grad_clip: float = 10.0
    trans_pos: float = 0.1
    scale_pos: float = 1.3
    trans_neg_init: float = 1.0
    scale_neg_init: float = 1.6
    trans_neg: float = 2.0
    scale_neg: float = 1.3
    n_pos_update: int = 50
    n_neg_update: int = 200
    n_frames_long: int = 100
    n_frames_short: int = 30
    long_interval: int = 10
    n_bbreg: int = 1000
    trans_bbreg: float = 0.3
    scale_bbreg: float = 1.6
    aspect_bbreg: float = 1.1
    bbreg_scale_range: tuple = (1.0, 2.0)
    bbreg_overlap: tuple = (0.6, 1.0)
    bbreg_lambda: float = 1000.0
    success_thr: float = 0.0
    topk: int = 5
    revert_on_failure: bool = False      # MANet: boxes revert at failure
    hard_trans_expand: bool = False      # MANet: spread set to trans_f_expand
    loss_sum: bool = False               # MANet: BCE summed, not averaged
    loss_focal: bool = False             # pyVITAL: gamma-1 focal BCE
    manet_seed_memory: bool = False      # MANet: memories seeded from init slices
    bbreg_reject: bool = False           # MANet: revert out-of-range refinements
    vital: bool = False
    vital_drop_cells: int = 3
    vital_feat_hw: int = 3
    vital_feat_dim: int = 512
    g_pretrain_iters: int = 20
    g_update_iters: int = 2
    lr_g: float = 1e-3


class TorchDraws:
    """The default draw source: JAX's key calculus over one CPU generator.
    Keys are placeholders; every draw takes the generator's next numbers."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(seed)

    def key(self):
        return None

    def split(self, key, n: int = 2) -> list:
        return [None] * n

    def fold_in(self, key, data: int):
        return None

    def normal(self, key, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator)

    def uniform(self, key, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator)

    def randint(self, key, shape, n: int) -> torch.Tensor:
        return torch.randint(0, n, shape, generator=self.generator)

    def permutation(self, key, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator)

    def bernoulli(self, key, p: float, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator) < p

    def choice(self, key, p: np.ndarray, shape) -> torch.Tensor:
        """Indices drawn with replacement with weights p, as jax.random.choice
        draws them: searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))."""
        cum = torch.cumsum(torch.from_numpy(np.asarray(p, np.float32)), 0)
        return torch.searchsorted(cum, cum[-1] * (1 - torch.rand(shape, generator=self.generator)))


# ---------------------------------------------------------------- sampling

@dataclass(frozen=True)
class Sampler:
    """One SampleGenerator: kind 'gaussian', 'uniform' or 'whole', its
    translation and scale spread and aspect jitter."""
    kind: str
    trans: float = 0.0
    scale: float = 1.0
    aspect: Optional[float] = None


def gaussian_draws(draws, key, n: int, aspect=None) -> dict:
    r1, r2, r3 = draws.split(key, 3)
    return {"c": draws.normal(r1, (n, 2)), "s": draws.normal(r2, (n, 1)),
            "a": draws.uniform(r3, (n, 2)) if aspect is not None else None}


def uniform_draws(draws, key, n: int, aspect=None) -> dict:
    r1, r2, r3 = draws.split(key, 3)
    return {"c": draws.uniform(r1, (n, 2)), "s": draws.uniform(r2, (n, 1)),
            "a": draws.uniform(r3, (n, 2)) if aspect is not None else None}


def whole_draws(draws, key, n: int) -> dict:
    r1, r2 = draws.split(key)
    m = int(2 * np.sqrt(n))
    return {"perm": draws.permutation(r1, m * m), "s": draws.uniform(r2, (n, 1))}


def _finish_samples(centers, wh, img_hw):
    """SampleGenerator._gen_samples' tail: wh clipped to [10, img - 10],
    centres to [0, img], then xywh."""
    H, W = img_hw
    wh = torch.minimum(torch.maximum(wh, _vec((10.0, 10.0), wh.device)),
                       _vec((W - 10.0, H - 10.0), wh.device))
    centers = torch.minimum(torch.maximum(centers, _vec((0.0, 0.0), wh.device)),
                            _vec((float(W), float(H)), wh.device))
    return torch.cat([centers - wh / 2, wh], 1)


def _aspect_wh(w, h, n, a, aspect):
    wh = torch.stack([w, h]).expand(n, 2)
    return wh if aspect is None else wh * aspect ** (a * 2 - 1)


def _gaussian_boxes(box, trans, scale, img_hw, d: dict, aspect=None):
    """SampleGenerator('gaussian') from its normals: centre jitter
    trans * mean(wh) * clip(0.5 n, -1, 1), scale jitter scale ** clip(...)."""
    x, y, w, h = box.unbind()
    c = torch.stack([x + w / 2, y + h / 2])
    m = torch.stack([w, h]).mean()
    n = d["c"].shape[0]
    wh = _aspect_wh(w, h, n, d["a"], aspect)
    centers = c + trans * m * torch.clamp(0.5 * d["c"], -1.0, 1.0)
    wh = wh * scale ** torch.clamp(0.5 * d["s"], -1.0, 1.0)
    return _finish_samples(centers, wh, img_hw)


def _uniform_boxes(box, trans, scale, img_hw, d: dict, aspect=None):
    """SampleGenerator('uniform') from its uniforms."""
    x, y, w, h = box.unbind()
    c = torch.stack([x + w / 2, y + h / 2])
    m = torch.stack([w, h]).mean()
    n = d["c"].shape[0]
    wh = _aspect_wh(w, h, n, d["a"], aspect)
    centers = c + trans * m * (d["c"] * 2 - 1)
    wh = wh * scale ** (d["s"] * 2 - 1)
    return _finish_samples(centers, wh, img_hw)


def _linspace01(m: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, m) in f32: i * (1 / (m - 1)) with the last point 1."""
    if m == 1:
        return torch.zeros(1, device=device)
    step = np.float32(1.0) / np.float32(m - 1)
    out = torch.arange(m, dtype=torch.float32, device=device) * float(step)
    out[-1] = 1.0
    return out


def _whole_boxes(box, scale, img_hw, d: dict):
    """SampleGenerator('whole') from its permutation and uniforms: centres
    on a permuted uniform grid over the image, scale jitter only."""
    w, h = box[2], box[3]
    H, W = img_hw
    n = d["s"].shape[0]
    m = int(2 * np.sqrt(n))
    lin = _linspace01(m, box.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)[d["perm"]][:n]
    wh0 = torch.stack([w, h])
    centers = wh0 / 2 + xy * (_vec((float(W), float(H)), box.device) - wh0 / 2 - 1)
    wh = wh0 * scale ** (d["s"] * 2 - 1)
    return _finish_samples(centers, wh, img_hw)


def _sample(draws, key, sampler: Sampler, box, n: int, img_hw) -> torch.Tensor:
    """n boxes of `sampler` around box: the draws, on box's device, then the
    transform."""
    dev = box.device

    def put(d):
        return {k: None if v is None else _to_device(v, dev) for k, v in d.items()}

    if sampler.kind == "gaussian":
        return _gaussian_boxes(box, sampler.trans, sampler.scale, img_hw,
                               put(gaussian_draws(draws, key, n, sampler.aspect)), sampler.aspect)
    if sampler.kind == "uniform":
        return _uniform_boxes(box, sampler.trans, sampler.scale, img_hw,
                              put(uniform_draws(draws, key, n, sampler.aspect)), sampler.aspect)
    return _whole_boxes(box, sampler.scale, img_hw, put(whole_draws(draws, key, n)))


def _iou(a, b):
    x1 = torch.maximum(a[:, 0], b[0])
    y1 = torch.maximum(a[:, 1], b[1])
    x2 = torch.minimum(a[:, 0] + a[:, 2], b[0] + b[2])
    y2 = torch.minimum(a[:, 1] + a[:, 3], b[1] + b[3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    union = a[:, 2] * a[:, 3] + b[2] * b[3] - inter
    return inter / torch.clamp(union, min=1e-9)


def _sample_filtered(draws, key, sampler: Sampler, gt_box, n: int, iou_range, img_hw,
                     oversample: int = 4):
    """Draw oversample * n, keep those inside the IoU range first (a stable
    sort), fill n slots; a slot without a valid box gets the gt box."""
    boxes = _sample(draws, key, sampler, gt_box, oversample * n, img_hw)
    ious = _iou(boxes, gt_box)
    ok = (ious >= iou_range[0]) & (ious <= iou_range[1])
    idx = torch.sort((~ok).to(torch.uint8), stable=True).indices[:n]
    return torch.where(ok[idx][:, None], boxes[idx], gt_box[None])


# ---------------------------------------------------------------- features

def _crop_image2_dev(rt: MDNetRuntime, img: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """crop_image2 (pyMDNet modules/utils.py:29-91) of each box of (N, 4) on
    the f32 (H, W, C) frame: the padded box warped anisotropically onto
    img_size^2, src = (dst - img_size / 2) * (w' / img_size) + cx at integer
    destination coordinates, bilinear; the border is cv2's Scalar(128, 0,
    0): channel 0 of each RGB triplet gets 128, the others 0. Returns
    (N, C, img_size, img_size) on the 0..255 scale."""
    n = rt.img_size
    H, W, C = img.shape
    x, y, w, h = boxes.unbind(1)
    cx, cy = x + w / 2, y + h / 2
    wp = w + 2 * rt.padding * w / n
    hp = h + 2 * rt.padding * h / n
    d = torch.arange(n, dtype=torch.float32, device=img.device) - n / 2.0
    xs = d * (wp / n)[:, None] + cx[:, None]
    ys = d * (hp / n)[:, None] + cy[:, None]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy = (ys - y0)[:, :, None, None]
    fx = (xs - x0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()
    border = _vec(tuple(128.0 if c % 3 == 0 else 0.0 for c in range(C)), img.device)

    def tap(yi, xi):
        inb = (((yi >= 0) & (yi < H))[:, :, None, None]
               & ((xi >= 0) & (xi < W))[:, None, :, None])
        v = img[yi.clamp(0, H - 1)[:, :, None], xi.clamp(0, W - 1)[:, None, :]]
        return torch.where(inb, v, border)

    out = ((1 - fy) * (1 - fx) * tap(y0, x0)
           + (1 - fy) * fx * tap(y0, x0 + 1)
           + fy * (1 - fx) * tap(y0 + 1, x0)
           + fy * fx * tap(y0 + 1, x0 + 1))
    return out.permute(0, 3, 1, 2)


def _chunked(rt: MDNetRuntime, embed: Callable, items: torch.Tensor, pad_row) -> torch.Tensor:
    """embed(items) in chunks of rt.extract_chunk; more items than a chunk
    are padded to whole chunks with pad_row, as the JAX package's lax.map
    pads them."""
    n, chunk = items.shape[0], rt.extract_chunk
    if n <= chunk:
        return embed(items)
    pad = (-n) % chunk
    if pad:
        items = torch.cat([items, pad_row.expand(pad, *items.shape[1:])])
    return torch.cat([embed(part) for part in items.split(chunk)])[:n]


def _extract_patches(rt: MDNetRuntime, model, img: torch.Tensor, boxes: torch.Tensor):
    """Crop each box with its context, subtract 128 (the reference's input
    convention) and embed: (N, streams, D); the chunks pad with the first
    box."""
    def embed(bs):
        return model.extract_features(_crop_image2_dev(rt, img, bs) - 128.0)
    return _chunked(rt, embed, boxes, boxes[:1])


def _embed_patches(rt: MDNetRuntime, model, patches: torch.Tensor):
    """Embed given raw crops (N, 107, 107, C) on the 0..255 scale; the
    chunks pad with zero crops."""
    def embed(ps):
        return model.extract_features(ps.permute(0, 3, 1, 2) - 128.0)
    return _chunked(rt, embed, patches, torch.zeros_like(patches[:1]))


# ---------------------------------------------------------------- fc training

def _topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, the lower index first
    on a tie (lax.top_k)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class Rows:
    """Rows of one tensor, or of two read as their concatenation (the init
    entry and the ring), gathered in place by device indices."""

    def __init__(self, *parts: torch.Tensor):
        self.parts = parts

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        if len(self.parts) == 1:
            return self.parts[0][idx]
        a, b = self.parts
        first = (idx < a.shape[0])[:, None, None]
        return torch.where(first, a[idx.clamp(max=a.shape[0] - 1)],
                           b[(idx - a.shape[0]).clamp(min=0)])


def _apply_cell_mask(rt: MDNetRuntime, feats, mask):
    """feats (B, streams, D) with D = C * hw * hw (CHW flatten); mask (B, hw, hw)."""
    B, S = feats.shape[:2]
    f = feats.reshape(B, S, rt.vital_feat_dim, rt.vital_feat_hw, rt.vital_feat_hw)
    return (f * mask[:, None, None]).reshape(B, S, -1)


def _vital_drop_mask(rt: MDNetRuntime, gnet: GNet, g: dict, pos_batch):
    """Per sample, zero the rt.vital_drop_cells cells of lowest G response
    (pyVITAL run_tracker.py:107-133)."""
    B = pos_batch.shape[0]
    scores = gnet(pos_batch.sum(1), g).reshape(B, -1)
    low = _topk(-scores, rt.vital_drop_cells)
    keep = torch.ones_like(scores).scatter_(1, low, 0.0)    # F.one_hot would read the card
    return keep.reshape(B, rt.vital_feat_hw, rt.vital_feat_hw)


def _bce(rt: MDNetRuntime, pos_logits, neg_logits):
    """BCE over (background, target) logits: the combined-count mean
    (pyMDNet), the raw sum (MANet, loss_sum) or the gamma-1 focal form
    (pyVITAL, loss_focal)."""
    pos_lp = -F.log_softmax(pos_logits, -1)[:, 1]
    neg_lp = -F.log_softmax(neg_logits, -1)[:, 0]
    if rt.loss_focal:
        pos_lp = (1.0 - torch.softmax(pos_logits, -1)[:, 1]) * pos_lp
        neg_lp = (1.0 - torch.softmax(neg_logits, -1)[:, 0]) * neg_lp
    total = pos_lp.sum() + neg_lp.sum()
    if rt.loss_sum:
        return total
    return total / (pos_logits.shape[0] + neg_logits.shape[0])


def _sgd(params: dict, mom: dict, grads: list, momentum: float, lrs: dict):
    """torch SGD's momentum step on already decayed gradients."""
    new_mom = {k: momentum * m + g for (k, m), g in zip(mom.items(), grads)}
    return {k: p - lrs[k] * new_mom[k] for k, p in params.items()}, new_mom


def _grads(loss_fn, params: dict) -> list:
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        return list(torch.autograd.grad(loss_fn(leaves), list(leaves.values())))


def _fc_train(rt: MDNetRuntime, model, fc: dict, momentum: dict, pos: Rows, neg: Rows,
              n_iter: int, lr: float, draws, key, pos_p=None, neg_p=None, gnet=None,
              g_state=None, inject_idx=None, dropout=True, vital_active=True,
              inject_masks=None, mined: Optional[list] = None):
    """SGD with momentum over the fc leaves with hard-negative mining (pyMDNet
    train(), run_tracker.py:52-117); pos_p / neg_p the host sampling
    weights of the pools' rows. A step in torch SGD's order: the data
    gradient, clip by the global norm, + weight_decay * p, the momentum
    buffer, the per-leaf lr (fc6 x lr_mult_fc6).

    inject_idx (pos_idx (T, batch_pos), cand_idx (T, batch_neg_cand))
    replaces the batch draws and dropout=False turns the fc dropout off
    (the parity harness's settings); inject_masks (T, batch_pos, hw, hw)
    replaces G's drop masks. With rt.vital, gnet and a G state, the
    positives are masked by G's hardest cells and G takes rt.g_update_iters
    steps against the updated classifier, only when vital_active (a
    successful long-term update). `mined` collects each iteration's mined
    negative indices. Returns (fc, momentum, key, g_state)."""
    use_vital = rt.vital and gnet is not None and bool(g_state)
    dev = pos.parts[0].device
    lrs = {k: lr * (rt.lr_mult_fc6 if model.is_fc6(k) else 1.0) for k in fc}
    for i in range(n_iter):
        key, r_pos, _, r_mine, r_drop = draws.split(key, 5)   # JAX's r_neg goes unused
        if inject_idx is not None:
            pos_idx = _to_device(torch.as_tensor(np.asarray(inject_idx[0][i])), dev)
            cand_idx = _to_device(torch.as_tensor(np.asarray(inject_idx[1][i])), dev)
        else:
            pos_idx = _to_device(draws.choice(r_pos, pos_p, (rt.batch_pos,)), dev)
            cand_idx = _to_device(draws.choice(r_mine, neg_p, (rt.batch_neg_cand,)), dev)
        cand_scores = model.score(neg.take(cand_idx), 0, None, fc)[:, 1]
        neg_idx = cand_idx[_topk(cand_scores, rt.batch_neg)]
        if mined is not None:
            mined.append(neg_idx)
        pf = pos.take(pos_idx)
        if inject_masks is not None:
            pf = _apply_cell_mask(rt, pf, _to_device(torch.as_tensor(
                np.asarray(inject_masks[i], np.float32)), dev))
        elif use_vital and vital_active:
            pf = _apply_cell_mask(rt, pf, _vital_drop_mask(rt, gnet, g_state["g"], pf))
        nf = neg.take(neg_idx)
        keep_p = keep_n = None
        if dropout:
            r1, r2 = draws.split(r_drop)
            keep_p = tuple(_to_device(m, dev) for m in model.dropout_masks(draws, r1, pf.shape[0]))
            keep_n = tuple(_to_device(m, dev) for m in model.dropout_masks(draws, r2, nf.shape[0]))
        grads = _grads(lambda p: _bce(rt, model.score(pf, 0, keep_p, p),
                                      model.score(nf, 0, keep_n, p)), fc)
        gnorm = torch.sqrt(sum((g ** 2).sum() for g in grads))
        clip = torch.clamp(rt.grad_clip / (gnorm + 1e-6), max=1.0)
        grads = [g * clip + rt.weight_decay * p for g, p in zip(grads, fc.values())]
        fc, momentum = _sgd(fc, momentum, grads, rt.momentum, lrs)

    if use_vital and n_iter > 0 and vital_active:
        g, g_mom = g_state["g"], g_state["g_mom"]
        lr_g = dict.fromkeys(g, rt.lr_g)
        for _ in range(rt.g_update_iters):
            key, r = draws.split(key)
            pf = pos.take(_to_device(draws.choice(r, pos_p, (rt.batch_pos,)), dev))

            def objective(gp):
                masked = _apply_cell_mask(rt, pf, gnet(pf.sum(1), gp))
                return model.score(masked, 0, None, fc)[:, 1].mean()

            g, g_mom = _sgd(g, g_mom, _grads(objective, g), rt.momentum, lr_g)
        g_state = {"g": g, "g_mom": g_mom}
    return fc, momentum, key, g_state


def _g_pretrain(rt: MDNetRuntime, model, gnet: GNet, fc: dict, pos_feats, draws, k_init,
                k_loop) -> dict:
    """pyVITAL's g_pretrain (g_pretrain.py, run_tracker.py:251): G learns to
    flag the rt.vital_drop_cells cells whose removal lowers the fresh
    classifier's mean positive probability most."""
    dev = pos_feats.device
    n_cells = rt.vital_feat_hw * rt.vital_feat_hw
    g = {k: v.to(dev) for k, v in gnet.init_from(draws, k_init).items()}
    g_mom = {k: torch.zeros_like(v) for k, v in g.items()}
    one_cell = one_cell_masks(rt.vital_feat_hw, dev)
    lr_g = dict.fromkeys(g, rt.lr_g)
    rng = k_loop
    for _ in range(rt.g_pretrain_iters):
        rng, r = draws.split(rng)
        pf = pos_feats[_to_device(draws.randint(r, (rt.batch_pos,), rt.n_init_pos), dev)]
        B = pf.shape[0]
        dmg = torch.stack([
            torch.softmax(model.score(_apply_cell_mask(rt, pf, m.expand(B, -1, -1)), 0, None, fc),
                          -1)[:, 1].mean() for m in one_cell])
        target = torch.ones_like(dmg).scatter_(0, _topk(-dmg, rt.vital_drop_cells), 0.0)

        def pre_loss(gp):
            return ((gnet(pf.sum(1), gp).reshape(B, n_cells) - target[None]) ** 2).mean()

        g, g_mom = _sgd(g, g_mom, _grads(pre_loss, g), rt.momentum, lr_g)
    return {"g": g, "g_mom": g_mom}


# ---------------------------------------------------------------- bbox regression

def _bbreg_targets(boxes, gt):
    cx = boxes[:, 0] + boxes[:, 2] / 2
    cy = boxes[:, 1] + boxes[:, 3] / 2
    gcx, gcy = gt[0] + gt[2] / 2, gt[1] + gt[3] / 2
    return torch.stack([(gcx - cx) / boxes[:, 2], (gcy - cy) / boxes[:, 3],
                        torch.log(gt[2] / boxes[:, 2]), torch.log(gt[3] / boxes[:, 3])], 1)


def _refine(boxes, deltas):
    cx = boxes[:, 0] + boxes[:, 2] / 2 + deltas[:, 0] * boxes[:, 2]
    cy = boxes[:, 1] + boxes[:, 3] / 2 + deltas[:, 1] * boxes[:, 3]
    w = boxes[:, 2] * torch.exp(deltas[:, 2])
    h = boxes[:, 3] * torch.exp(deltas[:, 3])
    return cx, cy, w, h


def _bbreg_apply(boxes, deltas, img_hw):
    """BBRegressor.predict (bbreg.py:35-48) with its clamps: xy >= 0 and
    wh <= img - the OLD top-left."""
    cx, cy, w, h = _refine(boxes, deltas)
    H, W = img_hw
    return torch.stack([torch.clamp(cx - w / 2, min=0.0), torch.clamp(cy - h / 2, min=0.0),
                        torch.minimum(w, W - boxes[:, 0]), torch.minimum(h, H - boxes[:, 1])], 1)


def _bbreg_apply_manet(rt: MDNetRuntime, boxes, deltas, img_hw):
    """MANet's BBRegressor.predict (bbreg.py:35-55): refine without clamps,
    revert a box whose IoU with the unrefined box leaves rt.bbreg_overlap
    or whose area ratio (old / new) leaves rt.bbreg_scale_range, then
    clamp as _bbreg_apply does."""
    cx, cy, w, h = _refine(boxes, deltas)
    ref = torch.stack([cx - w / 2, cy - h / 2, w, h], 1)
    x1 = torch.maximum(boxes[:, 0], ref[:, 0])
    y1 = torch.maximum(boxes[:, 1], ref[:, 1])
    x2 = torch.minimum(boxes[:, 0] + boxes[:, 2], ref[:, 0] + ref[:, 2])
    y2 = torch.minimum(boxes[:, 1] + boxes[:, 3], ref[:, 1] + ref[:, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    union = boxes[:, 2] * boxes[:, 3] + ref[:, 2] * ref[:, 3] - inter
    r = inter / torch.clamp(union, min=1e-9)
    s = (boxes[:, 2] * boxes[:, 3]) / torch.clamp(ref[:, 2] * ref[:, 3], min=1e-9)
    keep = ((r >= rt.bbreg_overlap[0]) & (r <= rt.bbreg_overlap[1])
            & (s >= rt.bbreg_scale_range[0]) & (s <= rt.bbreg_scale_range[1]))
    out = torch.where(keep[:, None], ref, boxes)
    H, W = img_hw
    room = torch.stack([W - boxes[:, 0], H - boxes[:, 1]], 1)
    return torch.cat([torch.clamp(out[:, :2], min=0.0), torch.minimum(out[:, 2:], room)], 1)


def _ridge_fit(X, Y, lam: float, valid=None):
    """Centred dual ridge, sklearn's Ridge(alpha=lam) with its intercept
    (bbreg.py:14): fit on mean-centred X / Y, predict (q - mu_x) @ Xc^T @ A
    + mu_y. `valid` masks the filtered-out samples (out of the means, a
    zero kernel row and column)."""
    if valid is None:
        valid = torch.ones(X.shape[0], device=X.device)
    nv = torch.clamp(valid.sum(), min=1.0)
    mu_x = (X * valid[:, None]).sum(0) / nv
    mu_y = (Y * valid[:, None]).sum(0) / nv
    Xc = (X - mu_x) * valid[:, None]
    Yc = (Y - mu_y) * valid[:, None]
    K = Xc @ Xc.T
    A = torch.linalg.solve_ex(K + lam * torch.eye(X.shape[0], device=X.device), Yc).result
    return A, Xc, mu_x, mu_y


def _bbreg_valid(rt: MDNetRuntime, boxes, init_box):
    """BBRegressor.train's re-filter (bbreg.py:24-29): overlap and area ratio."""
    ious = _iou(boxes, init_box)
    s = (boxes[:, 2] * boxes[:, 3]) / (init_box[2] * init_box[3])
    return ((ious >= rt.bbreg_overlap[0]) & (ious <= rt.bbreg_overlap[1])
            & (s >= rt.bbreg_scale_range[0]) & (s <= rt.bbreg_scale_range[1])).float()


# ---------------------------------------------------------------- runtime

def _init_common(rt: MDNetRuntime, model, init_box, pos_feats, neg_feats, bb_feats, bb_boxes,
                 neg_upd, draws, key, train_key, inject_idx=None, dropout=True,
                 g_keys=None, gnet=None) -> dict:
    """The init after the features: fc training, G's pretrain, the ridge
    regressor and the memories. neg_upd() embeds the fresh negatives of
    the first memory entry (pyMDNet)."""
    fc = {k: v.detach().clone() for k, v in model.fc_leaves().items()}
    zeros = {k: torch.zeros_like(v) for k, v in fc.items()}
    fc, _, _, _ = _fc_train(
        rt, model, fc, zeros, Rows(pos_feats), Rows(neg_feats), rt.init_iters, rt.lr_init, draws,
        train_key, pos_p=_uniform_p(pos_feats.shape[0]), neg_p=_uniform_p(neg_feats.shape[0]),
        inject_idx=inject_idx, dropout=dropout)
    g_state = {}
    if rt.vital and gnet is not None and g_keys is not None:
        g_state = _g_pretrain(rt, model, gnet, fc, pos_feats, draws, *g_keys)
    A, Xc, mu_x, mu_y = _ridge_fit(bb_feats.sum(1), _bbreg_targets(bb_boxes, init_box),
                                   rt.bbreg_lambda, valid=_bbreg_valid(rt, bb_boxes, init_box))
    S, D = pos_feats.shape[1:]
    pos_mem = pos_feats.new_zeros((rt.n_frames_long, rt.n_pos_update, S, D))
    neg_mem = pos_feats.new_zeros((rt.n_frames_short, rt.n_neg_update, S, D))
    if rt.manet_seed_memory:
        pos_init = pos_feats[:rt.n_pos_update].clone()
        neg_mem[0] = neg_feats[:rt.n_neg_update]
    else:
        pos_init = pos_feats
        neg_mem[0] = neg_upd()
    box = init_box.float()
    return {"box": box, "report_box": box, "report_box_host": box.cpu().numpy(),
            "pos_init": pos_init, "fc": fc, "momentum": zeros,
            "pos_mem": pos_mem, "neg_mem": neg_mem, "pos_count": 1, "neg_count": 1,
            "trans_f": np.float32(rt.trans), "frame_num": 1,
            "bbreg_X": Xc, "bbreg_alpha": A, "bbreg_mu_x": mu_x, "bbreg_mu_y": mu_y,
            "rng": key, "g_state": g_state}


def _uniform_p(n: int) -> np.ndarray:
    return np.full(n, np.float32(1.0) / np.float32(n), np.float32)


def mdnet_init_state(rt: MDNetRuntime, model, frame: torch.Tensor, init_box: torch.Tensor,
                     draws, key, gnet: Optional[GNet] = None) -> dict:
    """First-frame state. frame (H, W, C) uint8 or f32 on the model's device,
    init_box (4,) xywh on the same device."""
    img = frame.float()
    img_hw = tuple(frame.shape[:2])
    rngs = draws.split(key, 8)
    pos_boxes = _sample_filtered(draws, rngs[0], Sampler("gaussian", rt.trans_pos, rt.scale_pos),
                                 init_box, rt.n_init_pos, rt.overlap_pos, img_hw)
    r_nu, r_nw = draws.split(rngs[1])
    half = rt.n_init_neg // 2
    neg_boxes = torch.cat([
        _sample_filtered(draws, r_nu, Sampler("uniform", rt.trans_neg_init, rt.scale_neg_init),
                         init_box, half, rt.overlap_neg, img_hw),
        _sample_filtered(draws, r_nw, Sampler("whole", scale=1.0), init_box,
                         rt.n_init_neg - half, rt.overlap_neg, img_hw)])
    pos_feats = _extract_patches(rt, model, img, pos_boxes)
    neg_feats = _extract_patches(rt, model, img, neg_boxes)
    bb_boxes = _sample_filtered(
        draws, rngs[3], Sampler("uniform", rt.trans_bbreg, rt.scale_bbreg, rt.aspect_bbreg),
        init_box, rt.n_bbreg, rt.bbreg_overlap, img_hw)
    bb_feats = _extract_patches(rt, model, img, bb_boxes)

    def neg_upd():
        boxes = _sample_filtered(draws, rngs[7], Sampler("uniform", rt.trans_neg, rt.scale_neg),
                                 init_box, rt.n_neg_update, rt.overlap_neg, img_hw)
        return _extract_patches(rt, model, img, boxes)

    return _init_common(rt, model, init_box, pos_feats, neg_feats, bb_feats, bb_boxes, neg_upd,
                        draws, rngs[4], rngs[2], g_keys=(rngs[5], rngs[6]), gnet=gnet)


def mdnet_init_from_patches(rt: MDNetRuntime, model, init_box, pos_patches, neg_patches,
                            bbreg_patches, bbreg_boxes, neg_upd_patches, draws, key,
                            inject_idx=None, dropout=True) -> dict:
    """The parity harness's init: given raw crops (N, 107, 107, C) on the
    0..255 scale and training index streams; the state carries `key`."""
    return _init_common(
        rt, model, init_box, _embed_patches(rt, model, pos_patches),
        _embed_patches(rt, model, neg_patches), _embed_patches(rt, model, bbreg_patches),
        bbreg_boxes, lambda: _embed_patches(rt, model, neg_upd_patches), draws, key, key,
        inject_idx=inject_idx, dropout=dropout)


def _pool_weights(rt: MDNetRuntime, state: dict, success: bool):
    """Host sampling weights of the positive pool (init entry, then the
    ring's rows) and the negative ring (run_tracker.py:182-186, 253-274):
    the long-term window on success, the short-term one on failure."""
    Lp, Ln = state["pos_mem"].shape[0], state["neg_mem"].shape[0]
    u = state["pos_count"] - 1
    slots_p, slots_n = np.arange(Lp), np.arange(Ln)
    filled_p = slots_p < min(u, Lp)
    filled_n = slots_n < min(state["neg_count"], Ln)
    recent = (u - 1 - slots_p) % Lp < rt.n_frames_short
    pos_sel = filled_p if success else filled_p & recent
    init_valid = state["pos_count"] <= rt.n_frames_long
    if not success:
        init_valid = init_valid and state["pos_count"] <= rt.n_frames_short
    pos_valid = np.concatenate([np.full(state["pos_init"].shape[0], float(init_valid), np.float32),
                                np.repeat(pos_sel.astype(np.float32), rt.n_pos_update)])
    neg_valid = np.repeat(filled_n.astype(np.float32), rt.n_neg_update)
    return (pos_valid / np.float32(max(pos_valid.sum(), 1.0)),
            neg_valid / np.float32(max(neg_valid.sum(), 1.0)))


def _mdnet_core(rt: MDNetRuntime, model, state: dict, cands, feats, img_hw, collect_fn, draws,
                r_train, inject_idx=None, dropout=True, gnet=None, inject_masks=None):
    """The per-frame protocol given candidate boxes and features;
    collect_fn(raw_box) -> (pos_feats, neg_feats) gives the update samples.
    Returns (state, box (4,) on the host, mean score, aux)."""
    scores = model.score(feats, 0, None, state["fc"])[:, 1]
    top_idx = _topk(scores, rt.topk)
    mean_score = scores[top_idx].mean()
    top_boxes = cands[top_idx]
    new_box = top_boxes.mean(0)
    Xq = feats[top_idx].sum(1)
    deltas = ((Xq - state["bbreg_mu_x"]) @ state["bbreg_X"].T) @ state["bbreg_alpha"] \
        + state["bbreg_mu_y"]
    refined = (_bbreg_apply_manet(rt, top_boxes, deltas, img_hw) if rt.bbreg_reject
               else _bbreg_apply(top_boxes, deltas, img_hw)).mean(0)
    read = torch.cat([mean_score[None], refined, new_box]).cpu().numpy()  # the frame's one read
    score = read[0]
    success = bool(score > np.float32(rt.success_thr))
    if success:
        box, box_host, raw_box = refined, read[1:5], new_box
    elif rt.revert_on_failure:
        box, box_host, raw_box = state["report_box"], state["report_box_host"], state["box"]
    else:
        box, box_host, raw_box = new_box, read[5:9], new_box
    if success:
        trans_f = np.float32(rt.trans)
    elif rt.hard_trans_expand:
        trans_f = np.float32(rt.trans_f_expand)
    else:
        trans_f = min(state["trans_f"] * np.float32(1.1), np.float32(rt.trans_f_expand))
    state = {**state, "box": raw_box, "report_box": box, "report_box_host": box_host,
             "trans_f": trans_f}

    if success:
        pos_f, neg_f = collect_fn(raw_box)
        state["pos_mem"][(state["pos_count"] - 1) % state["pos_mem"].shape[0]] = \
            pos_f[:rt.n_pos_update]
        state["neg_mem"][state["neg_count"] % state["neg_mem"].shape[0]] = neg_f[:rt.n_neg_update]
        state["pos_count"] += 1
        state["neg_count"] += 1

    long_update = state["frame_num"] % rt.long_interval == 0
    do_update = not success or long_update
    mined: list = []
    if do_update:
        S, D = state["pos_mem"].shape[2:]
        pos_p, neg_p = _pool_weights(rt, state, success)
        fc, mom, _, g_state = _fc_train(
            rt, model, state["fc"], state["momentum"],
            Rows(state["pos_init"], state["pos_mem"].view(-1, S, D)),
            Rows(state["neg_mem"].view(-1, S, D)), rt.update_iters, rt.lr_update, draws, r_train,
            pos_p=pos_p, neg_p=neg_p, gnet=gnet, g_state=state["g_state"] or None,
            inject_idx=inject_idx, dropout=dropout, vital_active=success and long_update,
            inject_masks=inject_masks, mined=mined)
        state = {**state, "fc": fc, "momentum": mom, "g_state": g_state or state["g_state"]}
    aux = {"scores": scores, "top_idx": top_idx, "success": success, "raw_box": raw_box,
           "deltas": deltas, "refined": refined, "do_update": do_update,
           "long_update": success and long_update, "trans_f": trans_f, "mined": mined}
    return state, box_host, float(score), aux


def mdnet_track_step(rt: MDNetRuntime, model, state: dict, frame: torch.Tensor, draws,
                     gnet: Optional[GNet] = None):
    """A tracked frame, frame (H, W, C) uint8 or f32 on the model's device:
    device crops for the candidates and the update samples."""
    img = frame.float()
    img_hw = tuple(frame.shape[:2])
    state = {**state, "frame_num": state["frame_num"] + 1}
    rng, r_cand, r_pos, r_neg, r_train = draws.split(state["rng"], 5)
    state["rng"] = rng
    cands = _sample(draws, r_cand, Sampler("gaussian", float(state["trans_f"]), rt.scale_f),
                    state["box"], rt.n_samples, img_hw)
    feats = _extract_patches(rt, model, img, cands)

    def collect_fn(raw_box):
        pos_boxes = _sample_filtered(draws, r_pos, Sampler("gaussian", rt.trans_pos, rt.scale_pos),
                                     raw_box, rt.n_pos_update, rt.overlap_pos, img_hw)
        neg_boxes = _sample_filtered(draws, r_neg, Sampler("uniform", rt.trans_neg, rt.scale_neg),
                                     raw_box, rt.n_neg_update, (0.0, 0.3), img_hw)
        return (_extract_patches(rt, model, img, pos_boxes),
                _extract_patches(rt, model, img, neg_boxes))

    return _mdnet_core(rt, model, state, cands, feats, img_hw, collect_fn, draws, r_train,
                       gnet=gnet)


def mdnet_step_from_patches(rt: MDNetRuntime, model, state: dict, cand_boxes, cand_patches,
                            pos_patches, neg_patches, im_hw, draws, inject_idx=None,
                            dropout=True, inject_masks=None, gnet: Optional[GNet] = None):
    """The parity harness's step: candidate boxes and raw crops, the update
    crops, the training index streams (and VITAL's drop masks) given."""
    state = {**state, "frame_num": state["frame_num"] + 1}
    rng, r_train = draws.split(state["rng"])
    state["rng"] = rng
    feats = _embed_patches(rt, model, cand_patches)
    return _mdnet_core(
        rt, model, state, cand_boxes, feats, im_hw,
        lambda raw_box: (_embed_patches(rt, model, pos_patches),
                         _embed_patches(rt, model, neg_patches)),
        draws, r_train, inject_idx=inject_idx, dropout=dropout, gnet=gnet,
        inject_masks=inject_masks)


class MDNetTracker:
    """Single-sequence facade (BaseTracker API). `model` must hold its
    weights; it is moved to `device` and frozen (the fc leaves train as
    the state's own tensors). `draws` is a factory of draw sources, called
    at every initialize (default TorchDraws(seed)). A frame reads the card
    once. `updates` counts the long-term and short-term updates and
    `failures` the failed frames since construction."""

    def __init__(self, model, device, runtime: Optional[MDNetRuntime] = None, seed: int = 0,
                 draws: Optional[Callable[[], object]] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.rt = runtime or MDNetRuntime()
        self.seed = seed
        self.draws = draws or (lambda: TorchDraws(seed))
        self.gnet = None
        if self.rt.vital:
            self.gnet = GNet(self.rt.vital_feat_hw, self.rt.vital_feat_dim).to(self.device)
            self.gnet.requires_grad_(False)
        self.state = None
        self.updates = {"long": 0, "short": 0}
        self.failures = 0
        self.last_aux = None

    def _frame(self, image) -> torch.Tensor:
        return as_frames(image, self.device)[..., :self.model.in_channels]

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        self._draw = self.draws()
        box = _to_device(torch.from_numpy(np.asarray(info["init_bbox"], np.float32)), self.device)
        self.state = mdnet_init_state(self.rt, self.model, self._frame(image), box, self._draw,
                                      self._draw.key(), gnet=self.gnet)

    @torch.no_grad()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        self.state, box, score, aux = mdnet_track_step(self.rt, self.model, self.state,
                                                       self._frame(image), self._draw, self.gnet)
        self.last_aux = aux
        self.failures += not aux["success"]
        if aux["do_update"]:
            self.updates["long" if aux["long_update"] else "short"] += 1
        return {"target_bbox": [float(v) for v in box], "best_score": score}
