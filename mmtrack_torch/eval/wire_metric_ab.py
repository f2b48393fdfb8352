"""What each streaming wire costs in accuracy: port of
tools/wire_metric_ab.py.

    python -m mmtrack_torch.eval.wire_metric_ab [--n-seq 20] [--n-frames 101]
        [--train-seqs 8] [--steps 1500]

A synthetic OPE corpus (20 sequences x 101 frames of 320x240 jpeg + 16-bit
depth png, the JAX tool's seeds) is tracked end to end by deep_rgbd at
bf16 through `parallel/batched_eval.py::BatchedViPTTracker`, all
sequences in one batch, under each wire:

  host      `data/composition.py::get_x_frame` on the host, then `track`:
            the reference's own path and the baseline;
  rgbindex  `data/native_io.py::decode_pair_rgb_index` (RGB + JET index,
            4 B/px), composed on the card by `track_split`; bit-equal to
            host by construction;
  yuv420    `decode_pair_yuv_index` (raw 4:2:0 planes + JET index, 2.5
            B/px), `track_yuv`; it needs the native decoder (libjpeg), and
            where that does not load its entry says "not run" and why.

Random weights would make the comparison meaningless (their score maps
are noise whose argmax flips under a 1-LSB change), so the CENTER head is
first overfitted on the card on composed crops of the first
`--train-seqs` sequences, as the JAX tool's `overfit_head_on_device`
does: only `box_head` trains (the rest frozen, JAX's masked Adam), BCE on
the logits of the clamped-sigmoid maps, wide scale jitter, lr 2e-3
dropping 0.25x at half the steps, then the exact logit-space calibration
of the last size bias. Prints one JSON line per wire (SR / PR / NPR from
`eval/metrics.py::evaluate_ope`) and the summary: the deltas from host,
the box deviations, `within_budget` at the 0.001 clause over the wires
that ran, and the decoder. Writes docs/artifacts/wire_metric_ab_torch.json
and the corpus into .wire_ab_fixtures_torch/ (made once per size).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from mmtrack_torch.config import vipt_experiment_config
from mmtrack_torch.data import native_io
from mmtrack_torch.data.composition import get_x_frame
from mmtrack_torch.data.processing import sample_target_np
from mmtrack_torch.data.synthetic import make_synthetic_sequence
from mmtrack_torch.eval.metrics import evaluate_ope
from mmtrack_torch.models.vipt import build_viptrack
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
from mmtrack_torch.trackers.vipt_tracker import MEAN_6CH, STD_6CH, ViPTRuntime, make_track_scan
from mmtrack_torch.utils import optouts
from mmtrack_torch.utils.device import require_cuda

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE_DIR = os.path.join(REPO, ".wire_ab_fixtures_torch")
ART = os.path.join(REPO, "docs", "artifacts", "wire_metric_ab_torch.json")
H, W = 240, 320
WIRES = ("host", "rgbindex", "yuv420")
METRICS = ("success_auc", "precision_20px", "norm_precision_auc")
BUDGET = 0.001                     # absolute on SR / PR / NPR: the 0.1% clause
LR, LR_DROP = 2e-3, 0.25


def ensure_fixtures(root: str, n_seq: int, n_frames: int) -> None:
    """jpeg + png sequences with randomised central trajectories under
    `root`, the JAX tool's (:51-85) byte for byte; the depth plane carries
    the target as a near plane. Made once: a marker names the size."""
    import cv2

    marker = os.path.join(root, f"ok_{n_seq}x{n_frames}_{H}x{W}")
    if os.path.exists(marker):
        return
    rng = np.random.RandomState(7)
    for b in range(n_seq):
        w0, h0 = int(rng.uniform(36, 60)), int(rng.uniform(28, 46))
        x0 = rng.uniform(0.3, 0.6) * (W - w0)
        y0 = rng.uniform(0.3, 0.6) * (H - h0)
        vel = (float(rng.uniform(-2.5, 2.5)), float(rng.uniform(-1.8, 1.8)))
        frames, gt = make_synthetic_sequence(
            n_frames=n_frames, height=H, width=W, seed=1000 + b,
            box0=(x0, y0, float(w0), float(h0)), velocity=vel)
        sd = os.path.join(root, f"seq{b:02d}")
        os.makedirs(os.path.join(sd, "color"), exist_ok=True)
        os.makedirs(os.path.join(sd, "depth"), exist_ok=True)
        depth_bg = np.random.RandomState(b).randint(2500, 3500, (H, W), np.uint16)
        np.save(os.path.join(sd, "gt.npy"), gt)
        for t in range(n_frames):
            jp, pp = paths(root, b, t)
            cv2.imwrite(jp, frames[t][..., :3][..., ::-1])
            depth = depth_bg.copy()
            x, y, bw, bh = [int(round(v)) for v in gt[t]]
            depth[max(y, 0):y + bh, max(x, 0):x + bw] = 800
            cv2.imwrite(pp, depth)
    open(marker, "w").close()


def paths(root: str, b: int, t: int) -> tuple[str, str]:
    sd = os.path.join(root, f"seq{b:02d}")
    return os.path.join(sd, "color", f"{t:04d}.jpg"), os.path.join(sd, "depth", f"{t:04d}.png")


def compose_host(root: str, b: int, t: int) -> np.ndarray:
    return get_x_frame(*paths(root, b, t), "rgbcolormap", depth_clip=True)


def ground_truth(root: str, n_seq: int) -> list[np.ndarray]:
    return [np.load(os.path.join(root, f"seq{b:02d}", "gt.npy")) for b in range(n_seq)]


def head_crops(root: str, n_seq_train: int, n_frames: int) -> dict:
    """The overfit's samples, as the JAX tool caches them (:122-168): for
    every 10th frame of the first sequences, the crop at the true box and
    one jittered in centre (0.25 sqrt(wh)) and scale (e^+-0.25), each with
    its normalised template and search crops, Gaussian score label, size
    and offset labels, and the label cell with its 3 x 3 neighbours."""
    sf, ssz, stride, feat_sz = 4.0, 256, 16, 16
    rng = np.random.RandomState(0)
    k = np.arange(feat_sz, dtype=np.float64)
    rows = {key: [] for key in ("z", "x", "sc", "sz", "of", "idx", "nb")}
    for b, gt in enumerate(ground_truth(root, n_seq_train)):
        z_crop, _, _ = sample_target_np(compose_host(root, b, 0), gt[0].astype(np.float64),
                                        2.0, 128)
        z = (z_crop.astype(np.float32) / 255.0 - MEAN_6CH) / STD_6CH
        for t in range(0, n_frames, 10):
            frame = compose_host(root, b, t)
            x0, y0, w, h = [float(v) for v in gt[t]]
            cx, cy = x0 + 0.5 * w, y0 + 0.5 * h
            for j in range(2):
                if j == 0:
                    jb = [x0, y0, w, h]
                else:
                    dx, dy = rng.uniform(-0.25, 0.25, 2) * math.sqrt(w * h)
                    ds = math.exp(rng.uniform(-0.25, 0.25))
                    jw, jh = w * ds, h * ds
                    jb = [cx + dx - 0.5 * jw, cy + dy - 0.5 * jh, jw, jh]
                crop, rf, _ = sample_target_np(frame, np.asarray(jb), sf, ssz)
                jcx, jcy = jb[0] + 0.5 * jb[2], jb[1] + 0.5 * jb[3]
                gx = ((cx - jcx) * rf + 0.5 * ssz) / stride
                gy = ((cy - jcy) * rf + 0.5 * ssz) / stride
                ix, iy = int(gx), int(gy)
                if not (0 <= ix < feat_sz and 0 <= iy < feat_sz):
                    continue
                lab = np.exp(-0.5 * ((k[None, :] - gx) ** 2 + (k[:, None] - gy) ** 2))
                nb = [(iy + dy2) * feat_sz + (ix + dx2)
                      for dy2 in (-1, 0, 1) for dx2 in (-1, 0, 1)
                      if 0 <= iy + dy2 < feat_sz and 0 <= ix + dx2 < feat_sz]
                rows["z"].append(z)
                rows["x"].append((crop.astype(np.float32) / 255.0 - MEAN_6CH) / STD_6CH)
                rows["sc"].append(lab.astype(np.float32))
                rows["sz"].append([w * rf / ssz, h * rf / ssz])
                rows["of"].append([gx - ix, gy - iy])
                rows["idx"].append(iy * feat_sz + ix)
                rows["nb"].append((nb + [iy * feat_sz + ix] * 9)[:9])
    return {"z": np.stack(rows["z"]), "x": np.stack(rows["x"]), "sc": np.stack(rows["sc"]),
            "sz": np.asarray(rows["sz"], np.float32), "of": np.asarray(rows["of"], np.float32),
            "idx": np.asarray(rows["idx"], np.int64), "nb": np.asarray(rows["nb"], np.int64)}


def logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p) - torch.log1p(-p)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: labels cast to the logits' dtype."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def head_forward(model, data: dict, i: int, rt: ViPTRuntime) -> dict:
    return model(data["z"][i:i + 1], data["x"][i:i + 1], None, rt.ce_keep_lens)


def head_loss(model, data: dict, i: int, rt: ViPTRuntime) -> torch.Tensor:
    """The JAX tool's loss of sample i (:178-188): BCE of the score map's
    logits on the Gaussian label, 2x BCE of the size logits on the 3 x 3
    cells around the label cell, 0.2x L1 of its offset."""
    out = head_forward(model, data, i, rt)
    sc = bce_with_logits(logit(out["score_map"][0]), data["sc"][i]).mean()
    sz_log = logit(out["size_map"][0].reshape(-1, 2)[data["nb"][i]])
    sz = bce_with_logits(sz_log, data["sz"][i][None].expand(9, 2)).mean()
    of = (out["offset_map"][0].reshape(-1, 2)[data["idx"][i]] - data["of"][i]).abs().mean()
    return sc + 2.0 * sz + 0.2 * of


def train_head(model, data: dict, steps: int, log_every: int = 200) -> list[float]:
    """Adam on `box_head` alone for `steps` samples, in the JAX tool's
    order (a RandomState(it) shuffle at every pass); lr LR, times LR_DROP
    from step steps // 2 on. The rest of the model is frozen. Returns the
    loss of every step."""
    rt = ViPTRuntime()
    trainable = [p for name, p in model.named_parameters() if name.startswith("box_head.")]
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith("box_head."))
    opt = torch.optim.Adam(trainable, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    n = data["z"].shape[0]
    order = np.arange(n)
    losses = []
    for it in range(steps):
        if it % n == 0:
            np.random.RandomState(it).shuffle(order)
        for group in opt.param_groups:
            group["lr"] = LR * (LR_DROP if it >= steps // 2 else 1.0)
        opt.zero_grad(set_to_none=True)
        loss = head_loss(model, data, int(order[it % n]), rt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log_every and it % log_every == 0:
            print(f"  step {it}: loss {float(losses[-1]):.4f}", flush=True)
    return [float(v) for v in losses]


def calibrate_size_bias(model, data: dict) -> np.ndarray:
    """The exact logit-space size calibration (:218-240): add to the last
    size bias of `box_head` the mean over the samples of the label's logit
    less the predicted size logit at the label cell. Returns that delta."""
    rt = ViPTRuntime()
    dsum = np.zeros(2)
    with torch.no_grad():
        for i in range(data["z"].shape[0]):
            lab = data["sz"][i].double().cpu().numpy()
            out = head_forward(model, data, i, rt)
            pred = logit(out["size_map"][0].reshape(-1, 2)[data["idx"][i]])
            dsum += np.log(lab / (1 - lab)) - pred.double().cpu().numpy()
        delta = dsum / data["z"].shape[0]
        params = dict(model.named_parameters())
        last = sorted(k for k in params if k.startswith("box_head.") and "size" in k
                      and k.endswith(".bias"))[-1]
        if params[last].shape != (2,):
            raise ValueError(f"{last}: expected the (2,) size bias, "
                             f"got {tuple(params[last].shape)}")
        params[last].add_(torch.from_numpy(delta).to(params[last]))
    print(f"size-bias calibration: logit delta {delta.round(4).tolist()} on {last}", flush=True)
    return delta


def overfit_head(model, root: str, n_seq_train: int, n_frames: int, steps: int,
                 log_every: int = 200) -> dict:
    """Make `model` track (module docstring): the samples, the head's
    training and the size calibration, on the model's device. Returns the
    losses, the calibration delta and the number of samples."""
    device = next(model.parameters()).device
    data = {k: torch.from_numpy(v).to(device) for k, v in
            head_crops(root, n_seq_train, n_frames).items()}
    print(f"head overfit: {data['z'].shape[0]} crops cached", flush=True)
    losses = train_head(model, data, steps, log_every)
    for p in model.parameters():
        p.requires_grad_(False)
    return {"losses": losses, "delta": calibrate_size_bias(model, data),
            "samples": int(data["z"].shape[0])}


def yuv_unavailable(root: str) -> str | None:
    """Why the yuv420 wire cannot run on this machine's decoder for this
    corpus, or None when it can."""
    if native_io.load_imageio_lib() is None:
        return f"not run: the native decoder did not load ({native_io.load_error()})"
    y, idx = np.zeros((H, W), np.uint8), np.zeros((H, W), np.uint8)
    cb, cr = np.zeros((H // 2, W // 2), np.uint8), np.zeros((H // 2, W // 2), np.uint8)
    if not native_io.decode_pair_yuv_index(*paths(root, 0, 0), y, cb, cr, idx, clip=True):
        return "not run: the native decoder refused the corpus's 4:2:0 jpeg"
    return None


def run_wire(wire: str, model, rt: ViPTRuntime, root: str, n_seq: int, n_frames: int,
             device, scan=None) -> tuple[np.ndarray, float]:
    """Track every sequence in one batch under `wire`. Returns (boxes
    (n_seq, n_frames - 1, 4), seconds). `scan` is shared between wires (a
    `make_track_scan` on the card captures each shape once)."""
    gts = ground_truth(root, n_seq)
    tracker = BatchedViPTTracker(model, device, rt, scan=scan)
    tracker.initialize(np.stack([compose_host(root, b, 0) for b in range(n_seq)]),
                       np.stack([g[0] for g in gts]).astype(np.float32))
    rgb, idx = tracker.host_buffer((n_seq, H, W, 3)), tracker.host_buffer((n_seq, H, W))
    y = tracker.host_buffer((n_seq, H, W))
    cb = tracker.host_buffer((n_seq, H // 2, W // 2))
    cr = tracker.host_buffer((n_seq, H // 2, W // 2))
    boxes = []
    t0 = time.perf_counter()
    for t in range(1, n_frames):
        if wire == "host":
            bx, _ = tracker.track(np.stack([compose_host(root, b, t) for b in range(n_seq)]))
        elif wire == "rgbindex":
            for b in range(n_seq):
                native_io.decode_pair_rgb_index(*paths(root, b, t), rgb[b], idx[b], clip=True)
            bx, _ = tracker.track_split(rgb, idx)
        elif wire == "yuv420":
            for b in range(n_seq):
                if not native_io.decode_pair_yuv_index(*paths(root, b, t), y[b], cb[b], cr[b],
                                                       idx[b], clip=True):
                    raise RuntimeError(f"yuv420: the decoder refused {paths(root, b, t)[0]}")
            bx, _ = tracker.track_yuv(y, cb, cr, idx)
        else:
            raise ValueError(f"wire {wire!r}: one of {', '.join(WIRES)}")
        boxes.append(bx.copy())
    return np.stack(boxes, axis=1), time.perf_counter() - t0


def wire_metrics(boxes: np.ndarray, gts: list[np.ndarray]) -> dict:
    """SR / PR / NPR averaged over the sequences, frame 0 left out."""
    per_seq = [evaluate_ope(boxes[b], gts[b][1:]) for b in range(len(gts))]
    return {k: float(np.mean([m[k] for m in per_seq])) for k in METRICS}


def summarize(boxes: dict, gts: list[np.ndarray], not_run: dict, n_frames: int) -> dict:
    """The JAX tool's summary (:343-372) over the wires that ran (`boxes`,
    host among them): each wire's metrics, the deltas from host with the
    largest box deviation and the share of frames whose boxes are equal
    (within 0.01 px), `within_budget` at BUDGET; `not_run` names the wires
    left out and why, and the decoder the run used."""
    results = {w: wire_metrics(b, gts) for w, b in boxes.items()}
    deltas = {}
    for wire in boxes:
        if wire == "host":
            continue
        d = {f"d_{k}": abs(results[wire][k] - results["host"][k]) for k in results["host"]}
        bd = np.abs(boxes[wire] - boxes["host"])
        d["max_box_dev_px"] = float(bd.max())
        d["frac_frames_boxes_equal"] = float(np.mean(bd.max(axis=2) < 0.01))
        deltas[wire] = d
    return {
        "corpus": {"n_seq": len(gts), "n_frames": n_frames, "resolution": f"{W}x{H}",
                   "composition": "rgbcolormap"},
        "decoder": native_io.decoder(),
        "metrics": results,
        "deltas_vs_host": deltas,
        "budget_clause": f"<={BUDGET} absolute on SR/PR/NPR (the 0.1% clause)",
        "within_budget": {w: bool(all(v <= BUDGET for k, v in d.items() if k.startswith("d_")))
                          for w, d in deltas.items()},
        "not_run": not_run,
    }


def run(model, root: str, n_seq: int, n_frames: int, train_seqs: int, steps: int, device,
        wires=WIRES, art: str | None = None, log_every: int = 200) -> dict:
    """Fixtures, the head's overfit, every wire of `wires` that can run here,
    the summary (written to `art` when given). Returns the summary with the
    overfit's record under 'overfit' and the boxes under 'boxes'."""
    device = torch.device(device)
    ensure_fixtures(root, n_seq, n_frames)
    model = model.to(device)
    overfit = overfit_head(model, root, train_seqs, n_frames, steps, log_every)
    model.eval()
    rt = ViPTRuntime()
    scan = make_track_scan(rt, model, device) if device.type == "cuda" else None
    gts = ground_truth(root, n_seq)
    boxes, not_run = {}, {}
    for wire in wires:
        why = yuv_unavailable(root) if wire == "yuv420" else None
        if why:
            not_run[wire] = why
            print(json.dumps({"wire": wire, "status": why}), flush=True)
            continue
        boxes[wire], seconds = run_wire(wire, model, rt, root, n_seq, n_frames, device, scan)
        print(json.dumps({"wire": wire, "seconds": seconds, **wire_metrics(boxes[wire], gts)}),
              flush=True)
    summary = summarize(boxes, gts, not_run, n_frames)
    if art:
        os.makedirs(os.path.dirname(art), exist_ok=True)
        with open(art, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary | {"overfit": overfit, "boxes": boxes}


def main(argv=None) -> int:
    optouts.refuse("mmtrack_torch.eval.wire_metric_ab")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-seq", type=int, default=20)
    ap.add_argument("--n-frames", type=int, default=101)
    ap.add_argument("--train-seqs", type=int, default=8,
                    help="corpus sequences the head overfits on (all are tracked; the "
                         "deltas compare wires on the same weights)")
    ap.add_argument("--steps", type=int, default=1500)
    args = ap.parse_args(argv)
    device = require_cuda()
    cfg = vipt_experiment_config("deep_rgbd")
    # the serving dtype, over f32 parameters for the head's training (flax's)
    model = build_viptrack(cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=device,
                           seed=0)
    run(model, FIXTURE_DIR, args.n_seq, args.n_frames, args.train_seqs, args.steps, device,
        art=ART)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
