"""End-to-end learning demonstration of the port: a held-out tracking
metric improves. Port of tools/learning_demo.py.

Each phase trains through the port's training entry in a subprocess
(`python -m mmtrack_torch.train.run`: sampler -> processing -> loader ->
train step -> learning-rate schedule -> checkpoint -> resume) on the
synthetic multi-sequence corpus, then runs the port's tracker on
HELD-OUT synthetic sequences the sampler never saw (mean IoU, success
AUC, SR@0.5) before and after:

  stage 1 (foundation): --script vipt --full_tune on the tiny ViPT of
      tiny_synthetic.json over the RGB-only corpus (the target drawn only
      in the RGB triplet), as TWO runs (--epochs N/2, then --epochs N),
      so the second resumes from the first one's checkpoint; held-out
      RGB-only sequences.
  stage 2 (the prompt path): prompt-only tuning from the stage-1
      checkpoint (--init) on the aux-only corpus (the target invisible in
      RGB, carried by the aux triplet); held-out aux-only sequences, so
      the gain is the prompts' alone.

Opt-in phases, each evaluating the complete online tracker:

  --dimp: train DiMP-50 (ResNet-50, the meta-learned filter initialiser
      and optimiser, the IoUNet) and run the DiMP tracker.
  --kys: graft the DiMP phase's trained base into KYSNet, train the
      scene-propagation predictor alone on a corpus with a crossing twin
      of the target, and measure the fused response's peak on held-out
      transitions (and the KYS tracker, reported).
  --lwl: train LWL on rasterised boxes (exact masks of the synthetic
      rectangles) and run the LWL mask tracker from the init mask.

tiny_synthetic.json holds the settings of configs/demo/tiny_synthetic.yaml
merged onto the default config, as overrides onto deep_rgbd (the port's
--config): ViT-128, depth 4, 4 heads, 64 / 128 crops, f32.

    python -m mmtrack_torch.train.learning_demo [--dimp --kys --lwl] \\
        [--epochs 8] [--out docs/artifacts/learning_demo_torch.json] [--device cuda|cpu]

The device defaults to the card; without CUDA the demo raises (pass
--device cpu to run on the CPU). The result is written to --out and
printed. Each phase's gate is its held-out AUC over the one before
training (stage 1: +0.05; stage 2: +0.02; dimp: +0.02; lwl: +0.02; kys:
the fused peak's accuracy +0.1); the exit code is 0 when stages 1 and 2
pass, as tools/learning_demo.py's. --dimp_only / --kys_only / --lwl_only
run that phase alone, merge it into --out and exit 0 when it passes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny_synthetic.json")
OUT = os.path.join(REPO, "docs", "artifacts", "learning_demo_torch.json")
SEED = 7
ZOO_TRAIN_ARGS = ["--batch", "8", "--samples", "64"]   # the dimp, kys and lwl runs

# held-out sequences: the train corpus (SyntheticVideoDataset of train/run.py
# --synthetic) uses seeds 0-7, boxes (20+10i, 15+5i, 30, 24) and
# velocities (2+i, 1.5) at 120x160; these differ in all of them
HELDOUT = [
    dict(seed=101, box0=(95.0, 20.0, 26.0, 34.0), velocity=(-2.5, 2.0)),
    dict(seed=102, box0=(30.0, 60.0, 36.0, 22.0), velocity=(3.0, -1.0)),
    dict(seed=103, box0=(70.0, 70.0, 24.0, 24.0), velocity=(-1.5, -2.5)),
    dict(seed=104, box0=(15.0, 30.0, 40.0, 30.0), velocity=(2.0, 2.5)),
]
N_FRAMES = 40
FRAME_HW = (120, 160)


def load_cfg(path: str = None):
    from mmtrack_torch.config import merge_overrides, vipt_experiment_config

    with open(path or CFG_PATH) as f:
        return merge_overrides(vipt_experiment_config("deep_rgbd"), json.load(f))


def _build(cfg, device):
    """The seeded ViPT the trainer starts from (train/run.py --seed 7) and
    its runtime."""
    from mmtrack_torch.models.vipt import build_viptrack
    from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime

    model = build_viptrack(cfg, dtype=torch.float32, param_dtype=torch.float32, device=device,
                           seed=SEED)
    return model, ViPTRuntime.from_config(cfg)


def _mask_kind(mask) -> str:
    share = float(np.asarray(mask).mean())
    return "empty" if share == 0 else "full" if share == 1 else "partial"


def evaluate_factory(make_tracker, modality: str = "both", with_init_mask: bool = False,
                     distractor: bool = False) -> dict:
    """OPE over the held-out sequences: mean IoU, success AUC, SR@0.5.

    with_init_mask: the tracker also gets a first-frame mask (the
    rasterised init box, the exact mask of the synthetic rectangle), the
    LWL / STM init protocol. distractor: an identical second object
    crosses the target (the KYS setting). Also reported: the crop
    kernel's launches over the sequences, the tracker's localisation flags
    summed (DiMP's family) and its masks by kind (empty, partial, full)."""
    from mmtrack_torch.data.synthetic import make_synthetic_sequence
    from mmtrack_torch.eval.metrics import iou_xywh, success_auc
    from mmtrack_torch.ops.crop import crop_resize_normalized

    kw = {"both": {}, "rgb_only": {"target_aux": None},
          "aux_only": {"target_rgb": None}}[modality]
    ious, flags, masks = [], {}, {}
    launches0 = crop_resize_normalized.launches
    for spec in HELDOUT:
        frames, gt = make_synthetic_sequence(n_frames=N_FRAMES, height=FRAME_HW[0],
                                             width=FRAME_HW[1], distractor=distractor,
                                             **spec, **kw)
        tr = make_tracker()
        info = {"init_bbox": gt[0].tolist()}
        if with_init_mask:
            x, y, w, h = (int(round(v)) for v in gt[0])
            m = np.zeros(frames[0].shape[:2], np.float32)
            m[max(y, 0):y + h, max(x, 0):x + w] = 1.0
            info["init_mask"] = m
        tr.initialize(frames[0], info)
        pred = [gt[0]]
        for t in range(1, len(frames)):
            out = tr.track(frames[t])
            pred.append(out["target_bbox"])
            if "segmentation" in out:
                kind = _mask_kind(out["segmentation"])
                masks[kind] = masks.get(kind, 0) + 1
        for k, n in getattr(tr, "flags", {}).items():
            flags[k] = flags.get(k, 0) + n
        ious.append(iou_xywh(np.asarray(pred[1:], np.float64), gt[1:]))
    ious = np.concatenate(ious)
    out = {"mean_iou": float(ious.mean()), "auc": float(success_auc(ious)),
           "sr50": float((ious > 0.5).mean()),
           "crop_launches": crop_resize_normalized.launches - launches0}
    if flags:
        out["flags"] = flags
    if masks:
        out["masks"] = masks
    return out


def evaluate(model, rt, device, modality: str = "both") -> dict:
    from mmtrack_torch.trackers.vipt_tracker import ViPTTracker

    return evaluate_factory(lambda: ViPTTracker(model, device, rt), modality=modality)


def _run_train(save_dir: str, epochs: int, extra: list, device: str,
               script: str = "vipt") -> tuple[str, float]:
    """`python -m mmtrack_torch.train.run --script <script> --config
    CFG_PATH --synthetic` from the repository root on `device`, seed 7.
    Returns (its standard output, its seconds); a failed run raises."""
    cmd = [sys.executable, "-m", "mmtrack_torch.train.run", "--script", script, "--config",
           CFG_PATH, "--synthetic", "--save_dir", save_dir, "--epochs", str(epochs),
           "--seed", str(SEED), "--device", device, *extra]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr, flush=True)
        raise subprocess.CalledProcessError(proc.returncode, cmd, proc.stdout, proc.stderr)
    return proc.stdout, seconds


def params_digest(model: torch.nn.Module) -> str:
    """SHA-256 of the model's state_dict, name by name, bytes as stored:
    equal digests mean bit-equal parameters."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _latest_step_dir(root: str) -> str:
    """The newest epoch_NNNN.pt under a run's checkpoint directory."""
    names = sorted(f for f in os.listdir(root) if f.startswith("epoch_") and f.endswith(".pt")) \
        if os.path.isdir(root) else []
    if not names:
        raise FileNotFoundError(f"no checkpoints under {root}")
    return os.path.join(root, names[-1])


def _latest_ckpt(save_dir: str) -> str:
    cfg_name = os.path.splitext(os.path.basename(CFG_PATH))[0]
    return _latest_step_dir(os.path.join(save_dir, f"vipt-{cfg_name}", "checkpoints"))


def _restore_params(ckpt_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the trainer's checkpoint into `model`: every name of the model
    and no other."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return model


def _zoo_model(script: str) -> torch.nn.Module:
    """The seeded model `--script <script> --seed 7` starts from, on the
    CPU."""
    from mmtrack_torch.train.run import build_zoo_model

    return build_zoo_model(script, "", SEED, "cpu")


def _train_dimp(args, workdir: str) -> float:
    d = os.path.join(workdir, "dimp")
    return _run_train(d, args.dimp_epochs, ZOO_TRAIN_ARGS, args.device, "dimp")[1]


def run_dimp_phase(args, workdir: str) -> dict:
    """The online family (DiMP): train the full DiMPNet (ResNet-50, the
    meta-learned filter initialiser and optimiser, the IoUNet) and run the
    online tracker (init augmentation, steepest-descent solve, IoUNet
    refinement, memory updates) on the held-out sequences before and
    after."""
    from mmtrack_torch.trackers.dimp_tracker import DiMPTracker

    t0 = time.perf_counter()
    print("== dimp eval: random init", flush=True)
    model0 = _zoo_model("dimp")
    before = evaluate_factory(lambda: DiMPTracker(model0, args.device))
    print(json.dumps(before), flush=True)
    train_s = _train_dimp(args, workdir)
    model1 = _restore_params(_latest_step_dir(os.path.join(workdir, "dimp", "dimp", "checkpoints")),
                             _zoo_model("dimp"))
    print("== dimp eval: after offline training", flush=True)
    after = evaluate_factory(lambda: DiMPTracker(model1, args.device))
    print(json.dumps(after), flush=True)
    return {"epochs": args.dimp_epochs, "before": before, "after": after,
            "improved": bool(after["auc"] > before["auc"] + 0.02),
            "train_seconds": train_s, "seconds": time.perf_counter() - t0}


def _kys_transition_metric(model, device, n_frames: int = None) -> dict:
    """The held-out predictor metric: over serve-geometry transitions of
    the held-out distractor sequences, the share where the fused
    propagation response peaks within 1.5 feature cells of the true
    target (the raw DiMP score's share as a reference line). This is what
    the KYS recipe trains; the tracker-level comparison is confounded by
    the frozen base's own localisation and the twin crossing the target."""
    from mmtrack_torch.data.processing import MEAN_6, STD_6, sample_target_np
    from mmtrack_torch.data.synthetic import make_synthetic_sequence
    from mmtrack_torch.train.dimp_actor import gaussian_label_map

    n_frames = n_frames or N_FRAMES
    S, tf = 288, 5.0
    hS = S // 16
    model = model.to(device).eval()

    def crop_at_box(frame, box):
        crop, rf, _ = sample_target_np(frame, box, tf, output_sz=S)
        return (crop.astype(np.float32) / 255.0 - MEAN_6) / STD_6, rf

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    @torch.no_grad()
    def run_seq(tpl, tpl_anno, prev, cur, label_prev):
        cf_tpl = model.extract_classification_feat(model.extract_backbone(tpl))
        filt = model.optimize_filter(model.get_filter(cf_tpl, tpl_anno), cf_tpl, tpl_anno,
                                     None, 5)
        bf_p, bf_c = model.extract_backbone(prev), model.extract_backbone(cur)
        # one sequence, one filter: classify applies it to every frame
        score_cur = model.classify(filt, model.extract_classification_feat(bf_c))[:, :hS, :hS]
        st0 = model.init_motion_state(label_prev)
        fused, _, _ = model.predict_response(model.motion_feat(bf_p), model.motion_feat(bf_c),
                                             st0, score_cur)
        return fused, score_cur

    def peaks(m):
        m = m.reshape(m.shape[0], -1).argmax(1)
        return np.stack(np.unravel_index(m, (hS, hS)), 1)

    hits_fused = hits_dimp = total = 0
    for spec in HELDOUT:
        frames, gt = make_synthetic_sequence(n_frames=n_frames, height=FRAME_HW[0],
                                             width=FRAME_HW[1], distractor=True, **spec)
        tpl, rf0 = crop_at_box(frames[0], gt[0])
        side0 = float(np.sqrt(gt[0, 2] * gt[0, 3]) * rf0)
        c0 = (S - side0) / 2.0
        prevs, curs, lp, anno_cur = [], [], [], []
        for t in range(1, n_frames):
            p_crop, rf = crop_at_box(frames[t - 1], gt[t - 1])
            # serve geometry: the current crop is taken at the previous box
            c_crop, _ = crop_at_box(frames[t], gt[t - 1])
            prevs.append(p_crop)
            curs.append(c_crop)
            # the previous target is centred in its own crop by construction
            side = np.sqrt(gt[t - 1, 2] * gt[t - 1, 3]) * rf
            c = (S - side) / 2.0
            lp.append([c, c, side, side])
            # the true current box in the shared crop's coordinates
            d = (gt[t, :2] + gt[t, 2:] / 2) - (gt[t - 1, :2] + gt[t - 1, 2:] / 2)
            ctr = (S - 1) / 2 + d * rf
            wh = gt[t, 2:] * rf
            anno_cur.append(np.concatenate([ctr - wh / 2, wh]))
        fused, dimp = run_seq(T(tpl)[None], T([[c0, c0, side0, side0]]), T(np.stack(prevs)),
                              T(np.stack(curs)), gaussian_label_map(T(lp), hS, S, kernel_sz=4))
        # the truth cell: the argmax of the label the recipe supervises with
        truth = peaks(gaussian_label_map(T(anno_cur), hS, S, kernel_sz=4).cpu().numpy())
        hits_fused += int((np.linalg.norm(peaks(fused.float().cpu().numpy()) - truth,
                                          axis=1) <= 1.5).sum())
        hits_dimp += int((np.linalg.norm(peaks(dimp.float().cpu().numpy()) - truth,
                                         axis=1) <= 1.5).sum())
        total += n_frames - 1
    return {"fused_peak_acc": round(hits_fused / total, 4),
            "dimp_peak_acc_reference": round(hits_dimp / total, 4), "transitions": total}


def run_kys_phase(args, workdir: str) -> dict:
    """KYS (the propagation family), the reference protocol: the DiMP
    phase's trained DiMPNet grafted into KYSNet's base, which stays frozen;
    the predictor alone trains (--script kys --channels 6 --init <graft>),
    on the corpus with a crossing twin of the target. The gate is the
    fused response's peak on held-out transitions; the KYS tracker's
    metrics on the same sequences are reported."""
    from mmtrack_torch.models.convert import kys_base_from_dimp
    from mmtrack_torch.trackers.kys_tracker import KYSTracker

    t0 = time.perf_counter()
    dimp_root = os.path.join(workdir, "dimp", "dimp", "checkpoints")
    if not (os.path.isdir(dimp_root) and os.listdir(dimp_root)):
        _train_dimp(args, workdir)
    dimp = torch.load(_latest_step_dir(dimp_root), map_location="cpu",
                      weights_only=True)["model"]
    # JAX's graft: KYSNet's 'dimp' subtree replaced by the DiMP phase's;
    # both build a 3-channel conv1 (DiMPNet reads the first three channels)
    model0 = _zoo_model("kys")
    base = kys_base_from_dimp(dimp)
    own = model0.state_dict()
    assert set(base) <= set(own) and all(own[k].shape == v.shape for k, v in base.items())
    model0.load_state_dict(base, strict=False)
    graft = os.path.abspath(os.path.join(workdir, "kys_graft.pt"))
    torch.save({"model": model0.state_dict()}, graft)

    print("== kys eval (crossing distractor): trained DiMP base + seeded predictor", flush=True)
    before = evaluate_factory(lambda: KYSTracker(model0, args.device), distractor=True)
    print(json.dumps(before), flush=True)
    before_pred = _kys_transition_metric(model0, args.device)
    print("predictor metric (seeded):", json.dumps(before_pred), flush=True)

    d = os.path.join(workdir, "kys")
    _, train_s = _run_train(d, args.kys_epochs, ZOO_TRAIN_ARGS
                            + ["--synthetic_distractor", "--channels", "6", "--init", graft],
                            args.device, "kys")
    model1 = _restore_params(_latest_step_dir(os.path.join(d, "kys-base", "checkpoints")),
                             _zoo_model("kys"))
    print("== kys eval (crossing distractor): after predictor-only training", flush=True)
    after = evaluate_factory(lambda: KYSTracker(model1, args.device), distractor=True)
    print(json.dumps(after), flush=True)
    after_pred = _kys_transition_metric(model1, args.device)
    print("predictor metric (trained):", json.dumps(after_pred), flush=True)
    return {"epochs": args.kys_epochs,
            "base": "DiMP-phase checkpoint (frozen, reference protocol)",
            "trains": "propagation predictor only",
            "eval": "held-out sequences with an identical crossing distractor",
            "tracker_before": before, "tracker_after": after,
            "predictor_before": before_pred, "predictor_after": after_pred,
            "improved": bool(after_pred["fused_peak_acc"]
                             > before_pred["fused_peak_acc"] + 0.1),
            "train_seconds": train_s, "seconds": time.perf_counter() - t0}


def run_lwl_phase(args, workdir: str) -> dict:
    """LWL (the segmentation family): trained on rasterised boxes, which on
    the synthetic corpus are the exact masks of its rectangles; the full
    mask tracker (few-shot learning on the init mask, segmentation, the
    mask's box, memory updates) before and after. The phase runs under
    deterministic algorithms, its training run too, so that its outcome is
    one fixed number (without them cuDNN may pick convolution backwards that
    sum with atomics, and the AUC spread 0.06-0.86 over runs); it is the
    demo's last phase, so no other phase runs under them."""
    from mmtrack_torch.trackers.lwl_tracker import LWLTracker
    from mmtrack_torch.utils.device import set_deterministic

    set_deterministic()
    t0 = time.perf_counter()
    print("== lwl eval: random init", flush=True)
    model0 = _zoo_model("lwl")
    before = evaluate_factory(lambda: LWLTracker(model0, args.device), with_init_mask=True)
    print(json.dumps(before), flush=True)
    d = os.path.join(workdir, "lwl")
    _, train_s = _run_train(d, args.lwl_epochs, ZOO_TRAIN_ARGS + ["--deterministic"],
                             args.device, "lwl")
    model1 = _restore_params(_latest_step_dir(os.path.join(d, "lwl-base", "checkpoints")),
                             _zoo_model("lwl"))
    print("== lwl eval: after training", flush=True)
    after = evaluate_factory(lambda: LWLTracker(model1, args.device), with_init_mask=True)
    print(json.dumps(after), flush=True)
    with open(os.path.join(d, "lwl-base", "logs", "train.jsonl")) as f:
        epoch_losses = [json.loads(line)["Loss/total"] for line in f]
    return {"epochs": args.lwl_epochs,
            "supervision": "rasterized boxes (exact: the synthetic target is a rectangle)",
            "before": before, "after": after, "epoch_losses": epoch_losses,
            "params_sha256": params_digest(model1),
            "improved": bool(after["auc"] > before["auc"] + 0.02),
            "train_seconds": train_s, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="End-to-end learning demonstration of the port")
    ap.add_argument("--epochs", type=int, default=8,
                    help="stage-1 total epochs (the first run trains half)")
    ap.add_argument("--prompt_epochs", type=int, default=6)
    ap.add_argument("--dimp", action="store_true", help="also run the DiMP phase")
    ap.add_argument("--dimp_only", action="store_true",
                    help="run only the DiMP phase, merging it into --out")
    ap.add_argument("--dimp_epochs", type=int, default=4)
    ap.add_argument("--kys", action="store_true",
                    help="also run the KYS phase (the predictor on the DiMP phase's base)")
    ap.add_argument("--kys_only", action="store_true",
                    help="run only the KYS phase, merging it into --out (the DiMP phase's "
                         "checkpoint in --workdir, trained if absent)")
    ap.add_argument("--kys_epochs", type=int, default=6)
    ap.add_argument("--lwl", action="store_true", help="also run the LWL phase")
    ap.add_argument("--lwl_only", action="store_true",
                    help="run only the LWL phase, merging it into --out")
    ap.add_argument("--lwl_epochs", type=int, default=4)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--workdir", default=None,
                    help="keep the training workspace here (default: a temporary directory)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    workdir = args.workdir or tempfile.mkdtemp(prefix="mmtrack_demo_")
    only = [("dimp_online_family", run_dimp_phase, args.dimp_only),
            ("kys_propagation", run_kys_phase, args.kys_only),
            ("lwl_segmentation", run_lwl_phase, args.lwl_only)]
    if any(flag for _, _, flag in only):
        result = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                result = json.load(f)
        ok = True
        for key, fn, flag in only:
            if not flag:
                continue
            result[key] = fn(args, workdir)
            print(json.dumps(result[key], indent=2))
            ok = ok and result[key]["improved"]
            print(f"{key.upper()} PHASE:", "PASS" if result[key]["improved"] else "FAIL")
        _write(args.out, result)
        return 0 if ok else 1

    t_demo = time.perf_counter()
    cfg = load_cfg()
    model, rt = _build(cfg, "cpu")
    print("== eval: random init (before any training)", flush=True)
    before = evaluate(model, rt, args.device, modality="rgb_only")
    print(json.dumps(before), flush=True)

    # stage 1: the RGB foundation, with a checkpoint-resume break
    s1 = os.path.join(workdir, "stage1")
    rgb = ["--full_tune", "--synthetic_modality", "rgb_only"]
    _, s1a = _run_train(s1, max(args.epochs // 2, 1), rgb, args.device)
    out, s1b = _run_train(s1, args.epochs, rgb, args.device)   # resumes from epoch N/2
    resumed = f"resumed from checkpoint epoch {max(args.epochs // 2, 1)}" in out
    ckpt1 = _latest_ckpt(s1)
    params1 = _restore_params(ckpt1, _build(cfg, "cpu")[0])
    print("== eval: after stage-1 foundation training (rgb_only heldout)", flush=True)
    after1 = evaluate(params1, rt, args.device, modality="rgb_only")
    print(json.dumps(after1), flush=True)

    # stage 2: prompt-tune the frozen foundation onto the new modality
    print("== eval: stage-1 foundation on the NEW modality (aux_only)", flush=True)
    before2 = evaluate(params1, rt, args.device, modality="aux_only")
    print(json.dumps(before2), flush=True)
    s2 = os.path.join(workdir, "stage2")
    _, s2s = _run_train(s2, args.prompt_epochs,
                        ["--init", ckpt1, "--synthetic_modality", "aux_only"], args.device)
    params2 = _restore_params(_latest_ckpt(s2), _build(cfg, "cpu")[0])
    print("== eval: after prompt-only tuning (aux_only heldout)", flush=True)
    after2 = evaluate(params2, rt, args.device, modality="aux_only")
    print(json.dumps(after2), flush=True)

    result = {
        "config": os.path.relpath(CFG_PATH, REPO),
        "heldout_sequences": len(HELDOUT),
        "frames_per_sequence": N_FRAMES,
        "stage1": {"epochs": args.epochs, "corpus": "rgb_only", "before": before,
                   "after": after1, "resumed_from_checkpoint": resumed,
                   "train_seconds": s1a + s1b},
        "stage2_prompt_only": {"epochs": args.prompt_epochs,
                               "corpus": "aux_only (new modality)", "before": before2,
                               "after": after2, "train_seconds": s2s},
        "stage1_improved": bool(after1["auc"] > before["auc"] + 0.05),
        "prompt_tuning_improved": bool(after2["auc"] > before2["auc"] + 0.02),
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "stages_seconds": time.perf_counter() - t_demo,
    }
    for key, fn, flag in zip((k for k, _, _ in only), (f for _, f, _ in only),
                             (args.dimp, args.kys, args.lwl)):
        if flag:
            result[key] = fn(args, workdir)
    result["seconds"] = time.perf_counter() - t_demo
    _write(args.out, result)
    print(json.dumps(result, indent=2))
    ok = result["stage1_improved"] and result["prompt_tuning_improved"]
    print("LEARNING DEMO:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _write(path: str, result: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    sys.exit(main())
