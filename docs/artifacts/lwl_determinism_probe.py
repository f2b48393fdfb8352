"""What LWL's matrix resizes and deterministic algorithms cost on the card
(a one-off measurement, not a test; ~5 min on one H100):

    python3 docs/artifacts/lwl_determinism_probe.py

1. one lwl epoch through the training entry with --deterministic, which
   raises and names any op without a deterministic CUDA form;
2. in turns interp / matrix / det / det / matrix / interp, each in its own
   process: "interp" is F.interpolate's resizes (the form models/lwl.py had
   before it used matrix products), "matrix" the matrix resizes, both
   without deterministic algorithms, "det" the matrix resizes with them.
   Each process times STEPS lwl and lwl_box training steps at phase 16's
   B=16 of chip_smoke.py (the median leaves out the first), and, in the
   interp and matrix processes, the lwl and stm trackers over phase 15's
   640x480 sequence (median ms a frame after ZOO_WARMUP frames; stm calls
   none of LWL's resizes and is the control)."""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
ENV = dict(os.environ, PYTHONPATH=REPO)
STEPS = 6
MODES = ("interp", "matrix", "det", "det", "matrix", "interp")


def run(cmd, **kw):
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, env=ENV, capture_output=True, text=True, **kw)
    return p, time.perf_counter() - t0


def use_interpolate() -> None:
    """models/lwl.py's resizes as F.interpolate (antialiased where an axis
    shrinks, as the module was before its matrix form)."""
    import torch.nn.functional as F

    from mmtrack_torch.models import lwl

    def interp(x, out_hw):
        h, w = x.shape[-2:]
        if (h, w) == tuple(out_hw):
            return x
        return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                             antialias=out_hw[0] < h or out_hw[1] < w)

    def bicubic(x, out_hw):
        if tuple(x.shape[-2:]) == tuple(out_hw):
            return x
        return F.interpolate(x, size=tuple(out_hw), mode="bicubic", align_corners=False)

    lwl.interpolate, lwl.resize_bicubic = interp, bicubic


def timing(mode):
    import numpy as np
    import torch

    if mode == "det":
        from mmtrack_torch.utils.device import set_deterministic
        set_deterministic()
    elif mode == "interp":
        use_interpolate()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mmtrack_torch.config import vipt_experiment_config
    from mmtrack_torch.train import run as tr

    dev = torch.device("cuda")
    cfg = vipt_experiment_config("deep_rgbd")
    out = {"mode": mode, "card": cs.card_line()}
    for script in ("lwl", "lwl_box"):
        batches = cs.zoo_train_batches(script, 16, STEPS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = tr.build_zoo_model(script, "", 0, dev)
        state = tr.train_state(model, cfg, 1000, tr.zoo_trainable_mask(model, script, ""))
        step = tr.make_zoo_step(script, "", 0, torch.float32)
        ms, losses = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = step(state, b)
            losses.append(float(stats["Loss/total"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[script] = {"step_ms": ms, "median_ms": float(np.median(ms[1:])), "losses": losses,
                       "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        del model, state, step, batches
    if mode != "det":
        from mmtrack_torch.eval.datasets import list_sequences, load_sequence
        from mmtrack_torch.eval.ope import run_sequence

        H, W = cs.OPE_HW
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "DepthTrack")
            cs.ope_fixture(root, n_seqs=1, n_frames=cs.ZOO_FRAMES)
            seq_dir = list_sequences(root, "DepthTrack")[0]
            for name in cs.LWL_STM:
                recipe = cs.TRACKER_REGISTRY[name]
                seq = load_sequence(seq_dir, "DepthTrack")
                seq.dtype = recipe.composition
                tracker = cs.MaskRecorder(recipe.build(device=dev), (H, W))
                run_sequence(tracker, seq)
                out[f"track_{name}"] = {
                    "frames": cs.ZOO_FRAMES, "frame_ms": tracker.ms,
                    "median_ms_per_frame": float(np.median(tracker.ms[cs.ZOO_WARMUP:]))}
                del tracker
                torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card", card.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    cfg = os.path.join(REPO, "mmtrack_torch", "train", "tiny_synthetic.json")
    p, s = run([sys.executable, "-m", "mmtrack_torch.train.run", "--script", "lwl", "--config",
                cfg, "--synthetic", "--deterministic", "--batch", "4", "--samples", "8",
                "--epochs", "1", "--save_dir", os.path.join(tmp, "a")])
    print("entry_det rc", p.returncode, "s", round(s, 1), p.stdout[-1500:], p.stderr[-4000:],
          flush=True)
    if p.returncode != 0:
        return 1
    rows = []
    for mode in MODES:
        p, s = run([sys.executable, __file__, "--timing", mode])
        print("timing", mode, "rc", p.returncode, "s", round(s, 1), p.stdout[-6000:],
              p.stderr[-1500:] if p.returncode else "", flush=True)
        if p.returncode == 0:
            rows.append(json.loads(p.stdout.strip().splitlines()[-1]))
    summary = [{k: (v["median_ms"] if "median_ms" in v else v["median_ms_per_frame"])
                if isinstance(v, dict) else v for k, v in r.items()} for r in rows]
    print("SUMMARY", json.dumps(summary), flush=True)
    return 0 if len(rows) == len(MODES) else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--timing":
        timing(sys.argv[2])
    else:
        sys.exit(main())
