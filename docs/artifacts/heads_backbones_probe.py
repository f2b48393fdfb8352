"""chip_smoke.py's phase 20 alone, with its phase 17 (the learning demo's
--lwl_only, under deterministic algorithms) run twice side by side meanwhile: the two
runs' epoch losses, parameter digests and AUCs compared (a one-off
measurement, not a test; ~2 min on one H100):

    python3 docs/artifacts/heads_backbones_probe.py"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
import numpy as np
import torch

import chip_smoke as cs

dev = cs.require_cuda()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print("card", cs.card_line(), flush=True)
t0 = time.perf_counter()
lib = cs.load_library()
print("build", time.perf_counter() - t0, flush=True)
demos = [cs.start_learning_demo() for _ in range(2)]
cfg = cs.vipt_experiment_config("deep_rgbd")
rt = cs.ViPTRuntime.from_config(cfg)
frames, box0 = cs.synthetic_frames(cs.STEPS + 1, np.random.RandomState(0))
frames = torch.from_numpy(frames).to(dev)
try:
    print("phase20", cs.heads_backbones_path(dev, rt, frames, box0), flush=True)
except Exception as e:
    import traceback
    traceback.print_exc()
res = []
for d in demos:
    out, err = d["proc"].communicate(timeout=900)
    phase = json.load(open(d["out"]))["lwl_segmentation"] if os.path.exists(d["out"]) else None
    print("demo rc", d["proc"].returncode, "seconds", time.perf_counter() - d["t0"],
          err[-2000:] if d["proc"].returncode else "", flush=True)
    if phase:
        print("demo", json.dumps({k: phase[k] for k in ("epoch_losses", "params_sha256",
                                                        "improved", "train_seconds")}),
              "before", json.dumps(phase["before"]), "after", json.dumps(phase["after"]),
              flush=True)
    res.append(phase)
if all(res):
    print("DEMO_EQUAL", {k: res[0][k] == res[1][k]
                         for k in ("epoch_losses", "params_sha256", "before", "after")},
          flush=True)
