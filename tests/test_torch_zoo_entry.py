"""The training entry (train/run.py) for the MDNet, APFNet, KYS and LWL-box
scripts on the CPU, in a process where jax, flax and the JAX package are
never imported: `--script mdnet`, `--script apfnet --stage 1 --attribute
4`, `--script kys --channels 6 --synthetic_distractor` and `--script
lwl_box --channels 6`, one synthetic sample and one step each, every run
writing its checkpoint and a finite loss under <save_dir>/<script>-<stage
or 'base'>/; APFNet's stage 1 trains the attribute's branches and fc4-fc6
(the count printed is stage_mask's), KYS the predictor alone; KYS keeps a
3-channel conv1 at --channels 6, LWL builds a 6-channel one. --stage 1 is
not a stage of mdnet.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.models.apfnet import APFNet, stage_mask  # noqa: E402
from mmtrack_torch.models.kys import build_kysnet  # noqa: E402
from mmtrack_torch.train.optim import count_trainable  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_trains_mdnet_apfnet_kys_without_jax(tmp_path):
    ws = str(tmp_path / "ws")
    common = ["--synthetic", "--device", "cpu", "--batch", "1", "--samples", "1",
              "--epochs", "1", "--save_dir", ws]
    code = f"""
import sys
import pytest
from mmtrack_torch.train import run
common = {common!r}
assert run.main(["--script", "mdnet"] + common) == 0
assert run.main(["--script", "apfnet", "--stage", "1", "--attribute", "4"] + common) == 0
assert run.main(["--script", "kys", "--channels", "6", "--synthetic_distractor"] + common) == 0
assert run.main(["--script", "lwl_box", "--channels", "6"] + common) == 0
with pytest.raises(ValueError, match="--stage"):
    run.main(["--script", "mdnet", "--stage", "1"] + common)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mmtrack_tpu')]
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    apf = APFNet()
    n_apf = count_trainable(apf, stage_mask(apf, 1, 4))
    kys = build_kysnet()
    n_kys = sum(p.numel() for k, p in kys.named_parameters() if k.startswith("predictor."))
    assert f"apfnet 1 stage: {n_apf / 1e6:.2f}M trainable parameters" in proc.stdout
    assert f"kys base stage: {n_kys / 1e6:.2f}M trainable parameters" in proc.stdout
    for run_dir in ("mdnet-base", "apfnet-1", "kys-base", "lwl_box-base"):
        out = os.path.join(ws, run_dir)
        assert os.listdir(os.path.join(out, "checkpoints")) == ["epoch_0001.pt"]
        lines = open(os.path.join(out, "logs", "train.jsonl")).read().splitlines()
        assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["Loss/total"])
    sd = torch.load(os.path.join(ws, "kys-base", "checkpoints", "epoch_0001.pt"),
                    map_location="cpu", weights_only=True)
    assert sd["model"]["backbone_feature_extractor.conv1.weight"].shape == (64, 3, 7, 7)
    sd = torch.load(os.path.join(ws, "lwl_box-base", "checkpoints", "epoch_0001.pt"),
                    map_location="cpu", weights_only=True)
    assert sd["model"]["feature_extractor.conv1.weight"].shape == (64, 6, 7, 7)
