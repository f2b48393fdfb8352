"""The port's learning demo (mmtrack_torch/train/learning_demo.py) against
tools/learning_demo.py on the CPU.

- Its config: tiny_synthetic.json merged onto deep_rgbd against JAX's
  vipt_default_config with configs/demo/tiny_synthetic.yaml merged on,
  every key the port's config holds (all that its training and trackers
  read) equal.
- HELDOUT, N_FRAMES and evaluate_factory equal to JAX's: the same
  scripted stand-in tracker (its boxes a function of the frames it is
  given and of the init mask) run through both, in each modality, with
  the init mask and with the crossing distractor: the metrics equal, and
  the frames and masks it saw equal.
- Checkpoint restore: the newest of the trainer's checkpoints loads into
  a fresh model whole; a checkpoint of another model raises.
- The demo's plumbing at the smallest run: `main` on `--device cpu` in
  a process where jax, flax and the JAX package are never imported, over
  a narrow config (ViT-32, depth 2, 4 samples an epoch) and two held-out
  sequences of 4 frames: stage 1 as two runs of the entry, the second
  resuming from the first one's checkpoint, then stage 2 from it with
  --init; the JSON has JAX's keys. Improvement is not asserted here.
- The demo's KYS training, whose gate failed on the card: its first 8
  steps from one tree on the same sampler batches track JAX's (losses
  within 1e-5 relative at every step, the predictor within 1e-5 relative
  L2 after).
- The entry refuses to run without a card unless --device cpu.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_torch.train import learning_demo as demo  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from mmtrack_torch.train.trainer import CheckpointManager  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_learning_demo", os.path.join(REPO, "tools", "learning_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(ns, prefix=""):
    out = {}
    for k, v in vars(ns).items():
        if hasattr(v, "__dict__"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_config_matches_jax_demo_config():
    want = jax_demo()._load_cfg()
    got = _leaves(demo.load_cfg())
    assert len(got) > 40
    for key, value in got.items():
        node = want
        for part in key.split("."):
            node = node[part]
        assert value == node, (key, value, node)


class Scripted:
    """A stand-in tracker whose boxes are a function of each frame and of
    the init mask: a drift from the init box by the frame's mean level
    and the mask's area."""

    def __init__(self, seen):
        self.seen = seen

    def initialize(self, image, info):
        self.box = np.asarray(info["init_bbox"], np.float64)
        self.area = float(np.asarray(info.get("init_mask", 0.0)).sum())
        self.seen.append(("init", int(np.asarray(image, np.int64).sum()), self.area))

    def track(self, image):
        level = float(np.asarray(image, np.float64).mean())
        self.seen.append(("frame", int(np.asarray(image, np.int64).sum())))
        self.box = self.box + np.array([level % 3 - 1, level % 2 - 0.5,
                                        (self.area % 5) / 10, 0.0])
        return {"target_bbox": self.box.tolist()}


@pytest.mark.parametrize("kw", [dict(modality="rgb_only"), dict(modality="aux_only"),
                                dict(with_init_mask=True), dict(distractor=True)])
def test_heldout_and_evaluate_factory_match_jax(kw):
    jd = jax_demo()
    assert demo.HELDOUT == jd.HELDOUT and demo.N_FRAMES == jd.N_FRAMES
    seen_j, seen_p = [], []
    want = jd.evaluate_factory(lambda: Scripted(seen_j), **kw)
    got = demo.evaluate_factory(lambda: Scripted(seen_p), **kw)
    assert seen_p == seen_j and len(seen_p) == len(demo.HELDOUT) * demo.N_FRAMES
    assert {k: got[k] for k in want} == want
    assert got["crop_launches"] == 0 and 0 < want["mean_iou"] < 1


def test_restore_reads_the_newest_checkpoint_whole(tmp_path):
    cfg = demo.load_cfg()
    cfg.MODEL.BACKBONE.DEPTH = 1
    model = demo._build(cfg, "cpu")[0]
    opt, sched = build_optimizer(model, lr=1e-3)
    state = TrainState(model, opt, sched)
    ckpts = CheckpointManager(str(tmp_path / "vipt-tiny_synthetic" / "checkpoints"),
                              keep_last=2)
    for epoch in (1, 2):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.5)
        ckpts.save(epoch, state)
    path = demo._latest_ckpt(str(tmp_path))
    assert path.endswith("epoch_0002.pt")
    fresh = demo._restore_params(path, demo._build(cfg, "cpu")[0])
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    cfg.MODEL.BACKBONE.DEPTH = 2
    with pytest.raises(RuntimeError, match="Unexpected|Missing"):
        demo._restore_params(path, demo._build(cfg, "cpu")[0])


TINY = {"MODEL": {"BACKBONE": {"EMBED_DIM": 32, "DEPTH": 2, "NUM_HEADS": 2},
                  "HEAD": {"NUM_CHANNELS": 16}},
        "TRAIN": {"BATCH_SIZE": 2, "PRINT_INTERVAL": 1},
        "DATA": {"TRAIN": {"SAMPLE_PER_EPOCH": 4}}}


def test_demo_runs_stages_and_resumes_on_the_cpu_without_jax(tmp_path):
    with open(demo.CFG_PATH) as f:
        cfg = json.load(f)
    for section, values in TINY.items():
        for k, v in values.items():
            cfg[section][k] = {**cfg[section][k], **v} if isinstance(v, dict) else v
    tiny = tmp_path / "tiny.json"
    tiny.write_text(json.dumps(cfg))
    out = tmp_path / "out.json"
    code = f"""
import sys
from mmtrack_torch.train import learning_demo as d
d.CFG_PATH, d.N_FRAMES, d.HELDOUT = {str(tiny)!r}, 4, d.HELDOUT[:2]
rc = d.main(["--device", "cpu", "--epochs", "2", "--prompt_epochs", "1",
             "--out", {str(out)!r}, "--workdir", {str(tmp_path / "ws")!r}])
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mmtrack_tpu')]
assert not bad, bad
print("RC", rc)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "resumed from checkpoint epoch 1" in proc.stdout
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, "docs", "artifacts", "learning_demo.json")) as f:
        jax_keys = {k for k in json.load(f)
                    if k not in ("dimp_online_family", "kys_propagation", "lwl_segmentation")}
    assert jax_keys <= set(got) and got["backend"] == "cpu"
    assert got["stage1"]["resumed_from_checkpoint"] is True
    assert got["stage1"]["epochs"] == 2 and got["frames_per_sequence"] == 4
    for stage in ("stage1", "stage2_prompt_only"):
        for when in ("before", "after"):
            m = got[stage][when]
            assert set(m) >= {"mean_iou", "auc", "sr50"} and 0 <= m["auc"] <= 1
    ws = tmp_path / "ws"
    assert sorted(os.listdir(ws / "stage1" / "vipt-tiny" / "checkpoints")) == [
        "epoch_0001.pt", "epoch_0002.pt"]
    assert os.listdir(ws / "stage2" / "vipt-tiny" / "checkpoints") == ["epoch_0001.pt"]
    assert f"RC {0 if got['stage1_improved'] and got['prompt_tuning_improved'] else 1}" \
        in proc.stdout


KYS_STEPS = 8


def test_kys_training_tracks_jax_over_steps():
    """The demo's kys phase trains the predictor for 48 steps; its first
    KYS_STEPS here, JAX's jitted step and the port's from one flax tree
    (tests/test_torch_kys_train.py::kys_tree) on the same sampler batches
    of the distractor corpus (KYSPairProcessing at 96 px, B=2, lr 1e-3 as
    the demo's config): every step's losses within 1e-5 relative, the
    predictor within 1e-5 relative L2 after the last."""
    import jax
    import jax.numpy as jnp

    from mmtrack_torch.data.datasets import SyntheticVideoDataset
    from mmtrack_torch.data.loader import BatchLoader, collate_pair
    from mmtrack_torch.data.processing import KYSPairProcessing
    from mmtrack_torch.data.sampler import TrackingSampler
    from mmtrack_torch.models.convert import kys_state_dict_from_flax
    from mmtrack_torch.train import run, zoo_actors
    from mmtrack_tpu.models import kys as jkys
    from mmtrack_tpu.train import optim as jax_optim
    from mmtrack_tpu.train import train_step as jax_train_step
    from mmtrack_tpu.train import zoo_actors as jax_zoo
    from test_torch_kys_train import kys_tree, port_kys

    S, B, lr = 96, 2, 1e-3
    smp = TrackingSampler([SyntheticVideoDataset(8, 60, distractor=True)], None,
                          samples_per_epoch=B * KYS_STEPS, max_gap=5, num_search_frames=2,
                          processing=KYSPairProcessing(search_area_factor=5.0, output_sz=S),
                          seed=7)
    batches = [{k: np.asarray(b[k]) for k in zoo_actors.KYS_BATCH_KEYS}
               for b in BatchLoader(smp, B, collate_fn=collate_pair)]
    tree = kys_tree(3)
    mask = jax.tree_util.tree_map_with_path(lambda path, _: path[0].key == "predictor",
                                            tree["params"])
    tx = jax_optim.build_optimizer(tree, lr=lr, weight_decay=1e-4,
                                   trainable_mask={"params": mask})
    inner = jax_zoo.make_kys_train_step(jkys.build_kysnet(), tx)
    jstep = jax.jit(lambda st, b, r: inner(st, jax_zoo.kys_pair_adapt_batch(b, S, 5.0,
                                                                            channels=6), r))
    jstate = jax_train_step.TrainState.create(tree, tx)
    port = port_kys(tree)
    opt, sched = build_optimizer(port, lr=lr, weight_decay=1e-4,
                                 trainable_mask=run.zoo_trainable_mask(port, "kys", ""))
    state = TrainState(port, opt, sched)
    step = zoo_actors.make_kys_train_step(S, channels=6)
    for b in batches:
        jstate, want = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                             jax.random.PRNGKey(0))
        state, got = step(state, b)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    want = kys_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    got = port.state_dict()
    trained = [k for k in got if k.startswith("predictor.")]
    d2 = sum(float(((got[k] - want[k]) ** 2).sum()) for k in trained)
    n2 = sum(float((want[k] ** 2).sum()) for k in trained)
    assert len(batches) == KYS_STEPS and (d2 / n2) ** 0.5 <= 1e-5, (d2 / n2) ** 0.5


def test_demo_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--lwl_only", "--out", str(tmp_path / "x.json")])
    assert not os.path.exists(tmp_path / "x.json")
