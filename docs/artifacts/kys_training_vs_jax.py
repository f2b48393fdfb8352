"""The learning demo's KYS training in JAX and in the port, side by side on
the CPU (a one-off measurement, not a test; ~6 min on 4 threads):

    JAX_PLATFORMS=cpu python docs/artifacts/kys_training_vs_jax.py

The demo's 48 steps (6 epochs of 64 samples at B=8, lr and clip of
train/tiny_synthetic.json) at 96 px instead of the demo's 288, JAX's
jitted step and the port's from one tree: the port's seeded KYSNet (seed
7, as the demo's graft, but with its seeded DiMP base in place of the DiMP
phase's trained one, which the CPU cannot train in time) converted through
JAX's convert_kys_checkpoint, on the same sampler batches of the
distractor corpus. Then the demo's held-out metric (fused-peak accuracy on
156 transitions at 288 px) of the seeded, port-trained and JAX-trained
predictors. Writes kys_training_vs_jax.json beside this file."""
import json, os, sys, time
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO); sys.path.insert(0, os.path.join(REPO, "tests"))
import numpy as np, torch
torch.set_num_threads(4)
import jax, jax.numpy as jnp
from mmtrack_torch.config import merge_overrides, vipt_experiment_config
from mmtrack_torch.data.datasets import SyntheticVideoDataset
from mmtrack_torch.data.loader import BatchLoader, collate_pair
from mmtrack_torch.data.processing import KYSPairProcessing
from mmtrack_torch.data.sampler import TrackingSampler
from mmtrack_torch.models.convert import kys_state_dict_from_flax
from mmtrack_torch.train import run, zoo_actors, learning_demo as demo
from mmtrack_tpu.models import kys as jkys
from mmtrack_tpu.models.convert import convert_kys_checkpoint
from mmtrack_tpu.train import optim as jax_optim, train_step as jts, zoo_actors as jax_zoo
from test_torch_kys_train import kys_tree

S, B, STEPS = 96, 8, 48
cfg = merge_overrides(vipt_experiment_config("deep_rgbd"), json.load(open(demo.CFG_PATH)))
lr, wd, clip = cfg.TRAIN.LR, cfg.TRAIN.WEIGHT_DECAY, cfg.TRAIN.GRAD_CLIP_NORM
drop = cfg.TRAIN.LR_DROP_EPOCH * 8
smp = TrackingSampler([SyntheticVideoDataset(8, 60, distractor=True)], None,
                      samples_per_epoch=B * STEPS, max_gap=min(cfg.DATA.MAX_SAMPLE_INTERVAL, 5),
                      num_search_frames=2,
                      processing=KYSPairProcessing(search_area_factor=5.0, output_sz=S), seed=7)
batches = [{k: np.asarray(b[k]) for k in zoo_actors.KYS_BATCH_KEYS}
           for b in BatchLoader(smp, B, collate_fn=collate_pair)]
port = run.build_zoo_model("kys", "", 7, "cpu")
seed_sd = {k: v.clone() for k, v in port.state_dict().items()}
tree = kys_tree(3)
conv = convert_kys_checkpoint(port.state_dict())
def overlay(dst, src):
    for k, v in src.items():
        if isinstance(v, dict): overlay(dst[k], v)
        else: dst[k] = np.asarray(v, np.float32)
overlay(tree["params"], conv)
mask = jax.tree_util.tree_map_with_path(lambda p, _: p[0].key == "predictor", tree["params"])
tx = jax_optim.build_optimizer(tree, lr=lr, weight_decay=wd, lr_drop_step=drop,
                               grad_clip_norm=clip, trainable_mask={"params": mask})
inner = jax_zoo.make_kys_train_step(jkys.build_kysnet(), tx)
jstep = jax.jit(lambda st, b, r: inner(st, jax_zoo.kys_pair_adapt_batch(b, S, 5.0, channels=6), r))
jstate = jts.TrainState.create(tree, tx)
state = run.train_state(port, cfg, 8, run.zoo_trainable_mask(port, "kys", ""))
step = zoo_actors.make_kys_train_step(S, channels=6)
rows = []
t0 = time.time()
for i, b in enumerate(batches):
    jstate, want = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    state, got = step(state, b)
    rows.append({k: (float(got[k]), float(want[k])) for k in want})
    if i % 8 == 7 or i == 0:
        print(i + 1, {k: "%.6g / %.6g" % v for k, v in rows[-1].items()}, "%.0fs" % (time.time() - t0), flush=True)
jsd = kys_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
got = port.state_dict()
tr = [k for k in got if k.startswith("predictor.")]
rel = (sum(float(((got[k] - jsd[k]) ** 2).sum()) for k in tr) / sum(float((jsd[k] ** 2).sum()) for k in tr)) ** .5
print("predictor rel L2 port vs jax after 48:", rel, flush=True)
maxrel = max(abs(g - w) / max(abs(w), 1e-12) for r in rows for g, w in r.values())
print("max loss rel diff over 48 steps:", maxrel, flush=True)

def model_of(sd):
    m = run.build_zoo_model("kys", "", 7, "cpu"); m.load_state_dict(sd); return m.eval()
jmodel = model_of({**got, **{k: jsd[k] for k in tr}})
out = {"steps": STEPS, "size": S, "batch": B, "lr": lr, "loss_rows_first_last": [rows[0], rows[-1]],
       "predictor_rel_l2": rel, "max_loss_rel_diff": maxrel}
for name, m in (("seeded", model_of(seed_sd)), ("port_trained", port.eval()), ("jax_trained", jmodel)):
    out[name] = demo._kys_transition_metric(m, "cpu")
    print(name, out[name], flush=True)
json.dump(out, open(os.path.join(HERE, "kys_training_vs_jax.json"), "w"), indent=1)
print("done", time.time() - t0)
