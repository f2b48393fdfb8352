"""The learning demo's DiMP-50 training in JAX and in the port, side by side
on the CPU (a one-off measurement, not a test; ~10 min on 4 threads):

    JAX_PLATFORMS=cpu python docs/artifacts/dimp_training_vs_jax.py

The demo's first 16 steps (B=8, lr, decay and clip of
train/tiny_synthetic.json, the drop step of its 8-step epochs) at 128 px
instead of the demo's 288, JAX's jitted step and the port's from one tree:
the port's seeded DiMP-50 of the demo (seed 7) converted through JAX's
convert_dimp_checkpoint onto a DiMPNet tree (its unread layer4 from a
numpy seed), on the same sampler batches of the synthetic corpus (the
demo's processing at 128 px), JAX's proposal draws of each step's key
given to the port. Every step's Loss/iou, Loss/clf and Loss/total on both
sides and their relative differences, and the trained parameters' relative
L2 after the 16 steps. The control: each package again with the first
batch's crops changed by 1e-7 relative (a seeded +-1e-7 factor), every
step's losses against its own unchanged run, so that a parting between
the packages can be read against the training's own sensitivity to a
rounding-sized change. Writes dimp_training_vs_jax.json beside this
file."""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(4)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_torch.config import merge_overrides, vipt_experiment_config  # noqa: E402
from mmtrack_torch.data.datasets import SyntheticVideoDataset  # noqa: E402
from mmtrack_torch.data.loader import BatchLoader  # noqa: E402
from mmtrack_torch.data.processing import ViPTProcessing  # noqa: E402
from mmtrack_torch.data.sampler import TrackingSampler  # noqa: E402
from mmtrack_torch.models.convert import dimp_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train import dimp_actor, learning_demo as demo, run  # noqa: E402
from mmtrack_tpu.models import dimp as jd  # noqa: E402
from mmtrack_tpu.models.convert import convert_dimp_checkpoint  # noqa: E402
from mmtrack_tpu.train import dimp_actor as jax_actor  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jts  # noqa: E402
from test_torch_dimp_train import det_max_tree  # noqa: E402

S, B, STEPS, SEED = 128, 8, 16, demo.SEED
cfg = merge_overrides(vipt_experiment_config("deep_rgbd"), json.load(open(demo.CFG_PATH)))
lr, wd, clip = cfg.TRAIN.LR, cfg.TRAIN.WEIGHT_DECAY, cfg.TRAIN.GRAD_CLIP_NORM
steps_per_epoch = 64 // B                     # the demo's --samples 64 --batch 8
drop = cfg.TRAIN.LR_DROP_EPOCH * steps_per_epoch
proc = ViPTProcessing(search_area_factor={"template": 5.0, "search": 5.0},
                      output_sz={"template": S, "search": S},
                      center_jitter_factor={"template": 0.25, "search": 3.0},
                      scale_jitter_factor={"template": 0.0, "search": 0.25})
smp = TrackingSampler([SyntheticVideoDataset(n_sequences=8, n_frames=60)], None,
                      samples_per_epoch=B * STEPS, max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
                      processing=proc, seed=SEED)
keys = ("template", "search", "template_anno", "search_anno")
batches = [{k: np.asarray(b[k]) for k in keys} for b in BatchLoader(smp, B)]

tree0 = det_max_tree()
tree0 = {"params": {k: v for k, v in tree0["params"].items() if k != "backbone_x"}}


def overlay(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            overlay(dst[k], v)
        else:
            assert dst[k].shape == np.shape(v), k
            dst[k] = np.asarray(v, np.float32)


overlay(tree0["params"], convert_dimp_checkpoint(run.build_zoo_model("dimp", "", SEED,
                                                                     "cpu").state_dict()))
tree0 = jax.tree.map(np.asarray, tree0)
keys_ = [jax.random.PRNGKey(1000 + i) for i in range(STEPS)]
noises = [np.array(jax.random.normal(k, (B, dimp_actor.N_PROPOSALS, 4))) for k in keys_]
eps = np.random.RandomState(3)
perturbed = [dict(batches[0], **{k: (batches[0][k] * (1 + 1e-7 * eps.choice(
    [-1.0, 1.0], batches[0][k].shape))).astype(np.float32) for k in ("template", "search")})
             ] + batches[1:]


def jax_run(bs):
    tx = jax_optim.build_optimizer(tree0, lr=lr, weight_decay=wd, lr_drop_step=drop,
                                   grad_clip_norm=clip)
    jstep = jax.jit(jax_actor.make_dimp_train_step(jd.DiMPNet(), tx, image_sz=S))
    st = jts.TrainState.create(jax.tree.map(jnp.asarray, tree0), tx)
    out = []
    for b, key in zip(bs, keys_):
        st, stats = jstep(st, {k: jnp.asarray(v) for k, v in b.items()}, key)
        out.append({k: float(v) for k, v in stats.items()})
    return out, dimp_state_dict_from_flax(jax.tree.map(np.asarray, st.params["params"]))


def port_run(bs):
    model = run.build_zoo_model("dimp", "", SEED, "cpu")
    st = run.train_state(model, cfg, steps_per_epoch, None)
    step = dimp_actor.make_dimp_train_step(image_sz=S)
    out = []
    for b, noise in zip(bs, noises):
        st, stats = step(st, b, noise=noise)
        out.append({k: float(v) for k, v in stats.items()})
    return out, model.state_dict()


def rel_rows(a, b):
    return [{k: abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for k in y} for x, y in zip(a, b)]


t0 = time.time()
runs = {"port": port_run(batches), "jax": jax_run(batches),
        "port_perturbed": port_run(perturbed), "jax_perturbed": jax_run(perturbed)}
rows = [{k: {"port": p[k], "jax": j[k]} for k in j}
        for p, j in zip(runs["port"][0], runs["jax"][0])]
parting = {"port_vs_jax": rel_rows(runs["port"][0], runs["jax"][0]),
           "port_vs_port_perturbed": rel_rows(runs["port_perturbed"][0], runs["port"][0]),
           "jax_vs_jax_perturbed": rel_rows(runs["jax_perturbed"][0], runs["jax"][0])}
for i in range(STEPS):
    print(i + 1, {k: "%.6g / %.6g" % (v["port"], v["jax"]) for k, v in rows[i].items()},
          {name: "%.1e" % r[i]["Loss/total"] for name, r in parting.items()}, flush=True)


def params_rel(a, b):
    return (sum(float(((a[k] - b[k]) ** 2).sum()) for k in a)
            / sum(float((b[k] ** 2).sum()) for k in a)) ** .5


params = {"port_vs_jax": params_rel(runs["port"][1], runs["jax"][1]),
          "port_vs_port_perturbed": params_rel(runs["port_perturbed"][1], runs["port"][1]),
          "jax_vs_jax_perturbed": params_rel(runs["jax_perturbed"][1], runs["jax"][1])}
first_parting = {name: next((i + 1 for i, r in enumerate(rs) if max(r.values()) > 1e-2), None)
                 for name, rs in parting.items()}
print("params rel L2 after", STEPS, "steps:", params, flush=True)
print("first step with a loss term parted by more than 1e-2:", first_parting, flush=True)
out = {"steps": STEPS, "size": S, "batch": B, "lr": lr, "weight_decay": wd, "clip": clip,
       "seed": SEED, "rows": rows, "rel_diff": parting, "first_step_parted_1e-2": first_parting,
       "params_rel_l2": params, "seconds": time.time() - t0}
json.dump(out, open(os.path.join(HERE, "dimp_training_vs_jax.json"), "w"), indent=1)
print("done", time.time() - t0)
