"""Zoo training in the port (train/zoo_actors.py, the score stages'
trainable sets, the zoo branch of train/run.py) against the JAX package's
(train/zoo_actors.py, tools/train.py) at f32: SiamFC's labels and step,
the score masks and the entry here, STARK's steps in
tests/test_torch_stark_{,score_}train.py and MixFormer's in
tests/test_torch_mixformer_train.py, which share this file's helpers.

Narrow models, as tests/test_zoo_actors.py trains them: STARK-SPT at dim
48, 4 heads, one encoder and one decoder layer on 64 / 96 crops; MixFormer
at CvT dims 16/32/48, depths 1/1/1, heads 1/2/3, head channel 32 on 64 /
96 crops; SiamFC at full width on 127 / 255 crops. The flax trees' shapes
come from jax.eval_shape of each init (no compile), their values from a
numpy seed; the port loads them through models/convert.py. One optimizer
step (AdamW, lr 4e-4, decay 1e-4, the global-norm clip at 0.1; the score
stages train only the score head, as tools/train.py's masks) from the same
seeded batch, JAX's step jitted. Bars, those of
tests/test_torch_dimp_train.py::assert_step_matches: loss and stats within
1e-5 relative, the trained leaves within 1e-5 relative L2 (a tenth of the
learning rate for all but one element in a thousand, two learning rates
for every element), the frozen leaves unmoved in both.

A comparison at a point where the step is not continuous in its inputs
tests nothing: there the port moves as far from itself under a 1e-7
relative change of the search crops as from JAX. STARK's box stage at
weight seed 0 is such a point (its box misses the target, IoU 0; the port
against itself 1.1e-4 relative L2, 24,497 elements off), so STARK draws
seed 1 (the port against itself 1.8e-6, 29 elements off).

The score masks select exactly JAX's leaves (mapped through the bridge),
and at full width train as many parameters as JAX's score heads hold
(shapes from eval_shape; the port's models on the meta device). SiamFC's
labels are exact. The entry trains `--script dimp` and a narrowed
MixFormer's bbox then score stage (`--init` from the first) in a process
where jax and the JAX package are never imported.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import mixformer as jax_mf  # noqa: E402
from mmtrack_tpu.models import siamfc as jax_siamfc  # noqa: E402
from mmtrack_tpu.models import stark as jax_stark  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_tpu.train import zoo_actors as jax_zoo  # noqa: E402
from mmtrack_torch.models import mixformer, siamfc, stark  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    mixformer_state_dict_from_flax,
    siamfc_state_dict_from_flax,
    stark_state_dict_from_flax,
)
from mmtrack_torch.train import run, zoo_actors  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer, count_trainable  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from test_torch_dimp_train import LR, WD, assert_step_matches  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STARK_SMALL = dict(six_channel=True, template_size=64, search_size=96, dim=48, heads=4,
                   enc_layers=1, dec_layers=1)
MF_SMALL = dict(template_size=64, search_size=96, stage_dims=(16, 32, 48),
                stage_depths=(1, 1, 1), stage_heads=(1, 2, 3), head_channel=32)
# the flax prefix of the score head each score stage trains
JAX_SCORE_HEADS = {"stark": lambda k: k[0].startswith("cls_"),
                   "mixformer": lambda k: k[0] == "score_branch"}
BRIDGES = {"stark": stark_state_dict_from_flax, "mixformer": mixformer_state_dict_from_flax,
           "siamfc": siamfc_state_dict_from_flax}


def _leaf(rng, path, shape):
    """LeCun-normal kernels, scales near 1, positive variances, small
    biases, means and embeddings; SiamFC's response scale as its init."""
    name = path[-1].key
    if name == "kernel":
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "response_scale":
        return np.full(shape, 1e-3)
    return 0.1 * rng.randn(*shape)


def _seeded(shapes, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)


def jax_model(script, stage):
    if script == "stark":
        return jax_stark.STARK(**STARK_SMALL, score_head=stage == "score")
    if script == "mixformer":
        return jax_mf.MixFormer(**MF_SMALL)
    return jax_siamfc.SiamFC()


def port_model(script, stage, device=None):
    if script == "stark":
        return stark.STARK(**STARK_SMALL, score_head=stage == "score", device=device)
    if script == "mixformer":
        return mixformer.MixFormer(**MF_SMALL, device=device)
    return siamfc.SiamFC(device=device)


def _crops(script):
    return (127, 255) if script == "siamfc" else (64, 96)


def _init_args(script, z, x):
    return (z, z, x) if script == "mixformer" else (z, x)


def flax_tree(script, stage, seed=0):
    jm = jax_model(script, stage)
    t, s = _crops(script)
    z, x = jnp.zeros((1, t, t, 6)), jnp.zeros((1, s, s, 6))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *_init_args(script, z, x)))
    return _seeded(shapes, seed)


def jax_mask(script, params):
    flat = flax.traverse_util.flatten_dict(params["params"])
    return {"params": flax.traverse_util.unflatten_dict(
        {k: JAX_SCORE_HEADS[script](k) for k in flat})}


def batch(seed, script, b=2):
    rng = np.random.RandomState(seed)
    t, s = _crops(script)
    return {"template": rng.uniform(-1, 1, (b, t, t, 6)).astype(np.float32),
            "search": rng.uniform(-1, 1, (b, s, s, 6)).astype(np.float32),
            "search_anno": rng.uniform(0.3, 0.4, (b, 4)).astype(np.float32)}


JAX_STEPS = {"stark": jax_zoo.make_stark_train_step,
             "mixformer": jax_zoo.make_mixformer_train_step,
             "siamfc": lambda model, tx, stage: jax_zoo.make_siamfc_train_step(model, tx)}
PORT_STEPS = {"stark": zoo_actors.make_stark_train_step,
              "mixformer": zoo_actors.make_mixformer_train_step,
              "siamfc": lambda stage: zoo_actors.make_siamfc_train_step()}


def check_step(script, stage, params, batch_seed):
    """One step of JAX's (jitted) and the port's `script` / `stage` from
    the flax tree `params` on a seeded batch (B = 3 for a score stage,
    whose negatives are the batch rolled by one, else 2), held to
    assert_step_matches."""
    b = batch(batch_seed, script, b=3 if stage == "score" else 2)
    jm = jax_model(script, stage)
    score = stage == "score"
    tx = jax_optim.build_optimizer(params, lr=LR, weight_decay=WD,
                                   trainable_mask=jax_mask(script, params) if score else None)
    jstep = jax.jit(JAX_STEPS[script](jm, tx, stage))
    jstate, jstats = jstep(jax_train_step.TrainState.create(params, tx),
                           {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))

    port = port_model(script, stage)
    port.load_state_dict(BRIDGES[script](params["params"]))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    mask = run.zoo_trainable_mask(port, script, stage)
    opt, sched = build_optimizer(port, lr=LR, weight_decay=WD, trainable_mask=mask)
    _, stats = PORT_STEPS[script](stage)(TrainState(port, opt, sched), b)
    assert all(np.isfinite(float(v)) for v in stats.values())
    trained = set(start) if mask is None else {k for k, v in mask.items() if v}
    want = BRIDGES[script](jax.tree.map(np.asarray, jstate.params["params"]))
    assert_step_matches(stats, jstats, port.state_dict(), want, start, trained)


def test_siamfc_step_matches_jax():
    check_step("siamfc", "", flax_tree("siamfc", "", seed=4), 14)


def _count(shapes) -> int:
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("script", ["stark", "mixformer"])
def test_score_masks_select_jax_leaves(script):
    """The port's score stage trains the leaves JAX's mask trains, named
    through the bridge, and nothing else; at full width as many parameters
    as JAX's score head holds (STARK's cls_* from the full model's shapes,
    MixFormer-L's ScoreDecoder at dim 1024, 16 heads)."""
    params = flax_tree(script, "score")
    flat = flax.traverse_util.flatten_dict(params["params"])
    jax_sel = {k: v for k, v in flat.items() if JAX_SCORE_HEADS[script](k)}
    assert jax_sel and len(jax_sel) < len(flat)
    want = set(BRIDGES[script](flax.traverse_util.unflatten_dict(jax_sel)))
    port = port_model(script, "score")
    mask = run.zoo_trainable_mask(port, script, "score")
    assert {k for k, v in mask.items() if v} == want
    assert count_trainable(port, mask) == sum(v.size for v in jax_sel.values())
    assert run.zoo_trainable_mask(port, script, "bbox") is None

    if script == "stark":
        jm = jax_stark.STARK(six_channel=True, score_head=True)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 6)),
                                                jnp.zeros((1, 320, 320, 6))))
        n_jax = jax_optim.count_trainable(shapes["params"], jax_mask(script, shapes)["params"])
        full = stark.STARK(six_channel=True, score_head=True, device="meta")
    else:
        head = jax_mf.ScoreDecoder(dim=1024, heads=16)
        n_jax = _count(jax.eval_shape(lambda: head.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 20, 20, 1024)), jnp.zeros((1, 8, 8, 1024)),
            jnp.zeros((1, 4)))))
        full = mixformer.build_mixformer_rgbd(device="meta")
    assert count_trainable(full, run.zoo_trainable_mask(full, script, "score")) == n_jax


def test_siamfc_response_labels_exact():
    rng = np.random.RandomState(7)
    anno = rng.uniform(0.2, 0.5, (6, 4)).astype(np.float32)
    anno[0] = [0.4, 0.4, 0.2, 0.2]
    anno[1] = [0.25, 0.25, 0.5, 0.5]             # centred: the middle 5 cells positive
    for search, resp, stride in ((255, 17, 8), (96, 9, 8)):
        want = jax_zoo.siamfc_response_labels(jnp.asarray(anno), search, resp, stride)
        got = zoo_actors.siamfc_response_labels(torch.from_numpy(anno), search, resp, stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got == 1).any() and (got == -1).any()


def test_entry_trains_dimp_and_mixformer_stages_without_jax(tmp_path):
    """`run.main --script dimp --synthetic --device cpu` (one step at 288
    px), then a narrowed MixFormer's bbox stage and its score stage with
    --init of the bbox checkpoint, in a process where jax and the JAX
    package are never imported; unported scripts and a stage for dimp are
    refused."""
    ws = str(tmp_path / "ws")
    common = ["--synthetic", "--device", "cpu", "--batch", "1", "--samples", "1",
              "--epochs", "1", "--save_dir", ws]
    code = f"""
import sys
import pytest
from mmtrack_torch.models import mixformer
from mmtrack_torch.train import run
narrow = dict(stage_dims=(16, 32, 48), stage_depths=(1, 1, 1), stage_heads=(1, 2, 3),
              head_channel=32)
mixformer.build_mixformer_rgbd = lambda device=None: mixformer.MixFormer(device=device, **narrow)
common = {common!r}
assert run.main(["--script", "dimp"] + common) == 0
assert run.main(["--script", "mixformer"] + common) == 0
prior = {os.path.join(ws, "mixformer-bbox", "checkpoints", "epoch_0001.pt")!r}
assert run.main(["--script", "mixformer", "--stage", "score", "--init", prior] + common) == 0
for bad in (["--script", "mdnet"], ["--script", "lwl_box"]):
    with pytest.raises(NotImplementedError, match=bad[1]):
        run.main(bad + common)
with pytest.raises(ValueError, match="--stage"):
    run.main(["--script", "dimp", "--stage", "score"] + common)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mmtrack_tpu')]
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    n_score = sum(p.numel() for k, p in mixformer.MixFormer(
        device="meta", stage_dims=(16, 32, 48), stage_depths=(1, 1, 1), stage_heads=(1, 2, 3),
        head_channel=32).named_parameters() if k.startswith("score_branch."))
    assert f"mixformer score stage: {n_score / 1e6:.2f}M trainable parameters" in proc.stdout
    assert "missing=0 unexpected=0" in proc.stdout
    for run_dir in ("dimp", "mixformer-bbox", "mixformer-score"):
        out = os.path.join(ws, run_dir)
        assert os.listdir(os.path.join(out, "checkpoints")) == ["epoch_0001.pt"]
        lines = open(os.path.join(out, "logs", "train.jsonl")).read().splitlines()
        assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["Loss/total"])
