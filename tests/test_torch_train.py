"""The port's ViPT prompt-tuning training against the JAX package, at f32.

Weights cross from flax init through vipt_state_dict_from_flax; batches
are made from numpy seeds. Tolerances:

  * one train step (and three, with a learning-rate drop and a clip that
    fires): loss and every stat within 1e-5 relative; the prompt leaves
    after the step within 1e-5 relative (L2 over all of them; measured
    8e-7 after one step, 2e-6 after three), and each element within a
    tenth of the summed learning rate (Adam's first steps are g / (|g| +
    eps), so an element whose gradient is near eps moves by a few percent
    of lr more or less when its gradient differs in the last bits);
    every frozen leaf bit-equal to its value before the step, on both
    sides;
  * count_trainable at full deep_rgbd: equal;
  * processing, sampling, synthetic data and the config keys: equal, bit
    for bit;
  * resume and fail-safe restart: bit-equal to an uninterrupted run.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.config import vipt_experiment_config as jax_config  # noqa: E402
from mmtrack_tpu.models import vipt as jax_vipt  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_torch.config import vipt_experiment_config  # noqa: E402
from mmtrack_torch.models import vipt  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train import actor  # noqa: E402
from mmtrack_torch.train.optim import (  # noqa: E402
    build_optimizer,
    count_trainable,
    prompt_only_mask,
)
from mmtrack_torch.train.train_step import TrainState, make_train_step  # noqa: E402
from mmtrack_torch.train.trainer import CheckpointManager, Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=32, depth=3, num_heads=2, patch_size=16, template_size=32,
            search_size=64, ce_loc=(1,), prompt_type="vipt_deep", head_channel=16)
KEEP = vipt.ce_keep_schedule(16, (1,), (0.7,))
STEP_KW = dict(search_size=64, stride=16)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_vipt.ViPTrack(**TINY)
    z, x = jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6))
    mask = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    return jax.jit(lambda r: model.init(r, z, x, mask, KEEP))(jax.random.PRNGKey(0))


def _batch(seed, B=4):
    rng = np.random.RandomState(seed)
    return {"template": rng.randn(B, 32, 32, 6).astype(np.float32),
            "search": rng.randn(B, 64, 64, 6).astype(np.float32),
            "search_anno": rng.uniform(0.25, 0.4, (B, 4)).astype(np.float32)}


def _port_from_flax(params):
    model = vipt.ViPTrack(**TINY)
    model.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    return model


def _run_both(jax_params, keep, n_steps, opt_kw):
    """n_steps of the JAX step and the port's step on the same batches."""
    jm = jax_vipt.ViPTrack(**TINY)
    mask_z = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    tx = jax_optim.build_optimizer(
        jax_params, trainable_mask={"params": jax_optim.prompt_only_mask(jax_params["params"])},
        **opt_kw)
    jstep = jax.jit(jax_train_step.make_train_step(
        jm, tx, box_mask_z=mask_z, ce_keep_lens=keep, use_drop_path=False, **STEP_KW))
    jstate = jax_train_step.TrainState.create(jax_params, tx)

    port = _port_from_flax(jax_params)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt, sched = build_optimizer(port, trainable_mask=prompt_only_mask(port), **opt_kw)
    state = TrainState(port, opt, sched)
    step = make_train_step(box_mask_z=vipt.generate_ctr_mask(2, "CTR_POINT"),
                           ce_keep_lens=keep, use_drop_path=False, **STEP_KW)
    lr_sum = 0.0
    for i in range(n_steps):
        lr_sum += opt.param_groups[0]["lr"]
        batch = _batch(i)
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(0))
        state, stats = step(state, batch)
        assert stats.keys() == jstats.keys()
        for k in stats:
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == n_steps

    want = vipt_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    got = port.state_dict()
    assert want.keys() == got.keys()
    diff2 = norm2 = 0.0
    for k in got:
        if "prompt" in k:
            assert not torch.equal(got[k], start[k]), f"prompt leaf {k} did not move"
            d = got[k] - want[k]
            assert d.abs().max() <= 0.1 * lr_sum, (k, float(d.abs().max()))
            diff2 += float((d * d).sum())
            norm2 += float((want[k] * want[k]).sum())
        else:
            assert torch.equal(got[k], start[k]), f"frozen leaf {k} changed"
            assert torch.equal(want[k], start[k]), f"JAX frozen leaf {k} changed"
    assert norm2 > 0 and (diff2 / norm2) ** 0.5 <= 1e-5, (diff2 / norm2) ** 0.5
    return port


@pytest.mark.parametrize("keep", [KEEP, None], ids=["ce", "ce_warmup"])
def test_one_train_step_matches_jax(jax_params, keep):
    _run_both(jax_params, keep, 1, dict(lr=4e-4))


def test_three_steps_with_lr_drop_and_clip_match_jax(jax_params):
    # the clip must fire: the trainable gradient norm is far above 0.1
    port = _port_from_flax(jax_params)
    loss, _ = actor.vipt_forward_and_loss(
        port, {k: torch.from_numpy(v) for k, v in _batch(0).items()},
        box_mask_z=vipt.generate_ctr_mask(2, "CTR_POINT"), ce_keep_lens=KEEP, **STEP_KW)
    loss.backward()
    norm = torch.sqrt(sum((p.grad ** 2).sum() for n, p in port.named_parameters()
                          if "prompt" in n and p.grad is not None))
    assert norm > 0.1
    _run_both(jax_params, KEEP, 3, dict(lr=1e-3, lr_drop_step=2, grad_clip_norm=0.1))


def test_full_tune_step_matches_jax(jax_params):
    """One `--full_tune` step (no trainable mask) on both sides: every leaf,
    the FrozenBatchNorm statistics among them, moves as the JAX package's
    does. The JAX tree holds the four statistics as `params`, so AdamW
    (decay included) and the global-norm clip see them."""
    lr = 4e-4
    jm = jax_vipt.ViPTrack(**TINY)
    mask_z = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    tx = jax_optim.build_optimizer(jax_params, trainable_mask=None, lr=lr)
    jstep = jax.jit(jax_train_step.make_train_step(
        jm, tx, box_mask_z=mask_z, ce_keep_lens=KEEP, use_drop_path=False, **STEP_KW))
    jstate, _ = jstep(jax_train_step.TrainState.create(jax_params, tx),
                      {k: jnp.asarray(v) for k, v in _batch(0).items()}, jax.random.PRNGKey(0))

    port = _port_from_flax(jax_params)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt, sched = build_optimizer(port, trainable_mask=None, lr=lr)
    step = make_train_step(box_mask_z=vipt.generate_ctr_mask(2, "CTR_POINT"),
                           ce_keep_lens=KEEP, use_drop_path=False, **STEP_KW)
    step(TrainState(port, opt, sched), _batch(0))

    want = vipt_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    got = port.state_dict()
    assert want.keys() == got.keys()
    bn = [k for k in got if "running_" in k]
    assert bn, "the tiny model has FrozenBatchNorm statistics"
    for k in got:
        d = (got[k] - want[k]).abs().max()
        assert d <= 0.1 * lr, (k, float(d))
        # a leaf the JAX step moved must move in the port too
        assert torch.equal(got[k], start[k]) == torch.equal(want[k], start[k]), k
    assert not all(torch.equal(want[k], start[k]) for k in bn)


def test_keep_rate_schedule_matches_jax():
    from mmtrack_tpu.train import actor as jax_actor

    for epoch in range(0, 64):
        r = actor.adjust_keep_rate(epoch, 4, 20)
        assert r == jax_actor.adjust_keep_rate(epoch, 4, 20)
        assert actor.quantize_keep_rate(r) == jax_actor.quantize_keep_rate(r)


def test_count_trainable_full_deep_rgbd():
    jcfg = jax_config("deep_rgbd")
    jm = jax_vipt.build_viptrack(jcfg)
    rt_keep = jax_vipt.ce_keep_schedule(256, (3, 6, 9), (0.7, 0.7, 0.7))
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 128, 128, 6)),
                                              jnp.zeros((1, 256, 256, 6)), None, rt_keep),
                            jax.random.PRNGKey(0))["params"]
    want = jax_optim.count_trainable(shapes, jax_optim.prompt_only_mask(shapes))

    port = vipt.build_viptrack(vipt_experiment_config("deep_rgbd"), device="meta")
    assert count_trainable(port, prompt_only_mask(port)) == want
    # every flax leaf, the FrozenBatchNorm statistics among them, is a
    # parameter of the port
    total = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert total == sum(p.numel() for p in port.parameters())
    assert not list(port.buffers())


TRAIN_KEYS = ("TRAIN.PROMPT.TYPE", "TRAIN.LR", "TRAIN.WEIGHT_DECAY", "TRAIN.EPOCH",
              "TRAIN.LR_DROP_EPOCH", "TRAIN.BATCH_SIZE", "TRAIN.GIOU_WEIGHT",
              "TRAIN.L1_WEIGHT", "TRAIN.FOCAL_WEIGHT", "TRAIN.PRINT_INTERVAL",
              "TRAIN.GRAD_CLIP_NORM", "TRAIN.AMP", "TRAIN.SAVE_EPOCH_INTERVAL",
              "TRAIN.SAVE_LAST_N_EPOCH", "TRAIN.CE_START_EPOCH", "TRAIN.CE_WARM_EPOCH",
              "TRAIN.DROP_PATH_RATE", "TRAIN.SCHEDULER.DECAY_RATE",
              "DATA.MAX_SAMPLE_INTERVAL", "DATA.TRAIN.DATASETS_NAME",
              "DATA.TRAIN.DATASETS_RATIO", "DATA.TRAIN.SAMPLE_PER_EPOCH",
              "DATA.TEMPLATE.SIZE", "DATA.TEMPLATE.FACTOR", "DATA.TEMPLATE.CENTER_JITTER",
              "DATA.TEMPLATE.SCALE_JITTER", "DATA.SEARCH.SIZE", "DATA.SEARCH.FACTOR",
              "DATA.SEARCH.CENTER_JITTER", "DATA.SEARCH.SCALE_JITTER")


@pytest.mark.parametrize("name", ["deep_rgbd", "shaw_rgbd", "deep_rgbt", "shaw_rgbt",
                                  "deep_rgbe", "shaw_rgbe"])
def test_train_config_keys_match_jax(name):
    ours, theirs = vipt_experiment_config(name), jax_config(name)
    for key in TRAIN_KEYS:
        a, b = ours, theirs
        for part in key.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert a == b, key


def _frames_dict(seed):
    from mmtrack_tpu.data.synthetic import make_synthetic_sequence

    frames, gt = make_synthetic_sequence(n_frames=6, height=96, width=128, seed=seed)
    return {"template_images": [frames[0]], "template_anno": gt[:1].astype(np.float32),
            "search_images": [frames[4]], "search_anno": gt[4:5].astype(np.float32)}


@pytest.mark.parametrize("forced", [False, True], ids=["default", "every-augmentation"])
def test_processing_bit_equal_to_jax(forced):
    from mmtrack_tpu.data import processing as jax_processing
    from mmtrack_torch.data import processing

    cfg = vipt_experiment_config("deep_rgbd")
    ours = processing.from_config(cfg)
    theirs = jax_processing.from_config(jax_config("deep_rgbd"))
    if forced:
        for p in (ours, theirs):
            p.joint_grayscale_p = p.joint_flip_p = p.crop_flip_p = 1.0
    for seed in range(12):
        a = ours(_frames_dict(seed), np.random.default_rng(seed))
        b = theirs(_frames_dict(seed), np.random.default_rng(seed))
        assert a["valid"] == b["valid"]
        for k in ("template_images", "template_anno", "search_images", "search_anno"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"seed {seed} {k}")


@pytest.mark.parametrize("modality", ["both", "aux_only"])
def test_sampler_loader_and_synthetic_bit_equal_to_jax(modality):
    from mmtrack_tpu.data import datasets as jax_datasets
    from mmtrack_tpu.data import loader as jax_loader
    from mmtrack_tpu.data import processing as jax_processing
    from mmtrack_tpu.data import sampler as jax_sampler
    from mmtrack_torch.data import datasets, loader, processing, sampler

    cfg = vipt_experiment_config("deep_rgbd")
    kw = dict(n_sequences=3, n_frames=30, modality=modality)
    ours = sampler.TrackingSampler([datasets.SyntheticVideoDataset(**kw)], None, 16, 20,
                                   processing=processing.from_config(cfg), seed=3)
    theirs = jax_sampler.TrackingSampler(
        [jax_datasets.SyntheticVideoDataset(**kw)], None, 16, 20,
        processing=jax_processing.from_config(jax_config("deep_rgbd")), seed=3)
    for a, b in zip(ours.datasets[0]._seqs, theirs.datasets[0]._seqs):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    got = next(iter(loader.BatchLoader(ours, 4)))
    want = jax_loader.collate([theirs.sample() for _ in range(4)])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["search"].shape == (4, 256, 256, 6) and got["template"].dtype == np.float32


def _tiny_state(seed=0):
    model = vipt.ViPTrack(**TINY, drop_path_rate=0.1)
    vipt.init_weights(model, seed)
    opt, sched = build_optimizer(model, lr=1e-3, lr_drop_step=3,
                                 trainable_mask=prompt_only_mask(model))
    return TrainState(model, opt, sched)


def _steps():
    """Epoch 1 without candidate elimination, epoch 2 with it (the anneal)."""
    mask = vipt.generate_ctr_mask(2, "CTR_POINT")
    made = {e: make_train_step(box_mask_z=mask, ce_keep_lens=None if e == 1 else KEEP,
                               seed=5, **STEP_KW) for e in (1, 2)}
    return lambda epoch: made[epoch]


LOADER = [_batch(10), _batch(11)]


def _trainer(state, directory, log=None):
    step_for_epoch = _steps()
    return Trainer(step_for_epoch(1), state, LOADER, CheckpointManager(str(directory)),
                   step_for_epoch=step_for_epoch, log_fn=log or (lambda *_: None))


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for k in oa:
        for name in oa[k]:
            assert torch.equal(torch.as_tensor(oa[k][name]), torch.as_tensor(ob[k][name]))
    assert a.scheduler.state_dict() == b.scheduler.state_dict()


def test_resume_is_bit_equal_to_uninterrupted(tmp_path):
    straight = _trainer(_tiny_state(), tmp_path / "a")
    straight.train(2)

    _trainer(_tiny_state(), tmp_path / "b").train(1)
    logs = []
    resumed = _trainer(_tiny_state(seed=1), tmp_path / "b", logs.append)  # other weights
    resumed.train(2)
    assert any("resumed from checkpoint epoch 1" in m for m in logs)
    assert resumed.epoch == 2 and len(resumed.stats_history) == 1
    _assert_states_equal(straight.state, resumed.state)
    assert CheckpointManager(str(tmp_path / "b")).epochs() == [1, 2]
    assert not [f for f in os.listdir(tmp_path / "b") if f.endswith(".tmp")]


def test_fail_safe_restart_after_injected_exception(tmp_path):
    straight = _trainer(_tiny_state(), tmp_path / "a")
    straight.train(2)

    calls = []
    logs = []
    trainer = _trainer(_tiny_state(), tmp_path / "b", logs.append)
    inner = trainer.step_for_epoch

    def faulty(epoch):
        step = inner(epoch)

        def wrapped(state, batch):
            calls.append(epoch)
            if len(calls) == 4:          # the second step of epoch 2, once
                raise RuntimeError("injected fault")
            return step(state, batch)
        return wrapped

    trainer.step_for_epoch = faulty
    trainer.train(2)
    assert any("training crashed" in m for m in logs)
    assert calls == [1, 1, 2, 2, 2, 2]
    _assert_states_equal(straight.state, trainer.state)


def test_checkpoint_retention(tmp_path):
    state = _tiny_state()
    ckpt = CheckpointManager(str(tmp_path), keep_last=2)
    for epoch in (1, 2, 3):
        ckpt.save(epoch, state)
    assert ckpt.epochs() == [2, 3] and ckpt.latest_epoch() == 3
    assert ckpt.should_save(5, 60) and not CheckpointManager(
        str(tmp_path), save_interval=5).should_save(4, 60)


def test_entry_point_trains_tiny_on_cpu_without_jax(tmp_path):
    """`python -m mmtrack_torch.train.run` on a tiny configuration: two
    epochs (the second one with candidate elimination), checkpoints and
    logs written, and neither jax nor the JAX package imported."""
    cfg = {"MODEL": {"BACKBONE": {"EMBED_DIM": 32, "DEPTH": 3, "NUM_HEADS": 2, "CE_LOC": [1],
                                  "CE_KEEP_RATIO": [0.7]}, "HEAD": {"NUM_CHANNELS": 16}},
           "DATA": {"TEMPLATE": {"SIZE": 32}, "SEARCH": {"SIZE": 64}},
           "TRAIN": {"EPOCH": 2, "CE_START_EPOCH": 1, "CE_WARM_EPOCH": 1,
                     "SAVE_EPOCH_INTERVAL": 1}}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    code = ("import sys\n"
            "from mmtrack_torch.train import run\n"
            f"rc = run.main(['--config', {str(path)!r}, '--synthetic', '--batch', '2',\n"
            f"              '--samples', '4', '--device', 'cpu', '--save_dir', {str(tmp_path)!r}])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mmtrack_tpu')]\n"
            "assert rc == 0 and not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "vipt-tiny"
    assert sorted(os.listdir(out / "checkpoints")) == ["epoch_0001.pt", "epoch_0002.pt"]
    lines = (out / "logs" / "train.jsonl").read_text().splitlines()
    assert [json.loads(ln)["epoch"] for ln in lines] == [1, 2]
    assert all(np.isfinite(json.loads(ln)["Loss/total"]) for ln in lines)
