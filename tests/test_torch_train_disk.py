"""Training from disk: one train step of the port against the JAX package's
on a batch read from a corpus on disk, `--init` against JAX's `load_into`,
and the training entry without --synthetic.

At f32 on the tiny model of tests/test_torch_train.py, with JAX's weights
carried across by vipt_state_dict_from_flax. Tolerances, those of
tests/test_torch_train.py: loss and every stat within 1e-5 relative; the
trained leaves within 1e-5 relative (L2 over all of them) and each element
within a tenth of the learning rate; frozen leaves bit-equal. The disk
batches themselves are bit-equal between the packages.

On a disk batch a few weights of the auxiliary patch embedding get a
gradient within the two sides' f32 rounding of zero (the constant padding
of the crops): there Adam's first step lr * g / (|g| + eps) is not
continuous in the gradient's last bits. So at most one element in a
thousand of the trained leaves may differ by more than a tenth of the
learning rate, and none by more than two learning rates (a step of the
other sign).

ViPT (prompt-only) steps on a DepthTrack batch (6 channels). OSTrack
(every parameter) steps on a batch of the RGB mix (3 channels): as in
tools/train.py, both are initialised for 6-channel input, so OSTrack keeps
the auxiliary patch embedding `patch_embed_prompt`, which 3-channel input
never reaches. JAX's step still moves it, by AdamW's weight decay alone
(p * (1 - lr * wd)); the port's step must move every leaf the same way.
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
from mmtrack_tpu.data import datasets as jax_datasets  # noqa: E402
from mmtrack_tpu.data import loader as jax_loader  # noqa: E402
from mmtrack_tpu.data import processing as jax_processing  # noqa: E402
from mmtrack_tpu.data import sampler as jax_sampler  # noqa: E402
from mmtrack_tpu.models import vipt as jax_vipt  # noqa: E402
from mmtrack_tpu.models.convert import convert_vipt_checkpoint, load_into  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_torch.config import vipt_experiment_config  # noqa: E402
from mmtrack_torch.data import datasets, loader, processing, sampler  # noqa: E402
from mmtrack_torch.models import vipt  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask  # noqa: E402
from mmtrack_torch.train.run import load_init  # noqa: E402
from mmtrack_torch.train.train_step import TrainState, make_train_step  # noqa: E402
from mmtrack_torch.train.trainer import CheckpointManager  # noqa: E402
from test_torch_train import KEEP, STEP_KW, TINY  # noqa: E402
from test_torch_train_data import build_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OSTRACK = {**TINY, "prompt_type": "none"}
LR, WD = 4e-4, 1e-4
B = 4


def _jax_params(kw):
    """Flax init on 6-channel zeros, as tools/train.py does for both scripts."""
    model = jax_vipt.ViPTrack(**kw)
    z, x = jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6))
    mask = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    return jax.jit(lambda r: model.init(r, z, x, mask, KEEP))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params():
    return {"vipt": _jax_params(TINY), "ostrack": _jax_params(OSTRACK)}


def _tiny_cfg(make):
    cfg = make("deep_rgbd")
    cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE = 32, 64
    return cfg


def _disk_batch(root, corpus):
    """One batch from the port's loader and one from JAX's sampler + collate
    over the same tree and seed; they must be equal."""
    names, roots, ratios = build_corpus(root, corpus)
    cfg, jcfg = _tiny_cfg(vipt_experiment_config), _tiny_cfg(jax_config)
    ours = sampler.TrackingSampler(datasets.names2datasets(names, roots), ratios, B,
                                   cfg.DATA.MAX_SAMPLE_INTERVAL,
                                   processing=processing.from_config(cfg), seed=11)
    theirs = jax_sampler.TrackingSampler(jax_datasets.names2datasets(names, roots), ratios, B,
                                         jcfg.DATA.MAX_SAMPLE_INTERVAL,
                                         processing=jax_processing.from_config(jcfg), seed=11)
    got = next(iter(loader.BatchLoader(ours, B)))
    want = jax_loader.collate([theirs.sample() for _ in range(B)])
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return {k: got[k] for k in ("template", "search", "search_anno")}


def _port_from_flax(kw, params):
    model = vipt.ViPTrack(**kw)
    model.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    return model


@pytest.mark.parametrize("script,corpus,channels", [("vipt", "depthtrack", 6),
                                                    ("ostrack", "rgb_mix", 3)])
def test_disk_step_matches_jax(tmp_path, params, script, corpus, channels):
    batch = _disk_batch(str(tmp_path), corpus)
    assert batch["search"].shape == (B, 64, 64, channels)
    kw, jparams = (TINY, params["vipt"]) if script == "vipt" else (OSTRACK, params["ostrack"])
    prompt_only = script == "vipt"

    jm = jax_vipt.ViPTrack(**kw)
    mask_z = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    tx = jax_optim.build_optimizer(
        jparams, lr=LR, weight_decay=WD,
        trainable_mask=({"params": jax_optim.prompt_only_mask(jparams["params"])}
                        if prompt_only else None))
    jstep = jax.jit(jax_train_step.make_train_step(
        jm, tx, box_mask_z=mask_z, ce_keep_lens=KEEP, use_drop_path=False, **STEP_KW))
    jstate, jstats = jstep(jax_train_step.TrainState.create(jparams, tx),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    port = _port_from_flax(kw, jparams)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt, sched = build_optimizer(port, lr=LR, weight_decay=WD,
                                 trainable_mask=prompt_only_mask(port) if prompt_only else None)
    step = make_train_step(box_mask_z=vipt.generate_ctr_mask(2, "CTR_POINT"), ce_keep_lens=KEEP,
                           use_drop_path=False, **STEP_KW)
    _, stats = step(TrainState(port, opt, sched), batch)
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)

    want = vipt_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    got = port.state_dict()
    assert want.keys() == got.keys()
    trained = [k for k in got if "prompt" in k] if prompt_only else list(got)
    # OSTrack's auxiliary patch embedding gets no gradient: its bias starts
    # at zero, so weight decay leaves it there (it moves in neither package)
    still = [] if prompt_only else ["backbone.patch_embed_prompt.proj.bias"]
    assert all(not start[k].any() for k in still)
    diff2 = norm2 = 0.0
    off, n_trained = [], 0
    for k in got:
        moved, jax_moved = not torch.equal(got[k], start[k]), not torch.equal(want[k], start[k])
        assert moved == jax_moved == (k in trained and k not in still), k
        d = (got[k] - want[k]).abs()
        assert d.max() <= 2 * LR, (k, float(d.max()))
        off += [(k, float(v)) for v in d[d > 0.1 * LR]]
        n_trained += d.numel() if k in trained else 0
        diff2 += float((d * d).sum())
        norm2 += float((want[k] * want[k]).sum())
    assert len(off) <= n_trained // 1000, off
    assert (diff2 / norm2) ** 0.5 <= 1e-5, (diff2 / norm2) ** 0.5
    if script == "ostrack":
        for k in ("backbone.patch_embed_prompt.proj.weight",):
            # no gradient reaches it: weight decay alone moves it
            decayed = start[k] * (1 - LR * WD)
            torch.testing.assert_close(got[k], decayed, rtol=1e-6, atol=0)
            torch.testing.assert_close(want[k], decayed, rtol=1e-6, atol=0)


def _jax_load_counts(target, src_tree):
    _, missing, unexpected = load_into(target["params"], src_tree)
    return len(missing), len(unexpected)


@pytest.mark.parametrize("prior,target", [("ostrack", "vipt"), ("vipt", "ostrack")])
def test_init_loads_the_names_jax_loads(tmp_path, params, prior, target):
    """--init from a flax params .npz and from the trainer's .pt: the port
    loads the names JAX's load_into loads, with the same missing and
    unexpected counts, and the loaded values are the prior's."""
    kw = {"vipt": TINY, "ostrack": OSTRACK}
    src = jax.tree.map(np.asarray, params[prior]["params"])
    want = _jax_load_counts(params[target], src)
    assert want != (0, 0)

    npz = str(tmp_path / "prior.npz")
    np.savez(npz, params=src)
    model = _port_from_flax(kw[target], params[target])
    missing, unexpected = load_init(model, npz, target)
    assert (len(missing), len(unexpected)) == want
    prior_sd = vipt_state_dict_from_flax(src)
    sd = model.state_dict()
    for k in sd:
        if k in prior_sd:
            assert torch.equal(sd[k], prior_sd[k]), k

    prior_model = _port_from_flax(kw[prior], params[prior])
    vipt.init_weights(prior_model, 3)
    opt, sched = build_optimizer(prior_model, lr=LR)
    ckpts = CheckpointManager(str(tmp_path / "ckpt"))
    ckpts.save(1, TrainState(prior_model, opt, sched))
    pt_sd = {k: v.numpy() for k, v in prior_model.state_dict().items()}
    want_pt = _jax_load_counts(params[target], convert_vipt_checkpoint(pt_sd))
    model = _port_from_flax(kw[target], params[target])
    missing, unexpected = load_init(model, str(tmp_path / "ckpt" / "epoch_0001.pt"), target)
    assert (len(missing), len(unexpected)) == want_pt == want
    for k, v in model.state_dict().items():
        if k in pt_sd:
            assert torch.equal(v, torch.from_numpy(pt_sd[k])), k


def test_rgb_mix_override_names_jax_default_mix():
    """The README's JSON override for the OSTrack foundation mix gives the
    datasets and ratios of the JAX package's default config, which its
    YAML path starts from."""
    from mmtrack_torch.config import merge_overrides
    from mmtrack_tpu.config import vipt_default_config

    mix = {"DATA": {"TRAIN": {"DATASETS_NAME": ["LASOT", "GOT10K_vottrain"],
                              "DATASETS_RATIO": [1, 1]}}}
    ours = merge_overrides(vipt_experiment_config("deep_rgbd"), json.loads(json.dumps(mix)))
    theirs = vipt_default_config()
    assert ours.DATA.TRAIN.DATASETS_NAME == theirs.DATA.TRAIN.DATASETS_NAME
    assert ours.DATA.TRAIN.DATASETS_RATIO == theirs.DATA.TRAIN.DATASETS_RATIO


TINY_CFG = {"MODEL": {"BACKBONE": {"EMBED_DIM": 32, "DEPTH": 3, "NUM_HEADS": 2, "CE_LOC": [1],
                                   "CE_KEEP_RATIO": [0.7]}, "HEAD": {"NUM_CHANNELS": 16}},
            "DATA": {"TEMPLATE": {"SIZE": 32}, "SEARCH": {"SIZE": 64}},
            "TRAIN": {"EPOCH": 1, "SAVE_EPOCH_INTERVAL": 1}}


def test_entry_trains_from_disk_without_jax(tmp_path):
    """`run.main` without --synthetic, on the CPU, in a process where jax
    and the JAX package are never imported, with the roots in a local.yaml
    under a temporary HOME: --script ostrack on the RGB mix (two steps),
    then --script vipt on DepthTrack with --init from its checkpoint (two
    steps); a corpus without a root raises FileNotFoundError naming the
    settings file; --script mdnet (not ported yet) is refused."""
    import yaml

    data = str(tmp_path / "data")
    roots = {}
    for corpus in ("depthtrack", "rgb_mix"):
        roots.update(build_corpus(data, corpus)[1])
    home = tmp_path / "home"
    (home / ".mmtrack_tpu").mkdir(parents=True)
    settings = home / ".mmtrack_tpu" / "local.yaml"
    settings.write_text(yaml.safe_dump({"datasets": {
        "depthtrack_dir": roots["DepthTrack_train"], "lasot_dir": roots["LASOT"],
        "got10k_dir": roots["GOT10K_vottrain"]}}))
    configs = {"tiny": TINY_CFG,
               "mix": {**TINY_CFG, "DATA": {**TINY_CFG["DATA"], "TRAIN": {
                   "DATASETS_NAME": ["LASOT", "GOT10K_vottrain"], "DATASETS_RATIO": [1, 1]}}},
               "tnet": {**TINY_CFG, "DATA": {**TINY_CFG["DATA"], "TRAIN": {
                   "DATASETS_NAME": ["TRACKINGNET"]}}}}
    for name, cfg in configs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
    ws = str(tmp_path / "ws")
    common = ["--batch", "2", "--samples", "4", "--device", "cpu", "--save_dir", ws]
    code = f"""
import sys
import pytest
from mmtrack_torch.train import run
common = {common!r}
assert run.main(["--script", "ostrack", "--config", {str(tmp_path / "mix.json")!r}] + common) == 0
prior = {os.path.join(ws, "ostrack-mix", "checkpoints", "epoch_0001.pt")!r}
assert run.main(["--config", {str(tmp_path / "tiny.json")!r}, "--init", prior] + common) == 0
with pytest.raises(FileNotFoundError, match="trackingnet_dir in {settings}"):
    run.main(["--config", {str(tmp_path / "tnet.json")!r}] + common)
with pytest.raises(NotImplementedError, match="mdnet"):
    run.main(["--script", "mdnet"] + common)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mmtrack_tpu')]
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "HOME")}
    env.update(PYTHONPATH=REPO, HOME=str(home))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    n_prompt = sum("prompt" in k and "patch_embed_prompt" not in k
                   for k in vipt.ViPTrack(**TINY).state_dict())
    assert f"missing={n_prompt} unexpected=0" in proc.stdout
    for run_dir in ("ostrack-mix", "vipt-tiny"):
        out = os.path.join(ws, run_dir)
        assert os.listdir(os.path.join(out, "checkpoints")) == ["epoch_0001.pt"]
        lines = open(os.path.join(out, "logs", "train.jsonl")).read().splitlines()
        assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["Loss/total"])
    assert not os.path.exists(os.path.join(ws, "vipt-tnet", "checkpoints"))
