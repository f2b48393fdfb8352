"""The port's data-parallel layer (mmtrack_torch/parallel/mesh.py,
train/train_step.py::shard_train_step, the sharded BatchedViPTTracker,
run_ope and train.run under several ranks, parallel/dryrun.py) on the CPU.

Ranks are processes over gloo, each capped at one torch thread, joined
through a file:// store; they import neither jax nor the JAX package.

- `process_local_slice` equal to JAX's over (items, world, rank).
- A 2-rank step of the tiny ViPT (depth 2, dim 32, CE at block 1) at a
  global batch of 8 against JAX's `shard_train_step` on the 8-device CPU
  mesh (tests/test_train.py:114-130), drop path off, from one flax tree:
  loss and stats within 1e-5 relative, the trained (prompt) leaves within
  1e-5 relative L2, the frozen ones bit-equal (test_torch_dimp_train.py::
  assert_step_matches). With drop path on, against the port's own
  one-process step: every rank's mask is its rows of the global batch's
  draw, so the same bars hold.
- The sharded tracker (track, track_split, track_yuv; B=4 over 2 ranks)
  against the unsharded one: boxes within 1e-2 px, scores within 1e-5.
- The toy dry run (`python -m mmtrack_torch.parallel.dryrun --n 2
  --toy`), to its own bars.
- run_ope --tracker mosse at 2 ranks (torchrun's RANK / WORLD_SIZE, no
  process group) over 3 sequences: the result files of both ranks
  together equal the one-rank run's, byte for byte.
- `train.run --distributed` under torchrun (2 ranks, 2 steps of the tiny
  ViPT): the metric log's losses within 1e-5 relative of the one-process
  entry's, one log line an epoch and one checkpoint (rank 0 writes), the
  checkpoint's prompt leaves within 1e-5 relative L2. A batch that does
  not divide over the ranks is refused, naming both numbers.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import vipt as jax_vipt  # noqa: E402
from mmtrack_tpu.parallel import mesh as jax_mesh  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_torch.models import vipt  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.parallel import mesh  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask  # noqa: E402
from mmtrack_torch.train.train_step import TrainState  # noqa: E402
from test_torch_dimp_train import assert_step_matches  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, template_size=32,
            search_size=64, ce_loc=(1,), prompt_type="vipt_deep", head_channel=16)
KEEP = vipt.ce_keep_schedule(16, (1,), (0.7,))
LR = 1e-3
BLOCK_JAX = ("import sys\n"
             "class _Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'flax', 'mmtrack_tpu'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, _Block())\n")

# One rank of a sharded step: loads the specs the test wrote, runs each
# one's step sharded over the group, writes its stats (and, on rank 0, the
# model's state_dict after the step).
WORKER = BLOCK_JAX + r'''
import importlib, os, torch
torch.set_num_threads(1)
torch.set_num_interop_threads(1)
from mmtrack_torch.parallel.mesh import init_distributed, replicate
from mmtrack_torch.train.optim import build_optimizer
from mmtrack_torch.train.train_step import TrainState, shard_train_step
tmp = sys.argv[1]
shard, dev = init_distributed("cpu", init_method="file://" + os.path.join(tmp, "store"))
out = []
for spec in torch.load(os.path.join(tmp, "specs.pt"), weights_only=False):
    model = replicate(spec["model"], shard)
    opt, sched = build_optimizer(model, trainable_mask=spec["mask"], **spec["opt"])
    mod, fn, kw = spec["factory"]
    step = shard_train_step(getattr(importlib.import_module(mod), fn)(**kw), shard)
    _, stats = step(TrainState(model, opt, sched), spec["batch"], **spec.get("step_kw", {}))
    out.append({"stats": {k: float(v) for k, v in stats.items()},
                "state": model.state_dict() if shard.rank == 0 else None})
torch.save(out, os.path.join(tmp, "out%d.pt" % shard.rank))
'''


def rank_env(rank: int, world: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    return env


def run_ranks(tmp, code: str, world: int = 2, args=(), timeout: int = 240) -> None:
    """`code` in `world` processes (RANK, WORLD_SIZE set), all started
    together; each must exit 0."""
    script = os.path.join(tmp, "rank.py")
    with open(script, "w") as f:
        f.write(code)
    procs = [subprocess.Popen([sys.executable, script, *map(str, args)], cwd=str(tmp),
                              env=rank_env(r, world), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        if p.returncode != 0:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)


def sharded_steps(tmp, specs: list, world: int = 2) -> list:
    """Each spec's step over `world` ranks: [(stats per rank, rank 0's
    state_dict after the step)]."""
    torch.save(specs, os.path.join(tmp, "specs.pt"))
    run_ranks(tmp, WORKER, world, args=(tmp,))
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]
    return [([o[i]["stats"] for o in outs], outs[0][i]["state"]) for i in range(len(specs))]


def single_step(spec: dict) -> tuple[dict, dict]:
    """The spec's step in this process on the whole batch: (stats,
    state_dict after)."""
    import importlib

    spec = copy.deepcopy(spec)
    model = spec["model"]
    opt, sched = build_optimizer(model, trainable_mask=spec["mask"], **spec["opt"])
    mod, fn, kw = spec["factory"]
    _, stats = getattr(importlib.import_module(mod), fn)(**kw)(
        TrainState(model, opt, sched), spec["batch"], **spec.get("step_kw", {}))
    return {k: float(v) for k, v in stats.items()}, model.state_dict()


def assert_ranks_match(rank_stats, got, want_stats, want, start, trained, lr=LR):
    """Every rank reports the same stats, and the sharded step matches
    the reference to assert_step_matches's bars at learning rate `lr`."""
    assert all(s == rank_stats[0] for s in rank_stats), rank_stats
    assert_step_matches(rank_stats[0], want_stats, got, want, start, trained, lr=lr)


@pytest.mark.parametrize("n,world", [(10, 1), (10, 2), (10, 3), (7, 4), (3, 2), (2, 4), (0, 2)])
def test_process_local_slice_matches_jax(monkeypatch, n, world):
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", str(world))
        assert mesh.process_local_slice(n) == jax_mesh.process_local_slice(n)
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert mesh.process_local_slice(n) == slice(0, n)


def test_shard_rows_and_refusal():
    s = mesh.Shard(rank=1, world=4)
    assert s.rows(8) == slice(2, 4)
    x = np.arange(8)
    np.testing.assert_array_equal(s.rolled(x), np.roll(x, 1)[2:4])
    np.testing.assert_array_equal(s.rolled(torch.as_tensor(x)).numpy(), np.roll(x, 1)[2:4])
    with pytest.raises(ValueError, match="6 does not divide over 4"):
        s.rows(6)
    rows = mesh.shard_batch({"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}, s)
    assert rows["a"].tolist() == [2, 3] and rows["b"].tolist() == [[4, 5], [6, 7]]


def test_drop_path_rows_are_the_global_draw():
    from mmtrack_torch.models.layers import drop_path

    x = torch.ones(8, 5, 3)
    want = drop_path(x, 0.5, torch.Generator().manual_seed(3))
    for rank in range(4):
        gen = mesh.Shard(rank=rank, world=4).draws(torch.Generator().manual_seed(3), 8)
        got = drop_path(x[2 * rank:2 * rank + 2], 0.5, gen)
        assert torch.equal(got, want[2 * rank:2 * rank + 2])


def _batch(B=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"template": rng.randn(B, 32, 32, 6).astype(np.float32),
            "search": rng.randn(B, 64, 64, 6).astype(np.float32),
            "search_anno": rng.uniform(0.25, 0.4, (B, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def flax_params():
    model = jax_vipt.ViPTrack(**TINY)
    z, x = jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6))
    mask = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    return jax.jit(lambda r: model.init(r, z, x, mask, KEEP))(jax.random.PRNGKey(0))


def vipt_spec(params, drop_path: bool) -> dict:
    model = vipt.ViPTrack(**TINY, drop_path_rate=0.1 if drop_path else 0.0)
    model.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    kw = dict(box_mask_z=vipt.generate_ctr_mask(2, "CTR_POINT"), ce_keep_lens=KEEP,
              search_size=64, stride=16, use_drop_path=drop_path, seed=5)
    return {"model": model, "mask": prompt_only_mask(model), "opt": dict(lr=LR),
            "factory": ("mmtrack_torch.train.train_step", "make_train_step", kw),
            "batch": _batch()}


@pytest.fixture(scope="module")
def vipt_runs(flax_params, tmp_path_factory):
    specs = [vipt_spec(flax_params, False), vipt_spec(flax_params, True)]
    starts = [{k: v.clone() for k, v in s["model"].state_dict().items()} for s in specs]
    runs = sharded_steps(str(tmp_path_factory.mktemp("vipt")), specs)
    return specs, starts, runs


def test_two_rank_step_matches_jax_sharded_step(flax_params, vipt_runs):
    specs, starts, runs = vipt_runs
    jm = jax_vipt.ViPTrack(**TINY)
    tx = jax_optim.build_optimizer(
        flax_params, lr=LR,
        trainable_mask={"params": jax_optim.prompt_only_mask(flax_params["params"])})
    step = jax_train_step.make_train_step(jm, tx, box_mask_z=jax_vipt.generate_ctr_mask(
        2, "CTR_POINT"), ce_keep_lens=KEEP, search_size=64, stride=16, use_drop_path=False)
    m = jax_mesh.make_mesh({"data": 8})
    state = jax_mesh.replicate(jax_train_step.TrainState.create(flax_params, tx), m)
    jbatch = jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in specs[0]["batch"].items()}, m)
    jstate, jstats = jax_train_step.shard_train_step(step, m, donate=False)(
        state, jbatch, jax_mesh.replicate(jax.random.PRNGKey(0), m))
    want = vipt_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params["params"]))
    rank_stats, got = runs[0]
    trained = {k for k, v in specs[0]["mask"].items() if v}
    assert_ranks_match(rank_stats, got, {k: float(v) for k, v in jstats.items()}, want,
                       starts[0], trained)


def test_two_rank_drop_path_step_matches_one_process(vipt_runs):
    specs, starts, runs = vipt_runs
    want_stats, want = single_step(specs[1])
    rank_stats, got = runs[1]
    trained = {k for k, v in specs[1]["mask"].items() if v}
    assert_ranks_match(rank_stats, got, want_stats, want, starts[1], trained)
    # the masks dropped something: without drop path the step differs
    assert rank_stats[0]["Loss/total"] != runs[0][0][0]["Loss/total"]


TRACK_WORKER = BLOCK_JAX + r'''
import os, numpy as np, torch
torch.set_num_threads(1)
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
from mmtrack_torch.parallel.mesh import init_distributed
tmp = sys.argv[1]
shard, dev = init_distributed("cpu", init_method="file://" + os.path.join(tmp, "store"))
spec = torch.load(os.path.join(tmp, "track.pt"), weights_only=False)
t = BatchedViPTTracker(spec["model"], dev, spec["rt"], shard=shard)
t.initialize(spec["frames"], spec["boxes0"])
out = [t.track(spec["frames"]), t.track_split(*spec["split"]), t.track_yuv(*spec["yuv"])]
torch.save(out, os.path.join(tmp, "track%d.pt" % shard.rank))
'''


def test_sharded_tracker_matches_unsharded(flax_params, tmp_path):
    from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
    from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime

    model = vipt.ViPTrack(**TINY)
    model.load_state_dict(vipt_state_dict_from_flax(
        jax.tree.map(np.asarray, flax_params["params"])))
    rng = np.random.RandomState(2)
    B, H, W = 4, 96, 128
    frames = rng.randint(0, 255, (B, H, W, 6)).astype(np.uint8)
    y = rng.randint(0, 255, (B, H, W)).astype(np.uint8)
    cb, cr = (rng.randint(0, 255, (B, H // 2, W // 2)).astype(np.uint8) for _ in range(2))
    spec = {"model": model, "frames": frames,
            "boxes0": np.tile([W * 0.25, H * 0.2, W * 0.2, H * 0.18], (B, 1)),
            "rt": ViPTRuntime(template_factor=2.0, template_size=32, search_factor=4.0,
                              search_size=64, stride=16, ce_loc=(1,), ce_keep_ratio=(0.7,)),
            "split": (frames[..., :3].copy(), frames[..., 3].copy()),
            "yuv": (y, cb, cr, frames[..., 3].copy())}
    torch.save(spec, tmp_path / "track.pt")
    run_ranks(tmp_path, TRACK_WORKER, 2, args=(tmp_path,))
    t = BatchedViPTTracker(copy.deepcopy(model), "cpu", spec["rt"])
    t.initialize(frames, spec["boxes0"])
    want = [t.track(frames), t.track_split(*spec["split"]), t.track_yuv(*spec["yuv"])]
    for r in range(2):
        got = torch.load(tmp_path / f"track{r}.pt", weights_only=False)
        for (gb, gs), (wb, ws) in zip(got, want):
            assert gb.shape == (B, 4) and gs.shape == (B,)
            assert np.abs(gb - wb).max() < 1e-2 and np.abs(gs - ws).max() < 1e-5


def test_toy_dryrun_over_two_ranks():
    from mmtrack_torch.parallel import dryrun

    out = dryrun.run(2, toy=True, device="cpu")
    assert out["backend"] == "gloo" and out["batch"] == 4 and out["ranks_agree"]
    assert out["loss_rel_dev"] < dryrun.LOSS_REL_BAR
    assert out["params_max_abs_dev"] < dryrun.PARAM_BAR
    assert out["eval_boxes_max_abs_dev"] < dryrun.BOX_BAR and out["split_ok"]


def ope_fixture(root, n_seqs=3, n_frames=4, hw=(60, 80)):
    import cv2

    from mmtrack_torch.data.synthetic import make_synthetic_sequence

    for s in range(n_seqs):
        frames, gt = make_synthetic_sequence(n_frames=n_frames, height=hw[0], width=hw[1],
                                             box0=(20.0 + 3 * s, 15.0, 18.0, 14.0), seed=s)
        d = os.path.join(root, f"seq{s}")
        os.makedirs(os.path.join(d, "color"))
        os.makedirs(os.path.join(d, "depth"))
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(d, "color", f"{i + 1:08d}.jpg"), f[..., 2::-1])
            cv2.imwrite(os.path.join(d, "depth", f"{i + 1:08d}.png"),
                        f[..., 3].astype(np.uint16) * 40)
        np.savetxt(os.path.join(d, "groundtruth.txt"), gt, fmt="%.4f", delimiter=",")


OPE = BLOCK_JAX + r'''
from mmtrack_torch.eval import run_ope
assert run_ope.main(sys.argv[1:]) == 0
'''


def test_run_ope_at_two_ranks_equals_one_rank(tmp_path):
    ope_fixture(str(tmp_path / "data"))
    args = ["--tracker", "mosse", "--dataset", "DepthTrack", "--dataset_root",
            str(tmp_path / "data"), "--device", "cpu", "--analyze", "--results_root"]
    run_ranks(tmp_path, OPE, 1, args=args + [str(tmp_path / "one")])
    run_ranks(tmp_path, OPE, 2, args=args + [str(tmp_path / "two")])
    one = tmp_path / "one" / "DepthTrack" / "mosse"
    two = tmp_path / "two" / "DepthTrack" / "mosse"
    names = sorted(f for f in os.listdir(one) if f.endswith(".txt"))
    assert names == ["seq0.txt", "seq1.txt", "seq2.txt"]
    assert names == sorted(f for f in os.listdir(two) if f.endswith(".txt"))
    for f in names:
        assert (one / f).read_bytes() == (two / f).read_bytes(), f
    reports = sorted(os.listdir(tmp_path / "two" / "DepthTrack"))
    assert reports == ["mosse", "mosse_report.rank0.json", "mosse_report.rank1.json"]
    assert sorted(os.listdir(tmp_path / "one" / "DepthTrack")) == ["mosse", "mosse_report.json"]


TINY_CFG = {"MODEL": {"BACKBONE": {"EMBED_DIM": 32, "DEPTH": 2, "NUM_HEADS": 2, "CE_LOC": [1],
                                   "CE_KEEP_RATIO": [0.7]}, "HEAD": {"NUM_CHANNELS": 16}},
            "DATA": {"TEMPLATE": {"SIZE": 32}, "SEARCH": {"SIZE": 64}},
            "TRAIN": {"EPOCH": 1, "SAVE_EPOCH_INTERVAL": 1, "PRINT_INTERVAL": 1}}


def test_distributed_entry_matches_one_process(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CFG))
    common = ["--config", str(cfg), "--synthetic", "--batch", "4", "--samples", "8",
              "--device", "cpu"]
    env = rank_env(0, 1)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k)
    code = BLOCK_JAX + "from mmtrack_torch.train import run\nraise SystemExit(run.main())\n"
    (tmp_path / "entry.py").write_text(code)
    one = subprocess.run([sys.executable, str(tmp_path / "entry.py"), *common, "--save_dir",
                          str(tmp_path / "one")], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", str(tmp_path / "entry.py"), *common,
                          "--distributed", "--save_dir", str(tmp_path / "two")],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=240)
    assert two.returncode == 0, two.stderr[-3000:]
    assert "backend gloo (ranks on the CPU)" in two.stdout
    logs = [(tmp_path / d / "vipt-tiny" / "logs" / "train.jsonl").read_text().splitlines()
            for d in ("one", "two")]
    assert len(logs[0]) == len(logs[1]) == 1
    a, b = (json.loads(ln[0]) for ln in logs)
    for k in a:
        if k.startswith("Loss") or k == "IoU":
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    ckpts = [torch.load(tmp_path / d / "vipt-tiny" / "checkpoints" / "epoch_0001.pt",
                        weights_only=True)["model"] for d in ("one", "two")]
    assert os.listdir(tmp_path / "two" / "vipt-tiny" / "checkpoints") == ["epoch_0001.pt"]
    d2 = sum(float(((ckpts[1][k] - ckpts[0][k]) ** 2).sum()) for k in ckpts[0] if "prompt" in k)
    n2 = sum(float((ckpts[0][k] ** 2).sum()) for k in ckpts[0] if "prompt" in k)
    assert (d2 / n2) ** 0.5 <= 1e-5
    for k in ckpts[0]:
        if "prompt" not in k:
            assert torch.equal(ckpts[0][k], ckpts[1][k]), k


def test_distributed_entry_refuses_an_indivisible_batch(monkeypatch):
    from mmtrack_torch.train import run

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="batch of 3 does not divide over 2 ranks"):
        run.main(["--synthetic", "--batch", "3", "--device", "cpu", "--distributed"])
