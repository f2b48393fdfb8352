"""The JAX package's serving opt-outs in the port (mmtrack_torch/utils/
optouts.py), on the CPU.

  * `resolve` maps JAX's values to the port's switches as JAX's gates
    read them (layers.py:127-131, :252-256): MMTRACK_ATTN=xla takes the
    attention kernel and both half-blocks off (use_kernels=False,
    fuse=False), MMTRACK_MLP=xla the half-blocks only (fuse=False). A bf16
    forward built with those switches calls exactly the functions they
    name (counting stand-ins in models/layers.py): the unfused layers
    where JAX's gate sends its blocks, with the plain attention under ATTN
    and the attention kernel under MLP.
  * MMTRACK_CROP: unset and `gather` run the plain crop on CPU frames (held
    to JAX's gather crop, crop.py:160-166); `pallas` refuses a CPU device,
    `mxu` and anything else raise; on the meta device (a stand-in for the
    card: nothing is built) the wrapper takes the kernel's route, and the
    tracking step crops with the function it is given.
  * The port's modules read no environment: with every opt-out set, a
    model's blocks and the crop wrapper still take the kernels. Every
    entry point that runs a hand kernel, and chip_smoke.py, refuses to
    start with any of the three set; only ab_kernels reads them, its mode
    winning over MMTRACK_ATTN / MMTRACK_MLP and MMTRACK_CROP choosing the
    crop of its loop, as in the JAX tool; ab_kernels refuses the CPU.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_tpu.ops import crop as jax_crop  # noqa: E402
from mmtrack_torch.kernels import ab_kernels  # noqa: E402
from mmtrack_torch.models import layers, vipt  # noqa: E402
from mmtrack_torch.ops import crop  # noqa: E402
from mmtrack_torch.ops import flash_attn, mlp_fuse  # noqa: E402
from mmtrack_torch.trackers import vipt_tracker  # noqa: E402
from mmtrack_torch.utils import optouts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# depth 3 with CE at block 1: two blocks fusable without CE, one with it
TINY = dict(embed_dim=32, depth=3, num_heads=2, patch_size=16, template_size=32,
            search_size=64, ce_loc=(1,), head_channel=16)
KEEP = (2,)                                  # CE at block 1 keeps 2 of the 4 search tokens
MAPS = ("score_map", "size_map", "offset_map")
ALL_SET = {"MMTRACK_ATTN": "xla", "MMTRACK_MLP": "xla", "MMTRACK_CROP": "gather"}
# JAX's values -> (use_kernels, fuse)
GATES = {(): (True, True), (("ATTN", "xla"),): (False, False), (("MLP", "xla"),): (True, False),
         (("ATTN", "xla"), ("MLP", "xla")): (False, False),
         (("ATTN", "fused"), ("MLP", "fused")): (True, True), (("ATTN", "fused"), ("MLP", "xla")):
         (True, False)}
# the port's entry points that run a hand kernel, each refusing the opt-outs
ENTRIES = ("mmtrack_torch.demo", "mmtrack_torch.eval.benchmark_suite",
           "mmtrack_torch.eval.run_ope", "mmtrack_torch.eval.vot_entry",
           "mmtrack_torch.eval.wire_metric_ab", "mmtrack_torch.kernels.time_crop",
           "mmtrack_torch.parallel.dryrun", "mmtrack_torch.train.bench_train",
           "mmtrack_torch.train.learning_demo", "mmtrack_torch.train.run")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in optouts.VALUES:
        monkeypatch.delenv(name, raising=False)


def _opts(env, device=None):
    return optouts.resolve(**{k.lower(): v for k, v in env}, device=device)


def _ids(env):
    return "+".join(f"{k}={v}" for k, v in env) or "unset"


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 32, 32, 6).astype(np.float32),
            rng.randn(2, 64, 64, 6).astype(np.float32))


@pytest.mark.parametrize("env", list(GATES), ids=_ids)
def test_block_gates_follow_jax(monkeypatch, env):
    for key, value in env:                       # the modules read no environment
        monkeypatch.setenv(f"MMTRACK_{key}", value)
    default = vipt.ViPTrack(**TINY, dtype=torch.bfloat16)
    assert {(b.use_kernels, b.fuse, b.attn.use_kernels)
            for b in default.backbone.blocks} == {(True, True, True)}
    opts = _opts(env)
    use_kernels, fuse = GATES[env]
    assert (opts.use_kernels, opts.fuse, opts.plain_crop) == (use_kernels, fuse, False)
    block = layers.CEBlock(32, 2, dtype=torch.bfloat16, **opts.model_kwargs())
    assert (block.use_kernels, block.fuse, block.attn.use_kernels) == (use_kernels, fuse,
                                                                       use_kernels)
    model = vipt.ViPTrack(**TINY, dtype=torch.bfloat16, **opts.model_kwargs())
    assert {(b.attn.use_kernels, b.fuse) for b in model.backbone.blocks} == {GATES[env]}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_use_kernels_and_fuse_reach_every_block(use_kernels):
    model = vipt.build_ostrack(dtype=torch.bfloat16, use_kernels=use_kernels, **TINY)
    assert all(b.use_kernels == use_kernels and b.attn.use_kernels == use_kernels and b.fuse
               for b in model.backbone.blocks)
    model = vipt.build_ostrack(dtype=torch.bfloat16, use_kernels=use_kernels, fuse=False,
                               **TINY)
    assert all(b.use_kernels == use_kernels and not b.fuse for b in model.backbone.blocks)


# calls of each routed function in one bf16 forward of TINY with CE
# (blocks 0 and 2 fusable, block 1 eliminates: its attention is unfused
# and returns the probabilities, its MLP half follows the block's gate)
ROUTES = {(): {"attn_block_fused": 2, "mlp_block_fused": 3},
          (("ATTN", "xla"),): {"flash_mhsa_qkv_plain": 2},
          (("MLP", "xla"),): {"flash_mhsa_qkv": 2},
          (("ATTN", "xla"), ("MLP", "xla")): {"flash_mhsa_qkv_plain": 2}}
ROUTED = ("attn_block_fused", "mlp_block_fused", "attn_block_fused_plain",
          "mlp_block_fused_plain", "flash_mhsa_qkv", "flash_mhsa_qkv_plain")


@pytest.mark.parametrize("env", list(ROUTES), ids=_ids)
def test_forward_calls_the_functions_the_gates_name(monkeypatch, env):
    calls = dict.fromkeys(ROUTED, 0)
    plain = {"attn_block_fused": flash_attn.attn_block_fused_plain,
             "mlp_block_fused": mlp_fuse.mlp_block_fused_plain,
             "flash_mhsa_qkv": flash_attn.flash_mhsa_qkv_plain}
    for name in ROUTED:
        fn = plain.get(name, getattr(layers, name))

        def counted(*a, _name=name, _fn=fn, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(layers, name, counted)
    model = vipt.init_weights(vipt.ViPTrack(**TINY, dtype=torch.bfloat16,
                                            **_opts(env).model_kwargs()), 0).eval()
    z, x = _inputs()
    with torch.no_grad():
        out = model(torch.from_numpy(z), torch.from_numpy(x), None, KEEP)
    assert calls == {**dict.fromkeys(ROUTED, 0), **ROUTES[env]}
    assert all(torch.isfinite(out[k].float()).all() for k in MAPS)


@pytest.mark.parametrize("name,value", [("MMTRACK_ATTN", "flash"), ("MMTRACK_ATTN", ""),
                                        ("MMTRACK_MLP", "XLA"), ("MMTRACK_MLP", "pallas")])
def test_resolve_refuses_other_values(name, value):
    with pytest.raises(ValueError, match=name):
        optouts.resolve(**{name.split("_")[1].lower(): value})


def _crop_args(device="cpu"):
    rng = np.random.RandomState(4)
    frames = torch.from_numpy(rng.randint(0, 256, (2, 48, 64, 6)).astype(np.uint8)).to(device)
    boxes = torch.tensor([[10.5, 8.25, 20.0, 14.0], [-3.0, 30.0, 12.5, 9.0]], device=device)
    mean = torch.tensor([0.485, 0.456, 0.406] * 2, device=device)
    std = torch.tensor([0.229, 0.224, 0.225] * 2, device=device)
    return frames, boxes, 2.0, 16, mean, std


@pytest.mark.parametrize("value", [None, "gather"])
def test_crop_runs_plain_on_cpu_frames_as_jax_gather(monkeypatch, value):
    opts = optouts.resolve(crop=value, device="cpu")
    assert opts.plain_crop == (value == "gather")
    args = _crop_args()
    got, rf = crop.crop_resize_normalized(*args)
    want, rf_want = crop.crop_resize_normalized_plain(*args)
    assert torch.equal(got, want) and torch.equal(rf, rf_want)
    monkeypatch.setenv("MMTRACK_CROP", "gather")        # JAX reads it when it traces
    frames, boxes, factor, size, mean, std = args
    for b in range(2):
        j, jrf = jax_crop.crop_resize_normalized(frames[b].numpy(), boxes[b].numpy(), factor,
                                                 size, mean.numpy(), std.numpy())
        np.testing.assert_allclose(got[b].numpy(), np.asarray(j), rtol=0, atol=1e-5)
        assert float(rf[b]) == pytest.approx(float(jrf), rel=1e-6)


def test_crop_pallas_refuses_cpu_frames():
    with pytest.raises(ValueError, match="MMTRACK_CROP=pallas"):
        optouts.resolve(crop="pallas", device="cpu")
    assert not optouts.resolve(crop="pallas", device="cuda").plain_crop


@pytest.mark.parametrize("value,match", [("mxu", "Do not port"), ("MXU", "MMTRACK_CROP"),
                                         ("fused", "MMTRACK_CROP"), ("", "MMTRACK_CROP")])
def test_crop_refuses_mxu_and_other_values(value, match):
    with pytest.raises(ValueError, match=match):
        optouts.resolve(crop=value)


class _Built(Exception):
    pass


@pytest.mark.parametrize("env", [{}, ALL_SET], ids=["unset", "all_set"])
def test_crop_route_on_a_card_tensor(monkeypatch, env):
    """Meta tensors stand in for the card: the wrapper's kernel route
    reaches the library (made to raise here), whatever the environment;
    the plain version returns the crops."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)

    def load_library():
        raise _Built

    monkeypatch.setattr(crop, "load_library", load_library)
    frames = torch.empty(2, 48, 64, 6, dtype=torch.uint8, device="meta")
    args = (frames, torch.zeros(2, 4, device="meta"), 2.0, 16, torch.zeros(6, device="meta"),
            torch.ones(6, device="meta"))
    with pytest.raises(_Built):
        crop.crop_resize_normalized(*args)
    out, rf = crop.crop_resize_normalized_plain(*args)
    assert out.shape == (2, 16, 16, 6) and out.device.type == "meta" and rf.shape == (2,)


def test_tracking_crops_with_the_crop_it_is_given():
    rt = vipt_tracker.ViPTRuntime(template_size=32, search_size=64, stride=16, ce_loc=(1,),
                                  ce_keep_ratio=(0.5,))
    model = vipt.init_weights(vipt.ViPTrack(**TINY), 0).eval()
    frames, boxes, *_ = _crop_args()
    calls = []

    def counted(*a):
        calls.append(a[3])
        return crop.crop_resize_normalized_plain(*a)

    with torch.no_grad():
        state = vipt_tracker.vipt_init_state(rt, frames, boxes, counted)
        chunk = frames[None].expand(3, -1, -1, -1, -1)
        _, got, _ = vipt_tracker.vipt_track_scan_batched(rt, model, state, chunk, counted)
        ref = vipt_tracker.vipt_init_state(rt, frames, boxes)
        _, want, _ = vipt_tracker.vipt_track_scan_batched(rt, model, ref, chunk)
    assert calls == [32, 64, 64, 64]
    assert torch.equal(got, want)


def test_refuse_names_every_set_opt_out(monkeypatch):
    optouts.refuse("entry")                       # nothing set: nothing to refuse
    monkeypatch.setenv("MMTRACK_MLP", "fused")
    monkeypatch.setenv("MMTRACK_CROP", "pallas")
    assert optouts.set_names() == ["MMTRACK_MLP", "MMTRACK_CROP"]
    with pytest.raises(SystemExit, match="entry: unset MMTRACK_MLP, MMTRACK_CROP"):
        optouts.refuse("entry")


@pytest.mark.parametrize("module", ENTRIES)
def test_entry_points_refuse_an_opt_out(monkeypatch, capsys, module):
    mod = importlib.import_module(module)
    monkeypatch.setenv("MMTRACK_ATTN", "xla")
    with pytest.raises(SystemExit, match=f"{module}: unset MMTRACK_ATTN") as exc:
        mod.main()
    assert exc.value.code != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("name", sorted(optouts.VALUES))
def test_chip_smoke_refuses_to_start_with_an_opt_out(monkeypatch, capsys, name):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    monkeypatch.setenv(name, "fused" if name != "MMTRACK_CROP" else "gather")
    with pytest.raises(SystemExit, match=name) as exc:
        chip_smoke.main()
    assert exc.value.code != 0 and capsys.readouterr().out == ""


def test_chip_smoke_program_refuses_an_opt_out():
    env = dict(os.environ, MMTRACK_ATTN="xla")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "MMTRACK_ATTN" in proc.stderr


def test_ab_kernels_refuses_the_cpu_and_unknown_modes():
    with pytest.raises(ValueError, match="CUDA"):
        ab_kernels.run_fwd("fused", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ab_kernels.run_loop("xla", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        ab_kernels.mode_opt_outs("pallas")
    env, opts = ab_kernels.mode_opt_outs("xla", "gather")
    assert env == {"attn": "xla", "mlp": "xla", "crop": "gather"}
    assert opts == optouts.OptOuts(use_kernels=False, fuse=False, plain_crop=True)


def test_ab_kernels_reads_the_opt_outs_as_the_jax_tool(monkeypatch):
    runs = []
    monkeypatch.setattr(ab_kernels, "run_loop", lambda mode, crop=None: runs.append((mode, crop)))
    monkeypatch.setattr(ab_kernels, "run_fwd", lambda mode, B, T: runs.append((mode, B, T)))
    monkeypatch.setenv("MMTRACK_ATTN", "xla")            # the mode wins, as JAX's _setup
    monkeypatch.setenv("MMTRACK_CROP", "gather")         # the loop's crop
    for argv in (["loop", "fused"], ["crop", "pallas"], ["crop", "fused"],
                 ["fwd", "xla", "4", "2"]):
        assert ab_kernels.main(argv) == 0
    assert runs == [("fused", "gather"), ("fused", "pallas"), ("fused", "gather"), ("xla", 4, 2)]
