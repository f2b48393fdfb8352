"""The port's measuring tools (mmtrack_torch/train/bench_train.py,
mmtrack_torch/eval/wire_metric_ab.py) against the JAX package's
(tools/bench_train.py, tools/wire_metric_ab.py), on the CPU.

  * bench_train's function at a narrow width: one JSON line per batch size
    with the JAX tool's fields, its MFU arithmetic (JAX's 44.3 GFLOP x 3
    over 989 TFLOP/s), finite losses, no kernel launch on the CPU; the
    port's own FLOP count on the meta device equals FlopCounterMode's over
    a real CPU forward, and a prompt-only fwd + bwd counts between 1x and
    3x the forward.
  * The wire tool's corpus is byte-equal to JAX's `ensure_fixtures`
    (its FIXTURE_DIR pointed at a temporary directory).
  * The head's overfit and size calibration against JAX's
    `overfit_head_on_device` on the same flax weights (a narrow ViPT,
    embed 32, 2 heads, head channel 16, 12 blocks so that CE at 3 / 6 / 9
    holds, 128 / 256 crops, f32), 2 steps on 1 sequence of 11 frames: the
    crops each step trains on bit-equal (read out of JAX's jitted step by
    a debug callback), each step's loss and the calibration delta within
    the rounding of JAX's printed 4 decimals, every box_head leaf within
    1e-5 after (two Adam steps move a leaf by ~2.5e-3; one sign flip
    would show as 5e-4), every other leaf untouched.
  * The summary's metrics, deltas and `within_budget` equal JAX's
    arithmetic (its `main` run with the tracking stubbed to give the same
    boxes).
  * `run` on a 2 x 6 corpus on the CPU: the rgbindex wire's boxes equal
    the host wire's; the yuv420 wire runs where the native decoder loads
    and otherwise says "not run" with the decoder's error.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mmtrack_tpu.models.vipt as jax_vipt  # noqa: E402
import mmtrack_tpu.utils.env as jax_env  # noqa: E402
import tools.wire_metric_ab as jax_wire  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime  # noqa: E402
from mmtrack_torch.config import vipt_experiment_config  # noqa: E402
from mmtrack_torch.data import native_io  # noqa: E402
from mmtrack_torch.eval import wire_metric_ab as wire  # noqa: E402
from mmtrack_torch.models import vipt  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.train import bench_train as bt  # noqa: E402
from mmtrack_torch.utils.profiling import flops_estimate  # noqa: E402

NARROW = dict(embed_dim=32, num_heads=2, head_channel=16)   # ViPTrack's other defaults: deep_rgbd
HEAD_BAR = 1e-5


def _narrow_config():
    cfg = vipt_experiment_config("deep_rgbd")
    cfg.MODEL.BACKBONE.EMBED_DIM, cfg.MODEL.BACKBONE.NUM_HEADS = 32, 2
    cfg.MODEL.HEAD.NUM_CHANNELS = 16
    cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE = 32, 64
    return cfg


def test_bench_train_lines_and_mfu_arithmetic(capsys):
    rows = bt.bench_train(_narrow_config(), (2, 3), 2, torch.device("cpu"))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == rows and [r["batch"] for r in rows] == [2, 3]
    for r in rows:
        assert r["metric"] == "vipt_train_step" and r["steps_timed"] == 2
        assert np.isfinite([r["loss_first"], r["loss_last"]]).all()
        s = r["ms_per_step"] / 1e3
        assert r["samples_per_s"] == pytest.approx(r["batch"] / s, rel=1e-12)
        assert r["model_tflops"] == pytest.approx(r["batch"] * 44.3 * 3.0 / s / 1e3, rel=1e-12)
        assert r["mfu_vs_bf16_peak"] == pytest.approx(r["model_tflops"] / 989.0, rel=1e-12)
        assert r["launches_per_step"] == {"flash_mhsa_qkv": 0, "attn_block_fused": 0,
                                          "mlp_block_fused": 0}


def test_port_flop_count_on_the_meta_device():
    cfg = _narrow_config()
    count = bt.port_gflop_per_frame(cfg)
    Tz, Tx, _, keep, mask = bt.geometry(cfg, "cpu")
    model = vipt.build_viptrack(cfg, seed=0)
    with torch.no_grad():
        cpu = flops_estimate(model, torch.zeros(1, Tz, Tz, 6), torch.zeros(1, Tx, Tx, 6), mask,
                             keep)
    assert count["forward"] == pytest.approx(cpu / 1e9, rel=1e-12)
    assert count["forward"] < count["prompt_only_fwd_bwd"] < 3 * count["forward"]


def test_fixtures_are_byte_equal_to_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_wire, "FIXTURE_DIR", str(tmp_path / "jax"))
    jax_wire.ensure_fixtures(2, 12)
    wire.ensure_fixtures(str(tmp_path / "port"), 2, 12)
    files = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        files[side] = {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*")
                       if p.is_file()}
    assert len(files["jax"]) == 2 * (2 * 12 + 1) + 1
    assert files["port"] == files["jax"]


def test_overfit_and_calibration_match_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    monkeypatch.setattr(jax_wire, "FIXTURE_DIR", root)
    wire.ensure_fixtures(root, 1, 11)
    jm = jax_vipt.ViPTrack(**NARROW)
    keep = JaxRuntime().ce_keep_lens
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 128, 128, 6)),
                                       jnp.zeros((1, 256, 256, 6)), None, keep))(
        jax.random.PRNGKey(0))
    seen = []

    class Spy:
        """JAX's model with each (template, search) it is applied to recorded."""

        def apply(self, p, z, x, *a):
            jax.debug.callback(lambda z, x: seen.append((np.asarray(z), np.asarray(x))), z, x)
            return jm.apply(p, z, x, *a)

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trained = jax_wire.overfit_head_on_device(Spy(), params, 1, 11, 2, log_every=1)
    text = printed.getvalue()
    jax_losses = [float(v) for v in re.findall(r"step \d+: loss ([-0-9.]+)", text)]
    jax_delta = [float(v) for v in re.search(r"logit delta \[([^]]+)\]", text)[1].split(",")]

    port = vipt.ViPTrack(**NARROW).eval()
    start = vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"]))
    port.load_state_dict(start)
    out = wire.overfit_head(port, root, 1, 11, 2, log_every=1)

    data = wire.head_crops(root, 1, 11)
    order = np.arange(out["samples"])
    np.random.RandomState(0).shuffle(order)
    assert out["samples"] == 4 and len(seen) >= 2
    for it in range(2):
        z, x = seen[it]
        assert np.array_equal(z[0], data["z"][order[it]]) and np.array_equal(
            x[0], data["x"][order[it]])
    printed_bar = 5e-5 + 1e-6              # JAX prints 4 decimals
    assert len(jax_losses) == 2
    np.testing.assert_allclose(out["losses"], jax_losses, rtol=0, atol=printed_bar)
    np.testing.assert_allclose(out["delta"], jax_delta, rtol=0, atol=printed_bar)
    want = vipt_state_dict_from_flax(jax.tree.map(np.asarray, trained["params"]))
    got = port.state_dict()
    for k, v in want.items():
        if k.startswith("box_head."):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=HEAD_BAR,
                                       err_msg=k)
        else:
            assert torch.equal(got[k], start[k]), k


def _boxes(gts, seed, shift):
    """Host boxes near the truth, rgbindex equal to them, yuv420 moved by
    `shift` px on a few frames."""
    rng = np.random.RandomState(seed)
    host = np.stack([g[1:] + rng.uniform(-6, 6, g[1:].shape) for g in gts])
    yuv = host.copy()
    yuv[:, ::3, :2] += shift
    return {"host": host, "rgbindex": host.copy(), "yuv420": yuv}


@pytest.mark.parametrize("shift", [0.004, 3.0])
def test_summary_equals_jax_arithmetic(tmp_path, monkeypatch, shift):
    n_seq, n_frames = 3, 9
    rng = np.random.RandomState(1)
    gts = []
    for b in range(n_seq):
        d = tmp_path / f"seq{b:02d}"
        d.mkdir()
        gt = np.cumsum(rng.uniform(-2, 2, (n_frames, 4)), 0) + [100, 80, 40, 30]
        np.save(d / "gt.npy", gt)
        gts.append(gt)
    boxes = _boxes(gts, 2, shift)

    class Stub:
        def init(self, *a, **k):
            return {"params": {}}

    monkeypatch.setattr(jax_wire, "FIXTURE_DIR", str(tmp_path))
    monkeypatch.setattr(jax_wire, "ART", str(tmp_path / "jax.json"))
    monkeypatch.setattr(jax_wire, "ensure_fixtures", lambda *a: None)
    monkeypatch.setattr(jax_wire, "overfit_head_on_device", lambda model, params, *a: params)
    monkeypatch.setattr(jax_wire, "run_wire", lambda w, *a: (boxes[w], 0.0))
    monkeypatch.setattr(jax_vipt, "build_viptrack", lambda *a, **k: Stub())
    monkeypatch.setattr(jax_env, "enable_compile_cache", lambda *a, **k: None)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_wire.main(["--n-seq", str(n_seq), "--n-frames", str(n_frames)])
    want = json.load(open(tmp_path / "jax.json"))
    got = wire.summarize(boxes, gts, {}, n_frames)
    assert got["metrics"] == want["metrics"]
    assert {w: {k: round(v, 6) for k, v in d.items()} for w, d in got["deltas_vs_host"].items()
            } == want["deltas_vs_host"]
    assert got["within_budget"] == want["within_budget"]
    assert got["within_budget"] == {"rgbindex": True, "yuv420": shift < 0.01}


def test_run_on_a_small_corpus(tmp_path, monkeypatch, capsys):
    model = vipt.init_weights(vipt.ViPTrack(**NARROW), 0).eval()
    art = tmp_path / "ab.json"
    out = wire.run(model, str(tmp_path / "c"), 2, 6, 1, 2, "cpu", art=str(art), log_every=0)
    assert set(out["boxes"]) == ({"host", "rgbindex", "yuv420"} if native_io.decoder() == "native"
                                 else {"host", "rgbindex"})
    assert np.array_equal(out["boxes"]["rgbindex"], out["boxes"]["host"])
    assert out["boxes"]["host"].shape == (2, 5, 4) and np.isfinite(out["boxes"]["host"]).all()
    assert out["within_budget"]["rgbindex"] and out["deltas_vs_host"]["rgbindex"][
        "frac_frames_boxes_equal"] == 1.0
    assert json.load(open(art))["within_budget"] == out["within_budget"]

    monkeypatch.setattr(native_io, "load_imageio_lib", lambda: None)
    monkeypatch.setattr(native_io, "load_error", lambda: "no libjpeg here")
    capsys.readouterr()
    out = wire.run(model, str(tmp_path / "c"), 2, 6, 1, 2, "cpu", wires=("host", "yuv420"),
                   log_every=0)
    assert out["not_run"] == {"yuv420": "not run: the native decoder did not load "
                                        "(no libjpeg here)"}
    assert out["within_budget"] == {} and out["decoder"] == "cv2" and list(out["boxes"]) == [
        "host"]
    assert '"status": "not run' in capsys.readouterr().out
