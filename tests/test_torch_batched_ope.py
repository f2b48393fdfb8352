"""The port's batched OPE path against the JAX package's, at f32 on the CPU.

The tiny ViPTrack of tests/test_golden.py with flax-initialised weights
(PRNGKey(7)) carried across by the weight bridge, on synthetic sequences
and on DepthTrack-layout fixtures (JPEG colour + 16-bit PNG depth) that
the tests write with cv2:

- run_dataset_batched over unequal lengths matches the JAX driver within
  0.05 px (the golden bar) and the port's sequential run_sequence, and
  resumes;
- the rgb + JET-index wire gives the host-composed frames' boxes and
  scores bit for bit, and matches the JAX wire within 0.05 px;
- the raw 4:2:0 wire (MMTRACK_STREAM=yuv420) stays within IoU 0.6 of the
  exact wire, and without the native decoder the exact wire runs;
- ViPTTracker(host_preproc=True) matches the JAX host-crop tracker within
  0.05 px;
- the entry (python -m mmtrack_torch.eval.run_ope) runs in a process that
  cannot import jax, flax or mmtrack_tpu, and refuses what it cannot run.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cv2  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.eval import batched_ope as jax_batched_ope  # noqa: E402
from mmtrack_tpu.eval.datasets import EvalSequence as JaxEvalSequence  # noqa: E402
from mmtrack_tpu.models.vipt import ViPTrack as JaxViPTrack  # noqa: E402
from mmtrack_tpu.parallel.batched_eval import BatchedViPTTracker as JaxBatched  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTTracker as JaxTracker  # noqa: E402
from mmtrack_torch.data import native_io  # noqa: E402
from mmtrack_torch.data.composition import get_x_frame  # noqa: E402
from mmtrack_torch.eval import batched_ope  # noqa: E402
from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope  # noqa: E402
from mmtrack_torch.eval.datasets import EvalSequence, list_sequences, load_sequence  # noqa: E402
from mmtrack_torch.eval.metrics import iou_xywh  # noqa: E402
from mmtrack_torch.eval.ope import run_sequence  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.models.vipt import ViPTrack  # noqa: E402
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker  # noqa: E402
from mmtrack_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16,
            template_size=32, search_size=64, ce_loc=(1,), head_channel=16)
RT_ARGS = dict(template_size=32, search_size=64, stride=16, ce_loc=(1,), ce_keep_ratio=(0.7,))
PX = 0.05
H, W = 96, 128


@pytest.fixture(scope="module")
def tiny():
    """(jax model, flax params, port model) sharing the PRNGKey(7) weights."""
    jm = JaxViPTrack(**TINY)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6)),
                                       None, JaxRuntime(**RT_ARGS).ce_keep_lens))(
        jax.random.PRNGKey(7))
    port = ViPTrack(**TINY)
    port.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray, params["params"])))
    return jm, params, port


def _port(port):
    return lambda: BatchedViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS))


def _jax(jm, params):
    return lambda: JaxBatched(jm, params, JaxRuntime(**RT_ARGS))


def _synthetic(lengths=(5, 3)):
    """Port and JAX EvalSequences of in-memory frames, and their loaders."""
    seqs, jseqs, loaders = [], [], {}
    for i, n in enumerate(lengths):
        frames, gt = make_synthetic_sequence(n_frames=n, height=H, width=W, seed=i,
                                             box0=(30.0 + 5 * i, 20.0, 24.0, 20.0))
        seqs.append(EvalSequence(f"b{i}", [None] * n, [None] * n, gt))
        jseqs.append(JaxEvalSequence(f"b{i}", [None] * n, [None] * n, gt))
        loaders[f"b{i}"] = (lambda f: (lambda t: f[t]))(frames)
    return seqs, jseqs, loaders


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A DepthTrack-layout root of two sequences (5 and 3 frames)."""
    root = tmp_path_factory.mktemp("depthtrack")
    rng = np.random.RandomState(3)
    for i, n in enumerate((5, 3)):
        frames, gt = make_synthetic_sequence(n_frames=n, height=H, width=W, seed=10 + i,
                                             box0=(30.0 + 5 * i, 20.0, 24.0, 20.0))
        seq = root / f"seq{i}"
        (seq / "color").mkdir(parents=True)
        (seq / "depth").mkdir()
        base = rng.randint(500, 4000, (H, W)).astype(np.uint16)
        for t in range(n):
            cv2.imwrite(str(seq / "color" / f"{t:08d}.jpg"), frames[t][..., :3][..., ::-1])
            cv2.imwrite(str(seq / "depth" / f"{t:08d}.png"), (base + 7 * t).astype(np.uint16))
        np.savetxt(str(seq / "groundtruth.txt"), gt, delimiter=",")
    return str(root)


def _load(root, mod_load=load_sequence, mod_list=list_sequences):
    return [mod_load(d, "DepthTrack") for d in mod_list(root, "DepthTrack")]


def test_batched_ope_matches_jax_and_sequential(tiny, tmp_path):
    jm, params, port = tiny
    seqs, jseqs, loaders = _synthetic()
    assert len(batched_ope.bucket_sequences(seqs, loaders)) == 1
    out = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "p"), "DS", "cfg",
                                          batch_size=2, loaders=loaders, verbose=False)
    want = jax_batched_ope.run_dataset_batched(_jax(jm, params), jseqs, str(tmp_path / "j"),
                                               "DS", "cfg", batch_size=2, loaders=loaders,
                                               verbose=False)
    assert [r["boxes"].shape for r in out] == [(5, 4), (3, 4)]
    assert [r["wire"] for r in out] == ["frames", "frames"]
    for o, w in zip(out, want):
        np.testing.assert_allclose(o["boxes"], w["boxes"], atol=PX)
        np.testing.assert_allclose(o["confidences"], w["confidences"], atol=1e-4)
    for i, seq in enumerate(seqs):
        res = run_sequence(ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS)), seq,
                           frame_loader=loaders[seq.name])
        np.testing.assert_allclose(out[i]["boxes"], res["boxes"], atol=1e-3)
    assert batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "p"), "DS", "cfg",
                                           batch_size=2, loaders=loaders, verbose=False) == []


def test_rgb_index_wire_bit_equal_to_host_composed_frames(tiny, disk, tmp_path):
    _, _, port = tiny
    seqs = _load(disk)
    streamed = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "w2"),
                                               "DepthTrack", "cfg", batch_size=2,
                                               verbose=False)
    loaders = {s.name: (lambda s: lambda t: get_x_frame(s.rgb_frames[t], s.x_frames[t],
                                                        s.dtype, s.depth_clip))(s)
               for s in seqs}
    composed = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "w1"),
                                               "DepthTrack", "cfg", batch_size=2,
                                               loaders=loaders, verbose=False)
    assert [r["wire"] for r in streamed] == ["rgb_index"] * 2
    assert [r["wire"] for r in composed] == ["frames"] * 2
    for a, b in zip(streamed, composed):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["confidences"], b["confidences"])
    for seq in seqs:
        for suffix in (".txt", "_confidence.value"):
            rel = os.path.join("DepthTrack", "cfg", seq.name + suffix)
            assert open(tmp_path / "w2" / rel, "rb").read() == \
                open(tmp_path / "w1" / rel, "rb").read()


def test_streamed_stages_are_traced(tiny, disk, tmp_path):
    """Under the tracer each streamed step is one chunk: its upload,
    compose, tracking step and read; the waits for the decode thread are
    spans of their own."""
    _, _, port = tiny
    with profiling.tracing() as tr:
        batched_ope.run_dataset_batched(_port(port), _load(disk), str(tmp_path), "DepthTrack",
                                        "cfg", batch_size=2, verbose=False)
    spans = tr.snapshot()["spans"]
    steps = 4                                     # frames 1-4 of the longer sequence
    for name in ("ope.upload", "ope.compose", "vipt.step", "ope.read"):
        found = [s for s in spans if s["name"] == name]
        assert sorted(s["chunk"] for s in found) == list(range(steps)), name
    assert len([s for s in spans if s["name"] == "ope.decode_wait"]) == steps - 1


def test_rgb_index_wire_matches_jax(tiny, disk, tmp_path):
    jm, params, port = tiny
    from mmtrack_tpu.eval.datasets import list_sequences as jl, load_sequence as jload

    ours = batched_ope.run_dataset_batched(_port(port), _load(disk), str(tmp_path / "p"),
                                           "DepthTrack", "cfg", batch_size=2, verbose=False)
    theirs = jax_batched_ope.run_dataset_batched(_jax(jm, params), _load(disk, jload, jl),
                                                 str(tmp_path / "j"), "DepthTrack", "cfg",
                                                 batch_size=2, verbose=False)
    for o, w in zip(ours, theirs):
        np.testing.assert_allclose(o["boxes"], w["boxes"], atol=PX)
        np.testing.assert_allclose(o["confidences"], w["confidences"], atol=1e-4)


def _yuv_fixture(root):
    """One sequence of 4 frames at 96x128 (multiples of 16: 4:2:0 qualifies)."""
    return _load(root)[:1]


def test_yuv_wire_within_iou_of_the_exact_wire(tiny, disk, tmp_path, monkeypatch):
    _, _, port = tiny
    seqs = _yuv_fixture(disk)
    exact = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "r1"),
                                            "DepthTrack", "cfg", batch_size=1, verbose=False)
    monkeypatch.setenv("MMTRACK_STREAM", "yuv420")
    yuv = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "r2"),
                                          "DepthTrack", "cfg", batch_size=1, verbose=False)
    assert exact[0]["wire"] == "rgb_index" and yuv[0]["wire"] == "yuv420"
    assert yuv[0]["boxes"].shape == exact[0]["boxes"].shape
    ious = iou_xywh(exact[0]["boxes"][1:], yuv[0]["boxes"][1:])
    assert ious.min() > 0.6, ious


def test_yuv_wire_needs_the_native_decoder(tiny, disk, tmp_path, monkeypatch):
    """Asked for yuv420 on a machine without the native decoder, the batch
    takes the exact rgb + index wire on cv2 decode, bit-equal to it."""
    _, _, port = tiny
    seqs = _yuv_fixture(disk)
    exact = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "r1"),
                                            "DepthTrack", "cfg", batch_size=1, verbose=False)
    monkeypatch.setenv("MMTRACK_STREAM", "yuv420")
    monkeypatch.setattr(native_io, "load_imageio_lib", lambda: None)
    got = batched_ope.run_dataset_batched(_port(port), seqs, str(tmp_path / "r2"),
                                          "DepthTrack", "cfg", batch_size=1, verbose=False)
    assert got[0]["wire"] == "rgb_index"
    np.testing.assert_array_equal(got[0]["boxes"], exact[0]["boxes"])


def test_decode_errors_surface_at_join(tiny, disk, tmp_path):
    """A frame that cannot be read fails the run; no step sees stale planes."""
    _, _, port = tiny
    seqs = _load(disk)
    os.rename(seqs[0].rgb_frames[3], str(tmp_path / "moved.jpg"))
    try:
        with pytest.raises(IOError, match="could not read color frame"):
            batched_ope.run_batch(_port(port)(), seqs)
    finally:
        os.rename(str(tmp_path / "moved.jpg"), seqs[0].rgb_frames[3])


def test_host_crop_tracker_matches_jax(tiny):
    jm, params, port = tiny
    frames, gt = make_synthetic_sequence(n_frames=6, height=H, width=W, seed=11)
    ours = ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS), host_preproc=True)
    theirs = JaxTracker(jm, params, JaxRuntime(**RT_ARGS), host_preproc=True)
    device = ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS))
    for tr in (ours, theirs, device):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    for t in range(1, 6):
        o, w, d = (tr.track(frames[t]) for tr in (ours, theirs, device))
        np.testing.assert_allclose(o["target_bbox"], w["target_bbox"], atol=PX,
                                   err_msg=f"frame {t}")
        assert abs(o["best_score"] - w["best_score"]) <= 1e-4
        assert iou_xywh(np.asarray(o["target_bbox"]), np.asarray(d["target_bbox"])) > 0.5


BLOCKER = """
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmtrack_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
sys.argv = ["run_ope"] + sys.argv[1:]
runpy.run_module("mmtrack_torch.eval.run_ope", run_name="__main__")
"""

TINY_JSON = {"MODEL": {"BACKBONE": {"EMBED_DIM": 32, "DEPTH": 2, "NUM_HEADS": 2, "CE_LOC": [1],
                                    "CE_KEEP_RATIO": [0.7]}, "HEAD": {"NUM_CHANNELS": 16}},
             "DATA": {"TEMPLATE": {"SIZE": 32}, "SEARCH": {"SIZE": 64}},
             "TEST": {"TEMPLATE_SIZE": 32, "SEARCH_SIZE": 64}}


def test_entry_runs_without_jax(disk, tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_JSON))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MMTRACK_STREAM")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    results = tmp_path / "results"
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER, "--device", "cpu", "--config", str(cfg),
         "--dataset", "DepthTrack", "--dataset_root", disk, "--batched", "2", "--analyze",
         "--results_root", str(results)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert "decoder: native" in out and "wire: ['rgb_index']" in out
    seqs = _load(disk)
    run_dir = results / "DepthTrack" / "tiny"
    for s in seqs:
        for suffix in (".txt", "_time.value", "_confidence.value"):
            assert (run_dir / (s.name + suffix)).exists()
    report = json.loads((results / "DepthTrack" / "tiny_report.json").read_text())
    ope = analyze_ope(seqs, str(results), "DepthTrack", "tiny")["overall"]
    fs = analyze_fscore(seqs, str(results), "DepthTrack", "tiny")
    assert report["ope"] == {k: v for k, v in ope.items() if np.isscalar(v)}
    assert report["fscore"] == fs
    assert any(ln.startswith("tiny: SR ") for ln in out)


def test_entry_refuses_what_it_cannot_run(tmp_path):
    from mmtrack_torch.eval import run_ope

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_ope.main(["--dataset", "SYNTH", "--config", "deep_rgbd", "--synthetic"])
    with pytest.raises(SystemExit):
        run_ope.main(["--dataset", "SYNTH", "--tracker", "no_such_tracker", "--device", "cpu",
                      "--synthetic"])
    with pytest.raises(ValueError, match=r"\.pt file .* \.npz"):
        run_ope.load_checkpoint(str(tmp_path))


def test_entry_reads_both_checkpoint_formats(tiny, tmp_path):
    _, params, port = tiny
    from mmtrack_torch.eval.run_ope import load_checkpoint

    npz = tmp_path / "params.npz"
    np.savez(npz, params=jax.tree.map(np.asarray, params["params"]))
    pt = tmp_path / "epoch_0001.pt"
    torch.save({"epoch": 1, "model": port.state_dict()}, pt)
    want = port.state_dict()
    for got in (load_checkpoint(str(npz)), load_checkpoint(str(pt))):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
