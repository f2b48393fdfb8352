"""The MixFormer model of the port (MixFormer_RGBD, SAMF, ProMixTrack)
against the JAX package at f32, on bridged weights; its registry recipes
and entry. The trackers: tests/test_torch_mixformer_tracker.py.

JAX's small configuration (template 64, search 96, CvT dims 16/32/48,
depths 1/1/2, heads 1/2/3); the flax tree's leaves drawn from a numpy
seed at the shapes of its init and carried into the port through
mmtrack_torch.models.convert; inputs from numpy seeds. Bars: boxes within
1e-5, score logits within 1e-4, template and search features within 1e-5
on 3 and 6 channels with 1 and 3 online templates; the template features
exactly independent of the search; the ot_mask with garbage in the masked
slots equal to the forward with exactly n templates (n = 1, 2, 4) to
JAX's own bars (2e-6 boxes, 2e-5 logits); the ScoreDecoder alone within
1e-5; the port state_dict back to the JAX tree through JAX's
convert_mixformer_checkpoint; the three registry recipes with JAX's
names, modality, family, composition and runtime; `run_ope --tracker
promixtrack` without jax.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
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
from mmtrack_tpu.models import mixformer as jax_mf  # noqa: E402
from mmtrack_tpu.models.convert import convert_mixformer_checkpoint, load_into  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import mixformer_tracker as jax_mt  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.analysis import analyze_fscore, analyze_ope  # noqa: E402
from mmtrack_torch.eval.datasets import list_sequences, load_sequence  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import mixformer  # noqa: E402
from mmtrack_torch.models.convert import mixformer_state_dict_from_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MF_SMALL = dict(template_size=64, search_size=96, stage_dims=(16, 32, 48),
                stage_depths=(1, 1, 2), stage_heads=(1, 2, 3))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(rng, path, shape):
    """A seeded value for one flax leaf: LeCun-normal kernels, scales near
    1, positive variances, the score token at 0.02, small biases and
    means (so the bridge carries every kind of leaf with a value)."""
    name = path[-1].key
    if name == "kernel":
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "score_token":
        return 0.02 * rng.randn(*shape)
    return 0.1 * rng.randn(*shape)


def mixformer_models(C: int):
    """(jax model, flax params, port model) for C channels: the flax tree's
    shapes from jax.eval_shape of the init (no compile), values from a numpy
    seed, carried into the port by the bridge."""
    jm = jax_mf.MixFormer(in_channels=C, **MF_SMALL)
    z = jnp.zeros((1, 64, 64, C))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), z, z,
                                            jnp.zeros((1, 96, 96, C))))
    rng = np.random.RandomState(C)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    port = mixformer.MixFormer(in_channels=C, **MF_SMALL)
    port.load_state_dict(mixformer_state_dict_from_flax(params["params"]))
    return jm, params, port.eval()


@pytest.fixture(scope="module")
def models():
    return {C: mixformer_models(C) for C in (3, 6)}


def _inputs(C, K, seed=0, B=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 64, 64, C).astype(np.float32),
            rng.randn(B, K, 64, 64, C).astype(np.float32),
            rng.randn(B, 96, 96, C).astype(np.float32))


@pytest.mark.parametrize("C", [6, 3])
@pytest.mark.parametrize("K", [1, 3])
def test_mixformer_forward_matches_jax(models, C, K):
    jm, params, port = models[C]
    z, ot, x = _inputs(C, K)
    want = jax.jit(lambda p, *a: jm.apply(p, *a, return_features=True))(
        params, jnp.asarray(z), jnp.asarray(ot), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(ot), torch.from_numpy(x),
                   return_features=True)
    assert set(got) == set(want)
    bars = {"pred_boxes": 1e-5, "score_logits": 1e-4, "pred_scores": 1e-4,
            "template_feat": 1e-5, "search_feat": 1e-5}
    for k, bar in bars.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=bar,
                                   err_msg=k)


def test_mixformer_single_online_template_is_k1(models):
    """A 4-D online template is K = 1."""
    _, _, port = models[6]
    z, ot, x = (torch.from_numpy(a) for a in _inputs(6, 1, seed=3))
    with torch.no_grad():
        a, b = port(z, ot[:, 0], x), port(z, ot, x)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_mixformer_template_isolation(models):
    """Template and online-template queries attend template keys only, so
    the template features do not depend on the search at all."""
    _, _, port = models[3]
    z, ot, x1 = (torch.from_numpy(a) for a in _inputs(3, 2, seed=4, B=1))
    x2 = torch.from_numpy(np.random.RandomState(5).randn(1, 96, 96, 3).astype(np.float32))
    with torch.no_grad():
        t1 = port(z, ot, x1, run_score_head=False, return_features=True)["template_feat"]
        t2 = port(z, ot, x2, run_score_head=False, return_features=True)["template_feat"]
    assert torch.equal(t1, t2)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mixformer_ot_mask_equals_exact_templates(models, n):
    """Four slots with garbage in the masked ones equal the forward with
    exactly n templates."""
    _, _, port = models[3]
    rng = np.random.RandomState(1)
    z = rng.randn(1, 64, 64, 3).astype(np.float32)
    ots = rng.randn(1, 4, 64, 64, 3).astype(np.float32)
    x = rng.randn(1, 96, 96, 3).astype(np.float32)
    pad = np.concatenate([ots[:, :n], 13.0 * ots[:, n:] + 7.0], axis=1)
    mask = (np.arange(4) < n)[None]
    with torch.no_grad():
        exact = port(torch.from_numpy(z), torch.from_numpy(ots[:, :n]), torch.from_numpy(x))
        masked = port(torch.from_numpy(z), torch.from_numpy(pad), torch.from_numpy(x),
                      ot_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(masked["pred_boxes"].numpy(), exact["pred_boxes"].numpy(),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(masked["score_logits"].numpy(), exact["score_logits"].numpy(),
                               rtol=0, atol=2e-5)


def test_score_decoder_matches_jax(models):
    """The ScoreDecoder alone on given maps and a given box, including one
    that leaves the map."""
    _, params, port = models[6]
    rng = np.random.RandomState(2)
    s = rng.randn(3, 6, 6, 48).astype(np.float32)
    t = rng.randn(3, 4, 4, 48).astype(np.float32)
    box = np.array([[0.1, 0.2, 0.6, 0.7], [0.3, 0.25, 0.45, 0.9], [-0.1, 0.5, 1.2, 1.05]],
                   np.float32)
    want = jax.jit(jax_mf.ScoreDecoder(dim=48, heads=3).apply)(
        {"params": params["params"]["score_branch"]}, jnp.asarray(s), jnp.asarray(t),
        jnp.asarray(box))
    with torch.no_grad():
        got = port.score_branch(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(box))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [6, 3])
def test_mixformer_state_dict_goes_back_through_jax_converter(models, C):
    """Port names are the reference's: JAX's converter and a strict load_into
    rebuild the flax tree exactly."""
    _, params, port = models[C]
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, missing, unexpected = load_into(params["params"], convert_mixformer_checkpoint(sd),
                                          strict=True)
    assert not missing and not unexpected
    back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(params["params"])):
        np.testing.assert_array_equal(np.asarray(back[path]), leaf)


def test_mixformer_npz_loads_through_the_entry(models, tmp_path):
    _, params, port = models[6]
    path = str(tmp_path / "mixformer.npz")
    np.savez(path, params=np.asarray(_np_tree(params["params"]), dtype=object))
    fresh = mixformer.MixFormer(in_channels=6, **MF_SMALL)
    fresh.load_state_dict(load_checkpoint(path, "mixformer"))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


JAX_RUNTIMES = {  # mmtrack_tpu/registry.py:316-331, :360-373, :434-443
    "mixformer_rgbd": (6, jax_mt.MixFormerRuntime(scale_factors=(1.0,), online_size=3)),
    "samf": (6, jax_mt.MixFormerRuntime(scale_factors=(0.8, 1.0, 1.25), online_size=3)),
    "promixtrack": (3, jax_mt.MixFormerRuntime(online_size=3, re_constrain="none")),
}


@pytest.mark.parametrize("name", sorted(JAX_RUNTIMES))
def test_registry_mixformer_recipes_match_jax(monkeypatch, name):
    """Names, modality, family and composition as JAX's; the build gives the
    JAX recipe's runtime and channel count (on a narrow model here)."""
    r, j = registry.TRACKER_REGISTRY[name], JAX_REGISTRY[name]
    assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
    built = []

    def narrow(in_channels=6, device=None):
        built.append(in_channels)
        return mixformer.MixFormer(in_channels=in_channels, **MF_SMALL)

    monkeypatch.setattr(mixformer, "build_mixformer_rgbd", narrow)
    tracker = registry.build_tracker(name, device="cpu")
    channels, jrt = JAX_RUNTIMES[name]
    assert built == [channels]
    assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jrt)


BLOCKER = """
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "mmtrack_tpu"):
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
from mmtrack_torch.models import mixformer
# the recipe's crops (128 / 320) on a narrow CvT, so the CPU run is short
mixformer.build_mixformer_rgbd = lambda in_channels=6, device=None: mixformer.MixFormer(
    in_channels=in_channels, stage_dims=(16, 32, 48), stage_depths=(1, 1, 1),
    stage_heads=(1, 2, 3), head_channel=16)
sys.argv = ["run_ope"] + sys.argv[1:]
runpy.run_module("mmtrack_torch.eval.run_ope", run_name="__main__")
"""


def test_entry_runs_promixtrack_without_jax(tmp_path):
    """`run_ope --tracker promixtrack` on a 3-frame DepthTrack layout: the
    frames are composed rgbd_blend (3 channels) as the recipe asks; result
    files and a report equal to the analysis of those files."""
    root = tmp_path / "depthtrack"
    seq = root / "seq0"
    (seq / "color").mkdir(parents=True)
    (seq / "depth").mkdir()
    frames, gt = make_synthetic_sequence(n_frames=3, height=120, width=160, seed=5)
    base = np.random.RandomState(5).randint(500, 7000, (120, 160)).astype(np.uint16)
    for t in range(3):
        cv2.imwrite(str(seq / "color" / f"{t:08d}.jpg"), frames[t][..., :3][..., ::-1])
        cv2.imwrite(str(seq / "depth" / f"{t:08d}.png"), (base + 7 * t).astype(np.uint16))
    np.savetxt(str(seq / "groundtruth.txt"), gt, delimiter=",")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    results = tmp_path / "results"
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER, "--device", "cpu", "--tracker", "promixtrack",
         "--dataset", "DepthTrack", "--dataset_root", str(root), "--analyze",
         "--results_root", str(results)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    boxes = np.loadtxt(results / "DepthTrack" / "promixtrack" / "seq0.txt", delimiter=",")
    assert boxes.shape == (3, 4) and np.isfinite(boxes).all()
    seqs = [load_sequence(d, "DepthTrack") for d in list_sequences(str(root), "DepthTrack")]
    report = json.loads((results / "DepthTrack" / "promixtrack_report.json").read_text())
    ope = analyze_ope(seqs, str(results), "DepthTrack", "promixtrack")["overall"]
    assert report["ope"] == {k: v for k, v in ope.items() if np.isscalar(v)}
    assert report["fscore"] == analyze_fscore(seqs, str(results), "DepthTrack", "promixtrack")
