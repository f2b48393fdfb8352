"""The port's Alpha-Refine slice against the JAX package's, at f32 on the CPU.

Weights come from flax init with random FrozenBatchNorm statistics (so the
bridge's scale/bias/mean/var mapping is exercised) and cross through
mmtrack_torch.models.convert.alpha_refine_state_dict_from_flax; inputs are
made from numpy seeds. Tolerances:

  * prroi_pool, with inverted and partly outside RoIs: 1e-5;
  * resnet18 up to layer2: 1e-4 of the largest |feature|;
  * CornerPredictor: 1e-5; the bilinear x2 upsampling against
    jax.image.resize: 1e-6;
  * AlphaRefineNet at input size 64: boxes within 1e-5, mask logits
    within 1e-4;
  * ARcmSeg.initialize + refine on a synthetic 96 x 128 sequence, the same
    input box on both sides (the paste-back rounds the crop origin to an
    integer): refined boxes within 1e-3 px, full-frame probabilities
    within 1e-4.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import alpha_refine as jax_ar  # noqa: E402
from mmtrack_tpu.models.heads import CornerPredictor as JaxCornerPredictor  # noqa: E402
from mmtrack_tpu.models.resnet import resnet18 as jax_resnet18  # noqa: E402
from mmtrack_tpu.ops.prroi import prroi_pool as jax_prroi_pool  # noqa: E402
from mmtrack_torch.models import alpha_refine  # noqa: E402
from mmtrack_torch.models.convert import (  # noqa: E402
    alpha_refine_state_dict_from_flax,
    load_flax_npz,
)
from mmtrack_torch.models.heads import CornerPredictor  # noqa: E402
from mmtrack_torch.models.resnet import resnet18  # noqa: E402
from mmtrack_torch.ops.prroi import prroi_pool  # noqa: E402


def _randomize_bn(tree, rng):
    """Random FrozenBatchNorm statistics (var > 0) in a flax params tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng)
        else:
            v = np.asarray(v)
            if k in ("scale", "mean", "var") or (k == "bias" and "var" in tree):
                lo, hi = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(k, (-0.2, 0.2))
                v = rng.uniform(lo, hi, v.shape).astype(np.float32)
            out[k] = v
    return out


def _sub_state_dict(prefix: str, tree: dict) -> dict:
    sd = alpha_refine_state_dict_from_flax({prefix: tree})
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def ar64():
    """(jax model, flax variables, port model) at input size 64."""
    jm = jax_ar.AlphaRefineNet(input_size=64)
    z = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(lambda r: jm.init(r, z, jnp.asarray([[16.0, 16.0, 32.0, 32.0]]), z))(
        jax.random.PRNGKey(0))
    tree = _randomize_bn(jax.tree.map(np.asarray, params["params"]), np.random.RandomState(9))
    port = alpha_refine.build_alpha_refine(64, state_dict=alpha_refine_state_dict_from_flax(tree))
    return jm, {"params": jax.tree.map(jnp.asarray, tree)}, port


def test_prroi_pool_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 9, 11, 5).astype(np.float32)
    rois = np.array([[0, 8.0, 10.0, 60.0, 50.0],       # inside
                     [1, -20.0, -12.0, 30.0, 28.0],    # partly outside, top-left
                     [0, 60.0, 50.0, 120.0, 90.0],     # partly outside, bottom-right
                     [1, 50.0, 40.0, 20.0, 60.0],      # inverted in x
                     [0, 50.0, 40.0, 20.0, 10.0],      # inverted in both
                     [1, 30.0, 30.0, 30.0, 45.0]],     # zero width
                    np.float32)
    for scale in (1 / 8, 1.0):
        got = prroi_pool(torch.from_numpy(feat), torch.from_numpy(rois), 3, 3, scale).numpy()
        want = np.asarray(jax_prroi_pool(jnp.asarray(feat), jnp.asarray(rois), 3, 3, scale))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[3:] == 0).all()   # inverted and zero-area RoIs pool to 0


def test_resnet18_layer2_matches_jax():
    jm = jax_resnet18()
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), ("layer2",))
    tree = _randomize_bn(jax.tree.map(np.asarray, variables["params"]), np.random.RandomState(2))
    layers = ("conv1", "layer1", "layer2")
    want = jm.apply({"params": tree}, jnp.asarray(x), layers)
    port = resnet18("layer2").eval()
    port.load_state_dict(_sub_state_dict("backbone", tree))
    with torch.no_grad():
        got = port(torch.from_numpy(x), layers)
    for k in layers:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape
        err = np.abs(got[k].numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())


def test_corner_predictor_matches_jax():
    jm = JaxCornerPredictor(channel=64, feat_sz=8, stride=8)
    x = np.random.RandomState(3).randn(2, 8, 8, 64).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tree = _randomize_bn(jax.tree.map(np.asarray, variables["params"]), np.random.RandomState(4))
    port = CornerPredictor(64, channel=64, feat_sz=8, stride=8).eval()
    port.load_state_dict(_sub_state_dict("corner_head", tree))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": tree}, jnp.asarray(x))),
                               rtol=0, atol=1e-5)


def test_bilinear_x2_matches_jax_resize():
    x = np.random.RandomState(5).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_alpha_refine_net_matches_jax(ar64):
    jm, variables, port = ar64
    rng = np.random.RandomState(6)
    t = rng.randn(2, 64, 64, 3).astype(np.float32)
    s = rng.randn(2, 64, 64, 3).astype(np.float32)
    boxes = np.array([[20.0, 22.0, 24.0, 18.0], [10.0, 12.0, 30.0, 28.0]], np.float32)
    jb, jmask = jm.apply(variables, jnp.asarray(t), jnp.asarray(boxes), jnp.asarray(s))
    with torch.no_grad():
        pb, pmask = port(torch.from_numpy(t), torch.from_numpy(boxes), torch.from_numpy(s))
    assert pmask.shape == (2, 64, 64)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pmask.numpy(), np.asarray(jmask), rtol=0, atol=1e-4)


def test_arcmseg_plugin_matches_jax(ar64):
    jm, variables, port = ar64
    frames, gt = make_synthetic_sequence(n_frames=4, height=96, width=128, seed=3)
    rgb = np.ascontiguousarray(frames[..., :3])
    jseg = jax_ar.ARcmSeg(jm, variables, jax_ar.ARRuntime(input_size=64))
    pseg = alpha_refine.ARcmSeg(port, "cpu", alpha_refine.ARRuntime(input_size=64))
    jseg.initialize(rgb[0].astype(np.float32), gt[0])
    pseg.initialize(rgb[0], gt[0])
    np.testing.assert_allclose(pseg.kernel.numpy(), np.asarray(jseg.kernel), rtol=0, atol=1e-5)
    for t in range(1, 4):
        box = gt[t] + np.array([1.5, -2.0, 3.0, -1.0])     # an imperfect tracker box
        jbox, jfull = jseg.refine(rgb[t].astype(np.float32), box)
        pbox, pfull = pseg.refine(rgb[t], box)
        assert pfull.shape == (96, 128) and pfull.dtype == np.float32
        np.testing.assert_allclose(np.asarray(pbox, np.float64), np.asarray(jbox, np.float64),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(pfull, jfull, rtol=0, atol=1e-4)


def test_alpha_refine_variables_file_loads(ar64, tmp_path):
    """The entry's MMTRACK_AR_CKPT file, np.savez of the flax variables,
    reads back to the same state_dict."""
    _, variables, port = ar64
    path = tmp_path / "ar.npz"
    np.savez(path, **jax.tree.map(np.asarray, variables))
    got = alpha_refine_state_dict_from_flax(load_flax_npz(str(path)))
    want = port.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
