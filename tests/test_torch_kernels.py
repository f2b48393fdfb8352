"""The port's kernel modules against the JAX package's Pallas kernels.

Each CUDA kernel of mmtrack_torch has a plain PyTorch version beside it,
which is what a CPU tensor runs. Here those plain versions are held
against the Pallas kernels run in interpret mode (as tests/test_flash_attn.py
and tests/test_golden.py run them), on the same numpy-seeded inputs:

  attn_block_fused / mlp_block_fused: f32 within 1e-5; bf16 within one bf16
    ulp of the largest |x|, |y - x| or |y| in the element's token row (the
    two frameworks sum in another f32 order, so a few bf16 roundings inside
    the block flip by one ulp; downstream that is an absolute error at the
    row's scale, which near-zero outputs see as many of their own ulps);
  crop_resize_normalized: within 1e-5 of the gather path, 2e-5 of the
    Pallas path, resize factors equal.

The kernels themselves run only on the card (chip_smoke.py); the tests at
the end pin the no-fallback rule on a machine without CUDA.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mmtrack_torch.ops.crop import crop_resize_normalized  # noqa: E402
from mmtrack_torch.ops.flash_attn import attn_block_fused  # noqa: E402
from mmtrack_torch.ops.mlp_fuse import mlp_block_fused  # noqa: E402
from mmtrack_torch.utils import profiling  # noqa: E402
from mmtrack_torch.utils.device import require_cuda  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
MEAN_6CH = np.array([0.485, 0.456, 0.406] * 2, np.float32)
STD_6CH = np.array([0.229, 0.224, 0.225] * 2, np.float32)


def bf16_ulp(v):
    v = np.maximum(np.abs(v), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_block_close(got, want, x, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    x = x.float().numpy()
    scale = np.max([np.abs(x), np.abs(got), np.abs(want), np.abs(want - x)], axis=0)
    scale = scale.max(-1, keepdims=True)
    excess = np.abs(got - want) - bf16_ulp(scale)
    assert excess.max() <= 0, f"{(excess > 0).sum()} elements beyond one bf16 ulp"


def _block_inputs(seed, B=2, L=37, C=64):
    r = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (r.randn(*s) * k).astype(np.float32)  # noqa: E731
    return dict(x=f(B, L, C, k=0.5), g=1 + f(C, k=0.1), b=f(C, k=0.1),
                w1=f(C, 3 * C, k=0.1), b1=f(3 * C, k=0.05),
                w2=f(C, C, k=0.1), b2=f(C, k=0.05),
                m1=f(C, 4 * C, k=0.1), c1=f(4 * C, k=0.05),
                m2=f(4 * C, C, k=0.05), c2=f(C, k=0.05))


def _t(a, dt=torch.float32, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)).to(dt)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attn_block_plain_matches_pallas(dtype, seed):
    from mmtrack_tpu.ops.flash_attn import attn_block_fused as pallas_attn

    tdt, jdt = DTYPES[dtype]
    p = _block_inputs(seed)
    H = 4
    scale = (p["x"].shape[-1] // H) ** -0.5
    want = pallas_attn(jnp.asarray(p["x"]).astype(jdt), jnp.asarray(p["g"]),
                       jnp.asarray(p["b"]), jnp.asarray(p["w1"]).astype(jdt),
                       jnp.asarray(p["b1"]), jnp.asarray(p["w2"]).astype(jdt),
                       jnp.asarray(p["b2"]), num_heads=H, scale=scale, interpret=True)
    x = _t(p["x"], tdt)
    before = profiling.counters()
    got = attn_block_fused(x, _t(p["g"]), _t(p["b"]), _t(p["w1"], tdt, True), _t(p["b1"]),
                           _t(p["w2"], tdt, True), _t(p["b2"]), num_heads=H, scale=scale)
    assert profiling.launches([attn_block_fused], before) == {"attn_block_fused": 0}  # CPU: none
    assert got.dtype == tdt and got.shape == x.shape
    assert_block_close(got, want, x, dtype)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_block_plain_matches_pallas(dtype, seed):
    from mmtrack_tpu.ops.mlp_fuse import mlp_block_fused as pallas_mlp

    tdt, jdt = DTYPES[dtype]
    p = _block_inputs(seed)
    want = pallas_mlp(jnp.asarray(p["x"]).astype(jdt), jnp.asarray(p["g"]),
                      jnp.asarray(p["b"]), jnp.asarray(p["m1"]).astype(jdt),
                      jnp.asarray(p["c1"]), jnp.asarray(p["m2"]).astype(jdt),
                      jnp.asarray(p["c2"]), interpret=True)
    x = _t(p["x"], tdt)
    before = profiling.counters()
    got = mlp_block_fused(x, _t(p["g"]), _t(p["b"]), _t(p["m1"], tdt, True), _t(p["c1"]),
                          _t(p["m2"], tdt, True), _t(p["c2"]))
    assert profiling.launches([mlp_block_fused], before) == {"mlp_block_fused": 0}
    assert got.dtype == tdt and got.shape == x.shape
    assert_block_close(got, want, x, dtype)


CROP_BOXES = np.array([[40.0, 30.0, 30.0, 20.0],      # inside
                       [-10.0, -5.0, 40.0, 30.0],     # across the top-left edge
                       [130.0, 95.0, 40.0, 30.0],     # across the bottom-right edge
                       [60.3, 44.7, 0.6, 0.4],        # tiny: crop side clamps to 1
                       [77.5, 51.5, 3.0, 5.0]],       # small, half-pixel origin
                      np.float32)


def _crop_frames(seed=1, B=len(CROP_BOXES), H=120, W=160):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 6)).astype(np.uint8)


@pytest.mark.parametrize("factor,size", [(4.0, 64), (2.0, 32)])
def test_crop_plain_matches_gather(factor, size):
    from mmtrack_tpu.ops.crop import crop_resize_normalized as jax_crop

    frames = _crop_frames()
    got, rf = crop_resize_normalized(torch.from_numpy(frames), torch.from_numpy(CROP_BOXES),
                                     factor, size, torch.from_numpy(MEAN_6CH),
                                     torch.from_numpy(STD_6CH))
    assert got.shape == (len(CROP_BOXES), size, size, 6) and got.dtype == torch.float32
    for i, box in enumerate(CROP_BOXES):
        want, rf_w = jax_crop(jnp.asarray(frames[i]), jnp.asarray(box), factor, size,
                              jnp.asarray(MEAN_6CH), jnp.asarray(STD_6CH))
        assert float(rf[i]) == float(rf_w)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_crop_plain_matches_pallas_interpret():
    from mmtrack_tpu.ops.pallas_preproc import crop_resize_normalize_pallas

    frames = _crop_frames(seed=4)
    got, rf = crop_resize_normalized(torch.from_numpy(frames), torch.from_numpy(CROP_BOXES),
                                     4.0, 64, torch.from_numpy(MEAN_6CH),
                                     torch.from_numpy(STD_6CH))
    for i, box in enumerate(CROP_BOXES):
        want, rf_w = crop_resize_normalize_pallas(
            jnp.asarray(frames[i]), jnp.asarray(box), 4.0, 64, jnp.asarray(MEAN_6CH),
            jnp.asarray(STD_6CH), interpret=True)
        assert float(rf[i]) == float(rf_w)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_require_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        require_cuda()


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a card,
    and when it is run outside a checkout of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
