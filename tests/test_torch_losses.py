"""The port's box algebra, target heatmaps and training losses against the
JAX package at f32: values within 1e-6 (relative 1e-5 for the losses) and
gradients from autograd against jax.grad within 1e-5 relative, on
numpy-seeded boxes and score maps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.ops import box as jbox  # noqa: E402
from mmtrack_tpu.ops import heatmap as jheat  # noqa: E402
from mmtrack_tpu.ops import losses as jloss  # noqa: E402
from mmtrack_torch.ops import box, heatmap, losses  # noqa: E402

B = 16


def _boxes(seed, lo=0.1, hi=0.5):
    """(B, 4) normalised xywh boxes."""
    return np.random.RandomState(seed).uniform(lo, hi, (B, 4)).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["box_xywh_to_xyxy", "box_cxcywh_to_xyxy"])
def test_box_conversions_match_jax(name):
    b = _boxes(0)
    _close(getattr(box, name)(torch.from_numpy(b)), getattr(jbox, name)(jnp.asarray(b)),
           rtol=0, atol=0)


@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou"])
def test_iou_values_and_grads_match_jax(name):
    a = np.array(jbox.box_xywh_to_xyxy(jnp.asarray(_boxes(1))))
    b = np.array(jbox.box_xywh_to_xyxy(jnp.asarray(_boxes(2))))
    a[0] = b[0] + 0.6            # disjoint pair: IoU 0, GIoU negative

    def jf(x):
        out = getattr(jbox, name)(x, jnp.asarray(b))
        return (out[0] if isinstance(out, tuple) else out).sum()

    ta = torch.from_numpy(a).requires_grad_(True)
    out = getattr(box, name)(ta, torch.from_numpy(b))
    val = out[0] if isinstance(out, tuple) else out
    want = getattr(jbox, name)(jnp.asarray(a), jnp.asarray(b))
    _close(val, want[0] if isinstance(want, tuple) else want)
    val.sum().backward()
    _close(ta.grad, jax.grad(jf)(jnp.asarray(a)))


@pytest.mark.parametrize("S", [4, 16])
def test_heatmap_matches_jax(S):
    boxes = _boxes(3, 0.02, 0.6)
    boxes[0, 2:] = 0.001         # radius clamps to 0: a single peak
    got = heatmap.generate_heatmap(torch.from_numpy(boxes), S)
    want = jheat.generate_heatmap(jnp.asarray(boxes), S)
    assert got.shape == (B, S, S)
    _close(got, want, rtol=0, atol=1e-6)
    wh = torch.from_numpy(boxes[:, 2:] * S)
    _close(heatmap.gaussian_radius(wh), jheat.gaussian_radius(jnp.asarray(boxes[:, 2:] * S)),
           rtol=1e-6, atol=0)


def test_focal_loss_value_and_grad_match_jax():
    S = 16
    target = np.array(jheat.generate_heatmap(jnp.asarray(_boxes(4)), S))
    pred = np.random.RandomState(5).uniform(1e-4, 1 - 1e-4, (B, S, S)).astype(np.float32)
    tp = torch.from_numpy(pred).requires_grad_(True)
    loss = losses.focal_loss(tp, torch.from_numpy(target))
    _close(loss, jloss.focal_loss(jnp.asarray(pred), jnp.asarray(target)))
    loss.backward()
    g = jax.grad(lambda p: jloss.focal_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    _close(tp.grad, g, atol=1e-7)
    # no positives: the sum of the negative terms
    zero = np.zeros_like(target)
    _close(losses.focal_loss(torch.from_numpy(pred), torch.from_numpy(zero)),
           jloss.focal_loss(jnp.asarray(pred), jnp.asarray(zero)))


@pytest.mark.parametrize("name", ["giou_loss", "l1_loss"])
def test_box_losses_value_and_grad_match_jax(name):
    pred = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(6))))
    gt = np.clip(np.array(jbox.box_xywh_to_xyxy(jnp.asarray(_boxes(7)))), 0.0, 1.0)

    def first(v):
        return v[0] if isinstance(v, tuple) else v

    tp = torch.from_numpy(pred).requires_grad_(True)
    got = getattr(losses, name)(tp, torch.from_numpy(gt))
    want = getattr(jloss, name)(jnp.asarray(pred), jnp.asarray(gt))
    if isinstance(got, tuple):
        _close(got[1], want[1])          # mean IoU
    first(got).backward()
    _close(first(got), first(want))
    g = jax.grad(lambda p: first(getattr(jloss, name)(p, jnp.asarray(gt))))(jnp.asarray(pred))
    _close(tp.grad, g, atol=1e-7)
