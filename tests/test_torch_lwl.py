"""LWL in the port (models/lwl.py, trackers/lwl_tracker.py) against the JAX
package at f32 on the CPU.

The flax leaves are drawn from a numpy seed at the shapes of
jax.eval_shape of the init (the box encoder's from its own method), with
filter_reg at 0.05, and reach the port through
models/convert.py::lwl_state_dict_from_flax; the way back goes through
JAX's convert_lwl_checkpoint. The networks are build_lwl_paper's (16
filters of size 3, label encoder (16, 32, 64), decoder mdim 64) on 96 px
crops, and a narrow model with the box encoder (2 filters, encoder
(4, 8, 8), mdim 16).

JAX's module applies run jitted (a compile of a ResNet-50 at 96 px takes
a tenth of its eager dispatch here). Bars: the resizes within 1e-6 of
their largest magnitude, the shrinking bilinear against JAX's
antialiased resize (F.interpolate without
antialias is 1e-1 away); the label encoder, the box encoder, the target
model features, the decoder and the filter solve (20 Gauss-Newton steps
from zero, and 3 over a memory with sample weights) within 1e-5. The
geometry helpers exactly against JAX's jitted forms: the nearest mask
crop (its step a product with the f32 reciprocal of the crop size, as
XLA computes it), seg->box on dyadic maps (both sides' sums are exact; the size's sqrt
within one ulp)
and its gate, the paste, the mask's box (also empty), the memory update
over fills and replacements (the weights within 4 ulps, as DiMP's).

Free runs of 6 frames against JAX's jitted LWLTracker at memory 4 (the
updates fill it and the last one replaces a slot) with the default
schedule (20 steps at init, 3 per update): boxes within 0.05 px, the max
probability within 1e-4, the masks equal but for pixels whose JAX
probability is within 1e-4 of 0.5, the filter within 1e-5 after init and
after the first update. Seeded decoders give near-constant maps, so the
decoder's last conv is steered on purpose: scaled by 50 and biased to
the middle of its range ("partial": the masks are non-empty and the
min_mask_area gate passes, then the learner empties them) or biased to
-20 ("empty": every mask empty, the box (0, 0, 1, 1) and the gate keeps
the state). The box-encoder init (narrow model) is held against JAX's
jitted init.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import lwl as jl  # noqa: E402
from mmtrack_tpu.models.convert import convert_lwl_checkpoint  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import lwl_tracker as jlt  # noqa: E402
from mmtrack_torch import registry  # noqa: E402
from mmtrack_torch.eval.run_ope import load_checkpoint  # noqa: E402
from mmtrack_torch.models import lwl as pl  # noqa: E402
from mmtrack_torch.models.convert import lwl_state_dict_from_flax  # noqa: E402
from mmtrack_torch.trackers import lwl_tracker as plt  # noqa: E402
from test_torch_dimp import _leaf, close  # noqa: E402

PX, PROB = 0.05, 1e-4
NARROW = dict(num_filters=2, label_encoder_dims=(4, 8, 8), decoder_mdim=16, optim_iter=2,
              use_box_encoder=True, box_label_encoder_dims=(8, 4))
RT_KW = dict(image_sample_size=96, sample_memory_size=4)
S = 96


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def japply(jm, method: str, *args, static=()):
    """JAX's model.apply(*args, method=method), jitted: one compile of a
    ResNet-50 here costs a tenth of its eager op-by-op dispatch."""
    return jax.jit(partial(jm.apply, method=method), static_argnums=static)(*args)


def lwl_tree(jm, box_encoder: bool, seed: int = 0) -> dict:
    im, m = jnp.zeros((1, S, S, 3)), jnp.zeros((1, S, S))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), im, im, m))
    if box_encoder:
        g = S // 16
        bf = {f"layer{i}": jnp.zeros((1, S // 2 ** (i + 1), S // 2 ** (i + 1), 128 * 2 ** i))
              for i in range(1, 5)}
        sb = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)),
                                            jnp.zeros((1, g, g, 512)), bf, (S, S),
                                            method="mask_from_box"))
        shapes["params"]["box_label_encoder"] = sb["params"]["box_label_encoder"]
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_leaf(rng, path, s.shape), np.float32), shapes)
    tree["params"]["filter_reg"] = np.full((1,), 0.05, np.float32)
    return tree


@pytest.fixture(scope="module")
def paper():
    jm = jl.build_lwl_paper()
    tree = lwl_tree(jm, False)
    port = pl.build_lwl_paper()
    port.load_state_dict(lwl_state_dict_from_flax(tree["params"]))
    return jm, tree, port.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def narrow():
    jm = jl.build_lwl(**NARROW)
    tree = lwl_tree(jm, True, seed=1)
    port = pl.build_lwl(**NARROW)
    port.load_state_dict(lwl_state_dict_from_flax(tree["params"]))
    return jm, tree, port.eval().requires_grad_(False)


# ---------------------------------------------------------------- resizes

@pytest.mark.parametrize("shape", [(12, 12, 24, 24), (24, 24, 96, 96), (7, 9, 13, 20),
                                   (30, 30, 30, 30)])
def test_resize_bicubic_matches_jax(shape):
    h, w, oh, ow = shape
    x = np.random.RandomState(h * w).randn(2, h, w, 5).astype(np.float32)
    want = jax.jit(partial(jl.resize_bicubic, out_hw=(oh, ow)))(x)
    got = pl.resize_bicubic(T(x).permute(0, 3, 1, 2), (oh, ow)).permute(0, 2, 3, 1)
    close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("case", ["grow", "shrink", "box_shrink"])
def test_interpolate_matches_jax(case):
    """Growing (24 -> 96) either way; shrinking (the decoder's 30 -> 15
    onto layer4, the box encoder's 480 -> 30) only with antialias, as JAX's
    resize does it: without, F.interpolate is 1e-1 of the range away."""
    h, o = {"grow": (24, 96), "shrink": (30, 15), "box_shrink": (480, 30)}[case]
    x = np.random.RandomState(h).randn(1, h, h, 3).astype(np.float32)
    want = np.asarray(jl.interpolate(jnp.asarray(x), (o, o)))
    got = pl.interpolate(T(x).permute(0, 3, 1, 2), (o, o)).permute(0, 2, 3, 1).numpy()
    close(got, want, 1e-6)
    plain = F.interpolate(T(x).permute(0, 3, 1, 2), (o, o), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    err = np.abs(plain - want).max() / np.abs(want).max()
    assert (err > 1e-1) if case != "grow" else (err < 1e-6)


# ---------------------------------------------------------------- modules

@pytest.fixture(scope="module")
def features(paper):
    jm, tree, port = paper
    x = np.random.RandomState(2).randn(2, S, S, 3).astype(np.float32)
    bj = japply(jm, "extract_backbone", tree, x)
    with torch.no_grad():
        bp = port.extract_backbone(T(x))
    return bj, bp


def test_backbone_and_target_model_features_match_jax(paper, features):
    jm, tree, port = paper
    bj, bp = features
    for k in bj:
        close(bp[k].numpy(), bj[k], 1e-5)
    fj = japply(jm, "extract_target_model_features", tree, bj)
    with torch.no_grad():
        close(port.extract_target_model_features(bp).numpy(), fj, 1e-5)


@pytest.mark.parametrize("which", ["paper", "narrow"])
def test_label_encoder_matches_jax(paper, narrow, which):
    jm, tree, port = paper if which == "paper" else narrow
    rng = np.random.RandomState(3)
    masks = np.stack([(rng.rand(S, S) > 0.5), np.zeros((S, S)), np.ones((S, S))]).astype(
        np.float32)
    lj, sj = japply(jm, "encode_labels", tree, masks)
    with torch.no_grad():
        lp, sp = port.encode_labels(T(masks))
    close(lp.numpy(), lj, 1e-5)
    close(sp.numpy(), sj, 1e-5)


def test_filter_solve_matches_jax(paper, features):
    """get_filter's 20 GN steps from zero (the init), then 3 over a memory
    of four samples with their weights (an update), 16 filters of 3 x 3."""
    jm, tree, port = paper
    bj, bp = features
    rng = np.random.RandomState(4)
    masks = (rng.rand(2, S, S) > 0.6).astype(np.float32)
    fj = japply(jm, "extract_target_model_features", tree, bj)
    lj, sj = japply(jm, "encode_labels", tree, masks)
    filt_j = japply(jm, "get_filter", tree, fj[:1], lj[:1], sj[:1], None, 20, static=(4, 5))
    with torch.no_grad():
        fp = port.extract_target_model_features(bp)
        lp, sp = port.encode_labels(T(masks))
        filt_p = port.get_filter(fp[:1], lp[:1], sp[:1], None, 20)
    assert tuple(filt_p.shape) == (16, 3, 3, 512)
    close(filt_p.numpy(), filt_j, 1e-5)
    mem_f = np.concatenate([np.asarray(fj)] * 2)
    mem_l, mem_s = np.concatenate([np.asarray(lj)] * 2), np.concatenate([np.asarray(sj)] * 2)
    w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    upd_j = japply(jm, "optimize_filter", tree, filt_j, mem_f, mem_l, mem_s, w, 3,
                   static=(6,))
    upd_jm = japply(jm, "optimize_filter", tree, filt_j, mem_f, mem_l, mem_s, w, jnp.asarray(3),
                    3, static=(7,))
    with torch.no_grad():
        upd_p = port.optimize_filter(T(np.asarray(filt_j)), T(mem_f), T(mem_l), T(mem_s), T(w), 3)
    close(upd_p.numpy(), upd_j, 1e-5)
    close(upd_p.numpy(), upd_jm, 1e-5)


@pytest.mark.parametrize("which", ["paper", "narrow"])
def test_segment_matches_jax(paper, narrow, features, which):
    jm, tree, port = paper if which == "paper" else narrow
    bj, bp = features
    nf, fs = port.num_filters, port.filter_size
    filt = (np.random.RandomState(5).randn(nf, fs, fs, 512) * 0.05).astype(np.float32)
    fj = japply(jm, "extract_target_model_features", tree, bj)
    want = japply(jm, "segment", tree, filt, fj, bj, (S, S), static=(4,))
    with torch.no_grad():
        fp = port.extract_target_model_features(bp)
        got = port.segment(T(filt), fp, bp, (S, S))
    close(got.numpy(), want, 1e-5)


def test_box_encoder_matches_jax(narrow, features):
    jm, tree, port = narrow
    bj, bp = features
    bb = np.array([[20.3, 30.7, 40.2, 25.9], [5.0, 8.9, 60.5, 70.1]], np.float32)
    fj = japply(jm, "extract_target_model_features", tree, bj)
    want = japply(jm, "mask_from_box", tree, bb, fj, bj, (S, S), static=(4,))
    with torch.no_grad():
        got = port.mask_from_box(T(bb), port.extract_target_model_features(bp), bp, (S, S))
    close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------- the bridge

def test_lwl_bridge_round_trip(paper, narrow):
    """The port's state_dict through JAX's convert_lwl_checkpoint gives the
    flax tree exactly (the converter does not read the box encoder)."""
    for jm, tree, port in (paper, narrow):
        back = convert_lwl_checkpoint(port.state_dict())
        want = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert set(got) == {p for p in want if "box_label_encoder" not in jax.tree_util.keystr(p)}
        for path, v in got.items():
            np.testing.assert_array_equal(np.asarray(v), want[path], err_msg=str(path))


def test_lwl_npz_loads_through_the_entry(paper, tmp_path):
    jm, tree, port = paper
    path = str(tmp_path / "lwl.npz")
    np.savez(path, params=np.asarray(tree["params"], dtype=object))
    sd = load_checkpoint(path, "lwl")
    built = registry.build_tracker("lwl", params=sd, device="cpu")
    want = port.state_dict()
    assert set(built.model.state_dict()) == set(want)
    for k, v in built.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_lwl_recipe_matches_jax():
    r, j = registry.TRACKER_REGISTRY["lwl"], JAX_REGISTRY["lwl"]
    assert (r.modality, r.family, r.composition) == (j.modality, j.family, j.composition)
    tracker = registry.build_tracker("lwl", device="cpu")
    assert dataclasses.asdict(tracker.rt) == dataclasses.asdict(jlt.LWLRuntime())
    m = tracker.model
    assert (m.filter_size, m.num_filters, m.optim_iter) == (3, 16, 5)
    assert float(m.filter_reg) == pytest.approx(0.01)
    enc = m.label_encoder.samp_w_pred
    assert torch.equal(enc.weight, torch.zeros_like(enc.weight))
    assert torch.equal(enc.bias, torch.ones_like(enc.bias))
    again = registry.build_tracker("lwl", device="cpu").model.state_dict()
    for k, v in m.state_dict().items():
        assert torch.equal(v, again[k]), k


# ---------------------------------------------------------------- geometry

def test_crop_mask_nearest_matches_jitted_jax():
    rng = np.random.RandomState(6)
    img = (rng.rand(70, 90) > 0.5).astype(np.float32)
    fn = jax.jit(partial(jlt._crop_mask_nearest, out_sz=S))
    for tl, szl in (((-13, 40), 151), ((5, -7), 97), ((30, 50), 480), ((0, 0), 2), ((60, 80), 95),
                    ((-40, -40), 361)):
        tl = np.asarray(tl, np.float32)
        want = np.asarray(fn(img, tl, np.float32(szl)))
        got = plt._crop_mask_nearest(T(img), T(tl), T(szl), S).numpy()
        np.testing.assert_array_equal(got, want)


def _dyadic_map(H, W, y0, x0, h, w):
    m = np.zeros((H, W), np.float32)
    m[y0 - 2:y0 + h + 2, x0 - 2:x0 + w + 2] = 0.5
    m[y0:y0 + h, x0:x0 + w] = 1.0
    return m


def test_seg_to_box_and_gate_match_jitted_jax():
    rt_p, rt_j = plt.LWLRuntime(**RT_KW), jlt.LWLRuntime(**RT_KW)
    pos0, sz0 = np.array([10.0, 11.0], np.float32), np.array([5.0, 6.0], np.float32)
    fn = jax.jit(partial(jlt._seg_to_box, rt_j))
    maps = [_dyadic_map(60, 80, 20, 30, 16, 12), _dyadic_map(60, 80, 3, 5, 4, 6),
            np.zeros((60, 80), np.float32)]
    maps[2][3, 3] = 1.0        # below min_mask_area: the state kept
    for m in maps:
        wp, ws = fn(m, pos0, sz0)
        gp, gs = plt._seg_to_box(rt_p, T(m), T(pos0), T(sz0))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        # the size's sqrt: PyTorch's vectorised CPU sqrt is off by one ulp at
        # near-ties, where JAX's (and CUDA's) rounds correctly
        np.testing.assert_array_max_ulp(gs.numpy(), np.asarray(ws), maxulp=1)
    np.testing.assert_array_equal(gp.numpy(), pos0)


def test_paste_scores_matches_jitted_jax():
    rt_p, rt_j = plt.LWLRuntime(image_sample_size=32), jlt.LWLRuntime(image_sample_size=32)
    scores = np.random.RandomState(7).randn(32, 32).astype(np.float32)
    fn = jax.jit(partial(jlt._paste_scores, rt_j, im_hw=(70, 90)))
    for pos, scale in (((30.0, 42.0), 1.375), ((5.5, 80.0), 2.25), ((60.0, 10.0), 0.8125)):
        pos, scale = np.asarray(pos, np.float32), np.float32(scale)
        want = np.asarray(fn(scores, pos, scale))
        got = plt._paste_scores(rt_p, T(scores), T(pos), T(scale), (70, 90)).numpy()
        np.testing.assert_array_equal(got == -100.0, want == -100.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mask_to_box_matches_jitted_jax():
    fn = jax.jit(jlt._mask_to_box)
    for sl in ((slice(5, 9), slice(10, 17)), (slice(0, 1), slice(29, 30)), (slice(0), slice(0))):
        m = np.zeros((20, 30), bool)
        m[sl] = True
        np.testing.assert_array_equal(plt._mask_to_box(torch.from_numpy(m)).numpy(),
                                      np.asarray(fn(m)))
    assert plt._mask_to_box(torch.from_numpy(m)).tolist() == [0.0, 0.0, 1.0, 1.0]  # empty


def test_update_memory_matches_jitted_jax():
    """Six updates from JAX's state into a memory of 4: the fill, then
    replacements of the least weight (slot 0 protected); the slot, counts
    and memory exact, the weights within 4 ulps."""
    M = 4
    rt_p, rt_j = plt.LWLRuntime(sample_memory_size=M), jlt.LWLRuntime(sample_memory_size=M)
    fn = jax.jit(partial(jlt._update_memory, rt_j), static_argnums=(3,))   # lr: a constant
    rng = np.random.RandomState(8)
    js = {"memory_feat": jnp.zeros((M, 2, 2, 3)), "memory_masks": jnp.zeros((M, 4, 4)),
          "sample_weights": jnp.zeros((M,)).at[0].set(1.0),
          "num_stored": jnp.asarray(1, jnp.int32), "prev_replace_ind": jnp.asarray(-1, jnp.int32)}
    ps = {"memory_feat": torch.zeros((M, 2, 2, 3)), "memory_masks": torch.zeros((M, 4, 4)),
          "memory_label": torch.zeros((M, 1)), "memory_sw": torch.zeros((M, 1)),
          "sample_weights": T([1.0, 0.0, 0.0, 0.0]), "num_stored": 1, "updates": 0,
          "prev_replace_ind": torch.full((1,), -1)}
    for t in range(6):
        feat = rng.randn(2, 2, 3).astype(np.float32)
        mask = rng.rand(4, 4).astype(np.float32)
        lr = 0.1 if t != 3 else 0.3
        js = fn(js, feat, mask, lr)
        ps = plt._update_memory(rt_p, ps, T(feat), T(mask), torch.zeros(1), torch.zeros(1), lr)
        assert int(ps["prev_replace_ind"]) == int(js["prev_replace_ind"]) and \
            ps["num_stored"] == int(js["num_stored"])
        np.testing.assert_array_equal(ps["memory_feat"].numpy(), np.asarray(js["memory_feat"]))
        np.testing.assert_array_equal(ps["memory_masks"].numpy(),
                                      np.asarray(js["memory_masks"]))
        np.testing.assert_array_max_ulp(ps["sample_weights"].numpy(),
                                        np.asarray(js["sample_weights"]), maxulp=4)
        ps["sample_weights"] = T(np.asarray(js["sample_weights"]))
    assert ps["num_stored"] == M and int(ps["prev_replace_ind"]) != 0


# ---------------------------------------------------------------- free runs

STEER = {"partial": (50.0, None), "empty": (1.0, -20.0)}   # (kernel scale, bias)


def steered(tree: dict, how: str) -> dict:
    """The tree with the decoder's last conv steered (module docstring):
    'partial' scales its kernel by 50 and biases it to -28.2, inside the
    range of the scaled first frame's raw scores; 'empty' biases it to -20."""
    scale, bias = STEER[how]
    tree = jax.tree.map(lambda a: a, tree)
    conv = dict(tree["params"]["decoder"]["project_conv2"])
    conv["kernel"] = conv["kernel"] * np.float32(scale)
    conv["bias"] = np.full((1,), -28.2 if bias is None else bias, np.float32)
    tree["params"]["decoder"] = {**tree["params"]["decoder"], "project_conv2": conv}
    return tree


@pytest.fixture(scope="module")
def jax_tracker(paper):
    jm, tree, _ = paper
    frames, gt = make_synthetic_sequence(n_frames=7, height=120, width=160, seed=3)
    return jlt.LWLTracker(jm, tree, jlt.LWLRuntime(**RT_KW)), frames, gt


def _ellipse(gt0, H, W):
    x, y, w, h = gt0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return ((((yy - (y + h / 2)) / (h / 2)) ** 2 + ((xx - (x + w / 2)) / (w / 2)) ** 2)
            <= 1.0).astype(np.float32)


@pytest.mark.parametrize("init,how", [("box", "partial"), ("mask", "partial"),
                                      ("mask", "empty")])
def test_free_run_matches_jax(paper, jax_tracker, init, how):
    jm, tree, _ = paper
    jt, frames, gt = jax_tracker
    tree = steered(tree, how)
    jt.params = tree
    port = pl.build_lwl_paper()
    port.load_state_dict(lwl_state_dict_from_flax(tree["params"]))
    pt = plt.LWLTracker(port, "cpu", plt.LWLRuntime(**RT_KW))
    info = {"init_bbox": gt[0].tolist()}
    if init == "mask":
        info["init_mask"] = _ellipse(gt[0], *frames.shape[1:3])
    jt.initialize(frames[0], info)
    pt.initialize(frames[0], info)
    close(pt.state["filter"].numpy(), jt.state["filter"], 1e-5)
    np.testing.assert_array_equal(pt.state["seg_prob_im"].numpy(),
                                  np.asarray(jt.state["seg_prob_im"]))
    nonempty = 0
    for t, f in enumerate(frames[1:]):
        a, b = jt.track(f), pt.track(f)
        assert np.abs(np.subtract(a["target_bbox"], b["target_bbox"])).max() <= PX, t
        assert abs(a["best_score"] - b["best_score"]) <= PROB, t
        pj = np.asarray(jt.state["seg_prob_im"])
        np.testing.assert_allclose(pt.state["seg_prob_im"].numpy(), pj, rtol=0, atol=PROB)
        assert b["segmentation"].dtype == bool and b["segmentation"].shape == f.shape[:2]
        flipped = a["segmentation"] != b["segmentation"]
        assert (np.abs(pj[flipped] - 0.5) <= PROB).all(), t
        if t == 1:   # the first update (frame_num 3)
            close(pt.state["filter"].numpy(), jt.state["filter"], 1e-5)
        assert pt.state["num_stored"] == int(jt.state["num_stored"])
        nonempty += int(a["segmentation"].any())
    assert pt.updates == 5 and pt.optimizer_iters == 15 and pt.state["num_stored"] == 4
    assert int(pt.state["prev_replace_ind"]) == int(jt.state["prev_replace_ind"])
    if how == "partial":
        assert nonempty >= 1
    else:
        assert nonempty == 0 and b["target_bbox"] == [0.0, 0.0, 1.0, 1.0]


def test_box_encoder_init_matches_jitted_jax(narrow):
    """Box-only init with the learned box encoder: the raw logits as the
    first 'previous segmentation', the mask from their sigmoid, the filter
    from it; then one step."""
    jm, tree, port = narrow
    frames, gt = make_synthetic_sequence(n_frames=2, height=120, width=160, seed=5)
    rt = dict(RT_KW, net_opt_iter=3)
    jt = jlt.LWLTracker(jm, tree, jlt.LWLRuntime(**rt))
    pt = plt.LWLTracker(port, "cpu", plt.LWLRuntime(**rt))
    for tr in (jt, pt):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    close(pt.state["seg_prob_im"].numpy(), jt.state["seg_prob_im"], 1e-5)
    close(pt.state["filter"].numpy(), jt.state["filter"], 1e-5)
    a, b = jt.track(frames[1]), pt.track(frames[1])
    assert np.abs(np.subtract(a["target_bbox"], b["target_bbox"])).max() <= PX
    assert abs(a["best_score"] - b["best_score"]) <= PROB



@pytest.mark.parametrize("name", ["lwl", "stm"])
def test_mask_recipes_ask_for_the_card_by_default(name):
    """The builders default to device 'cuda': without a card the build
    fails rather than fall back to the CPU."""
    import inspect

    build = registry.TRACKER_REGISTRY[name].build
    assert inspect.signature(build).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            registry.build_tracker(name)
