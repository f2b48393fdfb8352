"""The MDNet protocol of the port (trackers/mdnet_tracker.py) against the
JAX package's on the CPU, at the reduced runtime of tests/test_mdnet.py
(64 / 128 init samples, 3 / 2 iterations, batches 8 / 16 / 64, rings of 6
and 3, long_interval 2), on bridged seeded weights (test_torch_mdnet.py).

The port draws JAX's numbers through `JaxDraws`, a draw source that
follows JAX's keys (the init's split into 8, the step's into 5, the SGD
iteration's into 5, the samplers' splits, the fold_in(6) dropout).
Bars: the samplers given JAX's draws equal to JAX's eager functions up
to one ulp of each box's largest coordinate (XLA's CPU pow differs from
every libm's in the last ulp on ~0.5% of inputs, and the scale and
aspect jitters are powers; the whole grid without them exactly); the crop
within 1e-3 on the 0..255 scale; _sample_filtered, the bbreg transforms
and _ridge_fit within 1e-4; _fc_train with given indices and no dropout,
for each of the three losses, the fc leaves within 1e-5 relative and the
mined negatives equal at every iteration; the injected-crop protocol
(*_from_patches) of pymdnet, manet and pyvital (JAX's G init, given drop
masks, the G steps) over 6 frames that hold long-term updates and forced
failures: boxes within 0.05 px (tools/parity/freerun.py::compare_freerun),
scores within 1e-4 of max(1, |score|) (seeded logits reach ~100), success,
the update, the top-5 indices and trans_f equal frame by frame, G's leaves
within 1e-4 of their largest magnitude; a free run of pymdnet's
MDNetTracker with JaxDraws: boxes within 0.05 px and the same success on
every frame.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import mdnet as jmd  # noqa: E402
from mmtrack_tpu.models import vital as jvital  # noqa: E402
from mmtrack_tpu.registry import TRACKER_REGISTRY as JAX_REGISTRY  # noqa: E402
from mmtrack_tpu.trackers import mdnet_tracker as jmt  # noqa: E402
from mmtrack_torch.models.convert import _hwc_rows_to_chw, gnet_state_dict_from_flax  # noqa: E402
from mmtrack_torch.models.vital import GNet  # noqa: E402
from mmtrack_torch.trackers import mdnet_tracker as mt  # noqa: E402
from test_torch_mdnet import chw, flax_tree, port_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools", "parity"))
from freerun import compare_freerun  # noqa: E402

SMALL = dict(n_init_pos=64, n_init_neg=128, init_iters=3, update_iters=2, batch_test=64,
             n_samples=64, batch_pos=8, batch_neg=16, batch_neg_cand=64, n_pos_update=8,
             n_neg_update=16, n_frames_long=6, n_frames_short=3, n_bbreg=32, long_interval=2)
PX = 0.05
SCORE_BAR = 1e-4
IMG_HW = (120, 160)
BOX0 = np.array([50.0, 40.0, 30.0, 24.0], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


class JaxDraws:
    """The port's draw source with JAX's keys and JAX's own draws."""

    def __init__(self, seed=0):
        self.seed = seed

    def key(self):
        return jax.random.PRNGKey(self.seed)

    def split(self, key, n=2):
        return list(jax.random.split(key, n))

    def fold_in(self, key, data):
        return jax.random.fold_in(key, data)

    def normal(self, key, shape):
        return T(jax.random.normal(key, shape))

    def uniform(self, key, shape):
        return T(jax.random.uniform(key, shape))

    def randint(self, key, shape, n):
        return T(jax.random.randint(key, shape, 0, n)).long()

    def permutation(self, key, n):
        return T(jax.random.permutation(key, n)).long()

    def bernoulli(self, key, p, shape):
        return T(jax.random.bernoulli(key, p, shape))

    def choice(self, key, p, shape):
        return T(_choice(len(p), tuple(shape))(key, jnp.asarray(p))).long()


@functools.lru_cache(maxsize=None)
def _choice(n, shape):
    """jax.random.choice with weights, jitted once per population and shape."""
    return jax.jit(lambda key, p: jax.random.choice(key, n, shape, p=p))


def jax_runtime(name: str, **kw):
    """The JAX recipe's runtime (its build given weights compiles nothing) at
    the reduced sizes."""
    return dataclasses.replace(JAX_REGISTRY[name].build(params={}).rt, **SMALL, **kw)


def port_runtime(jrt):
    return mt.MDNetRuntime(**dataclasses.asdict(jrt))


@pytest.fixture(scope="module")
def dual():
    jm = jmd.MDNet(mode="dual")
    params = flax_tree(jm, seed=3)
    return jm, params, port_model("dual", params)


# ---------------------------------------------------------------- pieces

def test_samplers_match_jax_draws():
    d = JaxDraws()
    box = np.array([50.3, 40.1, 20.7, 16.2], np.float32)
    jb, tb = jnp.asarray(box), T(box)
    key = jax.random.PRNGKey(3)
    pairs = [
        (jmt._gaussian_boxes(key, jb, 200, 0.6, 1.05, IMG_HW),
         mt._gaussian_boxes(tb, 0.6, 1.05, IMG_HW, mt.gaussian_draws(d, key, 200))),
        (jmt._uniform_boxes(key, jb, 200, 2.0, 1.3, IMG_HW),
         mt._uniform_boxes(tb, 2.0, 1.3, IMG_HW, mt.uniform_draws(d, key, 200))),
        (jmt._uniform_boxes(key, jb, 200, 0.3, 1.6, IMG_HW, aspect=1.1),
         mt._uniform_boxes(tb, 0.3, 1.6, IMG_HW, mt.uniform_draws(d, key, 200, 1.1), 1.1)),
        (jmt._whole_boxes(key, jb, 200, 1.0, IMG_HW),
         mt._whole_boxes(tb, 1.0, IMG_HW, mt.whole_draws(d, key, 200))),
        (jmt._whole_boxes(key, jb, 200, 1.3, IMG_HW),
         mt._whole_boxes(tb, 1.3, IMG_HW, mt.whole_draws(d, key, 200)))]
    for want, got in pairs:
        want = np.asarray(want)
        assert (np.abs(got.numpy() - want) <= np.spacing(np.abs(want).max(1, keepdims=True))).all()
    np.testing.assert_array_equal(pairs[3][1].numpy(), np.asarray(pairs[3][0]))


def test_crop_matches_jax():
    rt = jmt.MDNetRuntime()
    frame = np.random.RandomState(0).randint(0, 256, IMG_HW + (6,)).astype(np.uint8)
    boxes = np.array([[40.0, 30.0, 36.0, 22.0], [-5.0, 100.0, 50.0, 40.0],
                      [130.0, 90.0, 60.0, 55.0], [10.0, 5.0, 15.0, 80.0],
                      [0.3, 0.7, 159.0, 119.0]], np.float32)
    got = mt._crop_image2_dev(mt.MDNetRuntime(), T(frame).float(), T(boxes))
    for b, g in zip(boxes, got):
        want = np.asarray(jmt._crop_image2_dev(rt, jnp.asarray(frame), jnp.asarray(b)))
        assert np.abs(g.permute(1, 2, 0).numpy() - want).max() <= 1e-3


def test_sample_filtered_bbreg_and_ridge_match_jax():
    d = JaxDraws()
    gt = np.array([50.0, 40.0, 20.0, 16.0], np.float32)
    key = jax.random.PRNGKey(1)
    for kind, (trans, scale), rng_ in (("gaussian", (0.1, 1.2), (0.7, 1.0)),
                                       ("uniform", (1.0, 1.6), (0.0, 0.5))):
        gen = jmt._gaussian_boxes if kind == "gaussian" else jmt._uniform_boxes
        want = jax.jit(lambda k, b: jmt._sample_filtered(
            k, lambda r, n: gen(r, b, n, trans, scale, IMG_HW), b, 50, rng_))(key, jnp.asarray(gt))
        got = mt._sample_filtered(d, key, mt.Sampler(kind, trans, scale), T(gt), 50, rng_, IMG_HW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want = jax.jit(lambda k, b: jmt._sample_filtered(
        k, lambda r, n: jmt._whole_boxes(r, b, n, 1.0, IMG_HW), b, 64, (0.0, 0.5)))(
            key, jnp.asarray(gt))
    got = mt._sample_filtered(d, key, mt.Sampler("whole", scale=1.0), T(gt), 64, (0.0, 0.5),
                              IMG_HW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    rng = np.random.RandomState(2)
    boxes = np.concatenate([rng.uniform(0, 60, (30, 2)), rng.uniform(15, 40, (30, 2))],
                           1).astype(np.float32)
    deltas = (0.3 * rng.randn(30, 4)).astype(np.float32)
    np.testing.assert_allclose(mt._bbreg_targets(T(boxes), T(gt)).numpy(),
                               np.asarray(jmt._bbreg_targets(jnp.asarray(boxes), jnp.asarray(gt))),
                               atol=1e-4)
    np.testing.assert_allclose(
        mt._bbreg_apply(T(boxes), T(deltas), IMG_HW).numpy(),
        np.asarray(jmt._bbreg_apply(jnp.asarray(boxes), jnp.asarray(deltas), IMG_HW)), atol=1e-4)
    manet_rt = jax_runtime("manet")
    np.testing.assert_allclose(
        mt._bbreg_apply_manet(port_runtime(manet_rt), T(boxes), T(deltas), IMG_HW).numpy(),
        np.asarray(jmt._bbreg_apply_manet(manet_rt, jnp.asarray(boxes), jnp.asarray(deltas),
                                          IMG_HW)), atol=1e-4)
    X = rng.randn(60, 40).astype(np.float32)
    Y = (X[:, :4] * 0.5 + 0.1 * rng.randn(60, 4)).astype(np.float32)
    valid = (rng.uniform(size=60) > 0.3).astype(np.float32)
    for a, b in zip(mt._ridge_fit(T(X), T(Y), 3.0, T(valid)),
                    jmt._ridge_fit(jnp.asarray(X), jnp.asarray(Y), 3.0, jnp.asarray(valid))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def fc_tree_to_port(fc: dict) -> dict:
    """JAX's fc leaves of a dual MDNet under the port's names and layout."""
    fc = jax.tree.map(np.asarray, fc)
    return {"layers.fc4.0.weight": _hwc_rows_to_chw(fc["fc4"]["kernel"], (512,)),
            "layers.fc4.0.bias": fc["fc4"]["bias"],
            "layers.fc5.1.weight": fc["fc5"]["kernel"].T, "layers.fc5.1.bias": fc["fc5"]["bias"],
            "branches.0.1.weight": fc["fc6_0"]["kernel"].T,
            "branches.0.1.bias": fc["fc6_0"]["bias"]}


@pytest.mark.parametrize("loss", ["mean", "sum", "focal"])
def test_fc_train_matches_jax(dual, loss):
    """Three iterations with given indices, dropout off: JAX's _fc_train run
    one iteration per call (its carry is the fc leaves and the momentum),
    the mined negatives read from JAX's scores before each iteration."""
    jm, params, port = dual
    jrt = jmt.MDNetRuntime(**SMALL, loss_sum=loss == "sum", loss_focal=loss == "focal")
    rng = np.random.RandomState(4)
    pos = np.abs(rng.randn(40, 2, 4608)).astype(np.float32)
    neg = np.abs(rng.randn(80, 2, 4608)).astype(np.float32)
    idx = (rng.randint(0, 40, (3, 8)), rng.randint(0, 80, (3, 64)))
    fc = {k: params["params"][k] for k in ("fc4", "fc5", "fc6_0")}
    mom = jax.tree.map(np.zeros_like, fc)

    @jax.jit
    def one(fc, mom, i_pos, i_cand):
        mined = jax.lax.top_k(jmt._score_fn(jm, params, fc, jnp.asarray(neg)[i_cand])[:, 1],
                              jrt.batch_neg)[1]
        fc, mom, _, _ = jmt._fc_train(jrt, jm, params, fc, mom, jnp.asarray(pos),
                                      jnp.ones(40), jnp.asarray(neg), jnp.ones(80), 1, 1e-3,
                                      jax.random.PRNGKey(0), inject_idx=(i_pos[None], i_cand[None]),
                                      dropout=False)
        return fc, mom, i_cand[mined]

    want_mined = []
    for i in range(3):
        fc, mom, m = one(fc, mom, jnp.asarray(idx[0][i]), jnp.asarray(idx[1][i]))
        want_mined.append(np.asarray(m))
    p_fc = {k: v.detach().clone() for k, v in port.fc_leaves().items()}
    zeros = {k: torch.zeros_like(v) for k, v in p_fc.items()}
    mined = []
    got, _, _, _ = mt._fc_train(
        port_runtime(jrt), port, p_fc, zeros, mt.Rows(T(chw(pos, (512,)))),
        mt.Rows(T(chw(neg, (512,)))), 3, 1e-3, JaxDraws(), jax.random.PRNGKey(0),
        inject_idx=idx, dropout=False, mined=mined)
    for i in range(3):
        np.testing.assert_array_equal(mined[i].numpy(), want_mined[i])
    for k, v in fc_tree_to_port(fc).items():
        assert np.abs(got[k].numpy() - v).max() <= 1e-5 * np.abs(v).max(), k


# ---------------------------------------------------------------- the protocol

RECIPES = {"pymdnet": "dual", "manet": "adapter", "pyvital": "dual_sum"}
# frame k (frame_num k + 1): forced success or failure; frame_num 2, 4, 6
# are long-interval frames, so the run holds long-term updates on success
# (pyvital's G steps), short-term updates on failure and frames without one
FORCED = (True, True, False, True, True, False)


def patches(rng, n):
    return rng.uniform(0, 255, (n, 107, 107, 6)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_injected_protocol_matches_jax(name):
    topology = RECIPES[name]
    jm = {"dual": jmd.MDNet(mode="dual"), "adapter": jmd.MDNet(mode="adapter"),
          "dual_sum": jmd.MDNet(mode="dual", fc6_merge="sum")}[topology]
    params = flax_tree(jm, seed=5)
    port = port_model(topology, params)
    jrt = jax_runtime(name)
    prt = port_runtime(jrt)
    rng = np.random.RandomState(6)
    init = dict(pos=patches(rng, 64), neg=patches(rng, 128), bb=patches(rng, 32),
                bb_boxes=(BOX0 + rng.uniform(-4, 4, (32, 4))).astype(np.float32),
                nu=patches(rng, 16))
    init_idx = (rng.randint(0, 64, (3, 8)), rng.randint(0, 128, (3, 64)))
    key = jax.random.PRNGKey(0)

    j_init = jax.jit(lambda p, b, pos, neg, bb, bbb, nu, k, idx: jmt.mdnet_init_from_patches(
        jrt, jm, p, b, pos, neg, bb, bbb, nu, k, inject_idx=idx, dropout=False))
    js = j_init(params, jnp.asarray(BOX0), init["pos"], init["neg"], init["bb"],
                init["bb_boxes"], init["nu"], key, tuple(map(jnp.asarray, init_idx)))
    draws = JaxDraws()
    ps = mt.mdnet_init_from_patches(prt, port, T(BOX0), T(init["pos"]), T(init["neg"]),
                                    T(init["bb"]), T(init["bb_boxes"]), T(init["nu"]), draws, key,
                                    inject_idx=init_idx, dropout=False)
    gnet = jgnet = None
    if jrt.vital:
        jgnet = jvital.GNet()
        g = jgnet.init(jax.random.PRNGKey(9), jnp.zeros((1, 4608)))
        js = {**js, "g_state": {"g": g, "g_mom": jax.tree.map(jnp.zeros_like, g)}}
        pg = gnet_state_dict_from_flax(g["params"])
        ps["g_state"] = {"g": pg, "g_mom": {k: torch.zeros_like(v) for k, v in pg.items()}}
        gnet = GNet()

    def j_step(p, st, thr, cb, cp, pp, np_, idx, masks):
        # mdnet_step_from_patches with VITAL's G and a traced success_thr
        rt = dataclasses.replace(jrt, success_thr=thr)
        st = {**st, "frame_num": st["frame_num"] + 1}
        rng_, r_train = jax.random.split(st["rng"])
        st = {**st, "rng": rng_}
        feats = jmt._embed_patches(rt, jm, p, cp)
        return jmt._mdnet_core(
            rt, jm, p, st, cb, feats, IMG_HW,
            lambda raw: (jmt._embed_patches(rt, jm, p, pp), jmt._embed_patches(rt, jm, p, np_)),
            r_train, inject_idx=idx, dropout=False, gnet=jgnet, inject_masks=masks)

    j_step = jax.jit(j_step)
    j_boxes, boxes = [], []
    for k, ok in enumerate(FORCED):
        thr = -1e9 if ok else 1e9
        cb = (BOX0 + rng.uniform(-6, 6, (64, 4))).astype(np.float32)
        cp, pp, np_ = patches(rng, 64), patches(rng, 8), patches(rng, 16)
        n_pos = js["pos_init"].shape[0] + 8 * max(int(js["pos_count"]) - 1, 1)
        n_neg = 16 * min(int(js["neg_count"]), 3)
        idx = (rng.randint(0, n_pos, (2, 8)), rng.randint(0, n_neg, (2, 64)))
        masks = (rng.uniform(size=(2, 8, 3, 3)) > 0.3).astype(np.float32) if jrt.vital else None
        js, jb, jscore, jaux = j_step(params, js, jnp.float32(thr), jnp.asarray(cb), cp, pp, np_,
                                      tuple(map(jnp.asarray, idx)),
                                      None if masks is None else jnp.asarray(masks))
        ps, pb, pscore, paux = mt.mdnet_step_from_patches(
            dataclasses.replace(prt, success_thr=thr), port, ps, T(cb), T(cp), T(pp), T(np_),
            IMG_HW, draws, inject_idx=idx, dropout=False, inject_masks=masks, gnet=gnet)
        assert paux["success"] == bool(jaux["success"]) == ok, k
        assert paux["do_update"] == bool(jaux["do_update"]), k
        np.testing.assert_array_equal(paux["top_idx"].numpy(), np.asarray(jaux["top_idx"]))
        assert paux["trans_f"] == np.float32(js["trans_f"]), k
        assert abs(pscore - float(jscore)) <= SCORE_BAR * max(1.0, abs(float(jscore))), k
        j_boxes.append(np.asarray(jb).tolist())
        boxes.append(list(map(float, pb)))
    res = compare_freerun(j_boxes, boxes, PX)
    assert res["pass"], res
    if jrt.vital:
        want = gnet_state_dict_from_flax(js["g_state"]["g"]["params"])
        moved = gnet_state_dict_from_flax(jgnet.init(jax.random.PRNGKey(9),
                                                     jnp.zeros((1, 4608)))["params"])
        assert not torch.equal(want["fc1.weight"], moved["fc1.weight"])   # G stepped
        for k, v in want.items():
            assert (ps["g_state"]["g"][k] - v).abs().max() <= 1e-4 * v.abs().max(), k


def test_pymdnet_free_run_matches_jax(dual):
    """MDNetTracker with JaxDraws against JAX's jitted MDNetTracker."""
    jm, params, port = dual
    jrt = jax_runtime("pymdnet")
    frames, gt = make_synthetic_sequence(n_frames=5, height=IMG_HW[0], width=IMG_HW[1])
    theirs = jmt.MDNetTracker(jm, params, jrt)
    ours = mt.MDNetTracker(port, "cpu", port_runtime(jrt), draws=JaxDraws)
    for tr in (theirs, ours):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    j_boxes, boxes = [], []
    for f in frames[1:]:
        j_boxes.append(theirs.track(f)["target_bbox"])
        boxes.append(ours.track(f)["target_bbox"])
        assert ours.last_aux["success"] == (theirs.state["trans_f"] == jrt.trans)
    res = compare_freerun(j_boxes, boxes, PX)
    assert res["pass"], res
    assert sum(ours.updates.values()) > 0 and ours.state["pos_count"] > 1
