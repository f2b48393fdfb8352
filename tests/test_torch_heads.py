"""ViPT / OSTrack's CORNER and MLP heads in the port against the JAX
package's, at f32 on the CPU.

The tiny ViPTrack of tests/test_torch_vipt.py (embed 32, 2 heads, depth 2,
CE at block 1, 32 / 64 crops, head channel 16) with MODEL.HEAD.TYPE CORNER
or MLP, flax-initialised (PRNGKey(7)) and carried across by
vipt_state_dict_from_flax. Bars: the maps, boxes and scores within 1e-4
and the kept CE indices equal (the forward); the port's state_dict back
through JAX's convert_vipt_checkpoint + load_into equal to the flax tree
leaf for leaf (the bridge); 0.05 px a box coordinate and 1e-4 on the score
over a 6-frame free run of the single-sequence tracker, the batched
tracker likewise (the tracker); one prompt-only step within the bars of
tests/test_torch_train_disk.py (the step: loss and stats 1e-5 relative,
trained leaves 1e-5 relative L2, frozen leaves bit-equal).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models import heads as jax_heads  # noqa: E402
from mmtrack_tpu.models import vipt as jax_vipt  # noqa: E402
from mmtrack_tpu.models.convert import convert_vipt_checkpoint, load_into  # noqa: E402
from mmtrack_tpu.parallel.batched_eval import BatchedViPTTracker as JaxBatched  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_tpu.train import train_step as jax_train_step  # noqa: E402
from mmtrack_tpu.trackers import vipt_tracker as jax_tracker  # noqa: E402
from mmtrack_torch.models import heads, vipt  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker  # noqa: E402
from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask  # noqa: E402
from mmtrack_torch.train.train_step import TrainState, make_train_step  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker  # noqa: E402
from test_torch_vipt import TINY, _compare_forward  # noqa: E402

HEADS = ("CORNER", "MLP")
RT_ARGS = dict(template_size=32, search_size=64, stride=16, ce_loc=(1,), ce_keep_ratio=(0.7,))
LR, WD = 4e-4, 1e-4
PX = 0.05


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=HEADS)
def pair(request):
    """(head type, jax model, flax params, port model) on the same weights."""
    head = request.param
    rt = jax_tracker.ViPTRuntime(**RT_ARGS)
    jm = jax_vipt.ViPTrack(**TINY, head_type=head)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 32, 32, 6)), jnp.zeros((1, 64, 64, 6)),
                                       None, rt.ce_keep_lens))(jax.random.PRNGKey(7))
    port = vipt.ViPTrack(**TINY, head_type=head).eval()
    port.load_state_dict(vipt_state_dict_from_flax(_np_tree(params["params"])))
    return head, jm, params, port


def test_head_forward_matches_jax(pair):
    head, jm, params, port = pair
    rng = np.random.RandomState(3)
    z = rng.randn(3, 32, 32, 6).astype(np.float32)
    x = rng.randn(3, 64, 64, 6).astype(np.float32)
    mask = np.array(jax_vipt.generate_ctr_mask(2, "CTR_POINT"))
    keep = jax_tracker.ViPTRuntime(**RT_ARGS).ce_keep_lens
    _compare_forward(jm, params, port, z, x, mask, keep, atol=1e-4)
    with torch.no_grad():
        out = port(torch.from_numpy(z), torch.from_numpy(x))
    assert not out["size_map"].any() and not out["offset_map"].any()
    # the score map is a distribution over the search cells
    torch.testing.assert_close(out["score_map"].sum((1, 2)), torch.ones(3), rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_bn", [False, True])
def test_mlp_head_matches_jax(use_bn):
    """MLPHead alone: 3 layers at hidden = input, with and without the
    frozen BN (statistics drawn away from their init values)."""
    jh = jax_heads.MLPHead(hidden_dim=24, use_bn=use_bn)
    x = np.random.RandomState(1).randn(5, 24).astype(np.float32)
    tree = _np_tree(jh.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    rng = np.random.RandomState(4)
    for i in range(3 if use_bn else 0):
        bn = tree["params"][f"bn_{i}"]
        bn["scale"], bn["bias"] = rng.rand(*bn["scale"].shape) + 0.5, rng.randn(*bn["bias"].shape)
        bn["mean"], bn["var"] = rng.randn(*bn["mean"].shape), rng.rand(*bn["var"].shape) + 0.5
        tree["params"][f"bn_{i}"] = {k: np.asarray(v, np.float32) for k, v in bn.items()}
    want = np.asarray(jh.apply(tree, jnp.asarray(x)))
    port = heads.MLPHead(24, 24, use_bn=use_bn)
    sd = vipt_state_dict_from_flax({"box_head": tree["params"]})
    port.load_state_dict({k[len("box_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_head_state_dict_round_trips_through_jax(pair):
    """The port's state_dict -> JAX's convert_vipt_checkpoint -> load_into:
    every leaf of the flax tree is loaded, none missing, equal to the port's."""
    head, jm, params, port = pair
    names = {k for k in port.state_dict() if k.startswith("box_head.")}
    assert names == {k for k in vipt_state_dict_from_flax(_np_tree(params["params"]))
                     if k.startswith("box_head.")}
    tree = convert_vipt_checkpoint({k: v.numpy() for k, v in port.state_dict().items()})
    zeros = jax.tree.map(np.zeros_like, _np_tree(params["params"]))
    loaded, missing, unexpected = load_into(zeros, tree)
    assert not missing and not unexpected
    flat_want = jax.tree_util.tree_leaves_with_path(_np_tree(params["params"]))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(loaded))
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), want, err_msg=str(path))


def test_tracker_free_run_matches_jax(pair):
    """6 frames free from frame 0: the single-sequence trackers, and two
    sequences in lockstep through the batched trackers."""
    head, jm, params, port = pair
    frames, gt = make_synthetic_sequence(n_frames=7, height=96, width=128, seed=11)
    ours = ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS))
    theirs = jax_tracker.ViPTTracker(jm, params, jax_tracker.ViPTRuntime(**RT_ARGS))
    for tr in (ours, theirs):
        tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    for t in range(1, 7):
        a, b = ours.track(frames[t]), theirs.track(frames[t])
        np.testing.assert_allclose(a["target_bbox"], b["target_bbox"], rtol=0, atol=PX,
                                   err_msg=f"{head} frame {t}")
        np.testing.assert_allclose(a["best_score"], b["best_score"], rtol=0, atol=1e-4)

    pairs = [make_synthetic_sequence(n_frames=4, height=96, width=128, seed=s, box0=b0)
             for s, b0 in ((21, (40.0, 30.0, 30.0, 24.0)), (22, (70.0, 50.0, 24.0, 20.0)))]
    seq = np.stack([f for f, _ in pairs], axis=1)
    boxes0 = np.stack([g[0] for _, g in pairs]).astype(np.float32)
    ours_b = BatchedViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS))
    theirs_b = JaxBatched(jm, params, jax_tracker.ViPTRuntime(**RT_ARGS))
    ours_b.initialize(seq[0], boxes0)
    theirs_b.initialize(seq[0], boxes0)
    for t in range(1, 4):
        (ba, sa), (bb, sb) = ours_b.track(seq[t]), theirs_b.track(seq[t])
        np.testing.assert_allclose(ba, bb, rtol=0, atol=PX, err_msg=f"{head} frame {t}")
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-4)


def test_prompt_step_matches_jax(pair):
    """One prompt-only step (the focal term on the head's score map, GIoU
    and L1 on its box) from the same weights and batch."""
    head, jm, params, _ = pair
    keep = jax_tracker.ViPTRuntime(**RT_ARGS).ce_keep_lens
    rng = np.random.RandomState(5)
    batch = {"template": rng.randn(4, 32, 32, 6).astype(np.float32),
             "search": rng.randn(4, 64, 64, 6).astype(np.float32),
             "search_anno": rng.uniform(0.25, 0.4, (4, 4)).astype(np.float32)}
    tx = jax_optim.build_optimizer(params, lr=LR, weight_decay=WD, trainable_mask={
        "params": jax_optim.prompt_only_mask(params["params"])})
    mask_z = jax_vipt.generate_ctr_mask(2, "CTR_POINT")
    jstep = jax.jit(jax_train_step.make_train_step(
        jm, tx, box_mask_z=mask_z, ce_keep_lens=keep, use_drop_path=False, search_size=64,
        stride=16))
    jstate, jstats = jstep(jax_train_step.TrainState.create(params, tx),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    port = vipt.ViPTrack(**TINY, head_type=head)
    port.load_state_dict(vipt_state_dict_from_flax(_np_tree(params["params"])))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt, sched = build_optimizer(port, lr=LR, weight_decay=WD,
                                 trainable_mask=prompt_only_mask(port))
    step = make_train_step(box_mask_z=vipt.generate_ctr_mask(2, "CTR_POINT"), ce_keep_lens=keep,
                           use_drop_path=False, search_size=64, stride=16)
    _, stats = step(TrainState(port, opt, sched), batch)
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)

    want = vipt_state_dict_from_flax(_np_tree(jstate.params["params"]))
    got = port.state_dict()
    trained = {k for k in got if "prompt" in k}
    diff2 = norm2 = 0.0
    off, n_trained = [], 0
    for k in got:
        if k not in trained:
            assert torch.equal(got[k], start[k]) and torch.equal(want[k], start[k]), k
            continue
        d = (got[k] - want[k]).abs()
        assert d.max() <= 2 * LR, (k, float(d.max()))
        off += [(k, float(v)) for v in d[d > 0.1 * LR]]
        n_trained += d.numel()
        diff2 += float((d * d).sum())
        norm2 += float((want[k] * want[k]).sum())
    assert len(off) <= n_trained // 1000, off
    assert (diff2 / norm2) ** 0.5 <= 1e-5, (diff2 / norm2) ** 0.5
