"""The port's tracker runtimes against the JAX package's, at f32 on the CPU.

Both trackers run free from frame 0 on the tiny ViPTrack of
tests/test_golden.py, with flax-initialised weights (PRNGKey(7)) carried
across by the weight bridge. Bar: 0.05 px per box coordinate and 1e-4 on
the score, the golden test's own bar. The chunked scans are held against
the JAX package's jitted `lax.scan`s with the same bar, and on the CPU the
port's scan is its step loop bit for bit; the CUDA graph of the scan
(`make_track_scan`) runs on the card only (tests/test_torch_cuda.py).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data.synthetic import make_synthetic_sequence  # noqa: E402
from mmtrack_tpu.models.vipt import ViPTrack as JaxViPTrack  # noqa: E402
from mmtrack_tpu.parallel.batched_eval import BatchedViPTTracker as JaxBatched  # noqa: E402
from mmtrack_tpu.trackers import vipt_tracker as jax_tracker  # noqa: E402
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime  # noqa: E402
from mmtrack_torch.models.convert import vipt_state_dict_from_flax  # noqa: E402
from mmtrack_torch.models.vipt import ViPTrack  # noqa: E402
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker  # noqa: E402
from mmtrack_torch.trackers.vipt_tracker import (  # noqa: E402
    ViPTRuntime,
    ViPTTracker,
    make_track_scan,
    vipt_init_state,
    vipt_track_scan,
    vipt_track_scan_batched,
    vipt_track_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_vipt_tiny.npz")
TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16,
            template_size=32, search_size=64, ce_loc=(1,), head_channel=16)
RT_ARGS = dict(template_size=32, search_size=64, stride=16, ce_loc=(1,), ce_keep_ratio=(0.7,))


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


def test_golden_vipt_trajectory(tiny):
    _, _, port = tiny
    golden = np.load(FIXTURE)
    frames, gt = make_synthetic_sequence(n_frames=8, height=96, width=128, seed=11)
    tr = ViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS))
    tr.initialize(frames[0], {"init_bbox": gt[0].tolist()})
    outs = [tr.track(frames[t]) for t in range(1, 8)]
    np.testing.assert_allclose(np.asarray([o["target_bbox"] for o in outs]), golden["boxes"],
                               atol=0.05)
    np.testing.assert_allclose(np.asarray([o["best_score"] for o in outs]), golden["scores"],
                               atol=1e-4)


def _two_sequences():
    """Frames (8, 2, 96, 128, 6) of two synthetic sequences and their
    frame-0 boxes (2, 4)."""
    seqs = [make_synthetic_sequence(n_frames=8, height=96, width=128, seed=s,
                                    box0=b0, velocity=v)
            for s, b0, v in ((21, (40.0, 30.0, 30.0, 24.0), (3.0, 2.0)),
                             (22, (70.0, 50.0, 24.0, 20.0), (-2.0, -1.5)))]
    frames = np.stack([f for f, _ in seqs], axis=1)            # (T, B, H, W, 6)
    boxes0 = np.stack([gt[0] for _, gt in seqs]).astype(np.float32)
    return frames, boxes0


def test_batched_tracker_lockstep_with_jax(tiny):
    jm, params, port = tiny
    frames, boxes0 = _two_sequences()

    ours = BatchedViPTTracker(port, "cpu", ViPTRuntime(**RT_ARGS))
    theirs = JaxBatched(jm, params, JaxRuntime(**RT_ARGS))
    ours.initialize(frames[0], boxes0)
    theirs.initialize(frames[0], boxes0)
    for t in range(1, 8):
        b_ours, s_ours = ours.track(frames[t])
        b_theirs, s_theirs = theirs.track(frames[t])
        np.testing.assert_allclose(b_ours, b_theirs, atol=0.05, err_msg=f"frame {t}")
        np.testing.assert_allclose(s_ours, s_theirs, atol=1e-4, err_msg=f"frame {t}")


def test_batched_scan_matches_jax_scan(tiny):
    """T=7 frames of B=2 sequences in one chunk: the port's scan against
    jax.jit of the JAX package's vipt_track_scan_batched."""
    jm, params, port = tiny
    frames, boxes0 = _two_sequences()
    jrt = JaxRuntime(**RT_ARGS)
    jstate = jax.jit(jax.vmap(partial(jax_tracker.vipt_init_state, jrt)))(
        jnp.asarray(frames[0]), jnp.asarray(boxes0))
    _, jboxes, jscores = jax.jit(partial(jax_tracker.vipt_track_scan_batched, jrt, jm))(
        params, jstate, jnp.asarray(frames[1:]))

    rt = ViPTRuntime(**RT_ARGS)
    with torch.inference_mode():
        state = vipt_init_state(rt, torch.from_numpy(frames[0]), torch.from_numpy(boxes0))
        final, boxes, scores = vipt_track_scan_batched(rt, port, state,
                                                       torch.from_numpy(frames[1:]))
    assert boxes.shape == (7, 2, 4) and scores.shape == (7, 2)
    assert torch.equal(final["box"], boxes[-1])
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), atol=0.05)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-4)


def test_single_sequence_scan_matches_jax_scan(tiny):
    """vipt_track_scan (one sequence, no batch axis) against the JAX
    package's vipt_track_scan under jax.jit."""
    jm, params, port = tiny
    frames, boxes0 = _two_sequences()
    frames, box0 = frames[:, 1], boxes0[1]
    jrt = JaxRuntime(**RT_ARGS)
    jstate = jax.jit(partial(jax_tracker.vipt_init_state, jrt))(jnp.asarray(frames[0]),
                                                                jnp.asarray(box0))
    jfinal, jboxes, jscores = jax.jit(partial(jax_tracker.vipt_track_scan, jrt, jm))(
        params, jstate, jnp.asarray(frames[1:]))

    rt = ViPTRuntime(**RT_ARGS)
    with torch.inference_mode():
        state = vipt_init_state(rt, torch.from_numpy(frames[:1]), torch.from_numpy(box0[None]))
        final, boxes, scores = vipt_track_scan(rt, port, {k: v[0] for k, v in state.items()},
                                               torch.from_numpy(frames[1:]))
    assert boxes.shape == (7, 4) and scores.shape == (7,)
    assert final["box"].shape == (4,) and final["template"].shape == (32, 32, 6)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), atol=0.05)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-4)
    np.testing.assert_allclose(final["template"].numpy(), np.asarray(jfinal["template"]),
                               atol=1e-5)


def test_scan_is_the_step_loop_on_cpu(tiny):
    """On the CPU the scan is a plain loop of vipt_track_step: bit-equal."""
    _, _, port = tiny
    frames, boxes0 = _two_sequences()
    rt = ViPTRuntime(**RT_ARGS)
    frames = torch.from_numpy(frames)
    with torch.inference_mode():
        state = vipt_init_state(rt, frames[0], torch.from_numpy(boxes0))
        _, boxes, scores = vipt_track_scan_batched(rt, port, state, frames[1:])
        for t in range(1, 8):
            state, box, score = vipt_track_step(rt, port, state, frames[t])
            assert torch.equal(boxes[t - 1], box) and torch.equal(scores[t - 1], score)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_make_track_scan_refuses_the_cpu(tiny, device):
    _, _, port = tiny
    with pytest.raises(ValueError, match="CUDA"):
        make_track_scan(ViPTRuntime(**RT_ARGS), port, device)
