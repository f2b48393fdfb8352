"""The port's main-path ops against the JAX package's, on seeded inputs.

Candidate elimination is checked with exact ties in the scores (the
stable descending order of ce.py:71 must break them the same way),
cal_bbox with tied maxima (first index, heads.py:93). Everything here is
exact elementwise arithmetic, so the bar is equality except where a
transcendental (cos in the Hann window) differs by an ulp between the two
libraries.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models.heads import cal_bbox as jax_cal_bbox  # noqa: E402
from mmtrack_tpu.ops import box as jax_box  # noqa: E402
from mmtrack_tpu.ops import ce as jax_ce  # noqa: E402
from mmtrack_tpu.ops import window as jax_window  # noqa: E402
from mmtrack_torch.models.heads import cal_bbox  # noqa: E402
from mmtrack_torch.ops import box, ce, window  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("mask", ["none", "ctr_point", "two_rows"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_candidate_elimination_with_ties(dtype, mask):
    tdt, jdt = DTYPES[dtype]
    r = np.random.RandomState(5)
    B, H, Lt, Ls, C, keep = 3, 4, 4, 12, 8, 7
    L = Lt + Ls
    # probabilities from a 3-value set: every score below is tied with others
    attn = r.choice([0.0625, 0.125, 0.25], size=(B, H, L, L)).astype(np.float32)
    tokens = r.randn(B, L, C).astype(np.float32)
    gidx = np.stack([r.permutation(16)[:Ls] for _ in range(B)]).astype(np.int64)
    m = {"none": None,
         "ctr_point": np.eye(Lt, dtype=np.float32)[[1]].repeat(B, 0),
         "two_rows": np.tile(np.array([[1, 0, 1, 0]], np.float32), (B, 1))}[mask]

    jt, jk, jr = jax_ce.candidate_elimination(
        jnp.asarray(attn).astype(jdt), jnp.asarray(tokens).astype(jdt), Lt, keep,
        jnp.asarray(gidx), None if m is None else jnp.asarray(m))
    tt, tk, tr = ce.candidate_elimination(
        torch.from_numpy(attn).to(tdt), torch.from_numpy(tokens).to(tdt), Lt, keep,
        torch.from_numpy(gidx), None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tt.float().numpy(), np.asarray(jt.astype(jnp.float32)))


def test_recover_and_gather_search_tokens():
    r = np.random.RandomState(6)
    B, Lx, keep, C = 2, 16, 9, 5
    gidx = np.stack([r.permutation(Lx)[:keep] for _ in range(B)]).astype(np.int64)
    tok = r.randn(B, keep, C).astype(np.float32)
    full = r.randn(B, Lx, C).astype(np.float32)
    want = jax_ce.recover_search_tokens(jnp.asarray(tok), jnp.asarray(gidx), Lx)
    got = ce.recover_search_tokens(torch.from_numpy(tok), torch.from_numpy(gidx), Lx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_ce.gather_search_tokens(jnp.asarray(full), jnp.asarray(gidx))
    got = ce.gather_search_tokens(torch.from_numpy(full), torch.from_numpy(gidx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sz_h,sz_w,centered", [(16, 16, True), (7, 9, True),
                                                (16, 16, False), (9, 6, False)])
def test_hann2d(sz_h, sz_w, centered):
    want = np.asarray(jax_window.hann2d(sz_h, sz_w, centered))
    got = window.hann2d(sz_h, sz_w, centered).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)   # cos: one f32 ulp apart


def test_clip_box():
    r = np.random.RandomState(7)
    boxes = np.concatenate([r.uniform(-60, 380, (64, 2)), r.uniform(0.1, 150, (64, 2))],
                           1).astype(np.float32)
    want = jax_box.clip_box(jnp.asarray(boxes), 240.0, 320.0, margin=10.0)
    got = box.clip_box(torch.from_numpy(boxes), 240.0, 320.0, margin=10.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [16, 12])
def test_cal_bbox_tied_maxima(S):
    r = np.random.RandomState(8)
    B = 3
    score = r.uniform(0, 0.5, (B, S, S)).astype(np.float32)
    score[0, 3, 5] = score[0, 9, 2] = score[0, 3, 9] = 0.9    # three tied maxima
    score[1, :, :] = 0.25                                    # all tied
    score[2, S - 1, S - 1] = score[2, S - 1, 0] = 0.75
    size = r.uniform(0, 1, (B, S, S, 2)).astype(np.float32)
    offset = r.uniform(-1, 1, (B, S, S, 2)).astype(np.float32)
    wb, ws = jax_cal_bbox(jnp.asarray(score), jnp.asarray(size), jnp.asarray(offset))
    gb, gs = cal_bbox(torch.from_numpy(score), torch.from_numpy(size),
                      torch.from_numpy(offset))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-7)


@pytest.mark.parametrize("S", [16, 12])
def test_cal_bbox_at_given_cells(S):
    """Boxes decoded at given cells are the JAX decode of maps whose maximum
    sits at those cells; the scores are the given cells' own."""
    r = np.random.RandomState(9)
    B = 3
    score = r.uniform(0, 0.5, (B, S, S)).astype(np.float32)
    size = r.uniform(0, 1, (B, S, S, 2)).astype(np.float32)
    offset = r.uniform(-1, 1, (B, S, S, 2)).astype(np.float32)
    idx = r.randint(0, S * S, B)
    peaked = score.reshape(B, -1).copy()
    peaked[np.arange(B), idx] = 1.0
    wb, _ = jax_cal_bbox(jnp.asarray(peaked.reshape(B, S, S)), jnp.asarray(size),
                         jnp.asarray(offset))
    gb, gs = cal_bbox(torch.from_numpy(score), torch.from_numpy(size),
                      torch.from_numpy(offset), torch.from_numpy(idx))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(gs.numpy(), score.reshape(B, -1)[np.arange(B), idx])
