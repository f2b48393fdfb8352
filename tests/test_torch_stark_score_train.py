"""STARK's score stage in the port against the JAX package's at f32: one
step that trains only the score head (`cls_head`, JAX's cls_0..2) on
positive pairs and the batch's rolled negatives, on the narrow STARK-SPT,
the batches and the bars of tests/test_torch_zoo_train.py."""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

pytest.importorskip("torch")

from test_torch_zoo_train import check_step, flax_tree  # noqa: E402


def test_stark_score_step_matches_jax():
    check_step("stark", "score", flax_tree("stark", "score", seed=1), 11)
