"""MixFormer training in the port (train/zoo_actors.py::
make_mixformer_train_step, the score stage's trainable set) against the
JAX package's at f32: one step of the box stage and one of the score
stage (the score head pooled at the ground truth, only `score_branch`
trained) on the narrow MixFormer of tests/test_torch_zoo_train.py, whose
module docstring gives the trees, the batches and the bars
(tests/test_torch_dimp_train.py::assert_step_matches).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

pytest.importorskip("torch")

from test_torch_zoo_train import check_step, flax_tree  # noqa: E402


@pytest.mark.parametrize("stage,seed", [("bbox", 2), ("score", 3)])
def test_mixformer_step_matches_jax(stage, seed):
    check_step("mixformer", stage, flax_tree("mixformer", stage, seed=seed), 10 + seed)
