"""STARK training in the port (train/zoo_actors.py::make_stark_train_step)
against the JAX package's at f32: one step of the box stage on the narrow
STARK-SPT of tests/test_torch_zoo_train.py, whose module docstring gives
the trees, the batches and the bars (tests/test_torch_dimp_train.py::
assert_step_matches). The score stage's step is in
tests/test_torch_stark_score_train.py. Weight seed 1: at seed 0 the
predicted box misses the target and the step sits on a kink of GIoU's
clamp (the port moves as far from itself under a 1e-7 change of its input
as from JAX there).
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

pytest.importorskip("torch")

from test_torch_zoo_train import check_step, flax_tree  # noqa: E402


def test_stark_bbox_step_matches_jax():
    check_step("stark", "bbox", flax_tree("stark", "bbox", seed=1), 10)
