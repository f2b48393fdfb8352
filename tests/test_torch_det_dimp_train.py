"""DeT-max training in the port against the JAX package's at f32: one
det_dimp step (two ResNet-50 trunks merged by max) at 96-px crops, B = 2,
on the tree, batch and bars of tests/test_torch_dimp_train.py, JAX's
proposal noise given to the port."""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

pytest.importorskip("torch")

from test_torch_dimp_train import check_dimp_step, det_max_tree  # noqa: E402


def test_det_dimp_step_matches_jax():
    check_dimp_step("det_dimp", det_max_tree(), 11, 21)
