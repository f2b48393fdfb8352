"""The port covers the JAX package: every public top-level function and
class of each `mmtrack_tpu/**/*.py` (read with `ast`, nothing imported) is
defined at the top level of the same module of `mmtrack_torch`, or stands
in NOT_PORTED below with the reason. An entry of the table that names
something the port now defines, or that the JAX package no longer has,
fails too, so the table stays exact.

Also the small helpers ported for this coverage against the JAX package's:
the box converters and the image-to-crop map exactly, the CE lengths, the
StepLR schedule (and the StepLR of build_optimizer), the grayscale loader
on a 16-bit depth PNG.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import ast
import pathlib

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.data import image_loader as jax_loader  # noqa: E402
from mmtrack_tpu.ops import box as jax_box  # noqa: E402
from mmtrack_tpu.ops import ce as jax_ce  # noqa: E402
from mmtrack_tpu.train import optim as jax_optim  # noqa: E402
from mmtrack_torch.data import image_loader  # noqa: E402
from mmtrack_torch.ops import box, ce  # noqa: E402
from mmtrack_torch.train import optim  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
BRIDGE = ("the other direction of the weight bridge: the port carries flax trees in "
          "(models/convert.py::*_state_dict_from_flax); this one reads torch state_dicts "
          "into flax, which the tests use to send the port's weights back")
DO_NOT_PORT = "ROADMAP.md's Do not port: "
NOT_PORTED = {
    "config.py::ConfigNode": "the port's config is a yaml-free SimpleNamespace tree "
                             "(config.py::vipt_experiment_config, merge_overrides)",
    "config.py::vipt_default_config": "the keys the port reads are in "
                                      "config.py::vipt_experiment_config, held key by key "
                                      "by tests/test_torch_vipt.py",
    **{f"models/convert.py::convert_{n}_checkpoint": BRIDGE
       for n in ("vipt", "mixformer", "dimp", "atom", "prdimp", "super_dimp", "kys", "lwl",
                 "stm", "eco_backbone", "stark", "score_head", "mdnet", "manet", "apfnet",
                 "peak_matching")},
    "models/convert.py::load_into": BRIDGE,
    "models/dimp.py::ClfFeatureExtractor": "DiMPNet's classifier.feature_extractor, a "
                                           "Conv2d + InstanceL2Norm Sequential "
                                           "(models/dimp.py)",
    "models/vipt.py::ce_keep_schedule": "ops/ce.py::ce_keep_schedule, beside "
                                        "ce_keep_lengths, so that ops/ imports nothing of "
                                        "models/ (models/vipt.py imports it from there)",
    "models/peak_matching.py::MLPBlock": "models/peak_matching.py::MLP, the reference's "
                                         "name (Conv1d k=1, BatchNorm1d, ReLU)",
    "ops/crop.py::crop_resize_mxu": DO_NOT_PORT + "the MXU form of the crop works around "
                                                  "a TPU gather emitter",
    "ops/crop.py::sample_target_np": "data/processing.py::sample_target_np, beside the "
                                     "training processing that calls it",
    "ops/pallas_preproc.py::crop_resize_normalize_pallas": "a Pallas entry: its port is "
                                                           "ops/crop.py::"
                                                           "crop_resize_normalized over "
                                                           "csrc/crop.cu",
    "ops/xcorr.py::depthwise_xcorr_pallas": "a Pallas entry: its port is ops/xcorr.py::"
                                            "depthwise_xcorr over csrc/xcorr.cu",
    "ops/prroi.py::prroi_pool_single": "ops/prroi.py::prroi_pool pools a batch of RoIs; "
                                       "one RoI is a batch of one",
    "parallel/batched_eval.py::make_batched_track_step": "the port's vipt_init_state / "
                                                         "vipt_track_step take B sequences "
                                                         "(BatchedViPTTracker): no vmap "
                                                         "builder",
    "parallel/mesh.py::make_mesh": "a JAX device mesh; the port runs one process per card "
                                   "(parallel/mesh.py::init_distributed, Shard)",
    "trackers/mosse_tracker.py::mosse_step_from_patches": DO_NOT_PORT + "a seam of the "
                                                                        "tools/parity harness",
    "trackers/scsrdcf_tracker.py::scsrdcf_step_from_patches": DO_NOT_PORT + "a seam of the "
                                                                            "tools/parity "
                                                                            "harness",
    "utils/env.py::create_default_local_file": "the port never writes the user's "
                                               "local.yaml (utils/env.py)",
    "utils/env.py::enable_compile_cache": DO_NOT_PORT + "XLA's compile cache",
    "utils/hostmem.py::tune_host_allocator": DO_NOT_PORT + "the TPU VM's host allocator",
    "utils/profiling.py::Timer": "read by nothing; the port's tracer (utils/profiling.py "
                                 "span, tracing) times its layers",
}


def public_names(root: pathlib.Path) -> dict[str, set]:
    out = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        out[path.relative_to(root).as_posix()] = {
            n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}
    return out


JAX = public_names(REPO / "mmtrack_tpu")
PORT = public_names(REPO / "mmtrack_torch")


@pytest.mark.parametrize("module", sorted(m for m in JAX if JAX[m]))
def test_module_is_ported_or_listed(module):
    missing = sorted(n for n in JAX[module] - PORT.get(module, set())
                     if f"{module}::{n}" not in NOT_PORTED)
    assert not missing, f"mmtrack_tpu/{module}: no counterpart in mmtrack_torch/{module} " \
                        f"and no reason in NOT_PORTED: {missing}"


def test_not_ported_table_is_exact():
    for key, reason in NOT_PORTED.items():
        module, name = key.split("::")
        assert name in JAX.get(module, set()), f"{key}: not in the JAX package"
        assert name not in PORT.get(module, set()), f"{key}: ported, drop the entry"
        assert reason.strip(), key


@pytest.mark.parametrize("name", ["box_xywh_to_xyxy", "box_xyxy_to_xywh", "box_xywh_to_cxcywh",
                                  "box_cxcywh_to_xywh", "box_cxcywh_to_xyxy",
                                  "box_xyxy_to_cxcywh", "box_area_xyxy"])
def test_box_helpers_equal_jax(name):
    b = np.random.RandomState(0).uniform(-5, 50, (3, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(getattr(box, name)(torch.from_numpy(b)).numpy(),
                                  np.asarray(getattr(jax_box, name)(jnp.asarray(b))))


@pytest.mark.parametrize("normalize", [False, True])
def test_transform_image_to_crop_equals_jax(normalize):
    rng = np.random.RandomState(1)
    box_in = rng.uniform(5, 60, (6, 4)).astype(np.float32)
    extract = rng.uniform(5, 60, (6, 4)).astype(np.float32)
    factor = rng.uniform(0.5, 3, (6, 1)).astype(np.float32)
    want = jax_box.transform_image_to_crop(jnp.asarray(box_in), jnp.asarray(extract),
                                           jnp.asarray(factor), 256.0, normalize)
    got = box.transform_image_to_crop(torch.from_numpy(box_in), torch.from_numpy(extract),
                                      torch.from_numpy(factor), 256.0, normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("lens,loc,ratio,depth", [(256, [3, 6, 9], 0.7, 12),
                                                  (400, [3, 6, 9], 0.7, 12),
                                                  (16, [1], 0.5, 3)])
def test_ce_keep_lengths_equal_jax(lens, loc, ratio, depth):
    assert ce.ce_keep_lengths(lens, loc, ratio, depth) == jax_ce.ce_keep_lengths(
        lens, loc, ratio, depth)


def test_step_lr_schedule_equals_jax_and_the_optimizer():
    ours, theirs = optim.step_lr_schedule(4e-4, 15, 0.2), jax_optim.step_lr_schedule(4e-4, 15,
                                                                                       0.2)
    model = torch.nn.Linear(2, 2)
    opt, sched = optim.build_optimizer(model, lr=4e-4, lr_drop_step=15, decay_rate=0.2)
    for step in range(50):
        assert ours(step) == theirs(step)
        assert opt.param_groups[0]["lr"] == pytest.approx(ours(step), rel=1e-12)
        opt.step()
        sched.step()


def test_grayscale_loader_equals_jax(tmp_path):
    depth = np.random.RandomState(2).randint(0, 65535, (12, 17)).astype(np.uint16)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, depth)
    got, want = image_loader.grayscale_loader(path), jax_loader.grayscale_loader(path)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, depth)
    with pytest.raises(IOError):
        image_loader.grayscale_loader(str(tmp_path / "missing.png"))
