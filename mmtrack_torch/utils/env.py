"""Machine-local path configuration: the dataset roots of the OPE entry.

Port of mmtrack_tpu/utils/env.py:14-61 (`EnvironmentSettings`,
`load_env_settings`), the reference's generated `local.py`
(ViPT/lib/train/admin/environment.py:44+): a per-machine YAML file mapping
workspace and dataset roots. The port reads the same file,
`~/.mmtrack_tpu/local.yaml`, so one file serves both packages. Unlike the
JAX loader it never writes one: without the file the defaults apply, and
`dataset_root` names the file to create.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

DEFAULT_PATH = os.path.join(os.path.expanduser("~"), ".mmtrack_tpu", "local.yaml")

_DATASET_KEYS = [
    "depthtrack_dir", "cdtb_dir", "lasher_dir", "rgbt234_dir", "gtot_dir",
    "vtuav_dir", "visevent_dir", "lasot_dir", "got10k_dir", "coco_dir",
    "trackingnet_dir", "imagenet_dir", "otb_dir",
]


@dataclass
class EnvironmentSettings:
    workspace_dir: str = "./workspace"
    results_dir: str = "./workspace/results"
    checkpoints_dir: str = "./workspace/checkpoints"
    tensorboard_dir: str = "./workspace/tensorboard"
    pretrained_dir: str = "./pretrained"
    datasets: dict = field(default_factory=lambda: {k: "" for k in _DATASET_KEYS})
    path: str = DEFAULT_PATH

    def dataset_root(self, name: str) -> str:
        key = name.lower().split("_")[0] + "_dir"
        root = self.datasets.get(key, "")
        if not root:
            raise FileNotFoundError(
                f"dataset root for '{name}' not configured: set datasets.{key} in "
                f"{self.path} or pass --dataset_root")
        return root


def load_env_settings(path: str = DEFAULT_PATH) -> EnvironmentSettings:
    """The settings of `path`, over the defaults; the defaults alone when
    the file does not exist."""
    env = EnvironmentSettings(path=path)
    if not os.path.exists(path):
        return env
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    for k, v in data.items():
        if hasattr(env, k) and k != "path":
            setattr(env, k, v)
    return env
