"""The ViPT experiment settings the port needs, without yaml.

`mmtrack_tpu.config` imports yaml, which the port does not depend on.
This module carries the values of
mmtrack_tpu/config.py::vipt_experiment_config (ViPT
experiments/vipt/{deep,shaw}_{rgbd,rgbt,rgbe}.yaml) that `build_viptrack`,
`ViPTRuntime.from_config`, the training processing and the training entry
(`mmtrack_torch.train.run`) read; tests/test_torch_vipt.py and
tests/test_torch_train.py hold every one of them against the JAX
package's config.
"""

from __future__ import annotations

from types import SimpleNamespace as _ns

_PROMPT = {"deep_rgbd": "vipt_deep", "shaw_rgbd": "vipt_shaw",
           "deep_rgbt": "vipt_deep", "shaw_rgbt": "vipt_shaw",
           "deep_rgbe": "vipt_deep", "shaw_rgbe": "vipt_shaw"}
_DATASETS = {"rgbd": "DepthTrack_train", "rgbt": "LasHeR_all", "rgbe": "VisEvent_train"}


def vipt_experiment_config(name: str) -> _ns:
    """Attribute tree with the MODEL/DATA/TRAIN/TEST keys that the port
    reads."""
    if name not in _PROMPT:
        raise KeyError(f"unknown ViPT experiment '{name}'; options: {sorted(_PROMPT)}")
    return _ns(
        MODEL=_ns(
            BACKBONE=_ns(EMBED_DIM=768, DEPTH=12, NUM_HEADS=12, STRIDE=16,
                         CE_LOC=[3, 6, 9], CE_KEEP_RATIO=[0.7, 0.7, 0.7],
                         CE_TEMPLATE_RANGE="CTR_POINT"),
            HEAD=_ns(TYPE="CENTER", NUM_CHANNELS=256)),
        TRAIN=_ns(PROMPT=_ns(TYPE=_PROMPT[name]), LR=4e-4, WEIGHT_DECAY=1e-4, EPOCH=60,
                  LR_DROP_EPOCH=48, BATCH_SIZE=32, GIOU_WEIGHT=2.0, L1_WEIGHT=5.0,
                  FOCAL_WEIGHT=1.0, PRINT_INTERVAL=50, GRAD_CLIP_NORM=0.1, AMP=False,
                  SAVE_EPOCH_INTERVAL=5, SAVE_LAST_N_EPOCH=1, CE_START_EPOCH=4,
                  CE_WARM_EPOCH=16, DROP_PATH_RATE=0.1, SCHEDULER=_ns(DECAY_RATE=0.1)),
        DATA=_ns(MAX_SAMPLE_INTERVAL=200,
                 TRAIN=_ns(DATASETS_NAME=[_DATASETS[name[-4:]]], DATASETS_RATIO=[1],
                           SAMPLE_PER_EPOCH=60000),
                 TEMPLATE=_ns(SIZE=128, FACTOR=2.0, CENTER_JITTER=0, SCALE_JITTER=0),
                 SEARCH=_ns(SIZE=256, FACTOR=4.0, CENTER_JITTER=3, SCALE_JITTER=0.25)),
        TEST=_ns(TEMPLATE_FACTOR=2.0, TEMPLATE_SIZE=128, SEARCH_FACTOR=4.0,
                 SEARCH_SIZE=256),
    )


def merge_overrides(cfg: _ns, overrides: dict, prefix: str = "") -> _ns:
    """Set the nested keys of `overrides` on `cfg` in place (the yaml-free
    counterpart of ConfigNode.merge_from_dict); an unknown key raises."""
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"unknown config key {prefix}{key}")
        if isinstance(value, dict):
            merge_overrides(getattr(cfg, key), value, f"{prefix}{key}.")
        else:
            setattr(cfg, key, value)
    return cfg
