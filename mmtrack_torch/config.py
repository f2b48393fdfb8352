"""The ViPT experiment settings the port needs, without yaml.

`mmtrack_tpu.config` imports yaml, which the port does not depend on.
This module carries the values of
mmtrack_tpu/config.py::vipt_experiment_config (ViPT
experiments/vipt/{deep,shaw}_{rgbd,rgbt,rgbe}.yaml) that `build_viptrack`
and `ViPTRuntime.from_config` read; tests/test_torch_vipt.py holds every one of
them against the JAX package's config.
"""

from __future__ import annotations

from types import SimpleNamespace as _ns

_PROMPT = {"deep_rgbd": "vipt_deep", "shaw_rgbd": "vipt_shaw",
           "deep_rgbt": "vipt_deep", "shaw_rgbt": "vipt_shaw",
           "deep_rgbe": "vipt_deep", "shaw_rgbe": "vipt_shaw"}


def vipt_experiment_config(name: str) -> _ns:
    """Attribute tree with the MODEL/DATA/TRAIN/TEST keys that
    `build_viptrack` and `ViPTRuntime.from_config` read."""
    if name not in _PROMPT:
        raise KeyError(f"unknown ViPT experiment '{name}'; options: {sorted(_PROMPT)}")
    return _ns(
        MODEL=_ns(
            BACKBONE=_ns(EMBED_DIM=768, DEPTH=12, NUM_HEADS=12, STRIDE=16,
                         CE_LOC=[3, 6, 9], CE_KEEP_RATIO=[0.7, 0.7, 0.7],
                         CE_TEMPLATE_RANGE="CTR_POINT"),
            HEAD=_ns(TYPE="CENTER", NUM_CHANNELS=256)),
        TRAIN=_ns(PROMPT=_ns(TYPE=_PROMPT[name])),
        DATA=_ns(TEMPLATE=_ns(SIZE=128, FACTOR=2.0), SEARCH=_ns(SIZE=256, FACTOR=4.0)),
        TEST=_ns(TEMPLATE_FACTOR=2.0, TEMPLATE_SIZE=128, SEARCH_FACTOR=4.0,
                 SEARCH_SIZE=256),
    )
