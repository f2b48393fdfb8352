"""Sub-seeds of a run's --seed: one stream per use, so that adding a use
changes no other stream."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for `tag` from the run's seed (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, zlib.crc32(tag.encode())]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))
