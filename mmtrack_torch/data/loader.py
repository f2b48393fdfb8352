"""Batch loader: sampler -> numpy training batches, prefetched on one thread.

Port of mmtrack_tpu/data/loader.py (collate, collate_pair, BatchLoader;
:20-82) without
its host-allocator tuning. Sampling errors are relayed to the consumer
instead of ending the epoch early.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def collate(samples: list[dict]) -> dict:
    """Stack per-sample crops (one template and one search frame each) into
    (B, H, W, 6) batches and (B, 4) boxes."""
    return {
        "template": np.stack([s["template_images"][0] for s in samples]),
        "search": np.stack([s["search_images"][0] for s in samples]),
        "search_anno": np.stack([s["search_anno"][0] for s in samples]),
        "template_anno": np.stack([s["template_anno"][0] for s in samples]),
    }


def collate_pair(samples: list[dict]) -> dict:
    """collate + the previous search frame of KYSPairProcessing
    (search_prev / search_prev_anno, cropped at the current frame's box)."""
    out = collate(samples)
    out["search_prev"] = np.stack([s["search_prev_images"][0] for s in samples])
    out["search_prev_anno"] = np.stack([s["search_prev_anno"][0] for s in samples])
    return out


class BatchLoader:
    """Iterates `batches_per_epoch` batches of size `batch_size`, each
    stacked by `collate_fn`."""

    def __init__(self, sampler, batch_size: int, batches_per_epoch: int | None = None,
                 prefetch: int = 2, collate_fn=collate):
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.batch_size = batch_size
        self.batches_per_epoch = (batches_per_epoch if batches_per_epoch is not None
                                  else max(1, len(sampler) // batch_size))
        self.prefetch = prefetch

    def _produce(self, q: queue.Queue, n: int):
        try:
            for _ in range(n):
                q.put(self.collate_fn([self.sampler.sample() for _ in range(self.batch_size)]))
            q.put(None)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            q.put(e)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        threading.Thread(target=self._produce, args=(q, self.batches_per_epoch),
                         daemon=True).start()
        while True:
            batch = q.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch

    def __len__(self):
        return self.batches_per_epoch
