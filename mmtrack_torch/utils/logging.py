"""JSONL + plaintext metric log, port of mmtrack_tpu/utils/logging.py
(MetricLogger). The JAX package's module is free of jax itself, but importing
it runs `mmtrack_tpu/utils/__init__.py`, which imports jax."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    """Append-only JSONL metric sink with a plaintext mirror."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{name}.jsonl")
        self.text_path = os.path.join(log_dir, f"{name}.log")

    def write(self, step: int, stats: dict, epoch: int | None = None) -> None:
        rec = {"time": time.time(), "step": step,
               **({"epoch": epoch} if epoch is not None else {}),
               **{k: float(v) for k, v in stats.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        with open(self.text_path, "a") as f:
            f.write(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] step {step}: "
                    + ", ".join(f"{k}: {float(v):.5f}" for k, v in stats.items()) + "\n")
