"""The training step, port of mmtrack_tpu/train/train_step.py (:24-57) on one
device: forward + loss, backward, global-norm clip, AdamW, learning-rate
schedule. The data-parallel `shard_train_step` is not ported yet.

PyTorch updates the model in place, so the step mutates its TrainState and
returns it. The drop-path masks of step s come from a generator seeded
from (seed, s), so a run resumed from a checkpoint repeats the
uninterrupted run's masks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from mmtrack_torch.train.actor import vipt_forward_and_loss
from mmtrack_torch.train.optim import clip_by_global_norm_


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def drop_path_generator(seed: int, step: int, device) -> torch.Generator:
    """The drop-path generator of one step, on `device`."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def compute_context(device, dtype: torch.dtype):
    """The zoo steps' bf16 compute over f32 parameters (autocast on
    `device`), or no context for f32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(torch.device(device).type, dtype=dtype)


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k], device=device)
            for k in ("template", "search", "search_anno")}


def make_train_step(*, box_mask_z, ce_keep_lens, weights=(2.0, 5.0, 1.0),
                    search_size: int = 256, stride: int = 16, use_drop_path: bool = True,
                    seed: int = 0) -> Callable:
    """Build `train_step(state, batch) -> (state, stats)`.

    batch holds numpy arrays or tensors (template, search, search_anno);
    stats are detached 0-d tensors of the loss terms before the update.
    """

    def train_step(state: TrainState, batch: dict):
        model = state.model
        device = next(model.parameters()).device
        gen = drop_path_generator(seed, state.step, device) if use_drop_path else None
        loss, stats = vipt_forward_and_loss(
            model, batch_to_device(batch, device), box_mask_z=box_mask_z,
            ce_keep_lens=ce_keep_lens, weights=weights, search_size=search_size,
            stride=stride, generator=gen)
        return apply_update(state, loss, stats)

    return train_step


def apply_update(state: TrainState, loss: torch.Tensor, stats: dict):
    """Backward of `loss`, optax's global-norm clip over the trainable
    parameters, the optimizer and schedule steps: the update every train
    step of the port ends with. Returns (state, detached stats)."""
    state.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    group = state.optimizer.param_groups[0]
    for p in group["params"]:
        if p.grad is None:          # optax updates every trainable leaf
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in group["params"]], group["grad_clip_norm"])
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, {k: v.detach() for k, v in stats.items()}
