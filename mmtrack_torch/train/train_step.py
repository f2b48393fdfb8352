"""The training step and its data-parallel form, port of
mmtrack_tpu/train/train_step.py (:24-78): forward + loss, backward,
global-norm clip, AdamW, learning-rate schedule.

PyTorch updates the model in place, so the step mutates its TrainState and
returns it. The drop-path masks of step s come from a generator seeded
from (seed, s), so a run resumed from a checkpoint repeats the
uninterrupted run's masks.

Data parallelism (`shard_train_step`): JAX jits one global program over a
mesh and XLA inserts the gradient psum. Here each of `world` processes
runs the step on its rows of the global batch (`parallel/mesh.py::Shard`),
and the update equals one step of the single process on the whole batch:
  - every random draw of the step (drop path, DiMP's proposals, MDNet's
    patch boxes) is drawn for the global batch and this rank's rows kept;
  - every loss is this rank's share of the global batch's: a mean over
    equal rows as it is, a sum over a count with the count summed over
    the ranks (ops/losses.py::focal_loss, SiamFC's balanced loss) and
    scaled by the world, so that the ranks' mean is the global loss;
  - the trainable gradients are averaged over the ranks by one explicit
    all_reduce of a flat buffer before the clip and AdamW (apply_update),
    and the stats likewise. An explicit reduction rather than
    DistributedDataParallel: the zoo's steps call model methods other than
    `forward` (DDP hooks its reduction into `forward`), a stage's frozen
    or unused parameters would need `find_unused_parameters`, and
    `apply_update` already gives every trainable leaf a gradient (zeros
    where none reached it), so one reduction covers every script.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from mmtrack_torch.parallel.mesh import SINGLE, Shard
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


BATCH_KEYS = ("template", "search", "search_anno")


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}


def make_train_step(*, box_mask_z, ce_keep_lens, weights=(2.0, 5.0, 1.0),
                    search_size: int = 256, stride: int = 16, use_drop_path: bool = True,
                    seed: int = 0) -> Callable:
    """Build `train_step(state, batch, shard=SINGLE) -> (state, stats)`.

    batch holds numpy arrays or tensors (template, search, search_anno) of
    the global batch; the step runs on `shard`'s rows of it. stats are
    detached 0-d tensors of the loss terms before the update.
    """

    def train_step(state: TrainState, batch: dict, shard: Shard = SINGLE):
        model = state.model
        device = next(model.parameters()).device
        gen = None
        if use_drop_path:
            gen = shard.draws(drop_path_generator(seed, state.step, device),
                              len(batch["search"]))
        loss, stats = vipt_forward_and_loss(
            model, batch_to_device(shard.local_batch(batch, BATCH_KEYS), device),
            box_mask_z=box_mask_z, ce_keep_lens=ce_keep_lens, weights=weights,
            search_size=search_size, stride=stride, generator=gen, shard=shard)
        return apply_update(state, loss, stats, shard)

    return train_step


def apply_update(state: TrainState, loss: torch.Tensor, stats: dict, shard: Shard = SINGLE):
    """Backward of `loss`, the trainable gradients averaged over `shard`'s
    ranks, optax's global-norm clip over them, the optimizer and schedule
    steps: the update every train step of the port ends with. Returns
    (state, detached stats, averaged over the ranks)."""
    state.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    group = state.optimizer.param_groups[0]
    for p in group["params"]:
        if p.grad is None:          # optax updates every trainable leaf
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in group["params"]]
    shard.average_(grads)
    clip_by_global_norm_(grads, group["grad_clip_norm"])
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, shard.mean_stats({k: v.detach() for k, v in stats.items()})


def shard_train_step(train_step: Callable, shard: Shard) -> Callable:
    """`step(state, global_batch, **kw) -> (state, stats)`: `train_step`
    (any step of the port that takes `shard=`) run on `shard`'s rows of
    the global batch, its gradients and stats averaged over the ranks, so
    that the update is the one-process step's on the whole batch. Every
    rank holds the same model and optimizer state (`parallel/mesh.py::
    replicate`) and is given the same global batch."""

    def step(state: TrainState, batch: dict, **kw):
        return train_step(state, batch, shard=shard, **kw)

    return step
