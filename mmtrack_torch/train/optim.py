"""AdamW with global-norm clipping, a step learning-rate decay and the
prompt-only trainable set, port of mmtrack_tpu/train/optim.py (:16-68;
ViPT lib/train/base_functions.py:171-211).

The reference freezes every parameter without "prompt" in its name; here,
as there, that is `requires_grad=False`, so frozen parameters get no
gradient, no optimizer state and no update. The update is optax's
`chain(clip_by_global_norm, adamw)` over the trainable parameters only:
torch's AdamW is the same step as optax's adamw (b1 0.9, b2 0.999, eps
1e-8 outside the square root, decoupled decay lr * wd * p on every
trainable parameter), and `clip_by_global_norm_` uses optax's formula.
"""

from __future__ import annotations

import sys

import torch
from torch import nn


def prompt_only_mask(model: nn.Module) -> dict[str, bool]:
    """True (trainable) for parameters whose name contains 'prompt':
    prompt_blocks.*, prompt_norms.*, patch_embed_prompt.*."""
    return {name: "prompt" in name for name, _ in model.named_parameters()}


def prefix_mask(model: nn.Module, prefix: str) -> dict[str, bool]:
    """True (trainable) for the parameters under the module `prefix`
    (e.g. 'cls_head.', STARK's score head)."""
    return {name: name.startswith(prefix) for name, _ in model.named_parameters()}


def count_trainable(model: nn.Module, mask: dict[str, bool]) -> int:
    return sum(p.numel() for name, p in model.named_parameters() if mask[name])


def build_optimizer(model: nn.Module, *, lr: float, weight_decay: float = 1e-4,
                    lr_drop_step: int | None = None, decay_rate: float = 0.1,
                    grad_clip_norm: float = 0.1, trainable_mask: dict[str, bool] | None = None):
    """(AdamW, StepLR) over the trainable parameters of `model`.

    Sets `requires_grad` from `trainable_mask` (None trains everything).
    The learning rate is lr * decay_rate ** (step // lr_drop_step), stepped
    once per optimizer step like the JAX schedule; the clip norm rides in
    the parameter group (`grad_clip_norm`) so a checkpoint keeps it.
    """
    params = []
    for name, p in model.named_parameters():
        trainable = trainable_mask is None or trainable_mask[name]
        p.requires_grad_(trainable)
        if trainable:
            params.append(p)
    opt = torch.optim.AdamW([{"params": params, "grad_clip_norm": grad_clip_norm}], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=lr_drop_step or sys.maxsize,
                                            gamma=decay_rate)
    return opt, sched


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global L2 norm n of
    `grads` is at least max_norm, every g becomes (g / n) * max_norm (no
    epsilon, unlike torch's clip_grad_norm_). Returns n."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
