"""Hand-written forward kernels under autograd, with the plain version's gradient.

The JAX package's Pallas kernels have no `custom_vjp`, so there is no
backward kernel to port: `jax.grad` of a pallas_call fails, and the
reference gradient is that of the plain (einsum) formulation. A CUDA
kernel here runs the forward; its backward recomputes the kernel's plain
PyTorch version from the saved inputs and differentiates that, for the
inputs that need a gradient only (a frozen weight gets no gradient work).
A kernel with several outputs returns a tuple of tensors, and so does its
plain version.

Without grad mode, or when no input needs a gradient, the kernel is
launched directly and nothing is saved, so inference keeps its cost.
"""

from __future__ import annotations

from typing import Callable

import torch


class _PlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, kwargs: dict, *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*tensors)
        return launch(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grad_outs):
        needs = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.kwargs)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad],
                                         grad_outs))
        return (None, None, None, *(next(grads) if n else None for n in needs))


def launch_with_plain_grad(launch: Callable, plain: Callable, tensors: tuple,
                           **kwargs):
    """launch(*tensors, **kwargs) on the card, a tensor or a tuple of
    tensors; under autograd each output's gradient is that of
    plain(*tensors, **kwargs), recomputed in backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainGrad.apply(launch, plain, kwargs, *tensors)
    return launch(*tensors, **kwargs)
