"""Gradients for the kernel wrappers through their plain versions.

No Pallas kernel of the JAX package has a backward kernel: `jax.grad`
differentiates the module math. So a wrapper's forward is its kernel on a
CUDA tensor (its plain version on the CPU), and its backward recomputes the
plain version from the saved inputs under autograd and returns that
version's gradients. A call where no input needs a gradient goes straight
to the forward, so inference pays nothing for this.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


class _PlainBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward_fn, plain_fn, kwargs, *tensors):
        ctx.plain_fn, ctx.kwargs = plain_fn, kwargs
        ctx.save_for_backward(*tensors)
        return forward_fn(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain_fn(*leaves, **ctx.kwargs)
        grads = iter(torch.autograd.grad(
            out, [t for t, need in zip(leaves, needs) if need], grad))
        return (None, None, None, *(next(grads) if need else None for need in needs))


def with_plain_backward(forward_fn: Callable, plain_fn: Callable,
                        tensors: Sequence[Optional[torch.Tensor]], **kwargs) -> torch.Tensor:
    """forward_fn(*tensors, **kwargs), differentiable through
    plain_fn(*tensors, **kwargs) where grad mode is on and a tensor needs a
    gradient; otherwise forward_fn's result as it is."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _PlainBackward.apply(forward_fn, plain_fn, kwargs, *tensors)
    return forward_fn(*tensors, **kwargs)
