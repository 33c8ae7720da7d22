"""Pipeline parallelism: GPipe microbatch pipelining over a "stage" axis of
ranks (the port's copy of diffnorm_tpu/parallel/pipeline.py).

The layer stack splits into S stages, each held by one rank of the stage
axis; activations pass from stage s to stage s + 1 by `mesh.ring_shift`,
and M microbatches keep every stage busy after the fill (the GPipe
schedule of M + S - 1 ticks, S - 1 bubble ticks at each end).

Differentiable: a shift's backward sends the gradient back one stage. The
carry every rank receives enters its next tick (stage 0 adds it times 0 to
its microbatch), and the last tick's carry enters the output times 0, so
each rank's backward runs the same chain of shifts in the same order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from diffnorm_tpu_torch.parallel.mesh import (  # noqa: F401 (make_stage_mesh: JAX's name here)
    Axis,
    copy_in,
    make_stage_mesh,
    reduce_out,
    ring_shift,
)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params,
                   microbatches: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A pipelined forward.

    stage_fn(params, x) -> x of the same shape; stage_params: this rank's
    stage's parameters (stage `axis.index`); microbatches [M, mb, ...], the
    same on every rank. Returns [M, mb, ...] after all S stages, on every
    rank. At tick t stage s runs microbatch t - s (where it is in range) and
    every stage's activation moves one stage on. The microbatches' gradient
    (stage 0's) reaches every rank."""
    s, stage = axis.size, axis.index
    m = microbatches.shape[0]
    microbatches = copy_in(microbatches, axis)
    # the activation arriving here; every rank's backward reaches copy_in
    carry = 0.0 * microbatches[0]
    outs = [None] * m
    ticks = m + s - 1
    for t in range(ticks):
        active = 0 <= t - stage < m
        x_in = microbatches[min(t, m - 1)] + 0.0 * carry if stage == 0 else carry
        y = stage_fn(stage_params, x_in) if active else x_in
        if stage == s - 1 and active:
            outs[t - (s - 1)] = y
        if t < ticks - 1:
            carry = ring_shift(y, axis)
    if stage == s - 1:
        out = torch.stack(outs) + 0.0 * y
    else:
        out = torch.zeros_like(microbatches) + 0.0 * y
    return reduce_out(out, axis)  # the last stage's outputs on every rank
