"""Monotonic attention's expected alignment (MMA, simultaneous MT; the port
of diffnorm_tpu/ops/alignment.py, reference
examples/operators/alignment_train_cpu.cpp behind
simultaneous_translation/utils/monotonic_attention.py:12-59, arXiv
1704.00784): from the stepwise selection probabilities p_choose [B, T_tgt,
T_src], row by row over the target axis,

    alpha_i = p_i * cumprod(1 - p_i) * cumsum(alpha_{i-1} / clamp(cumprod(1 - p_i)))

with alpha_{-1} = [1, 0, ...], the exclusive cumprod clamped to [eps, 1]
inside the division and every alpha clipped to [0, 1].

* `expected_alignment_from_p_choose`: on the tensor's device, a loop over
  the target axis of vectorized cumsums (JAX's `lax.scan`);
* `expected_alignment_host`: the same recursion in numpy (JAX's host twin
  calls the repository's C library where it is built and falls back to
  this).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _exclusive_cumprod_1mp(p: torch.Tensor) -> torch.Tensor:
    """[1, (1 - p0), (1 - p0)(1 - p1), ...] along the last axis."""
    inc = torch.cumprod(1.0 - p, dim=-1)
    return torch.cat([torch.ones_like(inc[..., :1]), inc[..., :-1]], dim=-1)


def expected_alignment_from_p_choose(p_choose: torch.Tensor,
                                     padding_mask: Optional[torch.Tensor] = None,
                                     eps: float = 1e-6) -> torch.Tensor:
    """p_choose [B, T_tgt, T_src] -> alpha [B, T_tgt, T_src] in its type.
    padding_mask [B, T_src], True at PAD, zeroes those source columns first
    (monotonic_attention.py:42-43)."""
    p = p_choose.float()
    if padding_mask is not None:
        p = p.masked_fill(padding_mask[:, None, :], 0.0)
    cumprod_1mp = _exclusive_cumprod_1mp(p)
    cumprod_clamp = cumprod_1mp.clamp(eps, 1.0)
    b, tgt, src = p.shape
    prev = torch.zeros(b, src, dtype=torch.float32, device=p.device)
    prev[:, 0] = 1.0
    rows = []
    for i in range(tgt):
        scan = torch.cumsum(prev / cumprod_clamp[:, i], dim=-1)
        prev = (scan * p[:, i] * cumprod_1mp[:, i]).clamp(0.0, 1.0)
        rows.append(prev)
    return torch.stack(rows, dim=1).to(p_choose.dtype)


def expected_alignment_host(p_choose: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """The same recursion on the host, in float32 numpy."""
    p = np.ascontiguousarray(p_choose, np.float32)
    b, tgt, src = p.shape
    alpha = np.zeros_like(p)
    cumprod = np.concatenate(
        [np.ones_like(p[..., :1]), np.cumprod(1.0 - p, axis=-1)[..., :-1]], axis=-1)
    clamp = np.clip(cumprod, eps, 1.0)
    prev = np.zeros((b, src), np.float32)
    prev[:, 0] = 1.0
    for t in range(tgt):
        scan = np.cumsum(prev / clamp[:, t], axis=-1)
        alpha[:, t] = np.clip(scan * p[:, t] * cumprod[:, t], 0.0, 1.0)
        prev = alpha[:, t]
    return alpha
