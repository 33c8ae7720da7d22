"""Unit reduction: collapse consecutive duplicate units.

The port's copy of diffnorm_tpu/ops/unit_reduce.py (reference `_reduce_tgt`,
repr_to_repr_unit_dataset.py:92-113): keep the FIRST frame of each run;
durations are run lengths.
* `reduce_units` — host numpy, exact, ragged output (data pipeline)
* `reduce_units_padded` — fixed-shape tensors, a batch of rows at once, for
  the fused S2ST chain; returns padded rows and counts
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def reduce_units(tokens) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """tokens: 1-D int sequence. Returns (dedup, durations, index_to_keep)."""
    tokens = np.asarray(tokens)
    n = len(tokens)
    if n == 0:
        z = np.zeros((0,), dtype=np.int64)
        return z, z, z
    change = np.ones(n, dtype=bool)
    change[1:] = tokens[1:] != tokens[:-1]
    index_to_keep = np.nonzero(change)[0]
    dedup = tokens[index_to_keep]
    durations = np.diff(np.append(index_to_keep, n))
    return dedup, durations, index_to_keep


def reduce_units_padded(tokens: torch.Tensor, valid_mask: torch.Tensor):
    """tokens [..., T] int; valid_mask [..., T] bool. Returns (reduced
    [..., T], padded with 0 after count, keep_mask [..., T], count [...]):
    reduced[i] for i < count are the dedup tokens packed left."""
    t = tokens.shape[-1]
    prev = torch.cat([torch.full_like(tokens[..., :1], -1), tokens[..., :-1]], dim=-1)
    keep = (tokens != prev) & valid_mask
    pos = keep.long().cumsum(dim=-1) - 1
    idx = torch.where(keep, pos, t)  # dropped tokens land in a spill column
    out = torch.zeros(tokens.shape[:-1] + (t + 1,), dtype=tokens.dtype, device=tokens.device)
    out.scatter_(-1, idx, torch.where(keep, tokens, 0))
    return out[..., :t], keep, keep.sum(dim=-1)


def expand_units(reduced, durations) -> np.ndarray:
    """Inverse of reduce: repeat each unit by its duration (host numpy)."""
    return np.repeat(np.asarray(reduced), np.asarray(durations))
