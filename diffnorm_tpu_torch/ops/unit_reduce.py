"""Unit reduction: collapse consecutive duplicate units.

The port's copy of diffnorm_tpu/ops/unit_reduce.py:reduce_units (reference
`_reduce_tgt`, repr_to_repr_unit_dataset.py:92-113): keep the FIRST frame of
each run; durations are run lengths.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
