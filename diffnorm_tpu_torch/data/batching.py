"""Length buckets (the port's copy of diffnorm_tpu/data/batching.py:bucket_length).

Eager PyTorch compiles nothing per shape; the buckets are kept so the port
pads each batch exactly as the JAX CLI does and writes the same units.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

BUCKETS_DEFAULT = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
                   3072, 4096, 6144)


def bucket_length(n: int, buckets: Sequence[int] = BUCKETS_DEFAULT) -> int:
    """Smallest bucket >= n (multiples of the largest bucket beyond it)."""
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])
