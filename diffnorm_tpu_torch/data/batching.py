"""Length buckets and size-bounded batches (the port's copy of
diffnorm_tpu/data/batching.py).

Eager PyTorch compiles nothing per shape; the buckets are kept so the port
pads each batch exactly as the JAX CLI does and writes the same units.
`batch_by_size` is the numpy path of JAX's (fairseq's batch_by_size_vec),
which is exact; the port has no native version.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def batch_by_size(indices, sizes, max_tokens: Optional[int] = None,
                  max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1) -> List[np.ndarray]:
    """indices: the candidate order (e.g. length-sorted); sizes: per-index
    size. Batches are bounded by max_tokens (= the longest member times the
    batch size) and max_sentences, in multiples of
    required_batch_size_multiple where they can be. Returns index arrays."""
    indices = np.asarray(indices, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.int64)[indices]
    max_tokens = int(max_tokens) if max_tokens else 0
    max_sentences = int(max_sentences) if max_sentences else 0
    mult = max(int(required_batch_size_multiple), 1)
    n = len(indices)
    if n == 0:
        return []
    # fairseq data_utils_fast.pyx:20-105: a committed batch plus a running
    # tail; the tail joins when the combined count is < mult or a multiple
    # of it; an overflow closes the committed batch (two batches when the
    # tail alone overflows max_tokens). An item larger than max_tokens
    # becomes a batch of its own.
    ends = [0] * (2 * n + 2)
    count = batch_start = tail_max = batch_max = 0
    for pos in range(n):
        size = int(sizes[pos])
        tail_max = max(tail_max, size)
        new_end = pos + 1
        new_max = max(batch_max, tail_max)
        new_sent = new_end - batch_start
        overflow = ((max_sentences > 0 and new_sent > max_sentences)
                    or (max_tokens > 0 and new_sent * new_max > max_tokens))
        if overflow:
            if max_tokens > 0 and tail_max * (new_end - ends[count]) > max_tokens:
                count += 1
                ends[count] = pos
                tail_max = size
            batch_start = ends[count]
            count += 1
            new_max = tail_max
        if overflow or new_sent < mult or new_sent % mult == 0:
            ends[count] = new_end
            batch_max = new_max
            tail_max = 0
    if ends[count] != n:
        count += 1
    bounds = [0]
    for k in range(count):
        if ends[k] > bounds[-1]:
            bounds.append(ends[k])
    if bounds[-1] != n:
        bounds.append(n)
    return [indices[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]

BUCKETS_DEFAULT = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
                   3072, 4096, 6144)


def bucket_length(n: int, buckets: Sequence[int] = BUCKETS_DEFAULT) -> int:
    """Smallest bucket >= n (multiples of the largest bucket beyond it)."""
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])
