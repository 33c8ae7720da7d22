"""Length masks and the wav2vec2 / HuBERT span mask (the port's copy of
diffnorm_tpu/utils/masking.py; reference fairseq/data/data_utils.py).

`lengths_to_mask` is True at a valid position, `lengths_to_padding_mask` at
a padded one, the reference's two conventions. `compute_mask_indices` draws
on the host with numpy, as JAX's does: with `rng=None` from the legacy
global `np.random` stream in the reference's call order, else from the
`np.random.Generator` given; the same seed gives JAX's mask bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True where t < length (valid)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True where t >= length (padding)."""
    return ~lengths_to_mask(lengths, max_len)


def apply_mask(x: torch.Tensor, mask: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """x [B, T, ...] with the positions where mask [B, T] is False (padded)
    set to `fill`."""
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return torch.where(mask, x, fill)


def compute_mask_indices(shape, padding_mask, mask_prob: float, mask_length: int,
                         mask_type: str = "static", mask_other: float = 0.0,
                         min_masks: int = 0, no_overlap: bool = False, min_space: int = 0,
                         require_same_masks: bool = True, mask_dropout: float = 0.0,
                         rng=None) -> np.ndarray:
    """The span mask of JAX utils/masking.py:35-155 (reference
    data_utils.py:393-527): shape (B, T), padding_mask optional bool [B, T]
    (True = padded) -> bool [B, T], True = masked.

    Each row draws int(mask_prob * T / mask_length + U) span starts (T the
    row's unpadded length where padding_mask is given, one shared U
    otherwise), at least min_masks; span lengths by `mask_type` (static,
    uniform, normal, poisson); starts without replacement in [0, T -
    min_len), or by free-interval placement with `no_overlap`; spans clipped
    to the row and deduplicated; then every row subsampled to the batch's
    least count (`require_same_masks`) and `mask_dropout` of each row's
    positions dropped. The draws, and their order, are JAX's."""
    r = np.random if rng is None else rng
    # the legacy global stream and a Generator spell their draws differently
    _rand = r.rand if rng is None else r.random
    _randint = r.randint if rng is None else (
        lambda lo, hi, size=None: r.integers(lo, hi, size=size))
    bsz, all_sz = shape
    mask = np.zeros((bsz, all_sz), dtype=bool)

    all_num_mask = int(mask_prob * all_sz / float(mask_length) + _rand())
    all_num_mask = max(min_masks, all_num_mask)

    row_idcs = []
    for i in range(bsz):
        if padding_mask is not None:
            sz = int(all_sz - np.asarray(padding_mask[i]).sum())
            num_mask = int(mask_prob * sz / float(mask_length) + _rand())
            num_mask = max(min_masks, num_mask)
        else:
            sz = all_sz
            num_mask = all_num_mask

        if mask_type == "static":
            lengths = np.full(num_mask, mask_length)
        elif mask_type == "uniform":
            lengths = _randint(mask_other, mask_length * 2 + 1, size=num_mask)
        elif mask_type == "normal":
            lengths = r.normal(mask_length, mask_other, size=num_mask)
            lengths = [max(1, int(round(x))) for x in lengths]
        elif mask_type == "poisson":
            lengths = r.poisson(mask_length, size=num_mask)
            lengths = [int(round(x)) for x in lengths]
        else:
            raise ValueError(f"unknown mask type {mask_type}")
        lengths = list(lengths)

        if sum(lengths) == 0:
            lengths[0] = min(mask_length, sz - 1)

        if no_overlap:
            # the reference's recursive free-interval placement (:469-497)
            idc: list = []
            parts = [(0, sz)]
            min_length = min(lengths)
            for length in sorted(lengths, reverse=True):
                lens = np.array([e - s if e - s >= length + min_space else 0
                                 for s, e in parts], dtype=np.int64)
                l_sum = lens.sum()
                if l_sum == 0:
                    break
                c = r.choice(len(parts), p=lens / l_sum)
                s, e = parts.pop(c)
                span_start = int(_randint(s, e - length))
                idc.extend(span_start + j for j in range(length))
                if span_start - s - min_space >= min_length:
                    parts.append((s, span_start - min_space + 1))
                if e - span_start - min_length - min_space > min_length:
                    parts.append((span_start + length + min_space, e))
            mask_idc = np.asarray(idc)
        else:
            min_len = min(lengths)
            if sz - min_len <= num_mask:
                min_len = sz - num_mask - 1
            starts = r.choice(sz - min_len, num_mask, replace=False)
            mask_idc = np.asarray([starts[j] + offset for j in range(len(starts))
                                   for offset in range(lengths[j])])

        row_idcs.append(np.unique(mask_idc[mask_idc < sz]))

    min_count = min(len(m) for m in row_idcs)
    for i, idc in enumerate(row_idcs):
        if len(idc) > min_count and require_same_masks:
            idc = r.choice(idc, min_count, replace=False)
        if mask_dropout > 0:
            num_holes = np.rint(len(idc) * mask_dropout).astype(int)
            idc = r.choice(idc, len(idc) - num_holes, replace=False)
        mask[i, idc] = True
    return mask
