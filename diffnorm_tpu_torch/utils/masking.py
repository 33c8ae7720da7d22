"""Length masks (the port's copy of diffnorm_tpu/utils/masking.py:lengths_to_mask)."""

from __future__ import annotations

import torch


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True where t < length (valid)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
