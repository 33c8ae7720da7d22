"""Label-smoothed NLL and unit accuracy (the port's copy of
diffnorm_tpu/criterions/label_smoothing.py, fairseq's
label_smoothed_nll_loss numerics)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def label_smoothed_nll_loss(lprobs: torch.Tensor, target: torch.Tensor, epsilon: float,
                            ignore_index: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lprobs [N, V] log-probabilities, target [N] -> (loss_sum, nll_sum):
    loss_i = (1 - eps - eps / (V - 1)) * nll_i + eps / (V - 1) * smooth_i,
    smooth_i = -sum_v lprobs[i, v]; positions at ignore_index count zero."""
    vocab = lprobs.shape[-1]
    target = target.long()
    nll = -lprobs.gather(-1, target[:, None])[:, 0]
    smooth = -lprobs.sum(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        nll = torch.where(keep, nll, 0.0)
        smooth = torch.where(keep, smooth, 0.0)
    eps_i = epsilon / (vocab - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth
    return loss.sum(), nll.sum()


def unit_accuracy(lprobs: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_correct, total) of the argmax over positions where target !=
    ignore_index."""
    keep = target != ignore_index
    return ((lprobs.argmax(-1) == target) & keep).sum(), keep.sum()
