"""The speech VAE's loss: 0.1 * label-smoothed CE + 10 * MSE + 1e-4 * KL.

The port's copy of diffnorm_tpu/criterions/vae_loss.py:25-94 (reference
speech_vae_decoder_loss.py:45-100): CE with label smoothing 0.1 and
ignore_index 0 (units pad with 0), summed and divided by the batch's
ntokens; MSE over the valid feature elements only; the per-sequence masked
KL averaged over the batch; sample_size = nsentences. HubertVAELoss
(hubert_vae_loss, :96-104) weighs the CE 0 and the KL by `kl_beta`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.label_smoothing import (
    label_smoothed_nll_loss,
    unit_accuracy,
)
from diffnorm_tpu_torch.parallel.mesh import global_mean, global_sum
from diffnorm_tpu_torch.utils.masking import lengths_to_mask


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error in float32 over the valid ([B, T] mask) elements."""
    sq = (pred.float() - target.float()).square()
    n_valid = torch.clamp(global_sum(mask.sum() * target.shape[-1]), min=1)
    return torch.where(mask[..., None], sq, 0.0).sum() / n_valid


class SpeechVAELoss:
    # the reference backwards this already-normalized loss as it is, and the
    # trainer divides the summed gradients by the total sample_size
    grad_accum = "mean_loss"
    # its means divide by the global batch's counts under a data-parallel
    # split (parallel.mesh.global_sum), so the ranks' losses add up to it
    data_parallel = True
    ce_weight, mse_weight, kl_weight, eps = 0.1, 10.0, 1e-4, 0.1

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: reduce_target [B, T, C], reduce_target_unit [B, T],
        reduce_target_lengths [B], and optionally the injected posterior eps
        `posterior_noise`. Returns (loss, metrics)."""
        feature = batch["reduce_target"]
        units = batch["reduce_target_unit"]
        lengths = batch["reduce_target_lengths"]
        mask = lengths_to_mask(lengths, feature.shape[1])
        decoded, logits, kl = model(feature, mask, noise=batch.get("posterior_noise"),
                                    generator=generator)
        mse = masked_mse(decoded, feature, mask)
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        ce_sum, nll_sum = label_smoothed_nll_loss(lprobs, units.reshape(-1), self.eps,
                                                  ignore_index=0)
        n_correct, total = unit_accuracy(lprobs, units.reshape(-1), ignore_index=0)
        ntokens = torch.clamp(lengths.sum(), min=1)
        norm = global_sum(ntokens)
        kl_loss = global_mean(kl.float())
        loss = (self.ce_weight * (ce_sum / norm) + self.mse_weight * mse
                + self.kl_weight * kl_loss)
        metrics = {
            "loss": loss, "nll_loss": nll_sum / norm, "mse_loss": mse,
            "kl_loss": kl_loss, "acc": n_correct / torch.clamp(global_sum(total), min=1),
            "ntokens": ntokens, "nsentences": feature.shape[0],
            "sample_size": feature.shape[0],
        }
        return loss, metrics


class HubertVAELoss(SpeechVAELoss):
    """The HuBERT-feature VAE's loss: 10 * MSE + kl_beta * KL, no unit term
    (its CE is weighted 0; the metrics keep nll_loss and acc)."""

    def __init__(self, kl_beta: float = 1e-4):
        self.ce_weight, self.kl_weight = 0.0, kl_beta
