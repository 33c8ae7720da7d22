"""The latent normalizer's loss (the port's copy of
diffnorm_tpu/criterions/ddpm_loss.py:28-110).

* noise MSE: zeroed outside the mask, the mean over (T, C) per sequence
  (zeros included), min-SNR weighted, the batch mean;
* multitask reconstruction: 50 * the masked MSE of the decoded features
  plus the label-smoothed NLL (eps 0.1, ignore_index 0) over the unit count;
* total = noise MSE + reconstruction / timesteps (noise MSE alone without
  multitask); sample_size = nsentences.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.label_smoothing import (
    label_smoothed_nll_loss,
    unit_accuracy,
)
from diffnorm_tpu_torch.criterions.vae_loss import masked_mse
from diffnorm_tpu_torch.utils.masking import lengths_to_mask

INJECTED = ("times", "enc_noise", "x1_noise", "q_noise")


class DDPMDiscreteLoss:
    grad_accum = "mean_loss"  # see SpeechVAELoss
    eps, recon_mse_weight = 0.1, 50.0

    def assemble(self, out: Dict[str, torch.Tensor], feature: torch.Tensor,
                 units: torch.Tensor, mask: torch.Tensor, timesteps: int,
                 multitask: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and metrics from a training forward's output dict."""
        sq = (out["pred_noise"].float() - out["true_noise"].float()).square()
        per_seq = torch.where(mask[..., None], sq, 0.0).mean(dim=(1, 2))
        noise_mse = (per_seq * out["loss_weight"]).mean()

        recon_mse = masked_mse(out["recon_feature"], feature, mask)
        logits = out["lm_logits"]
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        flat_units = units.reshape(-1)
        ce_sum, _ = label_smoothed_nll_loss(lprobs, flat_units, self.eps, ignore_index=0)
        n_correct, total = unit_accuracy(lprobs, flat_units, ignore_index=0)
        ntokens = torch.clamp((flat_units != 0).sum(), min=1)
        smooth_loss = ce_sum / ntokens
        recon_loss = self.recon_mse_weight * recon_mse + smooth_loss
        loss = noise_mse + recon_loss / timesteps if multitask else noise_mse
        metrics = {
            "loss": loss, "noise_loss": noise_mse, "recon_mse_loss": recon_mse,
            "nll_loss": smooth_loss, "acc": n_correct / torch.clamp(total, min=1),
            "ntokens": ntokens, "nsentences": feature.shape[0],
            "sample_size": feature.shape[0],
        }
        return loss, metrics

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch as for SpeechVAELoss; the draws of the training forward may
        be injected as inject_times / inject_enc_noise / inject_x1_noise /
        inject_q_noise. Returns (loss, metrics)."""
        feature = batch["reduce_target"]
        mask = lengths_to_mask(batch["reduce_target_lengths"], feature.shape[1])
        out = model(feature, mask, generator=generator,
                    **{k: batch.get(f"inject_{k}") for k in INJECTED})
        return self.assemble(out, feature, batch["reduce_target_unit"], mask,
                             model.timesteps, model.multitask)
