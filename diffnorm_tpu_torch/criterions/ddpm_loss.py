"""The latent normalizer's losses (the port's copy of
diffnorm_tpu/criterions/ddpm_loss.py).

DDPMDiscreteLoss (ddpm_discrete_loss, :28-110):

* noise MSE: zeroed outside the mask, the mean over (T, C) per sequence
  (zeros included), min-SNR weighted, the batch mean;
* multitask reconstruction: 50 * the masked MSE of the decoded features
  plus the label-smoothed NLL (eps 0.1, ignore_index 0) over the unit count;
* total = noise MSE + reconstruction / timesteps (noise MSE alone without
  multitask); sample_size = nsentences.

DDPMLatentLoss (ddpm_latent_loss, :189-223, the continuous tasks): the
min-SNR noise MSE alone, sample_size = nsentences, ntokens the sum of the
lengths; the forward decodes nothing.

Both pass the batch's injected draws (inject_times / inject_enc_noise /
inject_x1_noise / inject_q_noise, and for a prompt-conditioned model
inject_cg_drop) to the model, and a batch's `prompt` / `prompt_mask` where
it holds one. JAX's criterions pass no prompt, and no task makes one: the
prompt-conditioned model trains from a caller that builds such batches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.label_smoothing import (
    label_smoothed_nll_loss,
    unit_accuracy,
)
from diffnorm_tpu_torch.criterions.vae_loss import masked_mse
from diffnorm_tpu_torch.parallel.mesh import global_mean, global_sum
from diffnorm_tpu_torch.utils.masking import lengths_to_mask

INJECTED = ("times", "enc_noise", "x1_noise", "q_noise")


def forward_kwargs(batch: Dict[str, torch.Tensor]) -> Dict:
    """The training forward's keyword arguments from a batch: its injected
    draws and, where given, its prompt."""
    kw = {k: batch.get(f"inject_{k}") for k in INJECTED}
    kw["cond_drop"] = batch.get("inject_cg_drop")
    for key in ("prompt", "prompt_mask"):
        if batch.get(key) is not None:
            kw[key] = batch[key]
    return kw


def noise_mse(out: Dict[str, torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """The min-SNR weighted noise MSE: zeroed outside the mask, the mean
    over (T, C) per sequence (zeros included), the batch mean."""
    sq = (out["pred_noise"].float() - out["true_noise"].float()).square()
    per_seq = torch.where(mask[..., None], sq, 0.0).mean(dim=(1, 2))
    return global_mean(per_seq * out["loss_weight"])


class DDPMDiscreteLoss:
    grad_accum = "mean_loss"  # see SpeechVAELoss
    data_parallel = True  # global counts under a split, as SpeechVAELoss
    eps, recon_mse_weight = 0.1, 50.0

    def assemble(self, out: Dict[str, torch.Tensor], feature: torch.Tensor,
                 units: torch.Tensor, mask: torch.Tensor, timesteps: int,
                 multitask: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and metrics from a training forward's output dict."""
        noise = noise_mse(out, mask)
        recon_mse = masked_mse(out["recon_feature"], feature, mask)
        logits = out["lm_logits"]
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        flat_units = units.reshape(-1)
        ce_sum, _ = label_smoothed_nll_loss(lprobs, flat_units, self.eps, ignore_index=0)
        n_correct, total = unit_accuracy(lprobs, flat_units, ignore_index=0)
        ntokens = torch.clamp((flat_units != 0).sum(), min=1)
        smooth_loss = ce_sum / global_sum(ntokens)
        recon_loss = self.recon_mse_weight * recon_mse + smooth_loss
        loss = noise + recon_loss / timesteps if multitask else noise
        metrics = {
            "loss": loss, "noise_loss": noise, "recon_mse_loss": recon_mse,
            "nll_loss": smooth_loss, "acc": n_correct / torch.clamp(global_sum(total), min=1),
            "ntokens": ntokens, "nsentences": feature.shape[0],
            "sample_size": feature.shape[0],
        }
        return loss, metrics

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch as for SpeechVAELoss, with the injected draws and prompt of
        `forward_kwargs`. Returns (loss, metrics)."""
        feature = batch["reduce_target"]
        mask = lengths_to_mask(batch["reduce_target_lengths"], feature.shape[1])
        out = model(feature, mask, generator=generator, **forward_kwargs(batch))
        return self.assemble(out, feature, batch["reduce_target_unit"], mask,
                             model.timesteps, model.multitask)


class DDPMLatentLoss:
    grad_accum = "mean_loss"  # ddpm_latent_loss.py:69, sample_size = nsentences
    data_parallel = True

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: reduce_target [B, T, C] and reduce_target_lengths [B], with
        the injected draws and prompt of `forward_kwargs`. Returns (loss,
        metrics)."""
        feature, lengths = batch["reduce_target"], batch["reduce_target_lengths"]
        mask = lengths_to_mask(lengths, feature.shape[1])
        out = model(feature, mask, generator=generator, decode=False, **forward_kwargs(batch))
        loss = noise_mse(out, mask)
        return loss, {"loss": loss, "ntokens": lengths.sum(), "nsentences": feature.shape[0],
                      "sample_size": feature.shape[0]}
