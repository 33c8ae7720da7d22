"""The SEDD criterion, "sedd_loss" (the port of
diffnorm_tpu/criterions/sedd_loss.py; reference score_model.py:1203-1207):
the dsigma-weighted denoising score entropy summed over positions and
averaged over the batch. The reference backwards that batch mean as it is,
so sample_size = nsentences and the trainer accumulates micro-batches under
"mean_loss".

The times and the perturbation's uniforms come from the generator the
trainer passes, or from a batch's `inject_times` [B] and `inject_mask_u`
[B, T], which a test fills with JAX's draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.parallel.mesh import global_mean
from diffnorm_tpu_torch.utils.masking import lengths_to_mask


class SEDDLoss:
    grad_accum = "mean_loss"
    data_parallel = True  # its means over the global batch under a split (parallel.mesh)

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: target_unit [B, T] and target_lengths [B]. Returns (loss,
        metrics)."""
        tokens = batch["target_unit"].long()
        valid = lengths_to_mask(batch["target_lengths"], tokens.shape[1])
        out = model(tokens, valid, generator=generator, t=batch.get("inject_times"),
                    u=batch.get("inject_mask_u"))
        loss = global_mean(out["weight"] * out["loss_per_pos"].sum(1))
        metrics = {"loss": loss, "n_masked": global_mean(out["n_masked"].float()),
                   "ntokens": valid.sum().clamp(min=1), "nsentences": tokens.shape[0],
                   "sample_size": tokens.shape[0]}
        return loss, metrics
