"""The NAR S2UT criterion, "nar_speech_to_unit" (the port's copy of
diffnorm_tpu/criterions/nar_loss.py:23-37, :115-194; reference
nar_speech_to_unit.py:125-220).

* unit CE, label-smoothed with eps_i = eps / (V - 1), only at the CMLM
  canvas's masked positions (prev == unk) that are not padding;
* the 256-way length classifier's CE with the same eps and
  ignore_index = pad = 1, so a target length of exactly 1 counts zero (the
  reference's quirk, kept);
* their sum divided by ntokens, the batch's non-pad target tokens;
  sample_size = ntokens, and the trainer accumulates micro-batches under the
  "sum_loss" convention, as JAX's criterion (no `grad_accum`) does.

The multitask and CTC terms are not ported (their flags raise in the task).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.label_smoothing import label_smoothed_nll_loss

PAD = 1


class NARSpeechToUnitLoss:
    # the reference backwards the summed loss: the trainer scales each
    # micro-batch's gradients by its sample_size and divides by the total
    grad_accum = "sum_loss"

    def __init__(self, label_smoothing: float = 0.2):
        self.eps = label_smoothing

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens [B, T, F], src_lengths [B], prev_target (the
        CMLM canvas) and target [B, L]; a training forward's CG and SP draws
        may be injected as inject_cg_drop [B] and inject_use_prompt (0-d).
        The model's dropouts draw from its own generators, so `generator`
        (the trainer's, for criterions that draw) is not used. Returns
        (loss, metrics)."""
        tgt = batch["target"].long()
        out = model(batch["src_tokens"], batch["src_lengths"], batch["prev_target"], tgt,
                    cg_drop=batch.get("inject_cg_drop"),
                    use_prompt=batch.get("inject_use_prompt"))
        logits = out["logits"]
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        keep = out["word_ins_mask"] & (tgt != PAD)
        masked_tgt = torch.where(keep, tgt, PAD).reshape(-1)
        ce_sum, nll_sum = label_smoothed_nll_loss(lprobs, masked_tgt, self.eps, ignore_index=PAD)
        len_lprobs = torch.log_softmax(out["length_logits"].float(), dim=-1)
        len_sum, _ = label_smoothed_nll_loss(len_lprobs, out["length_tgt"], self.eps,
                                             ignore_index=PAD)
        ntokens = torch.clamp((tgt != PAD).sum(), min=1)
        loss = (ce_sum + len_sum) / ntokens
        n_correct = ((lprobs.argmax(-1) == masked_tgt) & keep.reshape(-1)).sum()
        metrics = {
            "loss": loss, "nll_loss": nll_sum / ntokens, "loss_length": len_sum / ntokens,
            "acc": n_correct / torch.clamp(keep.sum(), min=1), "ntokens": ntokens,
            "nsentences": tgt.shape[0], "sample_size": ntokens,
        }
        return loss, metrics
