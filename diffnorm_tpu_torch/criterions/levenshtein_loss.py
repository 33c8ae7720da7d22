"""The Levenshtein transformer's criterion, "levenshtein_loss" (the port of
diffnorm_tpu/criterions/levenshtein_loss.py; reference
LabelSmoothedDualImitationCriterion), and "nat_loss", fairseq's generic NAT
criterion, which dispatches on the arch as JAX's alias does
(criterions/aliases.py:38-46): a levenshtein arch takes this criterion,
any other the NAR masked CE (`nar_loss.NARSpeechToUnitLoss`).

The loss sums three terms over the task's host-made canvases and divides
by ntokens, the batch's non-pad target tokens:
* deletion CE over prev_del's non-pad positions against del_target;
* insertion-count CE over prev_kept's adjacent slots where ins_valid,
  against ins_target clipped to the classes;
* the word CE, label-smoothed (eps / (V - 1)), at prev_ins's UNK
  placeholders against the target.
sample_size = ntokens; the trainer accumulates micro-batches under
"sum_loss", as JAX's criterion (no `grad_accum`) does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.label_smoothing import label_smoothed_nll_loss
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss

PAD, UNK = 1, 3


class LevenshteinLoss:
    grad_accum = "sum_loss"

    def __init__(self, label_smoothing: float = 0.1):
        self.eps = label_smoothing

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens, src_lengths, target [B, T], the canvases
        prev_del, prev_kept, prev_ins [B, T], del_target [B, T], ins_target
        and ins_valid [B, T + 1]. The model's dropouts draw from its own
        generators, so `generator` is not used. Returns (loss, metrics)."""
        out = model(batch["src_tokens"], batch["src_lengths"], batch["prev_del"],
                    batch["prev_kept"], batch["prev_ins"])
        del_lp = torch.log_softmax(out["del_logits"].float(), dim=-1)
        del_nll = -del_lp.gather(-1, batch["del_target"].long()[..., None])[..., 0]
        del_loss = torch.where(batch["prev_del"] != PAD, del_nll, 0.0).sum()

        ins_lp = torch.log_softmax(out["ins_logits"].float(), dim=-1)
        slots = ins_lp.shape[1]
        ins_tgt = torch.clamp(batch["ins_target"][:, :slots].long(), 0, ins_lp.shape[-1] - 1)
        ins_nll = -ins_lp.gather(-1, ins_tgt[..., None])[..., 0]
        ins_loss = torch.where(batch["ins_valid"][:, :slots].bool(), ins_nll, 0.0).sum()

        word_lp = torch.log_softmax(out["word_logits"].float(), dim=-1)
        word_mask = (batch["prev_ins"] == UNK).reshape(-1)
        flat_lp = torch.where(word_mask[:, None], word_lp.reshape(-1, word_lp.shape[-1]), 0.0)
        flat_tgt = torch.where(word_mask, batch["target"].reshape(-1).long(), PAD)
        word_sum, _ = label_smoothed_nll_loss(flat_lp, flat_tgt, self.eps, ignore_index=PAD)

        ntokens = torch.clamp((batch["target"] != PAD).sum(), min=1)
        loss = (del_loss + ins_loss + word_sum) / ntokens
        return loss, {"loss": loss, "del_loss": del_loss / ntokens,
                      "ins_loss": ins_loss / ntokens, "word_loss": word_sum / ntokens,
                      "ntokens": ntokens, "nsentences": batch["src_tokens"].shape[0],
                      "sample_size": ntokens}


def nat_loss(arch: str, label_smoothing: Optional[float] = None,
             multitask: Optional[Dict] = None):
    """fairseq's nat_loss for `arch` (module docstring), each criterion at
    its own default smoothing where `label_smoothing` is None; `multitask`:
    the NAR model's aux heads ({task: SingleTaskConfig})."""
    if "levenshtein" in arch:
        return LevenshteinLoss(0.1 if label_smoothing is None else label_smoothing)
    return NARSpeechToUnitLoss(0.2 if label_smoothing is None else label_smoothing,
                               multitask=multitask)
