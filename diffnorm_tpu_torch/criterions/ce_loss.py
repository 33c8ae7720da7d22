"""The AR S2UT criterions (the port's copy of
diffnorm_tpu/criterions/ce_loss.py:15-106; reference fairseq
label_smoothed_cross_entropy.py and speech_to_speech_criterion.py:159-225).

* "label_smoothed_cross_entropy": the decoder's teacher-forced logits
  against the target, label-smoothed with eps_i = eps / (V - 1), pad
  ignored, summed and divided by ntokens, the batch's non-pad target
  tokens (every sub-frame when stacked: logits [B, T, k, V] against
  targets [B, T, k]); sample_size = ntokens, the trainer accumulating
  micro-batches under "sum_loss" as JAX's does.
* "speech_to_unit": the same, with the --multitask-config-yaml aux heads on
  (the forward gets tgt_tokens and the transformer heads'
  prev_output_tokens) and their terms (`nar_loss.apply_multitask_losses`).
* "speech_to_unit_2pass" (UnitY; JAX ce_loss.py:108-131, reference
  speech_to_speech_criterion.py:258-330): "speech_to_unit" whose forward
  also gets the first-pass task's prev_output_tokens (`prev_tokens_mt`) and
  always tgt_tokens; the first pass's loss is that task's multitask term,
  its logits coming back under its name.
* "lm_cross_entropy" (the unit LM; JAX ce_loss.py:136-171): next-token CE
  on the targets shifted right behind an EOS, label-smoothed, pad (1)
  ignored, divided by ntokens; sample_size = ntokens, "sum_loss" as above.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.label_smoothing import label_smoothed_nll_loss
from diffnorm_tpu_torch.criterions.nar_loss import _multitask_prev, apply_multitask_losses

PAD, EOS = 1, 2


class LabelSmoothedCrossEntropy:
    grad_accum = "sum_loss"

    def __init__(self, label_smoothing: float = 0.1):
        self.eps = label_smoothing

    def model_kwargs(self, batch: Dict) -> Dict:
        """The forward's extra arguments (none here)."""
        return {}

    def finalize(self, out: Dict, batch: Dict, loss: torch.Tensor, metrics: Dict,
                 ntokens: torch.Tensor) -> torch.Tensor:
        """The loss after the main term (as it is here)."""
        return loss

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: src_tokens [B, T, F], src_lengths [B], prev_output_tokens
        [B, L] and target [B, L] ([B, L, k] stacked); tgt_speaker [B, D]
        where given. The model's dropouts draw from its own generators, so
        `generator` is not used. Returns (loss, metrics)."""
        tgt = batch["target"].long()
        out = model(batch["src_tokens"], batch["src_lengths"], batch["prev_output_tokens"],
                    tgt_speaker=batch.get("tgt_speaker"), **self.model_kwargs(batch))
        logits = out["logits"]
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        flat_tgt = tgt.reshape(-1)
        loss_sum, nll_sum = label_smoothed_nll_loss(lprobs, flat_tgt, self.eps, ignore_index=PAD)
        ntokens = torch.clamp((tgt != PAD).sum(), min=1)
        loss = loss_sum / ntokens
        keep = flat_tgt != PAD
        metrics = {"loss": loss, "nll_loss": nll_sum / ntokens,
                   "acc": ((lprobs.argmax(-1) == flat_tgt) & keep).sum() / ntokens,
                   "ntokens": ntokens, "nsentences": tgt.shape[0], "sample_size": ntokens}
        loss = self.finalize(out, batch, loss, metrics, ntokens)
        metrics["loss"] = loss
        return loss, metrics


class SpeechToUnitLoss(LabelSmoothedCrossEntropy):
    def __init__(self, label_smoothing: float = 0.1, multitask: Optional[Dict] = None):
        """multitask: {task: SingleTaskConfig}."""
        super().__init__(label_smoothing)
        self.multitask = dict(multitask or {})

    def model_kwargs(self, batch: Dict) -> Dict:
        if not self.multitask:
            return {}
        return {"tgt_tokens": batch["target"],
                "multitask_prev": _multitask_prev(batch, self.multitask)}

    def finalize(self, out, batch, loss, metrics, ntokens):
        return apply_multitask_losses(self.multitask, out, batch, loss, metrics, ntokens)


class SpeechToUnit2PassLoss(SpeechToUnitLoss):
    def __init__(self, label_smoothing: float = 0.1, multitask: Optional[Dict] = None,
                 mt_task_name: Optional[str] = None):
        """multitask: {task: SingleTaskConfig}, the first pass's among them
        under `mt_task_name`."""
        if not mt_task_name:
            raise ValueError("speech_to_unit_2pass needs a first-pass decoder multitask")
        super().__init__(label_smoothing, multitask)
        self.mt_task_name = mt_task_name

    def model_kwargs(self, batch: Dict) -> Dict:
        return {"tgt_tokens": batch["target"],
                "multitask_prev": _multitask_prev(batch, self.multitask),
                "prev_tokens_mt": batch["multitask"][self.mt_task_name]["prev_output_tokens"]}


class LMCrossEntropy:
    grad_accum = "sum_loss"

    def __init__(self, label_smoothing: float = 0.0):
        self.eps = label_smoothing

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: target_unit [B, T]. The model's dropouts draw from their
        own generators. Returns (loss, metrics)."""
        tokens = batch["target_unit"].long()
        prev = torch.cat([torch.full_like(tokens[:, :1], EOS), tokens[:, :-1]], dim=1)
        logits = model(prev)
        lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(-1, logits.shape[-1])
        loss_sum, nll_sum = label_smoothed_nll_loss(lprobs, tokens.reshape(-1), self.eps,
                                                    ignore_index=PAD)
        ntokens = torch.clamp((tokens != PAD).sum(), min=1)
        loss = loss_sum / ntokens
        return loss, {"loss": loss, "nll_loss": nll_sum / ntokens,
                      "ppl": torch.exp(nll_sum / ntokens), "ntokens": ntokens,
                      "nsentences": tokens.shape[0], "sample_size": ntokens}


CRITERIONS = {"label_smoothed_cross_entropy": LabelSmoothedCrossEntropy,
              "speech_to_unit": SpeechToUnitLoss,
              "speech_to_unit_2pass": SpeechToUnit2PassLoss,
              "lm_cross_entropy": LMCrossEntropy}
