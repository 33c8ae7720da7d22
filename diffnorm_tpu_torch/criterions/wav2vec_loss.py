"""wav2vec 2.0's criterion, "wav2vec" (the port of
diffnorm_tpu/criterions/wav2vec_loss.py; reference
fairseq/criterions/wav2vec_criterion.py:45-150 with infonce, as in every
recipe).

InfoNCE: the cross-entropy of the model's [B, M, 1 + N] logits with target
0 (the true quantized vector) over the valid masked slots; sample_size
their count, at least 1. The extra losses in the reference's order, the
codebook diversity (num_vars - prob_perplexity) / num_vars then
features_pen, each times its loss weight ([0.1, 10] in
wav2vec2_base_librispeech.yaml; a single weight serves both) and
sample_size; the sum divided by sample_size, accumulated under "sum_loss".
Accuracy: argmax at 0, less the rows whose argmin is 0 too (all equal).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffnorm_tpu_torch.criterions.hubert_loss import loss_weight_list


class Wav2VecLoss:
    grad_accum = "sum_loss"

    def __init__(self, loss_weights=None):
        lw = loss_weight_list(loss_weights, [0.1, 10.0])
        self.loss_weights = lw * 2 if len(lw) == 1 else lw

    def __call__(self, model, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: the task's prepared batch (mask_indices, masked_pos,
        masked_valid, neg_idxs, gumbel_temp)."""
        out = model(batch["src_tokens"], batch["src_lengths"], batch["mask_indices"].bool(),
                    batch["masked_pos"], batch["masked_valid"].bool(), batch["neg_idxs"],
                    temp=batch.get("gumbel_temp", 2.0))
        logits = out["logits"].float()
        valid = out["masked_valid"]
        w = valid.float()
        loss_sum = (-torch.log_softmax(logits, dim=-1)[..., 0] * w).sum()
        sample_size = w.sum().clamp_min(1.0)
        loss = loss_sum
        extra = [(out["num_vars"] - out["prob_perplexity"]) / out["num_vars"],
                 out["features_pen"]]
        for coef, p in zip(self.loss_weights, extra):
            if coef != 0:
                loss = loss + coef * p * sample_size
        amax, amin = logits.argmax(-1) == 0, logits.argmin(-1) == 0
        correct = (valid & amax & ~(amax & amin)).sum()
        temp = torch.as_tensor(out["temp"], dtype=torch.float32)
        return loss / sample_size, {
            "loss": loss / sample_size, "contrastive_loss": loss_sum / sample_size,
            "prob_perplexity": out["prob_perplexity"],
            "code_perplexity": out["code_perplexity"], "features_pen": out["features_pen"],
            "temp": temp, "correct": correct, "count": sample_size, "ntokens": sample_size,
            "nsentences": batch["src_tokens"].shape[0], "sample_size": sample_size}
